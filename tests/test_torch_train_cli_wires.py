"""The port's training entry point on the CPU on the other wires: lgc_ps
and lgc_rar_q8 (mesh, the packed ring, the int8 ring), the chaos wire
and the scrub guard on a clean wire, the hierarchical ring and the
bucketed packed ring; each phase's byte rows the pricer's."""
import numpy as np
import pytest

from _one_thread import one_thread  # noqa: F401  (autouse)
from _torch_train_common import ARGS
from repro_torch.configs import get_arch
from repro_torch.launch import train


@pytest.mark.parametrize("flags", [["--compression", "lgc_ps"],
                                   ["--compression", "lgc_ps",
                                    "--transport", "ring_packed"],
                                   ["--compression", "lgc_rar_q8",
                                    "--transport", "ring_q8"]])
def test_ps_q8_run_end_to_end_on_cpu(flags):
    """lgc_ps (mesh and the packed ring) and lgc_rar_q8 on the int8 ring
    from the entry point, through all three phases, each phase's byte
    rows the pricer's for the run's transport."""
    from repro_torch.dist import plan as XP
    args = train.parse_args(ARGS + flags + ["--device", "cpu"])
    out = train.run(get_arch("llama3.2-1b").reduced(), args)
    assert [h["phase"] for h in out["history"]] == ["warmup", "topk_ae",
                                                    "compressed"]
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    comp = out["compressor"]
    for phase, rows in out["wire"].items():
        plan = XP.build_plan(comp.cc, comp.layout, comp.K, phase=phase)
        assert rows == XP.wire_terms_by_op(plan)
    if "lgc_ps" in flags:
        assert out["rate"].bytes_leader > out["rate"].bytes_other


@pytest.mark.parametrize("flags", [["--transport", "chaos:mesh"],
                                   ["--guard", "scrub"]])
def test_unported_options_raise(flags):
    """The chaos wire with no fault set, and the scrub guard on a clean
    wire (the test's name is from before either was ported): the plain
    mesh run's losses bit for bit; under the guard every step is clean
    and counts no fault."""
    plain = train.main(ARGS + ["--device", "cpu"])
    history = train.main(ARGS + flags + ["--device", "cpu"])
    assert [h["loss"] for h in history] == [h["loss"] for h in plain]
    if "--guard" in flags:
        assert all(h["guard_ok"] == 1 and h["faults"] == 0
                   and set(h["fault"].values()) == {0} for h in history)
    assert all("fault_ops" not in h for h in history)


@pytest.mark.parametrize("flags", [["--transport", "ring_hier",
                                    "--pod-shards", "2", "--data-shards",
                                    "2", "--batch", "4"],
                                   ["--transport", "ring_packed",
                                    "--wire-buckets", "2"]])
def test_hier_and_bucketed_wires_run_end_to_end_on_cpu(flags):
    """The hierarchical ring on a (2, 2) pod mesh and the bucketed packed
    ring from the entry point, through all three phases: finite losses,
    and each phase's byte rows (``#b<i>`` rows where bucketed) the
    pricer's for the run's mesh."""
    from repro_torch.dist import plan as XP
    args = train.parse_args(ARGS + flags + ["--device", "cpu"])
    out = train.run(get_arch("llama3.2-1b").reduced(), args)
    assert [h["phase"] for h in out["history"]] == ["warmup", "topk_ae",
                                                    "compressed"]
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    comp = out["compressor"]
    assert comp.K == args.pod_shards * args.data_shards
    for phase, rows in out["wire"].items():
        plan = XP.build_plan(comp.cc, comp.layout, comp.K, phase=phase)
        assert rows == XP.wire_terms_by_op(plan, axis_sizes=comp.Ks)
    kinds = {k for rows in out["wire"].values() for row in rows.values()
             for k in row}
    if "ring_hier" in flags:
        assert {"ring_hier_intra", "ring_hier_inter"} <= kinds
    else:
        assert any("#b" in op for op in out["wire"]["compressed"])
