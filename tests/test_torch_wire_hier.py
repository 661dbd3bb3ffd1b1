"""The rest of the emulated wire against the reference's shard_map
collectives, bitwise: the hierarchical ring (``ring_hier``) on one axis
(where it is the ring) and on a (2, 2) (pod x data) mesh, the chained
rings of ``ring`` and ``ring_q8`` on that mesh, and the bucketed
exchanges (``wire_buckets`` B in {2, 3, 5}, last buckets padded) of
``ring``, ``ring_q8``, ``ring_hier`` and ``ring_packed``: results and per-op
tallies, ``<op>#b<i>`` rows included; one ``GradientCompressor`` step of lgc_rar on
``ring_hier`` (2 x 2) and of dgc on ``ring_packed`` with B = 4 against the
reference's ``dist_step``, from accumulators u, v that are not zero; and
the pricer (``wire_terms_by_op``, ``padding_overhead_terms``) against the
reference's for the same layout, transport, mesh shape and B.  The
reference runs once per mesh, (2, 2), K = 2 and K = 3, in a subprocess
with that many host devices (``conftest.run_py``)."""
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import CompressionConfig as RCC
from repro.core import build_compressor as ref_build_compressor
from repro.dist import collectives as RC
from repro.dist import plan as RXP
from repro_torch.configs.base import CompressionConfig
from repro_torch.core.compressors import build_compressor
from repro_torch.dist import collectives as C
from repro_torch.dist import packed as PK
from repro_torch.dist import plan as XP
from repro_torch.dist.transport import RingHierTransport, make_transport
from repro_torch.utils.convert import ae_from_numpy

from test_torch_plan import _layouts

N, KP = 1000, 50
PARAMS = {"embed": {"w": (32, 16)}, "layer1": {"w": (64, 64), "b": (64,)},
          "layer2": {"w": (64, 64)}, "lm_head": {"w": (16, 32)}}
MESHES = {"2x2": (2, 2), "K2": (2,), "K3": (3,)}
BUCKETS = (1, 2, 3, 5)


def _cases(Ks):
    """(label, transport, call, B) run on both sides for the mesh
    ``Ks``."""
    out = []
    for B in BUCKETS:
        out += [(f"ring_mean_b{B}", "ring", "mean", B),
                (f"ring_sum_b{B}", "ring", "sum", B),
                (f"hier_mean_b{B}", "ring_hier", "mean", B),
                (f"packed_b{B}", "ring_packed", "gather", B)]
    out += [(f"q8_b{B}", "ring_q8", "mean_q8", B) for B in (1, 3)]
    if len(Ks) == 2:
        out += [("hier_sum_b3", "ring_hier", "sum", 3)]
    return out


# (method, phase, step, transport, B) of the compressor steps, per mesh
STEPS = {"2x2": [("lgc_rar", "topk_ae", 3, "ring_hier", 1),
                 ("lgc_rar", "compressed", 3, "ring_hier", 3)],
         "K2": [("dgc", "topk_ae", 3, "ring_packed", 4)], "K3": []}


def _cc(method, **kw):
    return dict(method=method, sparsity=0.05, warmup_steps=1,
                ae_train_steps=1, **kw)


def _params():
    return {k: {n: torch.zeros(s) for n, s in d.items()}
            for k, d in PARAMS.items()}


def _inputs(K):
    r = np.random.default_rng(10 + K)
    idx = np.stack([np.concatenate([r.choice(N, KP - 2, replace=False),
                                    [N, N]]) for _ in range(K)])
    out = {"x": r.standard_normal((K, 37, 5)).astype(np.float32),
           "vals": r.standard_normal((K, KP)).astype(np.float32),
           "idx": idx.astype(np.int32),
           "xq": (r.standard_normal((K, 300, 7)) * np.logspace(
               -3, 2, 7)).astype(np.float32)}
    n = build_compressor(CompressionConfig(**_cc("dgc")), _params(),
                         K).layout.n_total
    for key in ("u", "v", "g"):
        out[key] = (r.standard_normal((K, n)) * 0.01).astype(np.float32)
    return out


REF = """
import json
import jax, jax.flatten_util, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.configs.base import CompressionConfig
from repro.core import build_compressor
from repro.dist import collectives as C
from repro.dist import packed as PK
from repro.dist.transport import make_transport

Ks, N, KP = {Ks!r}, {N}, {KP}
CASES, STEPS, PARAMS = {CASES!r}, {STEPS!r}, {PARAMS!r}
K = int(np.prod(Ks))
axes = ("pod", "data") if len(Ks) == 2 else ("data",)
mesh = jax.make_mesh(Ks, axes,
                     axis_types=(jax.sharding.AxisType.Auto,) * len(Ks))
node = P(axes)
d = dict(np.load({path_in!r}))
out, wire = {{}}, {{}}


def spmd(label, fn, *args):
    def inner(*a):
        with C.wire_op(label):
            return fn(*[x[0] for x in a])[None]
    C.reset_wire_tally()
    g = jax.jit(jax.shard_map(inner, mesh=mesh,
                              in_specs=tuple(node for _ in args),
                              out_specs=node, axis_names=set(axes),
                              check_vma=False))
    res = np.asarray(g(*[jnp.asarray(a) for a in args]))
    assert all((res[i] == res[0]).all() for i in range(K)), label
    out[label] = res[0]
    wire[label] = C.wire_report(by_op=True)


plan = PK.make_plan(N, KP)
for label, kind, call, B in CASES:
    t = make_transport(kind, K, axes=axes, wire_buckets=B)
    if call == "gather":
        spmd(label, lambda v, i: t.sparse_gather_packed(v, i, N, plan=plan),
             d["vals"], d["idx"])
    else:
        spmd(label, getattr(t, call), d["xq" if call == "mean_q8" else "x"])

params = {{k: {{n: jnp.zeros(s) for n, s in v.items()}}
          for k, v in PARAMS.items()}}
for method, phase, step, tkind, B in STEPS:
    cc = CompressionConfig(method=method, sparsity=0.05, warmup_steps=1,
                           ae_train_steps=1, wire_buckets=B)
    comp = build_compressor(cc, params, K)
    base = comp.init_state(jax.random.PRNGKey(0))
    ae_part = {{k: base[k] for k in ("ae", "ae_mom") if k in base}}

    def inner(u, v, g):
        state = {{"u": u[0], "v": v[0], **ae_part}}
        gg, st, _ = comp.dist_step(state, g[0], step, phase, axes,
                                   transport=tkind)
        return gg[None], st["u"][None], st["v"][None]
    C.reset_wire_tally()
    f = jax.jit(jax.shard_map(inner, mesh=mesh, in_specs=(node,) * 3,
                              out_specs=(node,) * 3, axis_names=set(axes),
                              check_vma=False))
    gg, u, v = (np.asarray(a) for a in f(d["u"], d["v"], d["g"]))
    key = "/".join((method, phase, tkind, str(B)))
    out[key + "/g"], out[key + "/u"], out[key + "/v"] = gg[0], u, v
    wire[key] = C.wire_report(by_op=True)
np.savez({path_out!r}, **out)
with open({path_wire!r}, "w") as f:
    json.dump(wire, f)
print("PASS")
"""


@pytest.fixture(scope="module")
def reference(subproc, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ref_wire_hier")
    out = {}
    for name, Ks in MESHES.items():
        K = int(np.prod(Ks))
        d = _inputs(K)
        paths = {k: str(tmp / f"{k}_{name}") for k in ("in", "out", "wire")}
        np.savez(paths["in"], **d)
        code = REF.format(Ks=Ks, N=N, KP=KP, CASES=_cases(Ks),
                          STEPS=STEPS[name], PARAMS=PARAMS,
                          path_in=paths["in"] + ".npz",
                          path_out=paths["out"] + ".npz",
                          path_wire=paths["wire"])
        assert "PASS" in subproc(code, devices=K)
        with open(paths["wire"]) as f:
            wire = json.load(f)
        out[name] = (d, dict(np.load(paths["out"] + ".npz")), wire)
    return out


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _equal(ours, ref, what):
    ours = ours.numpy()
    assert ours.shape == ref.shape, (what, ours.shape, ref.shape)
    np.testing.assert_array_equal(_bits(ours), _bits(ref), err_msg=what)


def _run(Ks, d, label, kind, call, B):
    K = int(np.prod(Ks))
    t = make_transport(kind, K, Ks=Ks, wire_buckets=B)
    with t.wire_op(label):
        if call == "gather":
            res = t.sparse_gather_packed(
                torch.from_numpy(d["vals"]), torch.from_numpy(d["idx"]), N,
                plan=PK.make_plan(N, KP))
        else:
            res = getattr(t, call)(torch.from_numpy(
                d["xq" if call == "mean_q8" else "x"]))
    return res, t.tally


@pytest.mark.parametrize("mesh", list(MESHES))
def test_wire_matches_reference(reference, mesh):
    """Every case of the mesh, results and per-op rows (a bucketed
    exchange's ``#b<i>`` rows included) equal to the reference's."""
    Ks = MESHES[mesh]
    d, ref, wire = reference[mesh]
    for label, kind, call, B in _cases(Ks):
        res, tally = _run(Ks, d, label, kind, call, B)
        _equal(res, ref[label], f"{mesh} {label}")
        assert tally == wire[label], (mesh, label, tally, wire[label])
        if B > 1:
            assert any("#b" in row for row in tally), (mesh, label)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_bucketed_equals_unbucketed(reference, mesh):
    """The float rings bucketed are bitwise their unbucketed selves (each
    column keeps its chunk row); on one axis ring_hier is the ring, rows
    and all.  The int8
    wires regroup their scale blocks per bucket, so they are held to the
    reference's bucketed results (above), and here the packed gather to
    its unbucketed self within the two quantizations' bound, max|x| /
    127 (a value that rounds to 0 in one grouping may not in the
    other)."""
    Ks = MESHES[mesh]
    d, ref, _ = reference[mesh]
    bound = np.abs(d["vals"]).max() / 127
    for B in BUCKETS[1:]:
        for name in ("ring_mean", "ring_sum", "hier_mean"):
            _equal(torch.from_numpy(ref[f"{name}_b{B}"]), ref[f"{name}_b1"],
                   f"{mesh} {name} B={B}")
        got, want = ref[f"packed_b{B}"], ref["packed_b1"]
        assert np.abs(got - want).max() <= bound, (mesh, B)
    if len(Ks) == 1:
        for B in (1, 3):
            hier, th = _run(Ks, d, f"b{B}", "ring_hier", "mean", B)
            ring, tr = _run(Ks, d, f"b{B}", "ring", "mean", B)
            assert torch.equal(hier, ring) and th == tr


def test_hierarchical_bytes_beat_chained(reference):
    """On the (2, 2) mesh the hierarchical ring moves 1/K_data of the
    buffer across the pods, fewer bytes than the chained full rings, at
    every bucket count; and its unbucketed rows are exactly 2(K1-1)·c and
    2(Ka-1)·ceil(c/Ka) values."""
    _, _, wire = reference["2x2"]
    n = 37 * 5
    c = -(-n // 2)
    assert wire["hier_mean_b1"]["hier_mean_b1"] == {
        "ring_hier_intra": 2 * 1 * c * 4.0,
        "ring_hier_inter": 2 * 1 * -(-c // 2) * 4.0}
    for B in BUCKETS:
        def total(label):
            return sum(sum(row.values()) for row in wire[label].values())
        assert total(f"hier_mean_b{B}") < total(f"ring_mean_b{B}"), B


def test_make_transport_carries_the_mesh():
    t = make_transport("ring_hier", 4, Ks=(2, 2), wire_buckets=3)
    assert type(t) is RingHierTransport
    assert (t.Ks, t.wire_buckets) == ((2, 2), 3)
    assert make_transport("ring", 3).Ks == (3,)
    with pytest.raises(ValueError, match="mesh shape"):
        make_transport("ring_hier", 4, Ks=(2, 3))


@pytest.mark.parametrize("mesh", [m for m in MESHES if STEPS[m]])
def test_compressor_step_matches_reference(reference, mesh):
    """lgc_rar on ring_hier (2 x 2), one top-k + AE step unbucketed and one
    compressed step with B = 3, and dgc on ring_packed with B = 4 at K = 2:
    global gradient, u and v against the reference's dist_step from
    nonzero accumulators, and the per-op rows against both pricers.
    Bitwise, except lgc_rar's compressed gradient, the AE decoder's
    output, whose convolutions round differently in XLA and PyTorch
    (2e-5 of its largest value, as the ring_packed step tests)."""
    Ks = MESHES[mesh]
    K = int(np.prod(Ks))
    d, ref, wire = reference[mesh]
    for method, phase, step, tkind, B in STEPS[mesh]:
        cc = CompressionConfig(**_cc(method, transport=tkind,
                                     wire_buckets=B))
        comp = build_compressor(cc, _params(), K, Ks)
        states = comp.init_sim_states(torch.Generator())
        states["u"] = torch.from_numpy(d["u"].copy())
        states["v"] = torch.from_numpy(d["v"].copy())
        if method == "lgc_rar":
            rparams = {k: {n: np.zeros(s, np.float32)
                           for n, s in v.items()} for k, v in PARAMS.items()}
            rcomp = ref_build_compressor(RCC(**_cc(method)), rparams, K)
            rae = rcomp.init_state(jax.random.PRNGKey(0))["ae"]
            states["ae"] = ae_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                                rae))
        gg, states, stats = comp.sim_step(states, torch.from_numpy(d["g"]),
                                          step, phase)
        key = "/".join((method, phase, tkind, str(B)))
        want = ref[key + "/g"]
        if phase == "compressed":
            np.testing.assert_allclose(gg.numpy(), want, rtol=0,
                                       atol=2e-5 * np.abs(want).max())
            np.testing.assert_array_equal(gg.numpy() != 0, want != 0)
        else:
            _equal(gg, want, key + " global gradient")
        _equal(states["u"], ref[key + "/u"], key + " u")
        _equal(states["v"], ref[key + "/v"], key + " v")
        plan = XP.build_plan(cc, comp.layout, K, phase=phase)
        assert stats["wire"] == XP.wire_terms_by_op(plan, axis_sizes=Ks) \
            == wire[key], key
        if B > 1:
            assert any("#b" in row for row in stats["wire"]), key


def test_bucket_widths_match_reference():
    for c in (0, 1, 2, 5, 37, 64, 600):
        for nb in (1, 2, 3, 5, 11, 1000):
            assert C.bucket_widths(c, nb) == RC.bucket_widths(c, nb)


@pytest.mark.parametrize("which,sparsity", [("odd", 0.05),
                                            ("llama4", 0.001)])
@pytest.mark.parametrize("transport,Ks", [
    ("mesh", (4,)), ("ring", (3,)), ("ring", (2, 2)), ("ring_q8", (3,)),
    ("ring_q8", (2, 2)), ("ring_hier", (2, 2)), ("ring_hier", (2, 3)),
    ("ring_hier", (4,)), ("ring_packed", (2, 2)), ("ring_packed", (3,))])
def test_pricer_matches_reference(which, sparsity, transport, Ks):
    """wire_terms_by_op, wire_terms and padding_overhead_terms equal the
    reference's for every method, phase and B in {1, 2, 3, 5, 7}, and
    accounted == ideal + padding per op: raising B changes an op's bytes
    by exactly its padding delta."""
    layout, rlayout = _layouts(which, sparsity)
    K = int(np.prod(Ks))
    for method in ("none", "dgc", "lgc_ps", "lgc_rar", "lgc_rar_q8"):
        for phase in ("warmup", "topk_ae", "compressed"):
            for B in (1, 2, 3, 5, 7):
                cc = CompressionConfig(method=method, transport=transport,
                                       wire_buckets=B)
                rcc = RCC(method=method, transport=transport,
                          wire_buckets=B)
                plan = XP.build_plan(cc, layout, K, phase=phase)
                rplan = RXP.build_plan(rcc, rlayout, K, phase=phase)
                where = (method, phase, B)
                assert XP.wire_terms_by_op(plan, axis_sizes=Ks) == \
                    RXP.wire_terms_by_op(rplan, axis_sizes=Ks), where
                assert XP.wire_terms(plan, axis_sizes=Ks) == \
                    RXP.wire_terms(rplan, axis_sizes=Ks), where
                pad = XP.padding_overhead_terms(plan, axis_sizes=Ks)
                assert pad == RXP.padding_overhead_terms(
                    rplan, axis_sizes=Ks), where
                pad1 = XP.padding_overhead_terms(plan, axis_sizes=Ks,
                                                 wire_buckets=1)
                rows1 = XP.wire_terms_by_op(plan, axis_sizes=Ks,
                                            wire_buckets=1)
                for op in plan.ops:
                    acc = sum(sum(r.values()) for lbl, r in
                              XP.wire_terms_by_op(plan,
                                                  axis_sizes=Ks).items()
                              if lbl.split("#b")[0] == op.label)
                    acc1 = sum(rows1.get(op.label, {}).values())
                    assert acc - pad.get(op.label, 0.0) == pytest.approx(
                        acc1 - pad1.get(op.label, 0.0), rel=1e-12), where
                    assert acc >= acc1, where


def test_hierarchical_pricing_splits_two_levels():
    """ring_hier on (2, 2): each reduction prices the full-length intra
    ring and the 1/K_data-length inter ring; on one axis, the ring."""
    layout, _ = _layouts("odd", 0.05)
    plan = XP.build_plan(CompressionConfig(method="lgc_rar",
                                           transport="ring_hier"), layout, 4)
    by_op = XP.wire_terms_by_op(plan, axis_sizes=(2, 2))
    nd = sum(l.size for l in layout.dense)
    c = -(-nd // 2)
    assert by_op["exempt_dense"] == {"ring_hier_intra": 2 * c * 4.0,
                                     "ring_hier_inter": 2 * -(-c // 2) * 4.0}
    assert set(XP.wire_terms_by_op(plan, axis_sizes=(4,))["exempt_dense"]) \
        == {"ring_allreduce"}
