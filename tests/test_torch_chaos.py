"""The port's chaos wire and guard policies against the reference's, at
K = 4 on the same wire names: the fault positions and the fault tally
(``ChaosTransport`` on f32, bf16 and index results), the packed
payload's checksum word and structural validation, the pricer with the
checksum, the executor's per-node guard counts (the int8 ring's and the
quantizers' counts differ by node), and compressor steps of dgc, lgc_rar,
lgc_rar_q8 and lgc_ps under ``scrub`` and ``skip_round`` on ``ring``,
``ring_q8``, ``ring_packed`` (with the checksum) and ``mesh``: the global
gradient (node 0's, as the reference's leaves its shard_map), u, v, the
fault tally, ``fault/<label>`` and ``guard_ok``, bitwise; the gradient
that the AE decodes is held to the trajectory tests' bounds.  The
reference runs once, in a subprocess with 4 host devices, its steps under
shard_map with the per-node values brought out per node."""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import CompressionConfig as RCC
from repro.core import build_compressor as ref_build_compressor
from repro.dist import chaos as RCH
from repro.dist import packed as RPK
from repro.dist import plan as RXP
from repro.dist import transport as RT
from repro_torch.configs.base import CompressionConfig
from repro_torch.core.compressors import build_compressor
from repro_torch.dist import chaos as CH
from repro_torch.dist import packed as PK
from repro_torch.dist import plan as XP
from repro_torch.dist.transport import SimTransport, make_transport
from repro_torch.launch import train
from repro_torch.utils.convert import ae_from_numpy

K, N, KP, KB, LEADER = 4, 1000, 50, 48, 1
PARAMS = {"embed": {"w": (32, 16)}, "layer1": {"w": (64, 64), "b": (64,)},
          "layer2": {"w": (64, 64)}, "lm_head": {"w": (16, 32)}}
NAN_AT = 676          # a coordinate of layer1/w, a compressed leaf
NANINF = dict(fault_seed=11, fault_nans=2, fault_infs=1)
FLIPS = dict(fault_seed=3, fault_bitflips=2, fault_nans=2, fault_infs=1,
             fault_ops="topk")
Q8_TOL = 2e-3          # the reference's bound on an int8 wire's gradient
# id: (method, phase, step, wire, guard, checksum, faults, gradient);
# gradient "nan2" puts a NaN into node 2's gradient at NAN_AT, so that the
# nodes' own counts differ
CASES = {
    "dgc-ring_packed-flips": ("dgc", "topk_ae", 1, "ring_packed", "scrub",
                              True, FLIPS, "normal"),
    "dgc-mesh-skip": ("dgc", "topk_ae", 1, "mesh", "skip_round", False,
                      NANINF, "normal"),
    "dgc-ring-drop-stale": ("dgc", "topk_ae", 1, "ring", "scrub", False,
                            dict(fault_drop_node=1, fault_stale_node=2,
                                 fault_ops="topk"), "normal"),
    "dgc-ring_packed-nan2": ("dgc", "topk_ae", 1, "ring_packed", "scrub",
                             True, {}, "nan2"),
    "dgc-ring-nan2": ("dgc", "topk_ae", 1, "ring", "skip_round", False, {},
                      "nan2"),
    "lgc_rar-warmup-ring-skip": ("lgc_rar", "warmup", 0, "ring",
                                 "skip_round", False, NANINF, "normal"),
    "lgc_rar-topk-ring-scrub": ("lgc_rar", "topk_ae", 3, "ring", "scrub",
                                False, NANINF, "normal"),
    "lgc_rar-topk-ring_packed-scrub": ("lgc_rar", "topk_ae", 3,
                                       "ring_packed", "scrub", True, NANINF,
                                       "normal"),
    "lgc_rar-comp-mesh-skip": ("lgc_rar", "compressed", 3, "mesh",
                               "skip_round", False, NANINF, "normal"),
    "lgc_rar-comp-mesh-scrub": ("lgc_rar", "compressed", 3, "mesh", "scrub",
                                False, NANINF, "normal"),
    "lgc_rar_q8-comp-ring_q8-skip": ("lgc_rar_q8", "compressed", 2,
                                     "ring_q8", "skip_round", False,
                                     dict(fault_nans=1,
                                          fault_ops="encoding"), "normal"),
    "lgc_rar_q8-comp-ring_q8-nan2": ("lgc_rar_q8", "compressed", 2,
                                     "ring_q8", "scrub", False, {}, "nan2"),
    "lgc_rar_q8-comp-mesh-scrub": ("lgc_rar_q8", "compressed", 2, "mesh",
                                   "scrub", False, NANINF, "normal"),
    "lgc_ps-topk-ring_packed-scrub": ("lgc_ps", "topk_ae", 3, "ring_packed",
                                      "scrub", True, NANINF, "normal"),
    "lgc_ps-comp-ring_packed-skip": ("lgc_ps", "compressed", 3,
                                     "ring_packed", "skip_round", True,
                                     NANINF, "normal"),
}
# the executor alone, one op, guard scrub: id -> (wire, op kind); the
# int8 ring's and the fake int8 means' quantizer counts are each node's
SINKS = {"q8-ring_q8": ("ring_q8", "q8"), "q8-ring": ("ring", "q8"),
         "q8-mesh": ("mesh", "q8"), "packed-ring_packed": ("ring_packed",
                                                           "packed"),
         "support-ring_packed": ("ring_packed", "support")}


def _cc_kw(method, guard="off", checksum=False, faults=None):
    return dict(method=method, sparsity=0.05, innovation_sparsity=0.005,
                warmup_steps=1, ae_train_steps=1, guard=guard,
                guard_checksum=checksum, **(faults or {}))


def _params():
    return {k: {n: torch.zeros(s) for n, s in d.items()}
            for k, d in PARAMS.items()}


def _inputs():
    r = np.random.default_rng(4)
    n = build_compressor(CompressionConfig(**_cc_kw("dgc")), _params(),
                         K).layout.n_total
    out = {key: (r.standard_normal((K, n)) * 0.01).astype(np.float32)
           for key in ("u", "v", "g")}
    out["g_nan2"] = out["g"].copy()
    out["g_nan2"][2, NAN_AT] = np.nan
    xq = (r.standard_normal((K, 300, 7)) * np.logspace(-3, 2, 7)
          ).astype(np.float32)
    xq[1, 5, :3] = np.nan
    xq[2, 290, 6] = np.inf
    out["xq"] = xq
    vals = r.standard_normal((K, KP)).astype(np.float32)
    vals[2, 7], vals[3, 1] = np.nan, -np.inf
    out["vals"] = vals
    out["idx"] = np.stack([np.concatenate([r.choice(N, KP - 2, replace=False),
                                           [N, N]]) for _ in range(K)]
                          ).astype(np.int32)
    out["sidx"] = np.sort(np.stack([np.concatenate(
        [r.choice(N, KB - 1, replace=False), [N]]) for _ in range(K)]),
        1).astype(np.int32)
    return out


REF = """
import json
import jax, jax.flatten_util, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.configs.base import CompressionConfig
from repro.core import build_compressor
from repro.dist import chaos as CH
from repro.dist import packed as PK
from repro.dist import plan as XP
from repro.dist.transport import make_transport

K, N, KP, KB, LEADER = {K}, {N}, {KP}, {KB}, {LEADER}
PARAMS = {PARAMS!r}
CASES = {CASES!r}
SINKS = {SINKS!r}
d = dict(np.load({path_in!r}))
mesh = jax.make_mesh((K,), ("data",),
                     axis_types=(jax.sharding.AxisType.Auto,))
out, tallies = {{}}, {{}}


def cc_kw(method, guard="off", checksum=False, faults=None):
    return dict(method=method, sparsity=0.05, innovation_sparsity=0.005,
                warmup_steps=1, ae_train_steps=1, guard=guard,
                guard_checksum=checksum, **(faults or {{}}))


def smap(fn, n_in):
    return jax.jit(jax.shard_map(fn, mesh=mesh,
                                 in_specs=(P("data"),) * n_in,
                                 out_specs=P("data"),
                                 axis_names={{"data"}}, check_vma=False))


def op_of(kind):
    if kind == "q8":
        return XP.Reduce("enc", n_vals=2100, wire="q8"), ("xq",)
    if kind == "packed":
        return XP.PackedSparseExchange(
            "topk", n_vec=N, k=KP, k_rate=KP,
            pack=PK.make_plan(N, KP, checksum=True)), ("vals", "idx")
    return XP.IndexBroadcast("support", n_vec=N, k=KB, k_rate=KB,
                             pack=PK.make_plan(N, KB, checksum=True)), \\
        ("sidx",)


for key, (wire, kind) in SINKS.items():
    op, names = op_of(kind)
    t = make_transport(wire, K, axes=("data",), guard="scrub")
    plan = XP.Plan(method="x", phase="x", transport=wire, K=K,
                   scale_block=256, ops=(op,))

    def inner(*a):
        a = tuple(x[0] for x in a)
        if kind == "support":
            a = a + (LEADER,)
        env = XP.execute(plan, t, {{op.label: lambda env: a}})
        return {{"bad": env["__guard__"]["bad"][op.label][None],
                 "res": env[op.label][None]}}
    got = smap(inner, len(names))(*[jnp.asarray(d[n]) for n in names])
    out[key + "/bad"] = np.asarray(got["bad"])
    out[key + "/res"] = np.asarray(got["res"])[0]

params = {{k: {{n: jnp.zeros(s) for n, s in v.items()}}
          for k, v in PARAMS.items()}}
for key, (method, phase, step, wire, guard, chk, faults, gk) in \\
        CASES.items():
    cc = CompressionConfig(**cc_kw(method, guard, chk, faults))
    comp = build_compressor(cc, params, K)
    base = comp.init_state(jax.random.PRNGKey(0))
    ae_part = {{k: base[k] for k in ("ae", "ae_mom") if k in base}}

    def inner(u, v, g):
        state = {{"u": u[0], "v": v[0], **ae_part}}
        gg, st, stats = comp.dist_step(state, g[0], step, phase,
                                       ("data",), transport=wire)
        stats = {{k: s for k, s in stats.items() if k != "ae_loss"}}
        return {{"g": gg[None], "u": st["u"][None], "v": st["v"][None],
                 **{{k: jnp.asarray(s)[None] for k, s in stats.items()}}}}
    CH.reset_fault_tally()
    got = smap(inner, 3)(d["u"], d["v"],
                         d["g_nan2" if gk == "nan2" else "g"])
    tallies[key] = CH.fault_report()
    for name, a in got.items():
        out[key + "/" + name] = np.asarray(a)
    if "ae" in base:
        out[key + "/ae"] = np.asarray(jax.flatten_util.ravel_pytree(
            base["ae"])[0])
np.savez({path_out!r}, **out)
with open({path_tally!r}, "w") as f:
    json.dump(tallies, f)
print("PASS")
"""


@pytest.fixture(scope="module")
def reference(subproc, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ref_chaos")
    d = _inputs()
    paths = {k: str(tmp / k) for k in ("in", "out", "tally")}
    np.savez(paths["in"], **d)
    code = REF.format(K=K, N=N, KP=KP, KB=KB, LEADER=LEADER, PARAMS=PARAMS,
                      CASES=CASES, SINKS=SINKS,
                      path_in=paths["in"] + ".npz",
                      path_out=paths["out"] + ".npz",
                      path_tally=paths["tally"])
    assert "PASS" in subproc(code, devices=K, timeout=900)
    with open(paths["tally"]) as f:
        tallies = json.load(f)
    return d, dict(np.load(paths["out"] + ".npz")), tallies


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _equal(ours, ref, what):
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else ours
    ref = np.asarray(ref)
    assert ours.shape == ref.shape, (what, ours.shape, ref.shape)
    nan = np.isnan(ref) if ref.dtype.kind == "f" else np.zeros(ref.shape,
                                                               bool)
    # NaN where the reference has NaN (the payload of a NaN that went
    # through an FMA is the device's), every other element by its bits
    np.testing.assert_array_equal(np.isnan(ours) if nan.any() else nan, nan,
                                  err_msg=what)
    np.testing.assert_array_equal(_bits(ours)[~nan], _bits(ref)[~nan],
                                  err_msg=what)


def _port_op(kind):
    if kind == "q8":
        return XP.Reduce("enc", n_vals=2100, wire="q8"), ("xq",)
    if kind == "packed":
        return XP.PackedSparseExchange(
            "topk", n_vec=N, k=KP, k_rate=KP,
            pack=PK.make_plan(N, KP, checksum=True)), ("vals", "idx")
    return XP.IndexBroadcast("support", n_vec=N, k=KB, k_rate=KB,
                             pack=PK.make_plan(N, KB, checksum=True)), \
        ("sidx",)


@pytest.mark.parametrize("key", list(SINKS))
def test_executor_guard_counts_per_node_match_reference(reference, key):
    """One op through ``execute`` under ``scrub``: the scrubbed result
    bitwise and each node's bad count equal to that node's in the
    reference's shard_map; on the int8 wires the counts differ by node
    (each node counts the non-finites it quantizes)."""
    d, ref, _ = reference
    wire, kind = SINKS[key]
    op, names = _port_op(kind)
    t = make_transport(wire, K, guard="scrub")
    plan = XP.Plan(method="x", phase="x", transport=wire, K=K,
                   scale_block=256, ops=(op,))
    args = tuple(torch.from_numpy(d[n]) for n in names)
    if kind == "support":
        args = args + (LEADER,)
    env = XP.execute(plan, t, {op.label: lambda env: args})
    if key in ("q8-ring", "q8-mesh"):
        # the float wires' fake-int8 mean: within an ulp of the largest
        # addend per addition (test_torch_transports' bound; which
        # dequantizes XLA fuses into the adds depends on the shapes)
        x = np.where(np.isfinite(d["xq"]), np.abs(d["xq"]), 0)
        assert (np.abs(env[op.label].numpy() - ref[key + "/res"])
                <= K * np.spacing(x.max(0))).all()
    else:
        _equal(env[op.label], ref[key + "/res"], key + " result")
    bad = env["__guard__"]["bad"][op.label]
    np.testing.assert_array_equal(bad.numpy(), ref[key + "/bad"],
                                  err_msg=key)
    if kind == "q8" and wire == "ring_q8":
        assert len(set(bad.tolist())) > 1, bad


def _port_step(d, key):
    method, phase, step, wire, guard, chk, faults, gk = CASES[key]
    cc = CompressionConfig(**_cc_kw(method, guard, chk, faults),
                           transport=wire)
    comp = build_compressor(cc, _params(), K)
    states = comp.init_sim_states(torch.Generator())
    states["u"] = torch.from_numpy(d["u"].copy())
    states["v"] = torch.from_numpy(d["v"].copy())
    if method.startswith("lgc"):
        rparams = {k: {n: np.zeros(s, np.float32) for n, s in v.items()}
                   for k, v in PARAMS.items()}
        rcomp = ref_build_compressor(RCC(**_cc_kw(method)), rparams, K)
        rae = rcomp.init_state(jax.random.PRNGKey(0))["ae"]
        states["ae"] = ae_from_numpy(jax.tree_util.tree_map(np.asarray, rae))
    CH.reset_fault_tally()
    g = torch.from_numpy(d["g_nan2" if gk == "nan2" else "g"])
    gg, states, stats = comp.sim_step(states, g, step, phase)
    return gg, states, stats, CH.fault_report()


@pytest.mark.parametrize("key", list(CASES))
def test_guarded_step_matches_reference(reference, key):
    d, ref, tallies = reference
    method, phase, step, wire, guard, chk, faults, gk = CASES[key]
    gg, states, stats, tally = _port_step(d, key)
    assert tally == tallies[key], (tally, tallies[key])
    # the reference's stats per node: the port reports node 0's
    names = [k[len(key) + 1:] for k in ref if k.startswith(key + "/")]
    counts = {k: int(ref[f"{key}/{k}"][0]) for k in names
              if k.startswith("fault/") or k == "guard_ok"}
    assert {k: stats[k] for k in counts} == counts, (stats, counts)
    want = ref[key + "/g"][0]
    skipped = guard == "skip_round" and counts["guard_ok"] == 0
    if phase == "compressed" and method.startswith("lgc") and not skipped:
        # the AE decoder's output: its convolutions round differently
        tol = Q8_TOL if method == "lgc_rar_q8" else \
            2e-5 * np.abs(want).max()
        np.testing.assert_allclose(gg.numpy(), want, rtol=0, atol=tol)
        np.testing.assert_array_equal(gg.numpy() != 0, want != 0)
    else:
        _equal(gg, want, key + " global gradient")
    _equal(states["u"], ref[key + "/u"], key + " u")
    _equal(states["v"], ref[key + "/v"], key + " v")
    if gk == "nan2" and wire != "ring":
        # the nodes' own counts differ: node 2 alone quantized its NaN,
        # and node 2 alone keeps its accumulators uncleared
        assert ref[key + "/guard_ok"].tolist() == [1, 1, 0, 1]


def test_fault_positions_and_tally_match_reference():
    """ChaosTransport's faults on f32 (K, n) and (n,) results, a bf16
    result (flipped on its f32 bits) and an index result (int32 bits; the
    port's int64 indices too): bitwise the reference's, and the same
    tally."""
    r = np.random.default_rng(0)
    spec = dict(seed=5, bitflips=7, nans=3, infs=2)
    port = CH.ChaosTransport(SimTransport(K), CH.FaultSpec(**spec))
    refc = RCH.ChaosTransport(RT.SimTransport(K), RCH.FaultSpec(**spec))
    cases = [("topk", r.standard_normal((K, 333)).astype(np.float32)),
             ("grad", r.standard_normal(1000).astype(np.float32)),
             ("bf", r.standard_normal(257).astype(np.float32)),
             ("support", np.sort(r.choice(10 ** 6, 500, replace=False)
                                 ).astype(np.int32))]
    CH.reset_fault_tally()
    RCH.reset_fault_tally()
    for label, x in cases:
        if label == "bf":
            got = port._corrupt(torch.from_numpy(x).to(torch.bfloat16), label)
            want = refc._corrupt(jnp.asarray(x, jnp.bfloat16), label)
            np.testing.assert_array_equal(
                got.view(torch.int16).numpy(),
                np.asarray(want).view(np.int16), err_msg=label)
            continue
        want = np.asarray(refc._corrupt(jnp.asarray(x), label))
        _equal(port._corrupt(torch.from_numpy(x), label), want, label)
    assert CH.fault_report() == RCH.fault_report()
    assert CH.fault_report()["support"] == {"bitflip": 7}
    # the port's int64 indices are flipped on their int32 bits: bit 31
    # gives a negative index, as in the reference
    got = port._corrupt(torch.from_numpy(cases[-1][1]).long(), "support")
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    # drop and stale act on the stacked node axis, as the reference's
    # sim transport does
    x = r.standard_normal((K, 40)).astype(np.float32)
    for s in (dict(drop_node=1), dict(stale_node=2)):
        got = CH.ChaosTransport(SimTransport(K), CH.FaultSpec(**s))._contrib(
            torch.from_numpy(x), "l")
        want = RCH.ChaosTransport(RT.SimTransport(K), RCH.FaultSpec(**s)
                                  )._contrib(jnp.asarray(x), "l")
        _equal(got, np.asarray(want), str(s))


def test_checksum_and_validation_match_reference():
    """checksum_word and validate_payload's (ok, bad) on a clean payload
    and on each corruption of the reference's own test (a flipped int8
    bit, a histogram off by 3, a NaN scale, an index-only histogram off
    by 1, raw indices out of order and out of bounds), plus a negative
    count: equal to the reference's."""
    def both(payload, plan, rplan, values=True):
        ok, bad = PK.validate_payload(
            tuple(torch.from_numpy(np.array(a)) for a in payload), plan,
            values=values)
        rok, rbad = RPK.validate_payload(payload, rplan, values=values)
        assert (bool(ok), int(bad)) == (bool(rok), int(rbad))
        return int(bad)

    n, k = 4096, 64
    r = np.random.default_rng(1)
    idx = np.sort(r.choice(n, k, replace=False)).astype(np.int32)
    vals = r.standard_normal(k).astype(np.float32)
    plan, rplan = PK.make_plan(n, k, 64, checksum=True), \
        RPK.make_plan(n, k, 64, checksum=True)
    pay = jax.jit(functools.partial(RPK.encode_sparse, plan=rplan))(
        jnp.asarray(vals), jnp.asarray(idx))
    ours = PK.encode_sparse(torch.from_numpy(vals), torch.from_numpy(idx),
                            plan)
    for a, b in zip(ours, pay):
        _equal(a, b, "payload")
    _equal(PK.checksum_word(ours[:-1]), RPK.checksum_word(pay[:-1]),
           "checksum word")
    assert both(pay, plan, rplan) == 0
    q_pos = len(pay) - 3
    flip = list(pay)
    flip[q_pos] = pay[q_pos].at[0].set(pay[q_pos][0] ^ 1)
    assert both(tuple(flip), plan, rplan) == 1
    for delta in (3, -70):
        hist = list(pay)
        hist[0] = pay[0].at[0].add(delta)
        assert both(tuple(hist), plan, rplan) >= 2
    nan = list(pay)
    nan[-2] = pay[-2].at[0].set(jnp.nan)
    assert both(tuple(nan), plan, rplan) >= 1
    ipay = RPK.encode_indices(jnp.asarray(idx), rplan)
    assert both(ipay, plan, rplan, values=False) == 0
    assert both((ipay[0].at[0].add(1),) + ipay[1:], plan, rplan,
                values=False) >= 1
    plan4, rplan4 = PK.make_plan(n, 4, 64), RPK.make_plan(n, 4, 64)
    assert plan4.raw_index
    raw = RPK.encode_sparse(jnp.ones(4), jnp.asarray([1, 5, 9, 4095],
                                                     jnp.int32), rplan4)
    assert both(raw, plan4, rplan4) == 0
    assert both((jnp.asarray([9, 5, 1, 4095], jnp.int32),) + raw[1:], plan4,
                rplan4) == 1
    assert both((jnp.asarray([1, 5, 9, n + 7], jnp.int32),) + raw[1:],
                plan4, rplan4) == 1


@pytest.mark.parametrize("method", ["dgc", "lgc_rar", "lgc_ps"])
def test_pricer_with_checksum_matches_reference(method):
    """With guard_checksum every PackPlan carries the word, and the
    ring_packed pricer charges it: per-op rows equal the reference's,
    phase by phase, and above the rows without it."""
    from repro.core import sparsify as RSP
    from repro_torch.core import sparsify as SP
    rparams = {k: {n: np.zeros(s, np.float32) for n, s in v.items()}
               for k, v in PARAMS.items()}
    layout, rlayout = SP.build_layout(_params(), 0.05), \
        RSP.build_layout(rparams, 0.05)
    for phase in ("topk_ae", "compressed"):
        kw = _cc_kw(method, checksum=True)
        plan = XP.build_plan(CompressionConfig(**kw), layout, K,
                             transport="ring_packed", phase=phase)
        rplan = RXP.build_plan(RCC(**kw), rlayout, K,
                               transport="ring_packed", phase=phase)
        packs = [op.pack for op in plan.ops
                 if getattr(op, "pack", None) is not None]
        assert packs and all(p.checksum for p in packs)
        assert XP.wire_terms_by_op(plan) == RXP.wire_terms_by_op(rplan)
        plain = XP.build_plan(CompressionConfig(**_cc_kw(method)), layout, K,
                              transport="ring_packed", phase=phase)
        assert sum(XP.wire_terms(plan).values()) > \
            sum(XP.wire_terms(plain).values())


def test_spec_and_transport_factory():
    assert CH.spec_from_config(CompressionConfig(method="dgc")) is None
    spec = CH.spec_from_config(CompressionConfig(
        method="dgc", fault_nans=3, fault_seed=7, fault_ops="topk,support"))
    assert spec == CH.FaultSpec(seed=7, nans=3, ops=("topk", "support"))
    for wire in XP.WIRE_TRANSPORTS:
        t = make_transport("chaos:" + wire, K, guard="skip_round", fault=spec)
        assert isinstance(t, CH.ChaosTransport)
        assert type(t.base) is type(make_transport(wire, K))
        assert t.spec == spec and t.guard == "skip_round" and t.K == K
    # an active spec wraps without the prefix
    assert isinstance(make_transport("ring", K, fault=spec), CH.ChaosTransport)
    assert type(make_transport("ring", K, fault=CH.FaultSpec())) \
        is not CH.ChaosTransport
    with pytest.raises(ValueError):
        make_transport("chaos:pigeon", K)


def test_raise_on_faults_names_the_label():
    with pytest.raises(CH.WireFaultError, match="encoding") as ei:
        CH.raise_on_faults({"fault/encoding": 2, "fault/support": 0,
                            "loss": 1.0}, step=4)
    assert "at step 4" in str(ei.value) and "support" not in str(ei.value)
    CH.raise_on_faults({"fault/encoding": 0, "guard_ok": 1})


ARGS = ["--smoke", "--steps", "4", "--batch", "2", "--seq", "16",
        "--compression", "lgc_rar", "--topk-backend", "fused",
        "--ae-backend", "pallas", "--data-shards", "2",
        "--warmup-steps", "1", "--ae-train-steps", "1", "--log-every", "1",
        "--device", "cpu"]


def test_fail_fast_run_raises_at_the_first_faulty_step():
    """The trainer under fail_fast with NaNs on the encoding: the
    compressed phase's first step raises, naming the op."""
    with pytest.raises(CH.WireFaultError, match="encoding") as ei:
        train.main(ARGS + ["--transport", "chaos:mesh", "--guard",
                           "fail_fast", "--fault-nans", "1", "--fault-ops",
                           "encoding"])
    assert "at step 2" in str(ei.value)


def test_bucketed_int8_ring_counts_every_bucket():
    """The bucketed int8 ring counts the non-finites of every bucket on
    the node that quantizes them: the unbucketed ring's per-node counts.
    (The reference keeps bucket 0's alone, its later buckets being
    quantized inside a loop's trace: ROADMAP.md Queue 3.)"""
    x = torch.from_numpy(_inputs()["xq"])
    bad = {}
    for B in (1, 3):
        t = make_transport("ring_q8", K, guard="scrub", wire_buckets=B)
        op = XP.Reduce("enc", n_vals=2100, wire="q8")
        plan = XP.Plan(method="x", phase="x", transport="ring_q8", K=K,
                       scale_block=256, ops=(op,), wire_buckets=B)
        env = XP.execute(plan, t, {"enc": lambda env: (x,)})
        bad[B] = env["__guard__"]["bad"]["enc"].tolist()
    assert bad[3] == bad[1] == [0, 3, 1, 0], bad
