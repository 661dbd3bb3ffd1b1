"""The emulated ring transports against the reference's shard_map rings,
bitwise: ``RingTransport`` (mean, sum, from_leader, the exact sparse
mean) and ``RingPackedTransport`` (the packed sparse gather and mean, the
packed index broadcast) at K = 2 and 3, results and per-op tallies; the
int8 ring (``RingQ8Transport.mean_q8``, ``ring_allreduce_q8``) bitwise
with equal tally bytes, and ``RingTransport.mean_q8``; one
``GradientCompressor`` step of dgc, sparse_gd and lgc_rar (both sparsified
phases) on ``ring_packed`` at K = 2 against the reference's
``dist_step``, from accumulators u, v that are not zero, and one step of
lgc_ps (both sparsified phases, ``ring_packed``) and lgc_rar_q8
(``ring_q8``).  The reference runs once per K in a subprocess with K host
devices (``conftest.run_py``), reading its inputs from an npz and writing
its outputs to another."""
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import CompressionConfig as RCC
from repro.core import build_compressor as ref_build_compressor
from repro_torch.configs.base import CompressionConfig
from repro_torch.core.compressors import build_compressor
from repro_torch.dist import packed as PK
from repro_torch.dist import plan as XP
from repro_torch.dist.transport import (RingHierTransport,
                                        RingPackedTransport, RingQ8Transport,
                                        RingTransport, SimTransport,
                                        make_transport)
from repro_torch.utils.convert import ae_from_numpy

N, KP, KB, LEADER = 1000, 50, 48, 1
PARAMS = {"embed": {"w": (32, 16)}, "layer1": {"w": (64, 64), "b": (64,)},
          "layer2": {"w": (64, 64)}, "lm_head": {"w": (16, 32)}}
# the compressor steps: (method, phase, step); step 3 makes node 1 the
# lgc leader
STEPS = [("dgc", "topk_ae", 3), ("sparse_gd", "topk_ae", 3),
         ("lgc_rar", "topk_ae", 3), ("lgc_rar", "compressed", 3)]
# (method, phase, step, transport) of the PS and int8-wire steps
PS_Q8_STEPS = [("lgc_ps", "topk_ae", 3, "ring_packed"),
               ("lgc_ps", "compressed", 3, "ring_packed"),
               ("lgc_rar_q8", "compressed", 2, "ring_q8")]
Q8_TOL = 2e-3          # the reference's bound on an int8 wire's gradient


def _cc(method, **kw):
    return dict(method=method, sparsity=0.05, warmup_steps=1,
                ae_train_steps=1, **kw)


def _inputs(K):
    r = np.random.default_rng(K)
    idx = np.stack([np.concatenate([r.choice(N, KP - 2, replace=False),
                                    [N, N]]) for _ in range(K)])
    sidx = np.sort(np.stack([np.concatenate(
        [r.choice(N, KB - 1, replace=False), [N]]) for _ in range(K)]), 1)
    out = {"x": r.standard_normal((K, 37, 5)).astype(np.float32),
           "vals": r.standard_normal((K, KP)).astype(np.float32),
           "idx": idx.astype(np.int32), "sidx": sidx.astype(np.int32),
           # per-column ranges from 1e-3 to 1e2: several scale blocks
           "xq": (r.standard_normal((K, 300, 7)) * np.logspace(
               -3, 2, 7)).astype(np.float32)}
    if K == 2:
        layout = build_compressor(CompressionConfig(**_cc("dgc")), _params(),
                                  K).layout
        # u != 0: m·u + g is one FMA on both sides
        for key in ("u", "v", "g"):
            out[key] = (r.standard_normal((K, layout.n_total)) * 0.01
                        ).astype(np.float32)
    return out


def _params():
    return {k: {n: torch.zeros(s) for n, s in d.items()}
            for k, d in PARAMS.items()}


REF = """
import json, sys
import jax, jax.flatten_util, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.configs.base import CompressionConfig
from repro.core import build_compressor
from repro.dist import collectives as C
from repro.dist import packed as PK
from repro.dist.transport import make_transport

K, N, KP, KB, LEADER = {K}, {N}, {KP}, {KB}, {LEADER}
PARAMS = {PARAMS!r}
STEPS = {STEPS!r}
PS_Q8_STEPS = {PS_Q8_STEPS!r}
d = dict(np.load({path_in!r}))
mesh = jax.make_mesh((K,), ("data",),
                     axis_types=(jax.sharding.AxisType.Auto,))
out, wire = {{}}, {{}}


def spmd(label, fn, *args):
    def inner(*a):
        with C.wire_op(label):
            return fn(*[x[0] for x in a])[None]
    C.reset_wire_tally()
    g = jax.jit(jax.shard_map(inner, mesh=mesh,
                              in_specs=tuple(P("data") for _ in args),
                              out_specs=P("data"), axis_names={{"data"}},
                              check_vma=False))
    res = np.asarray(g(*[jnp.asarray(a) for a in args]))
    assert all((res[i] == res[0]).all() for i in range(K)), label
    out[label] = res[0]
    wire[label] = C.wire_report(by_op=True)


ring = make_transport("ring", K, axes=("data",))
packed = make_transport("ring_packed", K, axes=("data",))
plan_v, plan_i = PK.make_plan(N, KP), PK.make_plan(N, KB)
spmd("mean", ring.mean, d["x"])
spmd("sum", ring.sum, d["x"])
spmd("from_leader", lambda x: ring.from_leader(x, LEADER), d["x"])
spmd("sparse_mean", lambda v, i: ring.sparse_mean(v, i, N), d["vals"],
     d["idx"])
spmd("packed_mean", packed.mean, d["x"])
spmd("sparse_gather_packed",
     lambda v, i: packed.sparse_gather_packed(v, i, N, plan=plan_v),
     d["vals"], d["idx"])
spmd("sparse_mean_packed",
     lambda v, i: packed.sparse_mean_packed(v, i, N, plan=plan_v),
     d["vals"], d["idx"])
spmd("broadcast_packed",
     lambda i: packed.broadcast_packed(i, LEADER, N, plan=plan_i), d["sidx"])
q8 = make_transport("ring_q8", K, axes=("data",))
spmd("ring_q8_mean_q8", q8.mean_q8, d["xq"])
spmd("ring_mean_q8", ring.mean_q8, d["xq"])
spmd("ring_allreduce_q8_add",
     lambda x: C.ring_allreduce_q8(x, "data", op="add"), d["xq"])

params = {{k: {{n: jnp.zeros(s) for n, s in v.items()}}
          for k, v in PARAMS.items()}}
ALL = [(m, p, s, "ring_packed", m + "/" + p) for m, p, s in STEPS] + [
    (m, p, s, tk, "/".join((m, p, tk))) for m, p, s, tk in PS_Q8_STEPS]
for method, phase, step, tkind, key in (ALL if K == 2 else []):
    cc = CompressionConfig(method=method, sparsity=0.05, warmup_steps=1,
                           ae_train_steps=1)
    comp = build_compressor(cc, params, K)
    base = comp.init_state(jax.random.PRNGKey(0))
    ae_part = {{k: base[k] for k in ("ae", "ae_mom") if k in base}}

    def inner(u, v, g):
        state = {{"u": u[0], "v": v[0], **ae_part}}
        gg, st, _ = comp.dist_step(state, g[0], step, phase, ("data",),
                                   transport=tkind)
        ae = jax.flatten_util.ravel_pytree(st.get("ae", {{}}))[0]
        return gg[None], st["u"][None], st["v"][None], ae[None]
    C.reset_wire_tally()
    f = jax.jit(jax.shard_map(inner, mesh=mesh,
                              in_specs=(P("data"),) * 3,
                              out_specs=(P("data"),) * 4,
                              axis_names={{"data"}}, check_vma=False))
    gg, u, v, ae = (np.asarray(a) for a in f(d["u"], d["v"], d["g"]))
    out[key + "/g"], out[key + "/u"], out[key + "/v"] = gg[0], u, v
    out[key + "/ae"] = ae[0]
    wire[key] = C.wire_report(by_op=True)
np.savez({path_out!r}, **out)
with open({path_wire!r}, "w") as f:
    json.dump(wire, f)
print("PASS")
"""


def _run_reference(run_py, tmp, K):
    d = _inputs(K)
    paths = {k: str(tmp / f"{k}{K}") for k in ("in", "out", "wire")}
    np.savez(paths["in"], **d)
    code = REF.format(K=K, N=N, KP=KP, KB=KB, LEADER=LEADER, PARAMS=PARAMS,
                      STEPS=STEPS, PS_Q8_STEPS=PS_Q8_STEPS, path_in=paths["in"] + ".npz",
                      path_out=paths["out"] + ".npz",
                      path_wire=paths["wire"])
    assert "PASS" in run_py(code, devices=K)
    with open(paths["wire"]) as f:
        wire = json.load(f)
    return d, dict(np.load(paths["out"] + ".npz")), wire


@pytest.fixture(scope="module")
def reference(subproc, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ref_rings")
    return {K: _run_reference(subproc, tmp, K) for K in (2, 3)}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _equal(ours, ref, what):
    ours = ours.numpy()
    assert ours.shape == ref.shape, (what, ours.shape, ref.shape)
    np.testing.assert_array_equal(_bits(ours), _bits(ref), err_msg=what)


@pytest.mark.parametrize("K", [2, 3])
def test_ring_transports_match_reference(reference, K):
    d, ref, wire = reference[K]
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    ring, packed = RingTransport(K), RingPackedTransport(K)
    plan_v, plan_i = PK.make_plan(N, KP), PK.make_plan(N, KB)
    assert not plan_v.raw_index and not plan_i.raw_index
    calls = {
        "mean": (ring, lambda: ring.mean(t["x"])),
        "sum": (ring, lambda: ring.sum(t["x"])),
        "from_leader": (ring, lambda: ring.from_leader(t["x"], LEADER)),
        "sparse_mean": (ring, lambda: ring.sparse_mean(t["vals"], t["idx"],
                                                       N)),
        "packed_mean": (packed, lambda: packed.mean(t["x"])),
        "sparse_gather_packed": (packed, lambda: packed.sparse_gather_packed(
            t["vals"], t["idx"], N, plan=plan_v)),
        "sparse_mean_packed": (packed, lambda: packed.sparse_mean_packed(
            t["vals"], t["idx"], N, plan=plan_v)),
        "broadcast_packed": (packed, lambda: packed.broadcast_packed(
            t["sidx"], LEADER, N, plan=plan_i)),
    }
    for label, (tr, call) in calls.items():
        with tr.wire_op(label):
            _equal(call(), ref[label], f"K={K} {label}")
        assert tr.tally[label] == wire[label][label], label
    # the packed values pay their one quantization, so they differ from
    # the exact wire's, but only at the indices the exact wire fills
    exact = SimTransport(K).sparse_gather_packed(t["vals"], t["idx"], N)
    got = torch.from_numpy(ref["sparse_gather_packed"])
    assert not torch.equal(got, exact)
    assert not ((got != 0) & (exact == 0)).any()


@pytest.mark.parametrize("K", [2, 3])
def test_int8_ring_matches_reference(reference, K):
    """The int8 ring against the reference's under shard_map: the q8 mean
    and the add, values bitwise and tally bytes equal; and the float
    ring's fake-quantized mean within one ulp of the largest addend per
    addition: XLA fuses some of the reference's dequantizes into the
    ring's adds as FMAs, which ones depending on K and the shapes; the
    port rounds them apart."""
    from repro_torch.dist import collectives as C
    d, ref, wire = reference[K]
    x = torch.from_numpy(d["xq"])
    q8, ring = RingQ8Transport(K), RingTransport(K)
    with q8.wire_op("ring_q8_mean_q8"):
        _equal(q8.mean_q8(x), ref["ring_q8_mean_q8"], f"K={K} mean_q8")
    assert q8.tally["ring_q8_mean_q8"] == wire["ring_q8_mean_q8"][
        "ring_q8_mean_q8"]
    rows = []
    got = C.ring_allreduce_q8(x, lambda kind, b: rows.append((kind, b)),
                              op="add")
    _equal(got, ref["ring_allreduce_q8_add"], f"K={K} ring_allreduce_q8")
    assert dict(rows) == wire["ring_allreduce_q8_add"][
        "ring_allreduce_q8_add"]
    with ring.wire_op("ring_mean_q8"):
        got = ring.mean_q8(x).numpy()
    want = ref["ring_mean_q8"]
    bound = K * np.spacing(np.abs(d["xq"]).max(0))
    assert (np.abs(got - want) <= bound).all()
    assert ring.tally["ring_mean_q8"] == wire["ring_mean_q8"]["ring_mean_q8"]


def test_make_transport_kinds():
    assert type(make_transport("mesh", 2)) is SimTransport
    assert type(make_transport("ring", 2)) is RingTransport
    assert type(make_transport("ring_q8", 2)) is RingQ8Transport
    assert type(make_transport("ring_packed", 2)) is RingPackedTransport
    assert type(make_transport("ring_hier", 2)) is RingHierTransport
    assert make_transport("ring_q8", 2, scale_block=64).scale_block == 64
    chaos = make_transport("chaos:ring", 2, guard="scrub")
    assert type(chaos.base) is RingTransport and chaos.kind == "ring"
    assert chaos.guard == "scrub" and not chaos.spec.active
    with pytest.raises(ValueError):
        make_transport("pigeon", 2)
    with pytest.raises(ValueError):
        make_transport("ring", 2, guard="panic")


@pytest.mark.parametrize("method,phase,step", STEPS)
def test_ring_packed_compressor_step_matches_reference(reference, method,
                                                       phase, step):
    """global gradient, u and v of one step against the reference's
    dist_step on ring_packed at K=2, from nonzero accumulators, and the
    measured per-op rows against both pricers.  Bitwise, except lgc_rar's
    compressed gradient, which is the AE decoder's output: its
    convolutions round differently in XLA and PyTorch (the same bound as
    the trajectory tests, 2e-5 of its largest value)."""
    d, ref, wire = reference[2]
    K = 2
    cc = CompressionConfig(**_cc(method, transport="ring_packed"))
    comp = build_compressor(cc, _params(), K)
    states = comp.init_sim_states(torch.Generator())
    states["u"] = torch.from_numpy(d["u"].copy())
    states["v"] = torch.from_numpy(d["v"].copy())
    if method == "lgc_rar":
        rparams = {k: {n: np.zeros(s, np.float32) for n, s in v.items()}
                   for k, v in PARAMS.items()}
        rcomp = ref_build_compressor(RCC(**_cc(method)), rparams, K)
        rae = rcomp.init_state(jax.random.PRNGKey(0))["ae"]
        states["ae"] = ae_from_numpy(jax.tree_util.tree_map(np.asarray, rae))
    gg, states, stats = comp.sim_step(states, torch.from_numpy(d["g"]), step,
                                      phase)
    key = f"{method}/{phase}"
    if key == "lgc_rar/compressed":
        want = ref[key + "/g"]
        np.testing.assert_allclose(gg.numpy(), want, rtol=0,
                                   atol=2e-5 * np.abs(want).max())
        np.testing.assert_array_equal(gg.numpy() != 0, want != 0)
    else:
        _equal(gg, ref[key + "/g"], key + " global gradient")
    _equal(states["u"], ref[key + "/u"], key + " u")
    _equal(states["v"], ref[key + "/v"], key + " v")
    plan = XP.build_plan(cc, comp.layout, K, phase=phase)
    assert stats["wire"] == XP.wire_terms_by_op(plan, "ring_packed") \
        == wire[key]


@pytest.mark.parametrize("method,phase,step,transport", PS_Q8_STEPS)
def test_ps_q8_compressor_step_matches_reference(reference, method, phase,
                                                 step, transport):
    """One step of lgc_ps (ring_packed: the innovations are a packed
    gather) and lgc_rar_q8 (ring_q8: the encoding mean is the int8 ring)
    against the reference's dist_step at K=2, on the reference's AE: u, v
    and the support bitwise; the gradient bitwise where no decoder ran
    (lgc_ps's top-k + AE phase), else within 2e-5 of its largest value
    (lgc_ps) or the reference's int8-wire bound Q8_TOL (lgc_rar_q8: an
    encoding that rounds the other way moves by one int8 step); the
    trained AE to 1e-5 of its largest leaf value; and the per-op rows
    against both pricers."""
    d, ref, wire = reference[2]
    K = 2
    key = f"{method}/{phase}/{transport}"
    cc = CompressionConfig(**_cc(method, transport=transport))
    comp = build_compressor(cc, _params(), K)
    states = comp.init_sim_states(torch.Generator())
    states["u"] = torch.from_numpy(d["u"].copy())
    states["v"] = torch.from_numpy(d["v"].copy())
    rparams = {k: {n: np.zeros(s, np.float32) for n, s in v.items()}
               for k, v in PARAMS.items()}
    rcomp = ref_build_compressor(RCC(**_cc(method)), rparams, K)
    rae = rcomp.init_state(jax.random.PRNGKey(0))["ae"]
    states["ae"] = ae_from_numpy(jax.tree_util.tree_map(np.asarray, rae))
    gg, states, stats = comp.sim_step(states, torch.from_numpy(d["g"]), step,
                                      phase)
    want = ref[key + "/g"]
    np.testing.assert_array_equal(gg.numpy() != 0, want != 0)
    if phase == "topk_ae":
        _equal(gg, want, key + " global gradient")
    else:
        tol = Q8_TOL if method == "lgc_rar_q8" else \
            2e-5 * np.abs(want).max()
        np.testing.assert_allclose(gg.numpy(), want, rtol=0, atol=tol)
    _equal(states["u"], ref[key + "/u"], key + " u")
    _equal(states["v"], ref[key + "/v"], key + " v")
    ae = torch.cat([a.reshape(-1) for a in
                    jax.tree_util.tree_leaves(states["ae"])]).numpy()
    want_ae = ref[key + "/ae"]
    np.testing.assert_allclose(ae, want_ae, rtol=0,
                               atol=1e-5 * np.abs(want_ae).max())
    plan = XP.build_plan(cc, comp.layout, K, phase=phase)
    assert stats["wire"] == XP.wire_terms_by_op(plan, transport) \
        == wire[key]
