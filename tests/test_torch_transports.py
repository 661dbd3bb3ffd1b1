"""The emulated ring transports against the reference's shard_map rings,
bitwise: ``RingTransport`` (mean, sum, from_leader, the exact sparse
mean) and ``RingPackedTransport`` (the packed sparse gather and mean, the
packed index broadcast) at K = 2 and 3, results and per-op tallies; and
one ``GradientCompressor`` step of dgc, sparse_gd and lgc_rar (both
sparsified phases) on ``ring_packed`` at K = 2 against the reference's
``dist_step``.  The reference runs once per K in a subprocess with K host
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
from repro_torch.dist.transport import (RingPackedTransport, RingTransport,
                                        SimTransport, make_transport)
from repro_torch.utils.convert import ae_from_numpy

N, KP, KB, LEADER = 1000, 50, 48, 1
PARAMS = {"embed": {"w": (32, 16)}, "layer1": {"w": (64, 64), "b": (64,)},
          "layer2": {"w": (64, 64)}, "lm_head": {"w": (16, 32)}}
# the compressor steps: (method, phase, step); step 3 makes node 1 the
# lgc leader
STEPS = [("dgc", "topk_ae", 3), ("sparse_gd", "topk_ae", 3),
         ("lgc_rar", "topk_ae", 3), ("lgc_rar", "compressed", 3)]


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
           "idx": idx.astype(np.int32), "sidx": sidx.astype(np.int32)}
    if K == 2:
        layout = build_compressor(CompressionConfig(**_cc("dgc")), _params(),
                                  K).layout
        # u starts at 0, so m·u + g is exact: XLA's CPU backend contracts
        # it into one FMA, which the port does not (ROADMAP.md Queue 3;
        # the trajectory tests hold that difference to its tolerance)
        out["u"] = np.zeros((K, layout.n_total), np.float32)
        for key in ("v", "g"):
            out[key] = (r.standard_normal((K, layout.n_total)) * 0.01
                        ).astype(np.float32)
    return out


def _params():
    return {k: {n: torch.zeros(s) for n, s in d.items()}
            for k, d in PARAMS.items()}


REF = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.configs.base import CompressionConfig
from repro.core import build_compressor
from repro.dist import collectives as C
from repro.dist import packed as PK
from repro.dist.transport import make_transport

K, N, KP, KB, LEADER = {K}, {N}, {KP}, {KB}, {LEADER}
PARAMS = {PARAMS!r}
STEPS = {STEPS!r}
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

params = {{k: {{n: jnp.zeros(s) for n, s in v.items()}}
          for k, v in PARAMS.items()}}
for method, phase, step in (STEPS if K == 2 else []):
    cc = CompressionConfig(method=method, sparsity=0.05, warmup_steps=1,
                           ae_train_steps=1)
    comp = build_compressor(cc, params, K)
    base = comp.init_state(jax.random.PRNGKey(0))
    ae_part = {{k: base[k] for k in ("ae", "ae_mom") if k in base}}

    def inner(u, v, g):
        state = {{"u": u[0], "v": v[0], **ae_part}}
        gg, st, _ = comp.dist_step(state, g[0], step, phase, ("data",),
                                   transport="ring_packed")
        return gg[None], st["u"][None], st["v"][None]
    C.reset_wire_tally()
    f = jax.jit(jax.shard_map(inner, mesh=mesh,
                              in_specs=(P("data"),) * 3,
                              out_specs=(P("data"),) * 3,
                              axis_names={{"data"}}, check_vma=False))
    gg, u, v = (np.asarray(a) for a in f(d["u"], d["v"], d["g"]))
    key = method + "/" + phase
    out[key + "/g"], out[key + "/u"], out[key + "/v"] = gg[0], u, v
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
                      STEPS=STEPS, path_in=paths["in"] + ".npz",
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


def test_make_transport_kinds():
    assert type(make_transport("mesh", 2)) is SimTransport
    assert type(make_transport("ring", 2)) is RingTransport
    assert type(make_transport("ring_packed", 2)) is RingPackedTransport
    for kind in ("ring_q8", "ring_hier", "chaos:ring"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            make_transport(kind, 2)
    with pytest.raises(ValueError):
        make_transport("pigeon", 2)


@pytest.mark.parametrize("method,phase,step", STEPS)
def test_ring_packed_compressor_step_matches_reference(reference, method,
                                                       phase, step):
    """global gradient, u and v of one step against the reference's
    dist_step on ring_packed at K=2, and the measured per-op rows against
    both pricers.  Bitwise, except lgc_rar's compressed gradient, which
    is the AE decoder's output: its convolutions round differently in
    XLA and PyTorch (the same bound as the trajectory tests, 2e-5 of its
    largest value)."""
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
