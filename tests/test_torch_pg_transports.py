"""The wires across processes (``dist.p2p``, ``make_transport(...,
group=)``) against the emulated transports on the stacked inputs of
tests/test_torch_transports.py: four gloo ranks, then two, each launch
once for the module (tests/_torch_pg_wire_worker.py), each rank holding
one node.

- Every op (mean, sum, from_leader, all_gather, mean_q8, sparse_mean,
  broadcast_packed, sparse_gather_packed, sparse_mean_packed) on ring,
  ring_q8, ring_hier and ring_packed, over 4 nodes on one ring and on
  2 pods x 2, at B = 1 and 3, with ring_hier's message cap and without:
  the result on every rank bitwise the emulated one; the nodes' mean of
  the bytes each rank handed to its sends equal to the emulated per-node
  row (each rank's own equal to it, a broadcast's summing to K times
  it); the cap leaves values and bytes alone and makes ceil(chunk / cap)
  messages of a hop.
- The mesh wire (the library's all_reduce, all_gather, broadcast):
  bitwise at K = 2; at K = 4 within K·eps·Σ_k|x_k| elementwise, as the
  library's all_reduce adds in its own order (and mean_q8 sums each
  node's rounded dequantize, where the emulation fuses it into the add
  as one FMA: within that bound at K = 2 too).
- ``dist_step`` of all six methods (each sparsified phase; none's
  warm-up) on ring, ring_q8 (B 3), ring_packed (pods, B 3), ring_hier
  (pods, B 3, capped) and mesh (K = 2): the global gradient, each node's
  u and v and the AE bitwise the emulated ``sim_step``'s, the per-op rows
  equal to its rows and to ``dist.plan.wire_terms_by_op``.  One
  exception, the mesh's mean_q8 above: lgc_rar_q8's compressed gradient
  on mesh is the decoder's output of an encoding mean an ulp apart, so
  it is held to 2e-5 of its largest value (the trajectory bound) on the
  same support; u, v and the AE stay bitwise."""
import numpy as np
import pytest
import torch

import _torch_pg_wire_worker as W
from _one_thread import one_thread  # noqa: F401  (autouse)
from _torch_pg import launch, worker
from repro_torch.configs.base import CompressionConfig
from repro_torch.core.compressors import build_compressor
from repro_torch.dist import packed as PK
from repro_torch.dist import plan as XP
from repro_torch.dist.collectives import bucket_widths
from repro_torch.dist.transport import make_transport
from repro_torch.utils.tree import tree_leaves
from test_torch_transports import KB, KP, LEADER, N, _inputs

K = 4
BROADCASTS = ("from_leader", "broadcast_packed")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four ranks' results, and the inputs they were given."""
    assert (W.N, W.KP, W.KB, W.LEADER) == (N, KP, KB, LEADER)
    tmp = tmp_path_factory.mktemp("pg_wires")
    d = _inputs(K)
    n = build_compressor(CompressionConfig(method="dgc", sparsity=0.05),
                         W.params(), K).layout.n_total
    r = np.random.default_rng(44)
    for key in ("u", "v", "g"):
        d[key] = (r.standard_normal((K, n)) * 0.01).astype(np.float32)
    np.savez(tmp / "in.npz", **d)
    res = {}
    for world, meshes in W.LAUNCHES.items():
        out = tmp / f"world{world}"
        out.mkdir()
        logs = launch(out, worker("_torch_pg_wire_worker.py") + [
            str(tmp / "in.npz"), str(out), "{store}"], world, timeout=150)
        assert all("PASS" in log for log in logs)
        ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
                 for r in range(world)]
        res.update({m: ranks for m in meshes})
    return {k: torch.from_numpy(v) for k, v in d.items()}, res


def _bits(t):
    t = t.detach()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same(a, b, what):
    assert a.shape == b.shape and a.dtype == b.dtype, (what, a.shape,
                                                       b.shape)
    assert torch.equal(_bits(a), _bits(b)), what


def _mesh_shape(mesh):
    return W.MESHES[mesh]


def _emulated(mesh, wire, B, op, d):
    """The emulated transport's result and tally for one op on the mesh's
    stacked node rows."""
    Ks = _mesh_shape(mesh)
    nodes = int(np.prod(Ks))
    t = make_transport(wire, nodes, Ks=Ks, wire_buckets=B)
    rows = {k: v[:nodes] for k, v in d.items()}
    with t.wire_op(op):
        res = W.call(t, op, rows, (PK.make_plan(N, KP), PK.make_plan(N, KB)))
    return res, t.tally


def _hier_messages(op, n, Ks, B, cap):
    """ring_hier's messages a node sends for a mean or sum of n values,
    per row: each hop's chunk in ceil(chunk / cap) pieces."""
    def pieces(w):
        return -(-w // cap) if cap else 1
    c = -(-n // Ks[-1])
    if len(Ks) == 1:
        Bc, cb = bucket_widths(c, B)
        per = 2 * (Ks[0] - 1) * pieces(cb)
    else:
        Ka, K1 = Ks
        ca = -(-c // Ka)
        Bc, cab = bucket_widths(ca, B)
        per = 2 * (K1 - 1) * pieces(c) + 2 * (Ka - 1) * pieces(ca) \
            if Bc == 1 else \
            2 * (K1 - 1) * pieces(Ka * cab) + 2 * (Ka - 1) * pieces(cab)
    if Bc == 1:
        return {op: per}
    return {f"{op}#b{b}": per for b in range(Bc)}


@pytest.mark.parametrize("mesh", ["flat", "pods"])
@pytest.mark.parametrize("wire", W.RING_WIRES)
def test_ring_wire_ops_match_emulated(ranks, mesh, wire):
    d, res = ranks
    for B in W.BUCKETS:
        for op in W.OPS:
            want, tally = _emulated(mesh, wire, B, op, d)
            for cap in (0, W.CAP):
                key = f"{mesh}/{wire}/B{B}/cap{cap}/{op}"
                owns = []
                for r in range(K):
                    got, own, mean_rows, msgs = res[mesh][r]["wire"][key]
                    _same(got, want, f"rank {r} {key}")
                    assert mean_rows == tally, (key, mean_rows, tally)
                    owns.append(own)
                    if op not in BROADCASTS:
                        assert own == tally, (key, r, own, tally)
                    if wire == "ring_hier" and op in ("mean", "sum"):
                        assert msgs == _hier_messages(
                            op, d["x"][0].numel(), _mesh_shape(mesh), B,
                            cap), (key, msgs)
                # a broadcast's forwarders send, its last node does not
                for label, row in tally.items():
                    for kind, b in row.items():
                        assert sum(o.get(label, {}).get(kind, 0.0)
                                   for o in owns) == K * b, (key, label)


def test_mesh_wire_ops(ranks):
    d, res = ranks
    eps = np.finfo(np.float32).eps
    for mesh in ("pair", "flat"):
        nodes = int(np.prod(_mesh_shape(mesh)))
        for op in W.MESH_OPS:
            want, tally = _emulated(mesh, "mesh", 1, op, d)
            key = f"{mesh}/mesh/B1/cap0/{op}"
            exact = op not in ("mean", "mean_q8") or (
                nodes == 2 and op == "mean")
            for r in range(nodes):
                got, own, mean_rows, _ = res[mesh][r]["wire"][key]
                assert own == mean_rows == tally, (key, own, tally)
                if exact:
                    _same(got, want, f"rank {r} {key}")
                    continue
                # the sum within K·eps·Σ_k|x_k|, so the mean within
                # eps·Σ_k|x_k|
                x = d["xq" if op == "mean_q8" else "x"][:nodes]
                bound = eps * x.abs().sum(0)
                assert ((got - want).abs() <= bound).all(), (key, r)


@pytest.mark.parametrize("mesh,wire,B,cap", W.STEP_WIRES)
def test_dist_step_matches_sim_step(ranks, mesh, wire, B, cap):
    d, res = ranks
    Ks = _mesh_shape(mesh)
    nodes = int(np.prod(Ks))
    for method, phase in W.STEPS:
        cc = W.cc(method, wire, B, cap)
        comp = build_compressor(cc, W.params(), nodes, Ks)
        states = comp.init_sim_states(torch.Generator().manual_seed(0))
        states["u"] = d["u"][:nodes].clone()
        states["v"] = d["v"][:nodes].clone()
        gg, st, stats = comp.sim_step(states, d["g"][:nodes].clone(),
                                      W.STEP, phase)
        plan = XP.build_plan(cc, comp.layout, nodes, phase=phase)
        priced = XP.wire_terms_by_op(plan, axis_sizes=Ks)
        assert stats["wire"] == priced, (method, phase)
        key = f"{mesh}/{wire}/{method}/{phase}"
        for r in range(nodes):
            got, u, v, ae, pstats = res[mesh][r]["step"][key]
            what = f"rank {r} {key}"
            if wire == "mesh" and method == "lgc_rar_q8":
                assert torch.equal(got != 0, gg != 0), what
                tol = 2e-5 * gg.abs().max()
                assert ((got - gg).abs() <= tol).all(), what
            else:
                _same(got, gg, what + " global gradient")
            _same(u, st["u"][r], what + " u")
            _same(v, st["v"][r], what + " v")
            for a, b in zip(ae, tree_leaves(st.get("ae", {}))):
                _same(a, b, what + " ae")
            assert pstats["wire"] == priced, (what, pstats["wire"])
