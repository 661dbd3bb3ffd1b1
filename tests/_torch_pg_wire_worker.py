"""One rank of tests/test_torch_pg_transports.py: every wire op and every
method's ``dist_step`` of the cases below on this rank's node, across
the gloo processes of the launch (4: the flat and the pod mesh; 2: the
mesh wire at K = 2), written to OUT/rank<r>.pt for the test to hold
against the emulated transports.

    RANK=r WORLD_SIZE=4 python tests/_torch_pg_wire_worker.py \
        INPUTS.npz OUT_DIR file:///STORE
"""
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import CompressionConfig
from repro_torch.core.compressors import build_compressor
from repro_torch.dist import packed as PK
from repro_torch.dist.p2p import ProcessMesh
from repro_torch.dist.transport import make_transport
from repro_torch.utils.tree import tree_leaves

N, KP, KB, LEADER = 1000, 50, 48, 1
PARAMS = {"embed": {"w": (32, 16)}, "layer1": {"w": (64, 64), "b": (64,)},
          "layer2": {"w": (64, 64)}, "lm_head": {"w": (16, 32)}}
# the process meshes: over 4 ranks the flat ring and 2 pods x 2; over 2
# the mesh wire at K = 2
MESHES = {"flat": (4,), "pods": (2, 2), "pair": (2,)}
LAUNCHES = {4: ("flat", "pods"), 2: ("pair",)}
RING_WIRES = ("ring", "ring_q8", "ring_hier", "ring_packed")
BUCKETS = (1, 3)
CAP = 7                 # ring_hier's intra and inter message cap
OPS = ("mean", "sum", "from_leader", "all_gather", "mean_q8", "sparse_mean",
       "broadcast_packed", "sparse_gather_packed", "sparse_mean_packed")
MESH_OPS = tuple(op for op in OPS if op != "sum")
# (method, phase) of the dist_step cases, at step 3 (leader 3 mod K)
STEPS = (("none", "warmup"), ("sparse_gd", "topk_ae"), ("dgc", "topk_ae"),
         ("lgc_ps", "topk_ae"), ("lgc_ps", "compressed"),
         ("lgc_rar", "topk_ae"), ("lgc_rar", "compressed"),
         ("lgc_rar_q8", "compressed"))
STEP = 3
# (mesh, wire, buckets, cap) of the dist_step cases
STEP_WIRES = (("flat", "ring", 1, 0), ("flat", "ring_q8", 3, 0),
              ("pods", "ring_packed", 3, 0), ("pods", "ring_hier", 3, CAP),
              ("pair", "mesh", 1, 0))


def params():
    return {k: {n: torch.zeros(s) for n, s in d.items()}
            for k, d in PARAMS.items()}


def cc(method, transport, buckets, cap):
    return CompressionConfig(method=method, sparsity=0.05, warmup_steps=1,
                             ae_train_steps=1, transport=transport,
                             wire_buckets=buckets, ring_intra_chunk=cap,
                             ring_inter_chunk=cap)


def call(t, op, d, plans):
    """One wire op on ``d``'s rows (the nodes the transport holds)."""
    x = d["x"]
    if op == "mean":
        return t.mean(x)
    if op == "sum":
        return t.sum(x)
    if op == "from_leader":
        return t.from_leader(x, LEADER)
    if op == "all_gather":
        return t.all_gather(x)
    if op == "mean_q8":
        return t.mean_q8(d["xq"])
    if op == "sparse_mean":
        return t.sparse_mean(d["vals"], d["idx"], N)
    if op == "broadcast_packed":
        return t.broadcast_packed(d["sidx"], LEADER, N, plan=plans[1])
    if op == "sparse_gather_packed":
        return t.sparse_gather_packed(d["vals"], d["idx"], N, plan=plans[0])
    return t.sparse_mean_packed(d["vals"], d["idx"], N, plan=plans[0])


def wire_cases(meshes, d):
    """{key: (result, own rows, node-mean rows, messages)} of every wire
    op: the ring wires on the flat and pod meshes at each bucket count,
    with and without the cap; the mesh wire on the pair and the flat
    mesh."""
    plans = (PK.make_plan(N, KP), PK.make_plan(N, KB))
    out = {}
    cases = [(m, w, B, cap) for m in ("flat", "pods") for w in RING_WIRES
             for B in BUCKETS for cap in (0, CAP)]
    cases += [("pair", "mesh", 1, 0), ("flat", "mesh", 1, 0)]
    for m, w, B, cap in cases:
        if m not in meshes:
            continue
        pm = meshes[m]
        rows = {k: v[pm.node:pm.node + 1] for k, v in d.items()}
        for op in (MESH_OPS if w == "mesh" else OPS):
            t = make_transport(w, pm.K, Ks=pm.Ks, wire_buckets=B,
                               group=pm, intra_chunk=cap, inter_chunk=cap)
            with t.wire_op(op):
                res = call(t, op, rows, plans)
            out[f"{m}/{w}/B{B}/cap{cap}/{op}"] = (
                res, t.tally, t.node_tally(), t.messages)
    return out


def step_cases(meshes, d):
    """{key: (global gradient, u, v, AE leaves, stats)} of every
    method's dist_step on each of STEP_WIRES."""
    out = {}
    for m, w, B, cap in STEP_WIRES:
        if m not in meshes:
            continue
        pm = meshes[m]
        for method, phase in STEPS:
            comp = build_compressor(cc(method, w, B, cap), params(), pm.K,
                                    pm.Ks)
            state = comp.init_state(torch.Generator().manual_seed(0))
            state["u"] = d["u"][pm.node].clone()
            state["v"] = d["v"][pm.node].clone()
            gg, st, stats = comp.dist_step(state, d["g"][pm.node].clone(),
                                           STEP, phase, pm)
            ae = [a.clone() for a in tree_leaves(st.get("ae", {}))]
            out[f"{m}/{w}/{method}/{phase}"] = (
                gg, st["u"], st["v"], ae,
                {k: stats[k] for k in ("wire", "wire_sent",
                                       "wire_messages")})
    return out


def main(path_in, out_dir, store):
    torch.set_num_threads(1)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dist.init_process_group("gloo", init_method=store, rank=rank,
                            world_size=world)
    meshes = {name: ProcessMesh(MESHES[name], "cpu")
              for name in LAUNCHES[world]}
    d = {k: torch.from_numpy(v) for k, v in np.load(path_in).items()}
    res = {"wire": wire_cases(meshes, d), "step": step_cases(meshes, d)}
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()
    print("PASS")


if __name__ == "__main__":
    main(*sys.argv[1:4])
