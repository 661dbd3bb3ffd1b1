"""Gradient compressors (paper Section V); counterpart of
``repro.core.compressors``:

  none        baseline, dense all-reduce of the gradient
  sparse_gd   top-k sparsification with plain residual accumulation
  dgc         top-k with DGC momentum correction
  lgc_ps      LGC, parameter-server pattern: warm-up dense, then top-k
              with the K-decoder autoencoder trained online, then the
              leader's common encoding + every node's sparse innovation,
              decoded per node and averaged
  lgc_rar     LGC, ring-allreduce pattern: warm-up dense, then top-k with
              the autoencoder trained online, then encode -> mean -> decode
  lgc_rar_q8  lgc_rar whose encoding mean is int8 (real on ``ring_q8``,
              fake-quantized on the float wires)

Each step compiles its exchanges with ``dist.plan.build_plan`` and runs
them with ``dist.plan.execute`` against a transport, supplying the
per-node compute as feed callbacks, as the reference does.  Under a guard
policy (``cc.guard``) the step's stats carry ``fault/<label>`` and
``guard_ok``; each node clears its u, v only after a clean round, and
``skip_round`` drops a faulty round's gradient.  A fault set in the
config (``cc.fault_*``) wraps the transport in ``chaos:<base>``.  The K nodes'
accumulators ``u``/``v`` are (K, n) tensors updated IN PLACE, node after
node: at llama3.2-1b width each is gigabytes, and sweeping the nodes one
after another keeps only one node's temporaries alive.

One ``step`` serves both layouts.  The global K sets the plan, the
rotating leader (``step % K``), lgc_ps's K decoders and every mean; the
nodes held here (``t.nodes``) set the per-node loops and stacks: all K on
the stacked axis (:meth:`GradientCompressor.sim_step`), this process's
one under a process group (:meth:`GradientCompressor.dist_step`, the
reference's ``dist_step``).

The fused path (``topk_backend="fused"``) runs the CUDA sweep kernel
(``kernels/csrc/sparsify_ef.cu``) on the card, ``topk_backend="pallas"``
the block top-k kernel once per compressed leaf
(``kernels/csrc/block_topk.cu``); the phase-3 encoder with
``ae_backend="pallas"`` runs the fused matmul kernel
(``kernels/csrc/matmul_lrelu.cu``).  On the CPU each takes its plain
PyTorch version.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import CompressionConfig
from repro_torch.core import autoencoder as AE
from repro_torch.core import sparsify as SP
from repro_torch.core.phases import PHASE_TOPK_AE, PHASE_WARMUP
from repro_torch.dist import chaos as CH
from repro_torch.dist import collectives as C
from repro_torch.dist import plan as XP
from repro_torch.dist.transport import make_transport
from repro_torch.kernels import ops as K_ops
from repro_torch.utils import fma_f32
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten


@dataclass(frozen=True)
class GradientCompressor:
    cc: CompressionConfig
    layout: SP.GradientLayout
    K: int                        # number of nodes (data-parallel shards)
    Ks: Tuple[int, ...] = ()      # their dp mesh shape; () = (K,)

    def __post_init__(self):
        cc = self.cc
        if cc.method not in XP.METHODS:
            raise ValueError(f"unknown method {cc.method!r}; known: "
                             f"{XP.METHODS}")
        if cc.topk_backend not in SP.SELECT_BACKENDS:
            raise ValueError(f"unknown topk_backend {cc.topk_backend!r}")
        if cc.ae_backend not in ("jnp", "pallas"):
            raise ValueError(f"unknown ae_backend {cc.ae_backend!r}")
        self._transport()          # raises for an unknown wire or guard

    # -- state ----------------------------------------------------------------

    def init_state(self, gen: torch.Generator, device="cpu"
                   ) -> Dict[str, Any]:
        """One node's state (u, v: (n,) f32) plus, for lgc, the
        autoencoder and its momentum."""
        return self._init((), gen, device)

    def init_sim_states(self, gen: torch.Generator, device="cpu"
                        ) -> Dict[str, Any]:
        """Stacked per-node state (u, v: (K, n) f32) plus, for lgc, the
        shared autoencoder and its momentum."""
        return self._init((self.K,), gen, device)

    def _init(self, lead, gen, device) -> Dict[str, Any]:
        shape = tuple(lead) + (self.layout.n_total,)
        out: Dict[str, Any] = {
            "u": torch.zeros(shape, dtype=torch.float32, device=device),
            "v": torch.zeros(shape, dtype=torch.float32, device=device),
        }
        if self.cc.method.startswith("lgc"):
            ps = self.cc.method == "lgc_ps"
            out["ae"] = AE.init_lgc_autoencoder(
                gen, device, num_decoders=self.K if ps else 1,
                ps_innovation=ps)
            out["ae_mom"] = tree_map(torch.zeros_like, out["ae"])
        return out

    def _transport(self, group=None):
        """``cc.transport``, wrapped in chaos:<base> when the config sets
        a fault, with ``cc.guard``; given a process mesh ``group``, the
        same wire across processes."""
        cc = self.cc
        return make_transport(cc.transport, self.K, cc.q8_scale_block,
                              Ks=self.Ks, wire_buckets=cc.wire_buckets,
                              guard=cc.guard, fault=CH.spec_from_config(cc),
                              group=group, intra_chunk=cc.ring_intra_chunk,
                              inter_chunk=cc.ring_inter_chunk)

    # -- per-node pieces -------------------------------------------------------

    def _encode(self, ae, x):
        if self.cc.ae_backend == "pallas":
            return K_ops.lgc_encode_fast(ae, x)
        return AE.lgc_encode(ae, x)[0]                    # (mu/16, 4)

    @property
    def _use_momentum(self) -> bool:
        # sparse_gd is plain residual accumulation, no momentum correction
        return self.cc.method != "sparse_gd"

    def _accumulate_select(self, u, v, g):
        """Node-local EF accumulate + selection.  Writes u', v' into
        ``u``/``v`` in place; returns (vals, idx, last vals, last idx)."""
        cc, layout = self.cc, self.layout
        if cc.topk_backend == "fused":
            u2, v2, vals, idx, last_vals, last_idx = \
                SP.fused_accumulate_select(
                    g, u, v, layout, cc.momentum_correction,
                    use_momentum=self._use_momentum,
                    extract=cc.extract_backend)
        else:
            if self._use_momentum:
                u2, v2 = SP.momentum_correct(u, v, g,
                                             cc.momentum_correction)
            else:
                u2, v2 = u, v + g
            last_vals, last_idx = SP.select_topk_last(
                v2, layout, backend=cc.topk_backend,
                extract=cc.extract_backend)
            vals, idx = SP.select_topk(v2, layout, backend=cc.topk_backend,
                                       extract=cc.extract_backend)
        if u2 is not u:
            u.copy_(u2)
        v.copy_(v2)
        return vals, idx, last_vals, last_idx

    # -- AE online training (phase 2) ------------------------------------------

    def _ae_update(self, state, g_nodes, inno_nodes, step: int):
        """One SGD step on the AE params (global-norm clip to 1, momentum
        0.9, lr ``ae_lr``), each momentum and parameter update one FMA
        as the reference's is under ``jit``.  g_nodes, inno_nodes: (K,
        mu_pad); the PS loss takes node ``step % K``'s encoding as the
        common representation."""
        cc = self.cc
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(state["ae"])]
        with torch.enable_grad():
            ae = tree_unflatten(state["ae"], leaves)
            if cc.method == "lgc_ps":
                ae_loss, _ = AE.ae_loss_ps(ae, g_nodes, inno_nodes,
                                           step % self.K, cc.lambda_rec,
                                           cc.lambda_sim)
            else:
                ae_loss = AE.ae_loss_rar(ae, g_nodes)
            grads = torch.autograd.grad(ae_loss, leaves)
        gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        scale = torch.clamp(1.0 / torch.clamp(gnorm, min=1e-12), max=1.0)
        mom = [fma_f32(0.9, m, g * scale)
               for m, g in zip(tree_leaves(state["ae_mom"]), grads)]
        ae = [fma_f32(-cc.ae_lr, m, p.detach())
              for p, m in zip(leaves, mom)]
        return (tree_unflatten(state["ae"], ae),
                tree_unflatten(state["ae_mom"], mom), ae_loss.detach())

    # -- the guard's gates -----------------------------------------------------

    @staticmethod
    def _guard_gate(env, stats):
        """The executor's guard counts into the stats, ``fault/<label>``
        and ``guard_ok`` as node 0 holds them (the reference's step stats
        leave its shard_map replicated, as node 0's), 0-d tensors the
        caller reads once the step is done; returns (each node's ok, a
        (K,) bool tensor, and the policy), or None when no guard ran.
        Nothing here waits for the device: the gates act on ``ok`` there."""
        g = env.get("__guard__")
        if g is None:
            return None
        for lbl, bad in g["bad"].items():
            stats[f"fault/{lbl}"] = bad[0]
        stats["guard_ok"] = g["ok"][0].to(torch.int64)
        return g["ok"], g["policy"]

    @staticmethod
    def _gate_round(gate, global_g):
        """skip_round: a round that saw a fault gives the optimizer zeros
        (node 0's round, whose gradient the step returns), in place."""
        if gate is None or gate[1] != "skip_round":
            return global_g
        return global_g.masked_fill_(~gate[0][0], 0.0)

    # ==========================================================================

    @torch.no_grad()
    def step(self, t, state, g, step: int, phase: str):
        """Compress the per-node gradients ``g`` (H, n) of the H nodes
        ``t.nodes`` held here and return (global gradient (n,), new state,
        stats).  ``state["u"]``/``["v"]`` (H, n) are updated in place."""
        cc, layout, n = self.cc, self.layout, self.layout.n_total
        held = len(t.nodes)
        stats: Dict[str, Any] = {}
        plan = XP.build_plan(cc, layout, self.K, transport=t.kind,
                             phase=phase)
        if phase == PHASE_WARMUP or cc.method == "none":
            env = XP.execute(plan, t, {"grad": lambda env: g})
            gate = self._guard_gate(env, stats)
            return self._gate_round(gate, env["grad"]), state, stats

        u, v = state["u"], state["v"]
        sel = [self._accumulate_select(u[k], v[k], g[k])
               for k in range(held)]
        vals, own_idx, last_vals, last_idx = (
            torch.stack([s[i] for s in sel]) for i in range(4))
        del sel
        dense_seg = torch.stack([SP.dense_segments(g[k], layout)
                                 for k in range(held)])
        feeds = {
            "exempt_dense": lambda env: dense_seg,
            "exempt_last": lambda env: (last_vals, last_idx),
        }

        def finish(env, gate, global_g, idx_nodes):
            # (sent + dense) + last, the reference's order of additions;
            # then zero u, v where each node's pairs were sent, on each
            # node whose round was clean (under a guard, a node that saw
            # a fault keeps its accumulators, so what was scrubbed ships
            # again)
            global_g += SP.scatter_dense_segments(env["exempt_dense"],
                                                  layout, n)
            global_g += env["exempt_last"]
            for k in range(held):
                idx_k, last_k = idx_nodes[k], last_idx[k]
                if gate is not None:
                    # a faulty node's indices go to the sentinel n, which
                    # the clear drops
                    idx_k = torch.where(gate[0][k], idx_k, n)
                    last_k = torch.where(gate[0][k], last_k, n)
                SP.clear_sent_merged(u[k], v[k], idx_k, last_k, n)
            return self._gate_round(gate, global_g)

        if cc.method in ("sparse_gd", "dgc"):
            # each node ships its own (vals, idx); each clears its own set
            feeds["topk"] = lambda env: (vals, own_idx)
            env = XP.execute(plan, t, feeds)
            gate = self._guard_gate(env, stats)
            return finish(env, gate, env["topk"], own_idx), dict(state), \
                stats

        # lgc: the rotating leader's sorted index set is every node's
        # support, and every node clears that shared set
        own_idx = torch.sort(own_idx, dim=-1)[0]
        leader = step % self.K

        def vals_of(env):
            # per-node gather at the broadcast support, shared by feeds
            if "_vals" not in env:
                env["_vals"] = torch.stack(
                    [SP.gather_at(v[k], env["support"])
                     for k in range(held)])
            return env["_vals"]

        feeds["support"] = lambda env: (own_idx, leader)
        new_state = dict(state)
        is_ps = cc.method == "lgc_ps"
        frac = SP.innovation_frac(cc.innovation_sparsity, cc.sparsity)

        def inno_of(env):
            # per-node innovation: (in-place vectors, values, local idx)
            if "_inno" not in env:
                x = vals_of(env)
                sel = [SP.select_innovation(x[k], frac)
                       for k in range(held)]
                ii = torch.stack([s[1] for s in sel])
                env["_inno"] = (torch.stack([s[0] for s in sel]),
                                torch.gather(x, 1, ii.long()), ii)
            return env["_inno"]

        if phase == PHASE_TOPK_AE:
            feeds["support_vals"] = vals_of
            feeds["gather_vals"] = vals_of
            if is_ps:
                feeds["gather_inno"] = lambda env: inno_of(env)[0]
            env = XP.execute(plan, t, feeds)
            gate = self._guard_gate(env, stats)
            sent = env["support_vals"]
            ae, ae_mom, ae_loss = self._ae_update(
                state, env["gather_vals"], env.get("gather_inno"), step)
            # the AE is not trained on a round that saw a fault (node 0's,
            # whose AE the step returns)
            if gate is not None:
                ok0 = gate[0][0]
                ae = tree_map(lambda a, b: torch.where(ok0, a, b), ae,
                              state["ae"])
                ae_mom = tree_map(lambda a, b: torch.where(ok0, a, b),
                                  ae_mom, state["ae_mom"])
            new_state.update(ae=ae, ae_mom=ae_mom)
            stats["ae_loss"] = ae_loss
        elif is_ps:
            # the leader ships E_c(g~) and every node its innovation; the
            # decoders reconstruct each node and the K reconstructions are
            # averaged (eq. 12-13).  Every node receives the same leader
            # encoding, so the emulation encodes only the leader's row;
            # under a process group each node encodes its own, as the SPMD
            # reference does, and the broadcast keeps the leader's.
            row = t.nodes.index(leader) if leader in t.nodes else 0

            def z_common(env):
                z = self._encode(state["ae"], vals_of(env)[row])
                return z[None].expand((held,) + tuple(z.shape)), leader
            feeds["z_common"] = z_common
            feeds["innovations"] = lambda env: inno_of(env)[1:]
            env = XP.execute(plan, t, feeds)
            gate = self._guard_gate(env, stats)
            recs = AE.lgc_decode_ps(state["ae"], env["z_common"],
                                    env["innovations"])    # (K, mu_pad)
            sent = C.node_mean(recs)
        else:
            # lgc_rar_q8's encoding mean is the plan's q8 Reduce
            feeds["encoding"] = lambda env: torch.stack(
                [self._encode(state["ae"], x) for x in vals_of(env)])
            env = XP.execute(plan, t, feeds)
            gate = self._guard_gate(env, stats)
            sent = AE.lgc_decode_rar(state["ae"], env["encoding"][None])[0]
        idx = env["support"]
        global_g = finish(env, gate, SP.scatter_to_dense(sent, idx, n),
                          [idx] * held)
        return global_g, new_state, stats

    def sim_step(self, states, g_nodes, step: int, phase: str):
        """Single-device emulation of K nodes on stacked (K, n) gradients,
        over the emulated transport ``cc.transport`` names.  Returns
        (global_g (n,), states, stats); ``stats["wire"]`` holds the step's
        bytes per node, {op label: {collective kind: bytes}}."""
        t = self._transport()
        global_g, states, stats = self.step(t, states, g_nodes, step, phase)
        stats["wire"] = t.tally
        return global_g, states, stats

    def dist_step(self, state, g, step: int, phase: str, group):
        """One node per process (the reference's ``dist_step``): this
        process's flat gradient ``g`` (n,) and its state (u, v: (n,),
        updated in place; the AE replicated) over ``cc.transport`` across
        the process mesh ``group`` (``dist.p2p.ProcessMesh``, node
        ``group.node`` of K).  Returns (global gradient (n,), state,
        stats); ``stats["wire"]`` holds the nodes' mean of the bytes each
        sent, the emulated per-node rows, ``stats["wire_sent"]`` this
        process's own and ``stats["wire_messages"]`` its message count per
        op.  Every process of the mesh calls it in the same step."""
        t = self._transport(group)
        local = {**state, "u": state["u"][None], "v": state["v"][None]}
        global_g, new_state, stats = self.step(t, local, g[None], step,
                                               phase)
        new_state = {**new_state, "u": state["u"], "v": state["v"]}
        stats.update(wire=t.node_tally(), wire_sent=t.tally,
                     wire_messages=t.messages)
        return global_g, new_state, stats


def build_compressor(cc: CompressionConfig, params_template, K: int,
                     Ks: Tuple[int, ...] = ()) -> GradientCompressor:
    layout = SP.build_layout(params_template, cc.sparsity)
    return GradientCompressor(cc=cc, layout=layout, K=K, Ks=tuple(Ks))
