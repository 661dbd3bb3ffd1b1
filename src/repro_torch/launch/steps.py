"""The LGC training step (counterpart of
``repro.launch.steps.make_lgc_train_step``), with the K nodes emulated on
one device or one node per process.

Emulated, per step: K per-node gradients (the reference vmaps over the
node axis; here a loop over nodes), flattened into a (K, n) f32 buffer in
the reference's leaf order, ``GradientCompressor.sim_step``, unflatten,
the optimizer.  Under a process mesh (``mesh``), process r is node r: it
takes batch rows [r·B/K, (r+1)·B/K), as ``node_grads`` gives node r, and
runs its gradient, ``GradientCompressor.dist_step`` and the optimizer on
its own replica; the logged metrics are the node mean of every node's,
gathered, in the emulated order, so its loss is the emulated run's bit
for bit.  No gradient all-reduce happens anywhere else: the compressor's
exchange is the whole cross-node traffic.

:func:`sim_sgd_step` is the same step for any loss, with plain SGD: the
reference's own single-host ConvNet5 loop (``tests/test_system.py``'s
``test_convnet5_paper_model_trains``), which has no trainer entry point.

With model shards (a ``launch.mesh.ProcessGrid`` whose ``model`` axis
is > 1) each process holds its model shard of the params and its node's
block of the gradient goes through the compressor over its shard's dp
column (``make_lgc_train_step(..., grid=)``).  The reference's other
builders run one process a device of the grid, on explicit collectives
(``dist.tp``): ``make_auto_train_step`` (TP over ``model``, FSDP over
``data``, DP over ``pod``), ``make_prefill_step`` and
``make_decode_step``.

The placement rules of the reference's step builders (``batch_pspecs``,
``auto_train_pspecs``, ``lgc_state_specs``, ``serve_pspecs``,
``serve_cache_pspecs``, ``decode_token_pspec``) are pure functions of
the model and a ``launch.mesh.MeshSpec``, at the end of this module;
``train_state_specs`` places a whole train state by them, key by key as
the trainer's checkpoint holds it.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import (CompressionConfig, InputShape,
                                      TrainConfig)
from repro_torch.core.compressors import GradientCompressor, build_compressor
from repro_torch.core.phases import phase_for_step
from repro_torch.dist import sharding as SH
from repro_torch.dist.p2p import ProcessMesh
from repro_torch.dist.tp import Shards
from repro_torch.launch.input_specs import params_specs
from repro_torch.launch.mesh import (MeshSpec, dp_axes_of, dp_size_of,
                                     model_size_of)
from repro_torch.models.model import Model
from repro_torch.optim.optimizers import (Optimizer, build_optimizer,
                                          sum_of_squares)
from repro_torch.utils.tree import (keystr_path, tree_leaves,
                                    tree_leaves_with_path, tree_map,
                                    tree_size_bytes, tree_unflatten,
                                    tree_unflatten_vector)


@dataclass
class LGCTrainStep:
    model: Model
    compressor: GradientCompressor
    optimizer: Optimizer
    device: torch.device
    mesh: Optional[ProcessMesh] = None     # one node per process
    # tensor parallelism: the model group and this shard's coordinates;
    # ``specs`` the params' {path: spec} over ``model``
    grid: Any = None
    specs: Optional[Dict[str, tuple]] = None

    @property
    def K(self) -> int:
        return self.compressor.K

    def init(self, gen: torch.Generator):
        """Params, optimizer state and the compressor's: the K nodes' (K,
        n) accumulators, or under a process mesh this node's (n,).  Every
        process draws the same params and AE from the same seed."""
        params = self.model.init(gen, self.device)
        if self.specs is not None:
            params = shard_params(params, self.specs, self.grid)
        opt_state = self.optimizer.init(params)
        comp_state = self.compressor.init_sim_states(gen, self.device) \
            if self.mesh is None else \
            self.compressor.init_state(gen, self.device)
        return params, opt_state, comp_state

    def node_grads(self, params, batch: Dict[str, torch.Tensor]):
        """(K, n) f32 per-node gradients and the node-mean metrics."""
        return node_grads(self.model.loss, params, batch, self.K,
                          self.compressor.layout.n_total)

    @torch.no_grad()
    def step(self, params, opt_state, comp_state, batch, step: int,
             phase: str):
        if self.mesh is None:
            g_nodes, metrics = self.node_grads(params, batch)
            g_global, comp_state, stats = self.compressor.sim_step(
                comp_state, g_nodes, step, phase)
        else:
            g_nodes, per_node = grads_of_nodes(
                self.model.loss, params, batch, self.K,
                self.compressor.layout.n_total, (self.mesh.node,))
            # every node's metrics, back on this device: the mean is then
            # computed as the emulated run computes it
            metrics = mean_metrics([
                {k: v.to(self.device) for k, v in m.items()}
                for m in self.mesh.gather_objects(
                    {k: v.cpu() for k, v in per_node[0].items()})], self.K)
            g_global, comp_state, stats = self.compressor.dist_step(
                comp_state, g_nodes[0], step, phase, self.mesh,
                None if self.grid is None else self.grid.model)
        del g_nodes
        grads = tree_unflatten_vector(g_global, params)
        del g_global
        params, opt_state = self.optimizer.update(grads, opt_state, params,
                                                  step)
        metrics.update(stats)
        return params, opt_state, comp_state, metrics


def node_grads(loss_fn: Callable, params, batch: Dict[str, torch.Tensor],
               K: int, n: int):
    """(K, n) f32 per-node gradients of ``loss_fn(params, shard) -> (loss,
    metrics)`` and the node-mean metrics.  Every entry of the batch
    splits by its rows into K equal node shards, in order (node k takes
    rows [k·B/K, (k+1)·B/K)), as the reference's per-node slices do."""
    out, per_node = grads_of_nodes(loss_fn, params, batch, K, n, range(K))
    return out, mean_metrics(per_node, K)


def grads_of_nodes(loss_fn: Callable, params,
                   batch: Dict[str, torch.Tensor], K: int, n: int,
                   nodes: Sequence[int]):
    """(len(nodes), n) f32 gradients of the given nodes' batch shards (of
    K), and each one's metrics."""
    rows = {x.shape[0] for x in batch.values()}
    if len(rows) != 1:
        raise ValueError(f"batch entries differ in rows: {rows}")
    B = rows.pop()
    if B % K:
        raise ValueError(f"batch {B} is not divisible by {K} nodes")
    out = torch.empty((len(nodes), n), dtype=torch.float32,
                      device=tree_leaves(params)[0].device)
    per_node: List[Dict[str, Any]] = []
    for j, k in enumerate(nodes):
        shard = {key: x[k * B // K:(k + 1) * B // K]
                 for key, x in batch.items()}
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        with torch.enable_grad():
            loss, m = loss_fn(tree_unflatten(params, leaves), shard)
            grads = torch.autograd.grad(loss, leaves)
        off = 0
        for gl in grads:
            out[j, off:off + gl.numel()].copy_(gl.reshape(-1))
            off += gl.numel()
        del grads
        per_node.append({key: val.detach() for key, val in m.items()})
    return out, per_node


def mean_metrics(per_node: Sequence[Dict[str, Any]], K: int
                 ) -> Dict[str, Any]:
    """The node mean of K nodes' metrics, in node order: 0 + m_0/K +
    m_1/K + ..., the order every run of the port logs."""
    metrics: Dict[str, Any] = {}
    for m in per_node:
        for key, val in m.items():
            metrics[key] = metrics.get(key, 0.0) + val / K
    return metrics


@torch.no_grad()
def sim_sgd_step(loss_fn: Callable, compressor: GradientCompressor, params,
                 states, batch: Dict[str, torch.Tensor], step: int,
                 lr: float):
    """One step of the reference's single-host loop: per-node loss and
    gradients, the flat (K, n) buffer, ``compressor.sim_step`` at
    ``phase_for_step(step)``, then plain ``p - lr·g``.  Returns (params,
    states, g, metrics): the global gradient g (n,) and the node-mean
    metrics of ``loss_fn`` with the compressor's stats (``wire`` among
    them) and ``phase``."""
    phase = phase_for_step(step, compressor.cc)
    g_nodes, metrics = node_grads(loss_fn, params, batch, compressor.K,
                                  compressor.layout.n_total)
    g, states, stats = compressor.sim_step(states, g_nodes, step, phase)
    del g_nodes
    params = tree_map(lambda p, gl: p - lr * gl, params,
                      tree_unflatten_vector(g, params))
    return params, states, g, {**metrics, **stats, "phase": phase}


def make_lgc_train_step(model: Model, tc: TrainConfig, K: int,
                        device: torch.device, Ks: Tuple[int, ...] = (),
                        mesh: Optional[ProcessMesh] = None, grid=None
                        ) -> LGCTrainStep:
    """``Ks``: the K nodes' dp mesh shape, (K_pod, K_data) for a pod
    axis; node ia·K_data + i1 takes batch shard ia·K_data + i1, the
    reference's order over ("pod", "data").  ``mesh``: one node per
    process over that mesh (``launch.mesh.init_process_mesh``).

    ``grid`` (a ``launch.mesh.ProcessGrid`` with model shards): the
    reference's step with a model axis.  Each process holds its model
    shard of the params (``lgc_state_specs``: replicated over dp), runs
    the forward and backward with tensor parallelism over the model
    group, and compresses its local flat gradient (the per-model-shard
    layout, ``n_local``) over its model shard's dp column, the shared
    AE's gradients averaged over the model group.  A leaf the spec does
    not split (a norm scale) is compressed by every model shard, as in
    the reference, which keeps each shard's copy."""
    if mesh is not None and (mesh.K, mesh.Ks) != (K, tuple(Ks or (K,))):
        raise ValueError(f"process mesh {mesh.Ks} is not the dp mesh "
                         f"{tuple(Ks or (K,))}")
    if grid is None or model_size_of(grid.spec) == 1:
        template = model.init(torch.Generator(), "meta")
        return LGCTrainStep(model,
                            build_compressor(tc.compression, template, K, Ks),
                            build_optimizer(tc), device, mesh)
    st = lgc_state_specs(model, tc.compression, grid.spec)
    tp = Shards(model=grid.model, specs=st.params)
    # the decoded global gradient is the same on every node: its norm
    # sums the blocks over ``model`` alone
    squares = sum_of_squares(st.params, {"model": grid.model})
    return LGCTrainStep(replace(model, tp=tp),
                        build_compressor(tc.compression, st.template, K, Ks),
                        build_optimizer(tc, squares=squares), device, mesh,
                        grid, st.params)


def shard_params(full, specs: Dict[str, tuple], grid):
    """This process's block of every leaf of ``full`` under ``specs``
    (``dist.sharding.shard_tree``), each its own copy, so the whole tree
    can be freed."""
    return tree_map(lambda t: t.clone(), SH.shard_tree(
        full, specs, grid.coords, grid.spec.axis_sizes))


def init_held(model: Model, seed: int, device, specs: Dict[str, tuple],
              grid):
    """This process's block of ``model.init`` from a generator seeded with
    ``seed`` on ``device``, the launch's processes drawing one after
    another (a barrier over the world between turns), each replacing
    every whole leaf by its block as each part of the model is drawn
    (``Model.init``'s ``place``): a card that the processes share holds
    their blocks and one whole part at a time, not one whole model a
    process (deepseek-v3's one layer of 256 experts and its MTP block,
    each 23 GB in bf16)."""
    import torch.distributed as dist

    def cut(tree, prefix):
        for key in list(tree):
            if isinstance(tree[key], dict):
                cut(tree[key], f"{prefix}{key}/")
            else:
                whole, tree[key] = tree[key], None
                tree[key] = SH.block_of(whole, specs[prefix + key],
                                        grid.coords,
                                        grid.spec.axis_sizes).clone()
                del whole
        return tree
    held = None
    for r in range(dist.get_world_size()):
        if r == grid.rank:
            held = model.init(torch.Generator(device=device).manual_seed(
                seed), device, place=lambda path, part: cut(part, path + "/"))
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()
        dist.barrier()
    return held


def held_bytes(tree) -> int:
    """The bytes of the tensors of ``tree`` (what a process holds)."""
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


# ===========================================================================
# the auto step: TP over model, FSDP over data, DP over pod (processes)
# ===========================================================================


@dataclass(eq=False)
class AutoTrainStep:
    """The reference's ``make_auto_train_step`` one process per device of
    the (pod, data, model) grid: each holds its block of the params and
    of AdamW's moments under ``auto_train_pspecs``; the forward gathers a
    block's ``data``-sharded dims on use (again under remat) and splits
    heads, FFN and vocabulary over ``model``; the gather's backward
    reduce-scatters the gradient over ``data``, a leaf no dp axis splits
    has its gradient summed over the dp column, and every gradient is
    summed over ``pod``.  The loss is the global batch's (``Model.loss``
    with the dp column as ``tp.batch``): the mean over its valid tokens
    (and the MTP head's), the MoE layers' dispatch groups and aux loss
    the whole batch's, each process's share summed over dp."""
    model: Model
    optimizer: Optimizer
    grid: Any
    pspecs: Dict[str, tuple]

    @property
    def device(self) -> torch.device:
        return self.grid.device

    def init(self, gen: torch.Generator):
        """Params (drawn whole from ``gen``, as one device draws them,
        then cut to this process's block) and the optimizer state."""
        return self.init_from(self.model.init(gen, self.device))

    def init_from(self, full):
        params = shard_params(full, self.pspecs, self.grid)
        return params, self.optimizer.init(params)

    def rows(self, batch: Dict[str, torch.Tensor]):
        """This process's rows of the global batch: its dp node's."""
        K, d = self.grid.pm.K, self.grid.pm.node
        return {k: x[d * x.shape[0] // K:(d + 1) * x.shape[0] // K]
                for k, x in batch.items()}

    def grads(self, params, batch: Dict[str, torch.Tensor]):
        """(loss, gradient tree): the global batch's loss and this
        process's block of its gradient."""
        metrics, grads = self.grads_and_metrics(params, batch)
        return metrics["loss"], grads

    def grads_and_metrics(self, params, batch: Dict[str, torch.Tensor]):
        """(metrics, gradient tree): the global batch's metrics (loss,
        xent, tokens, aux_loss, [mtp_loss]: the sums of every dp
        member's shares, ``Model.loss`` under ``tp.batch``) and this
        process's block of the gradient."""
        grid = self.grid
        shard = self.rows(batch)
        paths = [keystr_path(p) for p, _ in tree_leaves_with_path(params)]
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        with torch.enable_grad():
            loss, metrics = self.model.loss(tree_unflatten(params, leaves),
                                            shard)
            grads = torch.autograd.grad(loss, leaves)
        out = [grid.pod.all_reduce(g)
               if SH.dims_over(self.pspecs[path], "data")
               else grid.dp.all_reduce(g) for path, g in zip(paths, grads)]
        keys = sorted(metrics)
        summed = grid.dp.all_reduce(torch.stack(
            [metrics[k].detach().float().reshape(()) for k in keys]))
        return dict(zip(keys, summed.unbind())), tree_unflatten(params, out)

    @torch.no_grad()
    def step(self, params, opt_state, batch, step: int):
        metrics, grads = self.grads_and_metrics(params, batch)
        params, opt_state = self.optimizer.update(grads, opt_state, params,
                                                  step)
        return params, opt_state, metrics


def make_auto_train_step(model: Model, tc: TrainConfig, grid
                         ) -> AutoTrainStep:
    """The auto step on ``grid`` (a ``launch.mesh.ProcessGrid``), its
    placement ``auto_train_pspecs`` with FSDP, as the reference's
    trainer builds it; the optimizer state takes its params' specs."""
    pspecs = auto_train_pspecs(model, tc, grid.spec)[0]
    tp = Shards(model=grid.model, fsdp=grid.data, specs=pspecs,
                batch=grid.dp)
    squares = sum_of_squares(pspecs, {"model": grid.model,
                                              "data": grid.data})
    return AutoTrainStep(replace(model, tp=tp),
                         build_optimizer(tc, squares=squares), grid, pspecs)


# ===========================================================================
# serving steps: TP over model, the batch or the cache's sequence over dp
# ===========================================================================


@dataclass(eq=False)
class ServeLayout:
    """How a serving grid holds the model and the cache: ``model`` bound
    to the params' Shards; the batch rows of this process (``rows``, a
    slice, when the dp column splits the batch), or the cache's sequence
    split over ``data`` (``model.tp.seq``)."""
    model: Model
    grid: Any
    pspecs: Dict[str, tuple]
    rows: Optional[slice]


def _serve_layout(model: Model, grid, shape: InputShape) -> ServeLayout:
    """The reference's serving placement on ``grid``: ``serve_pspecs``,
    and the cache's ``serve_cache_pspecs`` (its batch over the dp axes
    when they divide it and it is > 1, as ``decode_token_pspec`` splits
    the tokens; else its sequence over ``data``, where pod x data
    divides it: a sliding window's ring of slots too, each pod holding
    the whole cache, the partial softmaxes combined over ``data``)."""
    spec = grid.spec
    pspecs = serve_pspecs(model, spec)
    cache = model.init_cache(shape.global_batch, shape.seq_len, "meta")
    # each leaf's split: dim 1 (a state's batch; a position ring's slots
    # are dim 1 of a 2-d leaf) over dp, or dim 2 over data
    cspecs = [sp for sp in serve_cache_pspecs(cache, spec).values()
              if len(sp) >= 3]
    rows, seq, batch = None, None, None
    if any(sp[1] is not None for sp in cspecs):
        B, K, d = shape.global_batch, grid.pm.K, grid.pm.node
        rows = slice(d * B // K, (d + 1) * B // K)
        batch = grid.dp
    elif any(sp[2] == "data" for sp in cspecs):
        seq = grid.data
    fsdp = any(SH.dims_over(sp, "data") for sp in pspecs.values())
    tp = Shards(model=grid.model, fsdp=grid.data if fsdp else None,
                specs=pspecs, seq=seq, batch=batch,
                seq_dp=dp_size_of(spec))
    return ServeLayout(replace(model, tp=tp), grid, pspecs, rows)


def _gather_rows(lay: ServeLayout, logits):
    return logits if lay.rows is None else lay.grid.dp.all_gather(logits, 0)


def make_prefill_step(model: Model, grid, shape: InputShape):
    """The reference's ``make_prefill_step`` on a process grid: returns
    (prefill(params, batch, cache_len) -> (the (B, 1, V) last-token
    logits, whole on every process; this process's cache), the
    ServeLayout; ``params`` this process's block under
    ``serve_pspecs``)."""
    lay = _serve_layout(model, grid, shape)

    def prefill(params, batch, cache_len=None):
        if lay.rows is not None:
            batch = {k: x[lay.rows] for k, x in batch.items()}
        logits, cache = lay.model.prefill(params, batch,
                                          cache_len=cache_len)
        return _gather_rows(lay, logits), cache
    return prefill, lay


def make_decode_step(model: Model, grid, shape: InputShape):
    """The reference's ``make_decode_step`` on a process grid: returns
    (decode(params, cache, tokens (B, 1), pos) -> (the (B, 1, V) logits,
    whole on every process; the cache, updated in place), the
    ServeLayout)."""
    lay = _serve_layout(model, grid, shape)

    def decode(params, cache, tokens, pos: int):
        if lay.rows is not None:
            tokens = tokens[lay.rows]
        logits, cache = lay.model.decode_step(params, cache, tokens, pos)
        return _gather_rows(lay, logits), cache
    return decode, lay


# ===========================================================================
# placement rules of the reference's step builders, on a MeshSpec
# ===========================================================================
#
# The specs each of ``repro.launch.steps``'s builders gives its inputs
# and state (``dist.sharding``'s tuples, {path: spec} per tree), as pure
# functions of the model and a ``launch.mesh.MeshSpec``, which the dry
# run prices.

# The per-model-shard weight bytes above which serving also shards its
# weights over ``data``: the reference's threshold (``_serve_pspecs``),
# kept for parity; a 671B-class MoE cannot serve with data-replicated
# weights
SERVE_FSDP_BYTES = 8e9


def batch_pspecs(batch_tree: Dict[str, Any], dp_axes: Sequence[str]
                 ) -> Dict[str, tuple]:
    """Each batch entry's rows over the dp axes, its other dims
    replicated (the reference's ``_batch_pspecs``: no divisibility
    check)."""
    bp = SH.batch_pspec(dp_axes)
    return {name: bp + (None,) * (x.dim() - 1)
            for name, x in batch_tree.items()}


def auto_train_pspecs(model: Model, tc: TrainConfig, mesh: MeshSpec,
                      fsdp: bool = True):
    """(params, optimizer state) specs of the reference's
    ``make_auto_train_step``: TP over ``model``, and with ``fsdp`` the
    ``data`` axis alone (sized by it, on the two-pod mesh too)."""
    mp = model_size_of(mesh)
    sizes = mesh.axis_sizes
    fsdp_axes = ("data",) if (fsdp and "data" in sizes) else ()
    fsdp_size = sizes.get("data", 1) if fsdp else 1
    p_shapes = params_specs(model)
    o_shapes = build_optimizer(tc).init(p_shapes)
    return (SH.param_pspecs(p_shapes, model_size=mp, fsdp_axes=fsdp_axes,
                            fsdp_size=fsdp_size),
            SH.param_pspecs(o_shapes, model_size=mp, fsdp_axes=fsdp_axes,
                            fsdp_size=fsdp_size))


@dataclass(frozen=True)
class LGCStateSpecs:
    """The reference's ``make_lgc_train_step`` placement: params and the
    optimizer state over ``model`` only (replicated over dp: every node
    holds the model), each (node x model shard) its own EF rows ``u``,
    ``v`` of the per-model-shard layout, the AE replicated."""
    params: Dict[str, tuple]
    optimizer: Dict[str, tuple]
    comp: Dict[str, tuple]        # "u", "v"[, "ae", "ae_mom": whole tree]
    template: Any                 # one model shard's params, on meta
    compressor: GradientCompressor
    n_local: int
    dp: int
    mp: int


def lgc_state_specs(model: Model, cc: CompressionConfig, mesh: MeshSpec
                    ) -> LGCStateSpecs:
    """The LGC step's specs, its optimizer state AdamW's (the dry run's;
    an SGD momentum tree is AdamW's ``m`` alone)."""
    mp = model_size_of(mesh)
    dp_axes = dp_axes_of(mesh)
    dp = dp_size_of(mesh)
    p_shapes = params_specs(model)
    pspecs = SH.param_pspecs(p_shapes, model_size=mp)
    tc = TrainConfig(optimizer="adamw", compression=cc)
    ospecs = SH.param_pspecs(build_optimizer(tc).init(p_shapes),
                             model_size=mp)
    # the compressor's layout is one model shard's: each leaf's local shape
    template = tree_unflatten(p_shapes, [
        torch.empty(SH.local_shape(tuple(leaf.shape), pspecs[keystr_path(
            path)], {"model": mp}), dtype=leaf.dtype, device="meta")
        for path, leaf in tree_leaves_with_path(p_shapes)])
    compressor = build_compressor(cc, template, dp)
    names = ("u", "v") + (("ae", "ae_mom") if cc.method.startswith("lgc")
                          else ())
    comp = {k: comp_state_spec(k, dp_axes) for k in names}
    return LGCStateSpecs(pspecs, ospecs, comp, template, compressor,
                         compressor.layout.n_total, dp, mp)


def comp_state_spec(name: str, dp_axes: Sequence[str]) -> tuple:
    """The spec of the LGC step's ``comp_state[name]``: each (node x model
    shard)'s own EF rows u, v of the (dp, mp, n_local) arrays, the AE and
    its momentum replicated."""
    if name not in ("u", "v"):
        return ()
    return (dp_axes[0] if len(dp_axes) == 1 else tuple(dp_axes), "model",
            None)


def train_state_specs(pspecs: Dict[str, tuple], state: Any,
                      dp_axes: Sequence[str]) -> Dict[str, tuple]:
    """{checkpoint key: spec} of a train state ``state`` ({"params",
    "opt_state"[, "comp_state"]}, keyed as the trainer's file): the params
    under ``pspecs``, each optimizer slot under its parameter's spec, the
    compressor's state as ``comp_state_spec``, as the reference's step
    builders place them."""
    out = {}
    for path, _ in tree_leaves_with_path(state):
        key = keystr_path(path)
        part, rest = key.split("/", 1)
        if part == "params":
            out[key] = pspecs[rest]
        elif part == "opt_state":
            out[key] = pspecs[rest.split("/", 1)[1]]
        else:
            out[key] = comp_state_spec(rest.split("/", 1)[0], dp_axes)
    return out


def serve_pspecs(model: Model, mesh: MeshSpec) -> Dict[str, tuple]:
    """Serving weights: TP over ``model``, and also over ``data``
    (weight-sharded inference) when one model shard's weights exceed
    ``SERVE_FSDP_BYTES``."""
    mp = model_size_of(mesh)
    sizes = mesh.axis_sizes
    p_shapes = params_specs(model)
    per_shard = tree_size_bytes(p_shapes) / max(mp, 1)
    if per_shard > SERVE_FSDP_BYTES and "data" in sizes:
        return SH.param_pspecs(p_shapes, model_size=mp, fsdp_axes=("data",),
                               fsdp_size=sizes["data"])
    return SH.param_pspecs(p_shapes, model_size=mp)


def serve_cache_pspecs(cache_tree: Any, mesh: MeshSpec) -> Dict[str, tuple]:
    """The cache's specs in the reference's prefill and decode steps (the
    sequence over ``data`` when the batch does not divide)."""
    dp = dp_size_of(mesh)
    return SH.cache_pspecs(cache_tree, dp_axes=dp_axes_of(mesh), dp_size=dp,
                           model_size=model_size_of(mesh),
                           seq_shard_axis="data" if dp > 1 else None)


def decode_token_pspec(shape: InputShape, mesh: MeshSpec) -> tuple:
    """The reference's decode step's (B, 1) tokens: rows over the dp axes
    when they divide B > 1, else replicated."""
    B, dp = shape.global_batch, dp_size_of(mesh)
    rows = SH.batch_pspec(dp_axes_of(mesh))[0] \
        if B % dp == 0 and B > 1 else None
    return (rows, None)
