"""Layouts of a process grid that the reference runs, each on threads
standing in for the ranks (tests/_torch_tp_threads.py ``thread_grids``:
the step builders and the server run on them as under torchrun) and
held to one process or to the reference:

- batch 1 served with the cache split along the sequence over
  ``data`` under a sliding window (long_500k's layout in the reference's
  dry run): reduced() llama3.2-1b with a 24-slot window, 8 ring slots a
  rank on (data 3), 12 on (pod 2, data 2) (the cache split over data,
  held whole over pod, as the reference's spec says), a 40-token prompt
  (past the ring already) and 20 generated tokens; and over pods
  without a window: every rank's greedy tokens equal one process's, the
  last logits within 1e-5 of their largest entry, each rank's cache
  leaf the reference's local shape (the position ring: this rank's
  slots);
- mamba2-130m reduced() served at batch 1 on (data 3): the conv state's
  3 rows split over data (one a rank), with 16 Mamba2 heads (the state
  whole) and 12 (4 a rank): tokens and logits as above;
- gradient clipping on sharded params, a clip that bites (a quarter of
  the norm), numpy gradients of reduced() llama's shapes: on (data 2,
  model 2) the auto step's specs (TP + FSDP) and the LGC step's (model
  only, every data rank alike), each rank's global norm within 1e-6 of
  the reference's ``_global_norm`` of the whole tree and its blocks of
  the clipped gradient and of momentum SGD's step (new - old params)
  within 1e-6 of the reference's ``_maybe_clip`` and ``update`` on the
  whole tree; and the
  auto step with ``grad_clip_norm`` on the threads, one step, the
  change of its param blocks within 1e-5 of one process's clipped
  update.

(The one-process windowed cache against the reference's
``_window_cache`` layout: tests/test_torch_serve.py.)
"""
from dataclasses import replace

import numpy as np
import pytest
import torch

from _one_thread import one_thread  # noqa: F401  (autouse)
from _torch_tp_threads import run_ranks, thread_grids
from _torch_train_common import close
from repro_torch.configs import get_arch
from repro_torch.configs.base import (CompressionConfig, InputShape,
                                      TrainConfig)
from repro_torch.dist import sharding as SH
from repro_torch.launch import serve, steps
from repro_torch.models.model import build_model
from repro_torch.optim import optimizers as O
from repro_torch.utils.tree import (keystr_path, tree_leaves,
                                    tree_leaves_with_path, tree_map,
                                    tree_unflatten)

WINDOW, PROMPT, GEN = 24, 40, 20


def _serve_args(B, prompt, gen):
    return serve.parse_args(["--batch", str(B), "--prompt-len", str(prompt),
                             "--gen", str(gen), "--device", "cpu"])


def _served_on_threads(cfg, grid_shape, prompt, gen):
    """One process's serve.run and each rank's on a thread grid, from the
    same seeded weights."""
    full = build_model(cfg).init(torch.Generator().manual_seed(0))
    args = _serve_args(1, prompt, gen)
    one = serve.run(cfg, args, params=full)

    def rank(grid):
        res = serve._serve(cfg, args, full, grid.device, grid)
        lay = steps._serve_layout(build_model(cfg), grid, InputShape(
            "d", prompt + gen, 1, "decode"))
        cache = lay.model.init_cache(1, prompt + gen, "meta")
        return res, lay, cache
    return one, run_ranks(rank, thread_grids(*grid_shape))


def _hold(cfg, one, ranks, grid_shape):
    pod, data, _ = grid_shape
    whole = build_model(cfg).init_cache(1, PROMPT + GEN, "meta")
    specs = SH.cache_pspecs(whole, dp_axes=("data",), dp_size=pod * data,
                            model_size=1, seq_shard_axis="data")
    split = 0
    for r, (res, lay, cache) in enumerate(ranks):
        assert lay.model.tp.seq is not None and lay.rows is None, r
        assert res["tokens"].tolist() == one["tokens"].tolist(), r
        close(res["logits"], one["logits"], 1e-5, f"rank {r} logits")
        for (path, x), c in zip(tree_leaves_with_path(whole),
                                tree_leaves(cache)):
            want = SH.local_shape(tuple(x.shape), specs[keystr_path(path)],
                                  {"data": data})
            assert tuple(c.shape) == want, (r, keystr_path(path))
            split += want != tuple(x.shape)
    return split


@pytest.mark.parametrize("grid_shape,window", [((1, 3, 1), WINDOW),
                                               ((2, 2, 1), WINDOW),
                                               ((2, 2, 1), 0)])
def test_b1_sequence_split_under_a_window_and_over_pods(grid_shape, window):
    cfg = replace(get_arch("llama3.2-1b").reduced(), sliding_window=window)
    one, ranks = _served_on_threads(cfg, grid_shape, PROMPT, GEN)
    assert _hold(cfg, one, ranks, grid_shape) > 0
    if window:
        ring = WINDOW // grid_shape[1]
        assert all(c["p0"]["k"].shape[2] == ring for _, _, c in ranks)


@pytest.mark.parametrize("d_model", [256, 192])
def test_mamba2_conv_state_split_by_rows(d_model):
    cfg = get_arch("mamba2-130m").reduced(d_model=d_model)
    one, ranks = _served_on_threads(cfg, (1, 3, 1), 16, 8)
    _hold(cfg, one, ranks, (1, 3, 1))
    heads = 2 * d_model // 32
    for _, _, cache in ranks:
        assert cache["p0"]["conv"].shape[2] == 1           # 3 rows / 3
        assert cache["p0"]["ssm"].shape[2] == (heads // 3 if heads % 3 == 0
                                               else heads)


def _ref_clip(grads, params, clip):
    """The reference's global norm, clipped gradient and momentum SGD
    update (one step from zero momentum) on the whole numpy trees."""
    import jax.numpy as jnp
    from repro.configs.base import TrainConfig as RTC
    from repro.optim import optimizers as RO
    g = {k: jnp.asarray(v) for k, v in grads.items()}
    p = {k: jnp.asarray(v) for k, v in params.items()}
    opt = RO.build_optimizer(RTC(optimizer="sgd_momentum",
                                 learning_rate=0.1, steps=10,
                                 grad_clip_norm=clip))
    new, _ = opt.update(g, opt.init(p), p, 3)
    return (float(RO._global_norm(g)),
            {k: np.asarray(v) for k, v in RO._maybe_clip(g, clip).items()},
            {k: np.asarray(v) for k, v in new.items()})


@pytest.mark.parametrize("step_kind", ["auto", "lgc"])
def test_clipping_on_sharded_params_matches_reference(step_kind):
    cfg = get_arch("llama3.2-1b").reduced()
    model = build_model(cfg)
    meta = model.init(torch.Generator(), "meta")
    paths = [keystr_path(p) for p, _ in tree_leaves_with_path(meta)]
    rng = np.random.default_rng(0)
    grads = {k: rng.normal(size=x.shape).astype(np.float32)
             for k, (_, x) in zip(paths, tree_leaves_with_path(meta))}
    # small params, so the step (new - old) is not lost in their rounding
    params = {k: (1e-2 * rng.normal(size=x.shape)).astype(np.float32)
              for k, (_, x) in zip(paths, tree_leaves_with_path(meta))}
    norm = float(np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                             for g in grads.values())))
    clip = 0.25 * norm
    ref_norm, ref_clipped, ref_new = _ref_clip(grads, params, clip)
    mesh = thread_grids(1, 2, 2)[0].spec
    tc = TrainConfig(optimizer="sgd_momentum", learning_rate=0.1, steps=10,
                     grad_clip_norm=clip,
                     compression=CompressionConfig(method="lgc_rar"))
    if step_kind == "auto":
        specs = steps.auto_train_pspecs(model, tc, mesh)[0]
        assert any(SH.dims_over(sp, "data") for sp in specs.values())
    else:
        specs = steps.lgc_state_specs(model, tc.compression, mesh).params
    assert any(SH.dims_over(sp, "model") for sp in specs.values())
    def blocks(tree, grid):
        whole = tree_unflatten(meta, [torch.from_numpy(np.array(tree[k]))
                                      for k in paths])
        return SH.shard_tree(whole, specs, grid.coords,
                             grid.spec.axis_sizes)

    def rank(grid):
        groups = {"model": grid.model}
        if step_kind == "auto":
            groups["data"] = grid.data
            opt = steps.make_auto_train_step(model, tc, grid).optimizer
        else:
            opt = steps.make_lgc_train_step(model, tc, 2, grid.device,
                                            grid=grid).optimizer
        squares = O.sum_of_squares(specs, groups)
        g, p = blocks(grads, grid), blocks(params, grid)
        new, _ = opt.update(g, opt.init(p), p, 3)
        return (float(torch.sqrt(squares(g))),
                O._maybe_clip(g, clip, squares),
                tree_map(lambda a, b: a - b, new, p))
    ref_step = {k: ref_new[k] - params[k] for k in paths}
    grids = thread_grids(1, 2, 2)
    for grid, (got_norm, clipped, step) in zip(grids, run_ranks(rank, grids)):
        np.testing.assert_allclose(got_norm, ref_norm, rtol=1e-6)
        assert got_norm > clip
        for got, ref in ((clipped, ref_clipped), (step, ref_step)):
            want = blocks(ref, grid)
            for (path, a), b in zip(tree_leaves_with_path(got),
                                    tree_leaves(want)):
                close(a.numpy(), b.numpy(), 1e-6,
                      f"{grid.coords} {keystr_path(path)}")


def test_auto_step_with_clipping_matches_one_process():
    cfg = get_arch("llama3.2-1b").reduced()
    model = build_model(cfg)
    full = model.init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (4, 16), generator=g)
    batch = {"tokens": tokens, "labels": tokens.roll(-1, 1)}
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(full)]
    loss, _ = model.loss(tree_unflatten(full, leaves), batch)
    grads = tree_unflatten(full, list(torch.autograd.grad(loss, leaves)))
    norm = float(torch.sqrt(O.sum_of_squares()(grads)))
    # a large rate: the step (new - old params) well above the params'
    # rounding, which the one-step difference would otherwise show
    tc = TrainConfig(optimizer="sgd_momentum", learning_rate=10.0, steps=4,
                     grad_clip_norm=0.25 * norm,
                     compression=CompressionConfig(method="none"))
    opt = O.build_optimizer(tc)
    with torch.no_grad():
        new, _ = opt.update(grads, opt.init(full), full, 1)
        want = tree_map(lambda a, b: a - b, new, full)
    pspecs = steps.auto_train_pspecs(model, tc, thread_grids(1, 2, 2)[0]
                                     .spec)[0]

    def rank(grid):
        ats = steps.make_auto_train_step(model, tc, grid)
        params, opt_state = ats.init_from(tree_map(torch.clone, full))
        before = tree_map(torch.clone, params)
        params, _, metrics = ats.step(params, opt_state, batch, 1)
        return tree_map(lambda a, b: a - b, params, before), \
            float(metrics["loss"])
    grids = thread_grids(1, 2, 2)
    for grid, (params, got_loss) in zip(grids, run_ranks(rank, grids)):
        np.testing.assert_allclose(got_loss, loss.item(), rtol=0, atol=1e-5)
        block = SH.shard_tree(want, pspecs, grid.coords,
                              grid.spec.axis_sizes)
        for (path, a), b in zip(tree_leaves_with_path(params),
                                tree_leaves(block)):
            close(a.numpy(), b.numpy(), 1e-5,
                  f"{grid.coords} {keystr_path(path)}")
