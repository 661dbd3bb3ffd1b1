"""Shared by the port's trainer tests (tests/test_torch_train*.py): the
trajectory harness that holds the port's training step against a
reference loop built by hand from the JAX package, its tolerance, and
the entry point's smoke arguments."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_arch as ref_get_arch
from repro.configs.base import CompressionConfig as RCC
from repro.configs.base import TrainConfig as RTC
from repro.core import build_compressor as ref_build_compressor
from repro.core.phases import phase_for_step as ref_phase_for_step
from repro.data import synthetic_token_batches as ref_batches
from repro.dist import plan as RXP
from repro.models.model import Model as RefModel
from repro.optim.optimizers import build_optimizer as ref_build_optimizer
from repro.utils.tree import tree_flatten_vector as ref_flatten
from repro.utils.tree import tree_unflatten_vector as ref_unflatten
from repro_torch.configs import get_arch
from repro_torch.configs.base import CompressionConfig, TrainConfig
from repro_torch.core.phases import phase_for_step
from repro_torch.launch.steps import make_lgc_train_step
from repro_torch.models.model import build_model
from repro_torch.utils.convert import ae_from_numpy, params_from_numpy
from repro_torch.utils.tree import tree_leaves, tree_map, \
    tree_unflatten_vector

K, STEPS, BATCH, SEQ = 2, 6, 4, 32
SLICE = dict(method="lgc_rar", warmup_steps=2, ae_train_steps=2)
ARGS = ["--smoke", "--steps", "3", "--batch", "2", "--seq", "16",
        "--compression", "lgc_rar", "--topk-backend", "fused",
        "--ae-backend", "pallas", "--data-shards", "2",
        "--warmup-steps", "1", "--ae-train-steps", "1", "--log-every", "1"]
# the ring_hier trajectory: lgc_rar on a (2, 2) pod mesh, K = 4 nodes, as
# the reference's REF_HIER below runs it and as the port's entry point
# takes it (its emulated run, and one node per process under torchrun)
HIER_K, HIER_BATCH, HIER_SEQ = 4, 8, 16
HIER_FLAGS = ["--smoke", "--steps", str(STEPS), "--batch", str(HIER_BATCH),
              "--seq", str(HIER_SEQ), "--compression", "lgc_rar",
              "--topk-backend", "fused", "--ae-backend", "pallas",
              "--transport", "ring_hier", "--pod-shards", "2",
              "--data-shards", "2", "--warmup-steps", "2",
              "--ae-train-steps", "2", "--optimizer", "sgd_momentum",
              "--lr", "0.1", "--log-every", "1", "--device", "cpu"]


def close(a, b, rel, what):
    """|a - b| <= rel * max|b|: f32 sums in another order, compounded
    over the steps.  Measured on the CPU: <= 2.1e-6 for the global
    gradient, u, v and params, 1e-13 for the AE; bounds are ~10x that."""
    a, b = np.asarray(a), np.asarray(b)
    scale = max(float(np.abs(b).max()), 1e-30)
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * scale,
                               err_msg=what)


def trajectory(method, backend, ae_rel=1e-12):
    """6 steps of the reference loop (jnp backends) beside the port's
    pieces with ``backend`` (and the kernel encoder for lgc), the AE held
    to ``ae_rel`` of its largest value; returns the phases seen."""
    rcfg = ref_get_arch("llama3.2-1b").reduced()
    rmodel = RefModel(rcfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    slice_ = dict(SLICE, method=method)
    rcc = RCC(**slice_, topk_backend="jnp", ae_backend="jnp")
    # momentum SGD: linear in the gradient, so rounding differences stay
    # rounding-sized (AdamW's m/sqrt(v) turns a 1e-12-vs-0 gradient into a
    # full step; its own parity is test_adamw_matches_reference)
    ropt = ref_build_optimizer(RTC(optimizer="sgd_momentum",
                                   learning_rate=0.1, steps=STEPS,
                                   compression=rcc))
    ropt_state = ropt.init(rparams)
    rcomp = ref_build_compressor(rcc, rparams, K)
    rstates = rcomp.init_sim_states(jax.random.PRNGKey(1))
    rgrad = jax.jit(jax.value_and_grad(rmodel.loss, has_aux=True))
    rsim = jax.jit(rcomp.sim_step, static_argnums=(3,))
    rupdate = jax.jit(ropt.update)

    cc = CompressionConfig(**slice_, topk_backend=backend,
                           ae_backend="pallas")
    tc = TrainConfig(optimizer="sgd_momentum", learning_rate=0.1,
                     steps=STEPS, compression=cc)
    lts = make_lgc_train_step(build_model(get_arch("llama3.2-1b").reduced()),
                              tc, K, torch.device("cpu"))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, rparams))
    opt_state = lts.optimizer.init(params)
    state = lts.compressor.init_sim_states(torch.Generator())
    lgc = "ae" in rstates
    if lgc:
        state["ae"] = ae_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                           rstates["ae"]))
        state["ae_mom"] = tree_map(torch.zeros_like, state["ae"])

    data = ref_batches(rcfg.vocab_size, BATCH, SEQ, seed=0)
    phases = []
    for step in range(STEPS):
        phase = phase_for_step(step, cc)
        assert phase == ref_phase_for_step(step, rcc)
        phases.append(phase)
        batch = next(data)
        # reference: per-node grads -> sim_step -> optimizer
        flats, rloss = [], 0.0
        for k in range(K):
            nb = {n: x[k * BATCH // K:(k + 1) * BATCH // K]
                  for n, x in batch.items()}
            (loss_k, _), grads = rgrad(rparams, nb)
            flats.append(ref_flatten(grads))
            rloss += float(loss_k) / K
        rgg, rstates, _ = rsim(rstates, jnp.stack(flats), step, phase)
        rparams, ropt_state = rupdate(ref_unflatten(rgg, rparams),
                                      ropt_state, rparams, step)
        # the port: the same pieces LGCTrainStep.step runs
        tbatch = {n: torch.from_numpy(x).long() for n, x in batch.items()}
        g_nodes, metrics = lts.node_grads(params, tbatch)
        gg, state, stats = lts.compressor.sim_step(state, g_nodes, step,
                                                   phase)
        params, opt_state = lts.optimizer.update(
            tree_unflatten_vector(gg, params), opt_state, params, step)

        where = f"{method} step {step} ({phase})"
        np.testing.assert_allclose(float(metrics["loss"]), rloss,
                                   rtol=1e-5, err_msg=where)
        close(gg.numpy(), rgg, 2e-5, where + " global gradient")
        if phase != "warmup":                 # the sent support, bitwise
            np.testing.assert_array_equal(gg.numpy() != 0,
                                          np.asarray(rgg) != 0, where)
        for key in ("u", "v"):
            ours, ref = state[key].numpy(), np.asarray(rstates[key])
            np.testing.assert_array_equal(ours == 0, ref == 0,
                                          f"{where} cleared {key}")
            close(ours, ref, 2e-5, f"{where} {key}")
        if lgc:
            close(torch.cat([a.reshape(-1)
                              for a in tree_leaves(state["ae"])]),
                   ref_flatten(rstates["ae"]), ae_rel, where + " ae")
        plan = RXP.build_plan(rcc, rcomp.layout, K, transport="mesh",
                              phase=phase)
        assert stats["wire"] == RXP.wire_terms_by_op(plan), where
    for a, b in zip(tree_leaves(params), jax.tree_util.tree_leaves(rparams)):
        close(a.numpy(), b, 2e-5, f"{method} params after 6 steps")
    return phases


def reference_hier_init():
    """The reference trainer's initial weights and AE for the ring_hier
    trajectory (PRNGKey(0), jitted as its trainer draws them), in this
    process: {p<i>: weight leaf, a<i>: AE leaf}, numpy, in tree order
    (REF_HIER saves the same keys from its 4-device run)."""
    key = jax.random.PRNGKey(0)
    rparams = jax.jit(RefModel(ref_get_arch("llama3.2-1b").reduced()).init)(
        key)
    rcc = RCC(method="lgc_rar", warmup_steps=2, ae_train_steps=2)
    rae = jax.jit(lambda k: ref_build_compressor(rcc, rparams, HIER_K)
                  .init_state(k)["ae"])(key)
    out = {f"p{i}": np.asarray(a)
           for i, a in enumerate(jax.tree_util.tree_leaves(rparams))}
    out.update({f"a{i}": np.asarray(a)
                for i, a in enumerate(jax.tree_util.tree_leaves(rae))})
    return out


def hier_loop(init):
    """The port's ``LGCTrainStep`` with K = 4 nodes, Ks = (2, 2), on
    ``ring_hier``, from ``init``'s weights and AE (``reference_hier_init``'s
    keys), node k on batch shard k of the reference's stream: six steps
    at HIER_FLAGS' settings.  Returns (each step's loss, each phase's
    per-op rows, the final params)."""
    rcfg = ref_get_arch("llama3.2-1b").reduced()
    key = jax.random.PRNGKey(0)
    pleaves, pdef = jax.tree_util.tree_flatten(
        jax.eval_shape(RefModel(rcfg).init, key))
    rparams = pdef.unflatten([init[f"p{i}"] for i in range(len(pleaves))])
    rcc = RCC(method="lgc_rar", warmup_steps=2, ae_train_steps=2)
    rae = jax.eval_shape(lambda k: ref_build_compressor(
        rcc, rparams, HIER_K).init_state(k)["ae"], key)
    aleaves, adef = jax.tree_util.tree_flatten(rae)
    cc = CompressionConfig(method="lgc_rar", warmup_steps=2,
                           ae_train_steps=2, transport="ring_hier",
                           topk_backend="fused", ae_backend="pallas")
    tc = TrainConfig(optimizer="sgd_momentum", learning_rate=0.1,
                     steps=STEPS, compression=cc)
    lts = make_lgc_train_step(build_model(get_arch("llama3.2-1b").reduced()),
                              tc, HIER_K, torch.device("cpu"), (2, 2))
    params = params_from_numpy(rparams)
    opt_state = lts.optimizer.init(params)
    state = lts.compressor.init_sim_states(torch.Generator())
    state["ae"] = ae_from_numpy(adef.unflatten(
        [init[f"a{i}"] for i in range(len(aleaves))]))
    state["ae_mom"] = tree_map(torch.zeros_like, state["ae"])
    data = ref_batches(rcfg.vocab_size, HIER_BATCH, HIER_SEQ, seed=0)
    losses, wire = [], {}
    for step in range(STEPS):
        phase = phase_for_step(step, cc)
        tbatch = {n: torch.from_numpy(x).long()
                  for n, x in next(data).items()}
        params, opt_state, state, metrics = lts.step(
            params, opt_state, state, tbatch, step, phase)
        losses.append(float(metrics["loss"]))
        wire.setdefault(phase, metrics["wire"])
    return losses, wire, params


def hier_twin(init_path: str, monkeypatch, extra=()):
    """The entry point's emulated run at HIER_FLAGS (``train.run``, K
    nodes stacked on this device) from the weights and AE saved in
    ``init_path`` (``reference_hier_init``'s keys), as the process runs of
    tests/test_torch_pg_train.py start; the wrapped init is undone after
    the test."""
    import _torch_pg_train_worker as W
    from repro_torch.launch import train
    monkeypatch.setattr(W.steps.LGCTrainStep, "init",
                        W.steps.LGCTrainStep.init)
    W.start_from(init_path)
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    return train.run(get_arch("llama3.2-1b").reduced(),
                     train.parse_args(HIER_FLAGS + list(extra)))


# The reference's own training step (``repro.launch.steps``, what
# ``repro.launch.train --pod-shards 2 --data-shards 2`` runs) on 4 host
# devices: lgc_rar on ring_hier over a (2, 2) pod mesh, momentum SGD;
# saves the initial weights (p<i>) and AE (a<i>), each step's loss and the
# final weights to ``path``, and each phase's per-op rows to path.json.
REF_HIER = """
import numpy as np, jax, jax.flatten_util
import jax.tree_util as jtu
from repro.configs import get_arch
from repro.configs.base import CompressionConfig, TrainConfig
from repro.core.phases import phase_for_step
from repro.data import synthetic_token_batches
from repro.dist import collectives as coll
from repro.launch.mesh import make_host_mesh
from repro.launch.steps import make_lgc_train_step
from repro.models import build_model
import json

cfg = get_arch("llama3.2-1b").reduced()
model = build_model(cfg)
cc = CompressionConfig(method="lgc_rar", warmup_steps=2, ae_train_steps=2,
                       transport="ring_hier", topk_backend="jnp",
                       ae_backend="jnp")
tc = TrainConfig(optimizer="sgd_momentum", learning_rate=0.1,
                 steps={STEPS}, compression=cc)
mesh = make_host_mesh(2, 1, pod=2)
lts = make_lgc_train_step(model, tc, mesh)
params, opt_state, comp_state = lts.init(jax.random.PRNGKey(0), model, mesh)
out = {{f"p{{i}}": np.asarray(a)
       for i, a in enumerate(jtu.tree_leaves(params))}}
out.update({{f"a{{i}}": np.asarray(a)
            for i, a in enumerate(jtu.tree_leaves(comp_state["ae"]))}})
data = synthetic_token_batches(cfg.vocab_size, {BATCH}, {SEQ}, seed=0)
fns, wire = {{}}, {{}}
for step in range({STEPS}):
    phase = phase_for_step(step, cc)
    batch = next(data)
    new = phase not in fns
    if new:
        coll.reset_wire_tally()
        fns[phase] = lts.make_step(phase, jtu.tree_map(
            lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), batch))
    params, opt_state, comp_state, metrics = fns[phase](
        params, opt_state, comp_state, batch, step)
    out[f"loss{{step}}"] = np.float64(metrics["loss"])
    if new:
        wire[phase] = coll.wire_report(by_op=True)
out.update({{f"final{{i}}": np.asarray(a)
            for i, a in enumerate(jtu.tree_leaves(params))}})
np.savez({path!r}, **out)
with open({path!r} + ".json", "w") as f:
    json.dump(wire, f)
print("PASS")
"""
