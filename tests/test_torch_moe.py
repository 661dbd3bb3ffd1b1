"""The port's MoE layer (``models.layers.moe_fwd``) against the JAX
reference's at arctic-480b's smoke config (f32, 4 experts, top-2, the
dense residual), with the reference's ``init_moe`` weights carried
across: the output, the aux loss and the gradients of the input and of
every weight, under the grouped capacity dispatch with drops
(capacity_factor 1.0: G = 32 groups of 8 tokens, C = 4), dropless, and
with a shared expert; and on tied gates (router weights zero, so every
prob and every gate ties), where the tie order alone decides which tokens
each expert keeps: the kept (expert, token) slots bitwise the
reference's ``lax.top_k`` selection."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _one_thread import one_thread  # noqa: F401  (autouse)
from repro.configs import get_arch as ref_get_arch
from repro.models import layers as RL
from repro_torch.configs import get_arch
from repro_torch.models import layers as L
from repro_torch.utils.convert import params_from_numpy
from repro_torch.utils.tree import tree_leaves, tree_leaves_with_path, \
    tree_unflatten

# port against reference, f32: sums in another order (measured on the
# CPU: <= 6.8e-7 of the largest entry on every output and gradient)
REL = 1e-5
B, S = 2, 128                        # T = 256 tokens: 32 groups of 8



def _close(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(float(np.abs(b).max()), 1e-30)
    np.testing.assert_allclose(a, b, rtol=0, atol=REL * scale, err_msg=what)


def _configs(**moe):
    ref, ours = (g("arctic-480b").reduced() for g in (ref_get_arch,
                                                        get_arch))
    return (dataclasses.replace(ref, moe=dataclasses.replace(ref.moe, **moe)),
            dataclasses.replace(ours, moe=dataclasses.replace(ours.moe,
                                                              **moe)))


def _weights(rcfg, zero_router=False):
    rp = jax.tree_util.tree_map(np.asarray, RL.init_moe(
        jax.random.PRNGKey(0), rcfg, jnp.float32))
    if zero_router:
        rp["router"]["w"] = np.zeros_like(rp["router"]["w"])
    return rp


def _ref_route(probs, mo, dropless):
    """The reference's selection (layers.py:512-533) on the same probs."""
    T, E = probs.shape
    topk_p, topk_i = jax.lax.top_k(probs, mo.top_k)
    topk_p = topk_p / jnp.maximum(topk_p.sum(-1, keepdims=True), 1e-9)
    gates = jnp.zeros((T, E), jnp.float32).at[
        jnp.arange(T)[:, None], topk_i].set(topk_p)
    G = RL.MOE_DISPATCH_GROUPS
    if dropless or T % G or T // G < E:
        G = 1
    Tg = T // G
    C = Tg if dropless else min(max(1, int(Tg * mo.top_k / E
                                            * mo.capacity_factor)), Tg)
    gsel, tok_idx = jax.lax.top_k(gates.reshape(G, Tg, E).transpose(0, 2, 1),
                                  C)
    return np.asarray(gates), np.asarray(gsel), np.asarray(tok_idx)


@pytest.mark.parametrize("case", ["capacity", "dropless", "shared"])
def test_moe_fwd_matches_reference(case):
    """y, aux and the gradients of sum(y * r) + aux with respect to x and
    every weight leaf; for the capacity case also the routing: C = 4 of
    8 tokens a group, some dropped, the kept slots bitwise."""
    moe = {"capacity_factor": 1.0}
    if case == "shared":
        moe["num_shared_experts"] = 1
    rcfg, cfg = _configs(**moe)
    dropless = case == "dropless"
    rp = _weights(rcfg)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, S, rcfg.d_model)).astype(np.float32)
    r = rng.standard_normal(x.shape).astype(np.float32)

    def rloss(p, xx):
        y, aux = RL.moe_fwd(p, rcfg, xx, dropless=dropless)
        return jnp.sum(y * r) + aux, (y, aux)

    (_, (ry, raux)), (rgp, rgx) = jax.jit(jax.value_and_grad(
        rloss, argnums=(0, 1), has_aux=True))(rp, x)
    tree = params_from_numpy(rp)
    leaves = [t.clone().requires_grad_(True) for t in tree_leaves(tree)]
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = L.moe_fwd(tree_unflatten(tree, leaves), cfg, tx,
                       dropless=dropless)
    grads = torch.autograd.grad((y * torch.from_numpy(r)).sum() + aux,
                                leaves + [tx])
    _close(y.detach().numpy(), ry, f"{case} y")
    np.testing.assert_allclose(float(aux), float(raux), rtol=REL)
    _close(grads[-1].numpy(), rgx, f"{case} dx")
    paths = [p for p, _ in tree_leaves_with_path(tree)]
    rleaves = jax.tree_util.tree_leaves(rgp)
    assert len(rleaves) == len(grads) - 1
    for path, a, b in zip(paths, grads, rleaves):
        _close(a.numpy(), b, f"{case} d{path}")
    if case == "capacity":
        # the routing on the reference's probs: G = 32, C = 4, drops
        h = RL.rmsnorm(rp["norm"], x, rcfg.rms_norm_eps).reshape(-1,
                                                                rcfg.d_model)
        probs = np.asarray(jax.nn.softmax(h @ rp["router"]["w"], axis=-1))
        rg, rgsel, ridx = _ref_route(probs, rcfg.moe, False)
        gates, gsel, idx = L.moe_route(torch.from_numpy(probs), cfg.moe)
        assert tuple(gsel.shape) == (32, 4, 4)
        np.testing.assert_array_equal(gates.numpy(), rg)
        np.testing.assert_array_equal(gsel.numpy(), rgsel)
        np.testing.assert_array_equal(idx.numpy(), ridx)
        kept = (gsel > 0).sum().item()
        assert 0 < kept < (rg > 0).sum()           # some assignments drop


def test_moe_tied_gates_keep_the_lowest_tokens():
    """Router weights zero: every prob is 1/4, so every token takes
    experts 0 and 1 (the lower index first) with gate 0.5, and each of
    them keeps the first C = 4 tokens of every group of 8 (the lower
    token first), bitwise the reference's lax.top_k; experts 2 and 3 take
    none.  The output and the gradients match as in the untied case."""
    rcfg, cfg = _configs(capacity_factor=1.0)
    rp = _weights(rcfg, zero_router=True)
    x = np.random.default_rng(2).standard_normal(
        (B, S, rcfg.d_model)).astype(np.float32)
    probs = np.full((B * S, 4), 0.25, np.float32)
    rg, rgsel, ridx = _ref_route(probs, rcfg.moe, False)
    gates, gsel, idx = L.moe_route(torch.from_numpy(probs), cfg.moe)
    np.testing.assert_array_equal(gates.numpy(), rg)
    np.testing.assert_array_equal(idx.numpy(), ridx)
    np.testing.assert_array_equal(gsel.numpy(), rgsel)
    kept = gsel.numpy() > 0
    assert kept[:, :2].all() and not kept[:, 2:].any()
    np.testing.assert_array_equal(
        idx.numpy()[:, :2], np.broadcast_to(np.arange(4), (32, 2, 4)))
    # the same through moe_fwd: its router's softmax gives exactly 0.25
    ry, raux = jax.jit(lambda p, xx: RL.moe_fwd(p, rcfg, xx))(rp, x)
    tree = params_from_numpy(rp)
    y, aux = L.moe_fwd(tree, cfg, torch.from_numpy(x))
    _close(y.numpy(), ry, "tied y")
    np.testing.assert_allclose(float(aux), float(raux), rtol=REL)
    # a dropped token (position 4..7 of a group) gets no expert output:
    # the same value as with every expert weight zeroed
    zeroed = dict(tree, w_down=torch.zeros_like(tree["w_down"]))
    y0, _ = L.moe_fwd(zeroed, cfg, torch.from_numpy(x))
    dropped = (np.arange(B * S) % 8 >= 4).reshape(B, S)
    assert torch.equal(y[torch.from_numpy(dropped)],
                       y0[torch.from_numpy(dropped)])
    assert not torch.equal(y[torch.from_numpy(~dropped)],
                           y0[torch.from_numpy(~dropped)])


def test_expert_init_takes_the_reference_scale():
    """_dense_init((E, D, F)) takes fan_in = E, as the reference's does:
    the expert stacks draw with std 1/sqrt(E), slice by slice into the
    target dtype; the router is f32 whatever the model's dtype."""
    cfg = dataclasses.replace(get_arch("arctic-480b").reduced(),
                              dtype="bfloat16")
    p = L.init_moe(torch.Generator().manual_seed(0), cfg, torch.bfloat16,
                   "cpu", lead=(2,))
    E = cfg.moe.num_experts
    assert p["w_gate"].shape == (2, E, cfg.d_model, cfg.moe.d_ff_expert)
    assert p["w_gate"].dtype == torch.bfloat16
    assert p["router"]["w"].dtype == torch.float32
    for name in ("w_gate", "w_up", "w_down"):
        std = float(p[name].float().std())
        assert abs(std * E ** 0.5 - 1.0) < 0.02, (name, std)
    # each (block, expert) slice is a draw of its own
    assert not torch.equal(p["w_gate"][0, 0], p["w_gate"][0, 1])
    assert not torch.equal(p["w_gate"][0, 0], p["w_gate"][1, 0])
