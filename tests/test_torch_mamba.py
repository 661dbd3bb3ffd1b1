"""The port's Mamba2 block (``models.mamba2``) against the JAX reference's
at mamba2-130m's smoke config (f32: d_model 256, 16 heads of 32, d_state
16, chunk 32), with the reference's ``init_mamba`` weights carried
across: ``ssd_chunked`` and its gradients at a length the chunk divides
and at S = 97, where the reference's rule gives 1-row chunks and the
port pads to its chunk instead; ``mamba_fwd`` and its gradients; the
prefill state against the reference's ``_mamba_fwd_with_state`` /
``_ssd_with_state``; decode steps from it.  Port only: the chunk plan,
and decode after a 2-token prompt (shorter than d_conv - 1 = 3, where
the reference's forward fails) equal to a 3-token prefill."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _one_thread import one_thread  # noqa: F401  (autouse)
from repro.configs import get_arch as ref_get_arch
from repro.models import mamba2 as RM2
from repro.models import model as RMOD
from repro_torch.configs import get_arch
from repro_torch.models import mamba2 as M
from repro_torch.models.model import build_model
from repro_torch.utils.convert import params_from_numpy
from repro_torch.utils.tree import tree_leaves, tree_leaves_with_path, \
    tree_unflatten

# port against reference, f32: sums in another order (measured on the
# CPU: outputs, states and decode <= 2.7e-6 of the largest entry, the
# gradients but the decay's <= 3.0e-6)
REL = 1e-5
# the gradient of the decay (A, A_log): a sum over every row of terms
# scaled by the cumulative dt, which cancel.  Two f32 evaluations of it
# differ by more than 1e-5: at mamba2-130m's smoke config the reference's
# own f32 A_log gradient is 1.2e-5 of the largest entry from an f64
# evaluation of the same function, the port's 1.5e-5; measured here
# port against reference: dA 1.2e-5 at S = 97, dA_log 2.4e-5
DECAY_REL = 5e-5



def _close(a, b, what, rel=REL):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(float(np.abs(b).max()), 1e-30)
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * scale, err_msg=what)


def _cfgs():
    return ref_get_arch("mamba2-130m").reduced(), \
        get_arch("mamba2-130m").reduced()


def _ssd_inputs(S, seed=0, b=2, H=16, P=32, N=16):
    r = np.random.default_rng(seed)
    f = np.float32
    x = r.standard_normal((b, S, H, P)).astype(f)
    dt = np.log1p(np.exp(r.standard_normal((b, S, H)))).astype(f)
    A = -np.exp(r.uniform(0.0, np.log(16.0), H)).astype(f)
    B = r.standard_normal((b, S, N)).astype(f)
    C = r.standard_normal((b, S, N)).astype(f)
    D = r.standard_normal(H).astype(f)
    return [x, dt, A, B, C, D]


def test_chunk_plan():
    """The reference's Q where it is >= min(chunk, 64) rows or the whole
    length; else the chunk, with S padded up to a multiple of it."""
    assert M.chunk_plan(64, 32) == (32, 64)
    assert M.chunk_plan(20, 32) == (20, 20)         # the whole length
    assert M.chunk_plan(97, 32) == (32, 128)        # the reference: Q = 1
    assert M.chunk_plan(2048, 256) == (256, 2048)
    assert M.chunk_plan(4097, 256) == (256, 4352)   # the reference: Q = 1
    assert M.chunk_plan(32769, 256) == (256, 33024)
    assert M.chunk_plan(1152, 256) == (128, 1152)   # the reference's 128
    assert M.chunk_plan(1056, 256) == (256, 1280)   # its 32 < 64: padded


@pytest.mark.parametrize("S", [64, 97])
def test_ssd_chunked_matches_reference(S):
    """y and the gradients of sum(y * r) with respect to x, dt, A, B, C,
    D; at S = 97 against the reference's 97 one-row chunks."""
    args = _ssd_inputs(S)
    r = np.random.default_rng(1).standard_normal(args[0].shape).astype(
        np.float32)
    ry, vjp = jax.vjp(lambda *a: RM2.ssd_chunked(*a, chunk=32), *args)
    rgrads = vjp(jnp.asarray(r))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y = M.ssd_chunked(*ts, chunk=32)
    grads = torch.autograd.grad((y * torch.from_numpy(r)).sum(), ts)
    _close(y.detach().numpy(), ry, f"S {S} y")
    for name, a, b in zip(("x", "dt", "A", "B", "C", "D"), grads, rgrads):
        _close(a.numpy(), b, f"S {S} d{name}",
               DECAY_REL if name == "A" else REL)


def _block_weights(rcfg):
    return jax.tree_util.tree_map(np.asarray, RM2.init_mamba(
        jax.random.PRNGKey(0), rcfg, jnp.float32))


def test_mamba_fwd_matches_reference():
    """The block's output and the gradients of x and every weight leaf
    at S = 97 (the padded SSD)."""
    rcfg, cfg = _cfgs()
    rp = _block_weights(rcfg)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 97, rcfg.d_model)).astype(np.float32)
    r = rng.standard_normal(x.shape).astype(np.float32)
    ry, vjp = jax.vjp(lambda p, xx: RM2.mamba_fwd(p, rcfg, xx), rp, x)
    rgp, rgx = vjp(jnp.asarray(r))
    tree = params_from_numpy(rp)
    leaves = [t.clone().requires_grad_(True) for t in tree_leaves(tree)]
    tx = torch.from_numpy(x).requires_grad_(True)
    y = M.mamba_fwd(tree_unflatten(tree, leaves), cfg, tx)
    grads = torch.autograd.grad((y * torch.from_numpy(r)).sum(),
                                leaves + [tx])
    _close(y.detach().numpy(), ry, "y")
    _close(grads[-1].numpy(), rgx, "dx")
    paths = [p for p, _ in tree_leaves_with_path(tree)]
    for path, a, b in zip(paths, grads, jax.tree_util.tree_leaves(rgp)):
        _close(a.numpy(), b, f"d{path}",
               DECAY_REL if path[-1] == "A_log" else REL)


@pytest.mark.parametrize("S", [24, 97])
def test_prefill_state_and_decode_match_reference(S):
    """mamba_fwd(with_state=True) against the reference's
    _mamba_fwd_with_state (output, the conv state, the SSM state of its
    _ssd_with_state), then 3 mamba_decode steps from that state, each
    output and the final state."""
    rcfg, cfg = _cfgs()
    rp = _block_weights(rcfg)
    x = np.random.default_rng(3).standard_normal(
        (2, S + 3, rcfg.d_model)).astype(np.float32)
    ry, rst = RMOD._mamba_fwd_with_state(rp, rcfg, x[:, :S])
    tree = params_from_numpy(rp)
    with torch.no_grad():
        y, st = M.mamba_fwd(tree, cfg, torch.from_numpy(x[:, :S]),
                            with_state=True)
    _close(y.numpy(), ry, "prefill y")
    _close(st["conv"].numpy(), rst["conv"], "conv state")
    _close(st["ssm"].numpy(), rst["ssm"], "ssm state")
    rcache = rst
    for pos in range(S, S + 3):
        ry, rcache = RM2.mamba_decode(rp, rcfg, x[:, pos:pos + 1], rcache,
                                      pos)
        with torch.no_grad():
            y, st = M.mamba_decode(tree, cfg,
                                   torch.from_numpy(x[:, pos:pos + 1]), st)
        _close(y.numpy(), ry, f"decode at {pos}")
    _close(st["conv"].numpy(), rcache["conv"], "conv after decode")
    _close(st["ssm"].numpy(), rcache["ssm"], "ssm after decode")


def test_decode_after_a_two_token_prompt():
    """A prompt of 2 tokens (< d_conv - 1 = 3): the port pads the conv
    input with 3 zero rows and keeps the padded input's last 3 as the
    state, so decoding the third token gives a 3-token prefill's logits
    (f32: the recurrent and the chunked forms sum in another order,
    within 1e-5 of the largest logit).  The reference pads with
    xBC[:, :3], which has 2 rows here, so its forward fails."""
    _, cfg = _cfgs()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(5))
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 3)))
    with torch.no_grad():
        _, cache = model.prefill(params, {"tokens": toks[:, :2]})
        assert cache["p0"]["conv"].shape[2] == cfg.ssm.d_conv - 1
        assert not cache["p0"]["conv"][:, :, 0].any()      # the zero pad
        logits, _ = model.decode_step(params, cache, toks[:, 2:], 2)
        full, _ = model.prefill(params, {"tokens": toks})
    _close(logits.numpy(), full.numpy(), "decode vs 3-token prefill")
    rcfg = ref_get_arch("mamba2-130m").reduced()
    with pytest.raises(TypeError, match="cannot reshape"):
        RMOD._mamba_fwd_with_state(_block_weights(rcfg), rcfg,
                                   np.zeros((1, 2, rcfg.d_model), np.float32))
