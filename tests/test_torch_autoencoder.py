"""The port's LGC autoencoder against the JAX reference, on carried
weights: encode, decode, the RAR loss and its gradients (to 1e-5), the
kernel-backed encoder's plain path, and the plain fused matmul against
the Pallas kernel in interpret mode.  The hazards: lax's asymmetric SAME
pad of the stride-2 convs, and lax.conv_transpose not flipping its
kernel."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import autoencoder as RAE
from repro.kernels import ops as ROPS
from repro.kernels.matmul_lrelu import matmul_bias_lrelu as ref_matmul
from repro_torch.core import autoencoder as AE
from repro_torch.kernels import matmul_lrelu as MM
from repro_torch.kernels import ops
from repro_torch.utils.convert import ae_from_numpy
from repro_torch.utils.tree import tree_leaves, tree_unflatten

TOL = dict(rtol=1e-5, atol=1e-5)


@functools.lru_cache(maxsize=1)
def _ref_ae():
    ae = RAE.init_lgc_autoencoder(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, ae)


def _g(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("L", [64, 256, 4096])
def test_encode_decode_match_reference(L):
    ref_ae, ae = _ref_ae(), ae_from_numpy(_ref_ae())
    g = _g((2, L), L)
    z = AE.lgc_encode(ae, torch.from_numpy(g))
    rz = jax.jit(RAE.lgc_encode)(ref_ae, jnp.asarray(g))
    assert tuple(z.shape) == (2, L // 16, 4)
    np.testing.assert_allclose(z.numpy(), np.asarray(rz), **TOL)
    zm = z.mean(0, keepdim=True)
    rec = AE.lgc_decode_rar(ae, zm)
    rrec = jax.jit(RAE.lgc_decode_rar)(ref_ae, jnp.asarray(zm.numpy()))
    assert tuple(rec.shape) == (1, L)
    np.testing.assert_allclose(rec.numpy(), np.asarray(rrec), **TOL)


@pytest.mark.parametrize("K,L", [(2, 256), (4, 1024)])
def test_ae_loss_rar_and_grads_match_reference(K, L):
    ref_ae, ae = _ref_ae(), ae_from_numpy(_ref_ae())
    g = _g((K, L), 7 * K) * 0.01
    leaves = [p.clone().requires_grad_(True) for p in tree_leaves(ae)]
    loss = AE.ae_loss_rar(tree_unflatten(ae, leaves), torch.from_numpy(g))
    grads = torch.autograd.grad(loss, leaves)
    rloss, rgrads = jax.jit(jax.value_and_grad(RAE.ae_loss_rar))(ref_ae,
                                                        jnp.asarray(g))
    np.testing.assert_allclose(loss.item(), float(rloss), rtol=1e-5)
    rleaves = jax.tree_util.tree_leaves(rgrads)
    assert len(rleaves) == len(grads)
    for a, b in zip(grads, rleaves):
        scale = max(float(np.abs(np.asarray(b)).max()), 1e-12)
        np.testing.assert_allclose(a.numpy() / scale, np.asarray(b) / scale,
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("L", [64, 1184])
def test_lgc_encode_fast_matches_reference_encode(L):
    ref_ae, ae = _ref_ae(), ae_from_numpy(_ref_ae())
    g = _g((L,), L)
    z = ops.lgc_encode_fast(ae, torch.from_numpy(g))
    np.testing.assert_allclose(z.numpy(),
                               np.asarray(RAE.lgc_encode(ref_ae, g)[0]),
                               **TOL)


@pytest.mark.parametrize("L,k,s", [(64, 3, 2), (37, 3, 2), (20, 1, 1)])
def test_im2col_matches_reference(L, k, s):
    x = _g((L, 5), L)
    np.testing.assert_array_equal(
        ops._im2col_1d(torch.from_numpy(x), k, s).numpy(),
        np.asarray(ROPS._im2col_1d(jnp.asarray(x), k, s)))


@pytest.mark.parametrize("apply_lrelu", [True, False])
def test_plain_matmul_matches_pallas_kernel(apply_lrelu):
    """The plain version of the CUDA fused matmul against the reference's
    Pallas kernel in interpret mode, at one 128-multiple shape: to 1e-5 of
    the largest output (f32 sums of 256 products in another order)."""
    x, w, b = _g((128, 256), 1), _g((256, 128), 2), _g((128,), 3)
    y = MM.matmul_bias_lrelu(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(b), apply_lrelu)
    ry = ref_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                    apply_lrelu=apply_lrelu)
    ry = np.asarray(ry)
    np.testing.assert_allclose(y.numpy(), ry, rtol=0,
                               atol=1e-5 * np.abs(ry).max())
