"""The threshold EF pass (kernel K7's plain version) and the exact FMA
the port's EF momentum is built on, against the JAX reference, bitwise:
``ops.sparsify_ef`` against the reference's Pallas kernel in interpret
mode (all three outputs, NaN, ±inf and ±0 planted, ragged lengths), its
conservation and disjoint supports, ``ops.estimate_threshold``, and
``utils.fma_f32`` against ``jax.jit(m*u + g)``, which XLA contracts into
one fused multiply-add, on random data and on cases where a sum rounded
in f64 and then cast to f32 rounds twice and is wrong."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ROPS
from repro.kernels.sparsify_ef import TILE
from repro_torch.kernels import ops as OPS
from repro_torch.kernels import sparsify_ef as EF
from repro_torch.utils import fma_f32

E = 2.0 ** -23


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _inputs(n, seed):
    r = np.random.default_rng(seed)
    g = r.standard_normal(n).astype(np.float32)
    u = (r.standard_normal(n) * 0.1).astype(np.float32)
    v = (r.standard_normal(n) * 0.3).astype(np.float32)
    for x, off in ((g, 0), (u, 1), (v, 2)):
        x[off::1013] = np.nan
        x[off + 3::1019] = np.inf
        x[off + 5::1021] = -np.inf
        x[off + 7::97] = 0.0
        x[off + 9::89] = -0.0
    return g, u, v


@pytest.mark.parametrize("m", [0.0, 0.9])
@pytest.mark.parametrize("tau", [0.0, 0.5, 10.0])
@pytest.mark.parametrize("n", [TILE, 2 * TILE + 999, 4096 + 517])
def test_sparsify_ef_plain_matches_reference_kernel(n, tau, m):
    g, u, v = _inputs(n, n + int(10 * tau))
    ref = ROPS.sparsify_ef(jnp.asarray(g), jnp.asarray(u), jnp.asarray(v),
                           tau, m)
    ours = OPS.sparsify_ef(*(torch.from_numpy(x) for x in (g, u, v)), tau, m)
    for name, a, b in zip(("u_out", "v_out", "sent"), ours, ref):
        assert a.shape == (n,)
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b),
                                      err_msg=name)
    u_out, v_out, sent = (a.numpy() for a in ours)
    # conservation and disjoint supports, as the reference's property test
    # states them, on the finite coordinates: sent + v_out == v'
    v_acc = (torch.from_numpy(v)
             + fma_f32(m, torch.from_numpy(u), torch.from_numpy(g))).numpy()
    fin = np.isfinite(v_acc)
    np.testing.assert_array_equal(_bits((sent + v_out)[fin]),
                                  _bits(v_acc[fin] + 0.0))
    assert not np.any((sent != 0) & (v_out != 0))
    assert not np.any((sent != 0) & (u_out != 0))
    if tau == 0.0:                       # every non-NaN coordinate is sent
        assert not np.any(v_out[~np.isnan(v_acc)])
    assert np.isnan(v_out[np.isnan(v_acc)]).all()      # NaN never kept


@pytest.mark.parametrize("k", [1, 50, 3000, 10 ** 6])
@pytest.mark.parametrize("stride", [1, 32])
def test_estimate_threshold_matches_reference(k, stride):
    r = np.random.default_rng(k + stride)
    v = r.standard_normal(5000).astype(np.float32)
    v[::7] = np.round(v[::7])                          # tied magnitudes
    ours = OPS.estimate_threshold(torch.from_numpy(v), k, stride)
    ref = ROPS.estimate_threshold(jnp.asarray(v), k, stride)
    assert ours.shape == ()
    np.testing.assert_array_equal(_bits(ours.numpy()), _bits(ref))


def test_sparsify_ef_refuses_a_tensor_off_the_card():
    """For a tensor that is not on the CPU the wrapper never takes the
    plain version: a meta tensor (there is no card here) is refused."""
    g = torch.zeros(8, device="meta")
    with pytest.raises(ValueError):
        EF.sparsify_ef(g, g, g, 0.5, 0.9)


def _jit_fma(m, u, g):
    return np.asarray(jax.jit(lambda m, u, g: m * u + g)(
        np.float32(m), u, g))


@pytest.mark.parametrize("m", [0.9, 0.3, 1e-3, -1e-3])
def test_fma_f32_matches_jitted_reference(m):
    r = np.random.default_rng(int(abs(m) * 1000))
    u = r.standard_normal(1 << 20).astype(np.float32)
    g = (r.standard_normal(1 << 20) * r.choice([1e-6, 1.0, 1e3], 1 << 20)
         ).astype(np.float32)
    ours = fma_f32(m, torch.from_numpy(u), torch.from_numpy(g)).numpy()
    np.testing.assert_array_equal(_bits(ours), _bits(_jit_fma(m, u, g)))
    # rounding the product and the sum apart is not the same function
    assert (_bits(np.float32(m) * u + g) != _bits(ours)).any()


def test_fma_f32_double_rounding_cases():
    """m = 1 + 2^-23, u = ±2^-24(1 - 2^-23), g = ±(1 + 2^-23), ±(1 + 2^-22):
    the exact m·u + g lies just past a half-way point of f32 that its f64
    rounding lands on, so a plain f64 cast rounds it the wrong way."""
    m = 1 + E
    u = np.array([2 ** -24 * (1 - E), -2 ** -24 * (1 - E)] * 2, np.float32)
    g = np.array([1 + E, -(1 + E), 1 + 2 * E, -(1 + 2 * E)], np.float32)
    want = _jit_fma(m, u, g)
    ours = fma_f32(m, torch.from_numpy(u), torch.from_numpy(g)).numpy()
    np.testing.assert_array_equal(_bits(ours), _bits(want))
    naive = (u.astype(np.float64) * np.float64(np.float32(m))
             + g.astype(np.float64)).astype(np.float32)
    assert (_bits(naive) != _bits(want)).any()


def test_fma_f32_special_values():
    """Signed zeros, infinities, NaN and overflow.  (Subnormals are left
    out: XLA's CPU backend flushes them to zero, the card does not.)"""
    inf, nan = np.inf, np.nan
    u = np.array([inf, nan, 1, -0.0, 0.0, 3e38, 1e-30], np.float32)
    g = np.array([1, 1, -inf, -0.0, -0.0, 3e38, -1e-30], np.float32)
    for m in (0.9, 0.0, 2.0):
        want = _jit_fma(m, u, g)
        ours = fma_f32(m, torch.from_numpy(u), torch.from_numpy(g)).numpy()
        np.testing.assert_array_equal(np.isnan(ours), np.isnan(want))
        fin = ~np.isnan(want)
        np.testing.assert_array_equal(_bits(ours[fin]), _bits(want[fin]))
