"""The port's flash attention (``repro_torch.models.flash``) and
``layers.blockwise_attention`` against the JAX reference's on the CPU,
f32: the output and dq, dk, dv (through ``jax.vjp`` of the reference's
custom VJP) to 1e-5 of each one's largest entry, at lengths where the
reference's chunk rule gives one chunk, 8-row chunks, full chunks and,
at the prime 521, 1-row chunks (where the port pads); the skipped masked
chunk pairs against the loop that masks every pair, bitwise; and the
chunk rule's floor at every length."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import flash as ref_flash
from repro.models import layers as ref_layers
from repro_torch.models import flash
from repro_torch.models import layers as L

# port against reference, f32: the same products summed in another
# order (chunk sizes differ where the port pads); measured on the CPU
# 1.4e-7 to 1.1e-6 of the largest entry
REL = 1e-5


def _close(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(float(np.abs(b).max()), 1e-30)
    np.testing.assert_allclose(a, b, rtol=0, atol=REL * scale, err_msg=what)


def _inputs(S, H=4, KH=2, D=16, Dv=16, B=1, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KH, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KH, Dv)).astype(np.float32)
    do = rng.standard_normal((B, S, H, Dv)).astype(np.float32)
    return q, k, v, do


def _port(q, k, v, do, window):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    o = flash.flash_attention(qt, kt, vt, True, window)
    o.backward(torch.from_numpy(do))
    return o.detach(), qt.grad, kt.grad, vt.grad


# (S, window, H, KH, D, Dv): one chunk; the reference's 8-row query
# chunks (the port pads to 512); full chunks, causal and windowed; the
# prime 521 (reference: 1-row chunks); Dv != D; MHA (G = 1)
CASES = [(97, 0, 4, 2, 16, 16), (600, 0, 4, 2, 16, 16),
         (1536, 0, 4, 2, 16, 16), (1536, 300, 4, 2, 16, 16),
         (521, 0, 4, 2, 16, 16), (521, 100, 4, 2, 16, 8),
         (130, 0, 2, 2, 8, 8)]


@pytest.mark.parametrize("S,window,H,KH,D,Dv", CASES)
def test_flash_matches_reference(S, window, H, KH, D, Dv):
    q, k, v, do = _inputs(S, H, KH, D, Dv)
    o, dq, dk, dv = _port(q, k, v, do, window)
    ro, vjp = jax.vjp(lambda a, b, c: ref_flash.flash_attention(
        a, b, c, True, window), q, k, v)
    rdq, rdk, rdv = vjp(jnp.asarray(do))
    assert o.shape == (1, S, H, Dv) and o.dtype == torch.float32
    _close(o, ro, "o")
    _close(dq, rdq, "dq")
    _close(dk, rdk, "dk")
    _close(dv, rdv, "dv")


@pytest.mark.parametrize("S,window", [(600, 0), (1536, 300), (2100, 700)])
def test_skipped_pairs_equal_the_masked_loop(S, window, monkeypatch):
    """Skipping the pairs the mask hides, and the mask of the pairs it
    hides nothing of, gives the same bits as masking every pair."""
    q, k, v, do = _inputs(S, seed=1)
    want = _port(q, k, v, do, window)
    monkeypatch.setattr(flash, "_pair", lambda *a: flash.PARTLY)
    got = _port(q, k, v, do, window)
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        assert torch.equal(a, b), name


def test_bf16_inputs_keep_their_dtype():
    q, k, v, do = _inputs(200, seed=2)
    qt, kt, vt = (torch.from_numpy(x).bfloat16().requires_grad_(True)
                  for x in (q, k, v))
    o = flash.flash_attention(qt, kt, vt)
    o.backward(torch.from_numpy(do).bfloat16())
    assert o.dtype == qt.grad.dtype == kt.grad.dtype == vt.grad.dtype \
        == torch.bfloat16
    ref = flash.flash_attention(*(t.detach().float() for t in (qt, kt, vt)))
    assert (o.float() - ref).abs().max() <= 2 ** -7 * ref.abs().max()


def test_chunk_rule_floor():
    """No chunk under MIN_CHUNK rows at any length (unless it is the
    whole length); the reference's rule where it gives at least that;
    padded lengths are multiples of the chunk and short by less than
    one chunk."""
    for n in list(range(1, 4200)) + [32768, 32769, 65537]:
        cq, ck, qp, kp = flash.chunk_plan(n, n)
        rq, rk = flash._chunks(n, n)
        assert cq >= min(n, flash.MIN_CHUNK) and ck >= min(n,
                                                           flash.MIN_CHUNK)
        assert qp % cq == 0 and kp % ck == 0
        assert n <= qp < n + cq and n <= kp < n + ck
        if rq >= min(n, flash.MIN_CHUNK):
            assert (cq, qp) == (rq, n)
        if rk >= min(n, flash.MIN_CHUNK):
            assert (ck, kp) == (rk, n)
    assert flash._chunks(521, 521) == (1, 521)
    assert flash.chunk_plan(521, 521) == (512, 521, 1024, 521)
    assert flash._chunks(4097, 4097) == (1, 1)
    assert flash.chunk_plan(4097, 4097) == (512, 1024, 4608, 5120)
    assert flash.chunk_plan(32769, 32769) == (512, 1024, 33280, 33792)


@pytest.mark.parametrize("causal,window,Sq,Sk,Dv", [
    (True, 0, 40, 40, 16), (True, 24, 40, 40, 16), (False, 0, 24, 56, 8),
    (True, 0, 600, 600, 16)])
def test_blockwise_attention_with_positions_matches_reference(
        causal, window, Sq, Sk, Dv):
    """Explicit positions (queries at the end of a longer key range, as
    a chunk of a prompt sees its prefix), Dv != D once."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, Sq, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, Sk, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, Sk, 2, Dv)).astype(np.float32)
    qpos = np.arange(Sk - Sq, Sk, dtype=np.int32)
    kpos = np.arange(Sk, dtype=np.int32)
    ro = ref_layers.blockwise_attention(
        q, k, v, causal=causal, window=window, q_positions=jnp.asarray(qpos),
        kv_positions=jnp.asarray(kpos))
    o = L.blockwise_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=causal,
        window=window, q_positions=torch.from_numpy(qpos).long(),
        kv_positions=torch.from_numpy(kpos).long())
    assert o.shape == (2, Sq, 4, Dv)
    _close(o, ro, "o")
    ro = ref_layers.blockwise_attention(q[:, :Sq], k[:, :Sq], v[:, :Sq],
                                        causal=causal, window=window)
    o = L.blockwise_attention(
        *(torch.from_numpy(x[:, :Sq]) for x in (q, k, v)), causal=causal,
        window=window)
    _close(o, ro, "o, default positions")
