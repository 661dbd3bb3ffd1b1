"""The packed sparse wire's arithmetic against the JAX reference, on the
CPU and bitwise: the plain versions of K5a/K5b (``pack_bits``,
``unpack_bits``, the latter also on a (B, width, W) stack, row by row)
and K4 (``quantize_pack``) against ``repro.kernels.bitpack`` in
interpret mode, the int8 quantizer against
the jitted ``repro.dist.quantize`` (the reference runs it under ``jit``),
and every codec payload and decoded pair against the jitted
``repro.dist.packed``."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist import packed as RPK
from repro.dist import quantize as RQ
from repro.kernels import bitpack as RBP
from repro_torch.dist import packed as PK
from repro_torch.dist import quantize as Q
from repro_torch.kernels import bitpack as BP

# all-tail (< 128 words), and whole 128-word tiles plus a tail
ALL_WIDTH_K = (33, 32 * 128 * 2 + 5)
# one value, under and at one word column, one tile plus a tail
SOME_WIDTH_K = (1, 31, 32, 4096 + 7)


def _ints(kind, k, width, seed):
    r = np.random.default_rng(seed)
    if kind == "random":
        return r.integers(0, 2 ** width, k).astype(np.int32)
    if kind == "max":
        return np.full(k, 2 ** width - 1, np.int32)
    return np.zeros(k, np.int32)


def _bits(a):
    """Arrays compared by their bits (f32 through int32)."""
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _equal(ours, ref, what=""):
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else ours
    assert ours.shape == np.asarray(ref).shape, (what, ours.shape)
    np.testing.assert_array_equal(_bits(ours), _bits(ref), err_msg=what)


# a gathered table: B stacked payloads of random words, unpacked in one call
BATCHED_K = (1, 33, 4096 + 7)
BATCHED = [pytest.param(w, b, id=f"{w}-batch{b}") for w in (1, 16, 31)
           for b in (1, 3)]


@pytest.mark.parametrize(
    "width,batch",
    [pytest.param(w, 0, id=str(w)) for w in range(1, BP.MAX_WIDTH + 1)]
    + BATCHED)
def test_pack_unpack_match_reference(width, batch):
    if batch:
        for k in BATCHED_K:
            r = np.random.default_rng(width * 100 + batch * 10 + k)
            words = r.integers(-2 ** 31, 2 ** 31, (batch, width,
                                                   BP.word_count(k)),
                               dtype=np.int64).astype(np.int32)
            back = BP.unpack_bits(torch.from_numpy(words), k)
            assert back.shape == (batch, k)
            for i in range(batch):
                _equal(back[i].contiguous(),
                       RBP.unpack_bits(jnp.asarray(words[i]), k),
                       f"unpack {width} {k} row {i} of {batch}")
        return
    ks = ALL_WIDTH_K + (SOME_WIDTH_K if width in (1, 16, 29, 31) else ())
    for k in ks:
        for kind in ("random", "zeros", "max"):
            x = _ints(kind, k, width, width * 1000 + k)
            words = BP.pack_bits(torch.from_numpy(x), width)
            rwords = RBP.pack_bits(jnp.asarray(x), width)
            _equal(words, rwords, f"pack {width} {k} {kind}")
            assert words.shape == (width, BP.word_count(k))
            back = BP.unpack_bits(words, k)
            _equal(back, RBP.unpack_bits(rwords, k),
                   f"unpack {width} {k} {kind}")
            _equal(back, x)


def test_pack_layout_is_the_reference_row_major_reshape():
    """Word j of plane b gathers bit b of values j, W + j, 2W + j, ...:
    the (32, W) row-major reshape, not 32 consecutive values."""
    k, W = 100, 4
    x = np.zeros(k, np.int32)
    x[W + 2] = 1                                  # row 1, column 2
    words = BP.pack_bits(torch.from_numpy(x), 1).numpy()
    assert words.tolist() == [[0, 0, 2, 0]]
    assert (np.asarray(RBP.pack_bits(jnp.asarray(x), 1)) == words).all()


def _qp_inputs(k, seed):
    """Values with NaN/±Inf, an all-zero block, exact .5 ties of a scale
    of 1.0, and random 16-bit low index bits."""
    r = np.random.default_rng(seed)
    v = r.standard_normal(k).astype(np.float32)
    v[::97] = np.nan
    v[5::101] = np.inf
    v[7::103] = -np.inf
    if k >= 512:
        v[256:512] = 0.0
    if k >= 1024:
        v[768:812] = np.arange(-22, 22, dtype=np.float32) + 0.5
        v[812] = 127.0
    return v, r.integers(0, 2 ** 16, k).astype(np.int32)


@pytest.mark.parametrize("k", [1, 255, 256, 257, 1000, 1300])
@pytest.mark.parametrize("scale_block", [256, 64])
def test_quantize_pack_matches_reference(k, scale_block):
    v, lo = _qp_inputs(k, k)
    ours = BP.quantize_pack(torch.from_numpy(v), torch.from_numpy(lo), 16,
                            scale_block, Q._EPS)
    ref = RBP.quantize_pack(jnp.asarray(v), jnp.asarray(lo), 16,
                            scale_block, RQ._EPS)
    for name, a, b in zip(("words", "q", "scales"), ours, ref):
        _equal(a, b, name)


@pytest.mark.parametrize("scale_block", [256, 64])
def test_quantize_i8_matches_the_jitted_reference(scale_block):
    """quantize_i8, dequantize_i8 and fake_quantize bitwise against the
    jitted reference; the eager reference divides its scales by 127 and
    differs from both in the last bit of some scales."""
    v, _ = _qp_inputs(256 * 64 + 3, 1)
    v[np.isnan(v)] = 0.5                  # a NaN reaches the same 0 either way
    x = jnp.asarray(v)
    q, s = Q.quantize_i8(torch.from_numpy(v), scale_block)
    rq, rs = jax.jit(RQ.quantize_i8, static_argnums=1)(x, scale_block)
    _equal(q, rq, "q")
    _equal(s, rs, "scales")
    n = v.shape[0]
    _equal(Q.dequantize_i8(q, s, n),
           jax.jit(RQ.dequantize_i8, static_argnums=2)(rq, rs, n), "deq")
    _equal(Q.fake_quantize(torch.from_numpy(v), scale_block),
           jax.jit(RQ.fake_quantize, static_argnums=1)(x, scale_block),
           "fake_quantize")
    _, eager_s = RQ.quantize_i8(x, scale_block)
    assert (_bits(eager_s) != _bits(rs)).any()
    assert Q.wire_nbytes(n, scale_block) == RQ.wire_nbytes(n, scale_block)


def _pairs(n, k, n_sentinel, seed):
    """k unsorted pairs over [0, n], the last n_sentinel indices n."""
    r = np.random.default_rng(seed)
    idx = np.concatenate([r.choice(n, k - n_sentinel, replace=False),
                          np.full(n_sentinel, n)]).astype(np.int32)
    idx = idx[r.permutation(k)]
    vals = (r.standard_normal(k) * 1e-3).astype(np.float32)
    return vals, idx


# (n, k, sentinels): small; the raw-index fallback (k of a handful); a
# plan with n > 2^24 (the path's n, 29-bit indices); a single pair
CODEC_CASES = [(1000, 50, 3), (1_000_000, 3, 1), (505_956_352, 3000, 5),
               (100, 1, 0)]


@pytest.mark.parametrize("n,k,n_sentinel", CODEC_CASES)
def test_codec_matches_reference(n, k, n_sentinel):
    vals, idx = _pairs(n, k, n_sentinel, k)
    plan, rplan = PK.make_plan(n, k), RPK.make_plan(n, k)
    assert plan.raw_index == rplan.raw_index
    if k == 3:
        assert plan.raw_index
    if n > 2 ** 24:
        assert plan.width == 29 and not plan.raw_index
    tv, ti = torch.from_numpy(vals), torch.from_numpy(idx)
    jv, ji = jnp.asarray(vals), jnp.asarray(idx)

    def rjit(fn):
        return jax.jit(functools.partial(fn, plan=rplan))

    for enc, renc in ((PK.encode_sparse_fused, RPK.encode_sparse_fused),
                      (PK.encode_sparse, RPK.encode_sparse)):
        payload = enc(tv, ti, plan)
        rpayload = rjit(renc)(jv, ji)
        assert len(payload) == len(rpayload) == (3 if plan.raw_index else 4)
        for i, (a, b) in enumerate(zip(payload, rpayload)):
            _equal(a, b, f"{enc.__name__} payload[{i}]")
        dv, di = PK.decode_sparse(payload, plan)
        rdv, rdi = rjit(RPK.decode_sparse)(rpayload)
        _equal(dv, rdv, "decoded vals")
        _equal(di, rdi, "decoded idx")
        _equal(di, np.sort(idx))
    idx_s = np.sort(idx)
    ipay = PK.encode_indices(torch.from_numpy(idx_s), plan)
    ripay = rjit(RPK.encode_indices)(jnp.asarray(idx_s))
    for a, b in zip(ipay, ripay):
        _equal(a, b, "index payload")
    _equal(PK.decode_indices(ipay, plan), idx_s)
    fv, fi = PK.fake_roundtrip(tv, ti)
    rfv, rfi = jax.jit(RPK.fake_roundtrip)(jv, ji)
    _equal(fv, rfv, "fake_roundtrip vals")
    _equal(fi, rfi, "fake_roundtrip idx")


def test_checksum_plans_wait_for_the_guard():
    """A checksum plan's round trip (the test's name is from before the
    guard was ported): the index and pair payloads carry one more int32
    word, equal to the reference's, and decode as without it."""
    plan = PK.make_plan(1000, 50, checksum=True)
    idx = torch.arange(0, 1000, 20, dtype=torch.int32)
    vals = torch.linspace(-1.0, 1.0, 50)
    ipay = PK.encode_indices(idx, plan)
    pay = PK.encode_sparse(vals, idx, plan)
    assert ipay[-1].shape == pay[-1].shape == (1,)
    assert sum(a.numel() * a.element_size() for a in pay) \
        == PK.wire_nbytes(plan)
    rplan = RPK.make_plan(1000, 50, checksum=True)
    rpay = jax.jit(functools.partial(RPK.encode_sparse, plan=rplan))(
        jnp.asarray(vals.numpy()), jnp.asarray(idx.numpy()))
    for a, b in zip(pay, rpay):
        _equal(a, b, "checksum payload")
    _equal(PK.decode_indices(ipay, plan), idx.numpy())
    dv, di = PK.decode_sparse(pay, plan)
    _equal(di, idx.numpy())
    _equal(dv, jax.jit(functools.partial(RPK.decode_sparse, plan=rplan))(
        rpay)[0])
