"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card.  A CUDA kernel has no CPU mode, so every test here
is marked ``cuda`` and skips on a machine without an NVIDIA GPU.  On one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The file imports no JAX: the machine with the card need not have it.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import autoencoder as AE
from repro_torch.core import sparsify as SP
from repro_torch.dist import packed as PK
from repro_torch.dist import quantize as Q
from repro_torch.kernels import LAUNCHES, ops
from repro_torch.kernels import bitpack as BP
from repro_torch.kernels import block_topk as BT
from repro_torch.kernels import matmul_lrelu as MM
from repro_torch.kernels import segmented_topk as ST
from repro_torch.kernels import sparsify_ef as EF

pytestmark = pytest.mark.cuda

ROLES = (SP.ROLE_COMPRESSED, SP.ROLE_TOPK_ONLY)
# "odd": leaves of odd sizes, so blocks hold several slot pieces and leaf
# boundaries fall anywhere, with unselectable runs inside a block; "big_k":
# one sweep block (131072) longer than the vector, so the one block is
# ragged and spans ten 8192-word radix tiles; "tiles": loop blocks of
# 54272 words (6.6 tiles, as the main path's loop rule gives) and a ragged
# last block; "tiny": hundreds of one- and two-element slot pieces in a
# block, more than the 256 slot ids the cap walk ranks per digit, so one
# warp ranks them; "wide_embed": whole blocks (the ragged last one too)
# with no selectable element
TREES = {
    "odd": ({"embed": {"w": (300, 7)}, "block1": {"w": (1000, 37),
                                                  "b": (13,)},
             "block2": {"w": (777, 53)}, "fc": {"w": (129, 71)}}, 0.05),
    "big_k": ({"embed": {"w": (16,)}, "mid": {"w": (81920,)},
               "fc": {"w": (37,)}}, 0.25),
    "tiles": ({"embed": {"w": (64,)}, "mid": {"w": (135680,)},
               "fc": {"w": (1000,)}}, 0.05),
    "tiny": ({"embed": {"w": (300,)},
              **{f"l{i:03d}": {"w": (1 + i % 2,)} for i in range(700)},
              "fc": {"w": (5,)}}, 0.5),
    "wide_embed": ({"embed": {"w": (5000, 3)}, "block": {"w": (300, 11)}},
                   0.05),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _layout(which):
    shapes, sparsity = TREES[which]
    tree = {k: {n: torch.zeros(s, device="meta") for n, s in d.items()}
            for k, d in shapes.items()}
    return SP.build_layout(tree, sparsity)


# bit patterns of the "special" kind: NaNs of several payloads and signs,
# +-inf, +-0.0, subnormals (the smallest, a middle one, the largest)
SPECIAL_BITS = np.array([0x7FC00000, 0xFFC00000, 0x7F800001, 0xFFFFFFFF,
                         0x7F800000, 0xFF800000, 0x00000000, 0x80000000,
                         0x00000001, 0x80000001, 0x00012345, 0x807FFFFF],
                        dtype=np.uint32)


def _vec(kind, n, seed, dev):
    r = np.random.default_rng(seed)
    if kind == "normal":
        x = r.standard_normal(n)
    elif kind == "ties":                       # nearly every magnitude tied
        x = r.integers(-2, 3, n)
    elif kind == "special":                    # a third of them special
        x = r.standard_normal(n).astype(np.float32)
        at = r.random(n) < 1 / 3
        x[at] = SPECIAL_BITS[r.integers(0, len(SPECIAL_BITS),
                                        int(at.sum()))].view(np.float32)
    else:
        x = np.zeros(n)
    return torch.from_numpy(x.astype(np.float32)).to(dev)


def _same_bits(a, b):
    """Equal as bits: f32 through their int32 views, so NaN payloads,
    +-0.0 and subnormals count."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


@pytest.mark.parametrize("which", sorted(TREES))
@pytest.mark.parametrize("extract", ["loop", "bitonic"])
@pytest.mark.parametrize("kind", ["normal", "ties", "zeros", "special"])
@pytest.mark.parametrize("use_momentum", [True, False])
def test_fused_ef_topk_kernel_is_bitwise_its_plain_version(
        card, which, extract, kind, use_momentum):
    """Every output as bits, u' NaN payloads aside: the card's FMA returns
    its canonical NaN (0x7fffffff), the plain version's exact FMA (f64
    operations) another NaN in the same places.  v' is a sum on the card
    on both sides, so its NaNs, and the candidates', are equal bits."""
    layout = _layout(which)
    _, block, seg, kcap, n_cand, _ = SP._fused_meta(layout, ROLES, extract)
    n = layout.n_total
    g, u, v = (_vec(kind, n, 10 * i + 1, card) for i in range(3))
    seg_t, kcap_t = (torch.from_numpy(a).to(card) for a in (seg, kcap))
    args = (g, u, v, seg_t, kcap_t, 0.9, use_momentum, n_cand, block)
    before = LAUNCHES["fused_ef_topk"]
    out = EF.sparsify_ef_topk(*args)
    torch.cuda.synchronize()
    assert LAUNCHES["fused_ef_topk"] == before + 1
    plain = EF.sparsify_ef_topk_plain(*args)
    nan = out[0].isnan()
    assert torch.equal(nan, plain[0].isnan())
    assert _same_bits(out[0][~nan], plain[0][~nan]), "u"
    for name, a, b in zip(("v", "vals", "idx", "seg"), out[1:], plain[1:]):
        assert _same_bits(a, b), name


@pytest.mark.parametrize("which", sorted(TREES))
@pytest.mark.parametrize("extract", ["loop", "bitonic"])
@pytest.mark.parametrize("kind", ["normal", "ties", "zeros", "special"])
def test_segmented_topk_kernel_is_bitwise_its_plain_version(
        card, which, extract, kind):
    layout = _layout(which)
    _, block, seg, kcap, n_cand, _ = SP._fused_meta(layout, ROLES, extract)
    x = _vec(kind, layout.n_total, 7, card)
    seg_t, kcap_t = (torch.from_numpy(a).to(card) for a in (seg, kcap))
    before = LAUNCHES["segmented_topk"]
    out = ST.segmented_topk(x, seg_t, kcap_t, n_cand, block)
    torch.cuda.synchronize()
    assert LAUNCHES["segmented_topk"] == before + 1
    plain = ST.segmented_topk_plain(x, seg_t, kcap_t, n_cand, block)
    for name, a, b in zip(("vals", "idx", "seg"), out, plain):
        assert _same_bits(a, b), name


# (n_blocks, block, kb): a small k; the whole block; blocks of several
# 8192-word tiles, just above a power of two and at the path's leaf shapes,
# cut to a few blocks; the largest block the wrapper takes; kb = 1; and
# blocks that are not a multiple of the radix sort's 8192-word tile, inside
# one tile and across two
BLOCK_SHAPES = [(4, 256, 8), (5, 384, 384), (3, 8192, 4194),
                (2, 16896, 16777), (2, 67200, 67109), (2, 131072, 131072),
                (3, 8192, 1), (3, 4096 + 384, 2000), (3, 8192 + 384, 2000)]


@pytest.mark.parametrize("nb,block,kb", BLOCK_SHAPES)
@pytest.mark.parametrize("kind", ["normal", "ties", "zeros", "special"])
def test_block_topk_kernel_is_bitwise_its_plain_version(card, nb, block, kb,
                                                        kind):
    """Values compared as bits, so NaNs (payloads too), +-0.0 and
    subnormals count: both versions copy x's bits."""
    x = _vec(kind, nb * block, nb + block, card).view(nb, block)
    before = LAUNCHES["block_topk"]
    out = BT.block_topk(x, kb)
    torch.cuda.synchronize()
    assert LAUNCHES["block_topk"] == before + 1
    vals, idx = BT.block_topk_plain(x, kb)
    assert torch.equal(out[0].view(torch.int32), vals.view(torch.int32))
    assert torch.equal(out[1], idx)


@pytest.mark.parametrize("which", sorted(TREES))
@pytest.mark.parametrize("kind", ["normal", "ties", "zeros"])
def test_selections_on_the_card_equal_the_jnp_backend(card, which, kind):
    """select_topk and select_topk_last through K6 ("pallas", one launch
    per leaf) and K2 ("fused", one launch) equal the torch.topk backend
    bitwise, and each launched its kernel."""
    layout = _layout(which)
    v = _vec(kind, layout.n_total, 5, card)
    for select in (SP.select_topk, SP.select_topk_last):
        want = select(v, layout, backend="jnp")
        for backend, kernel in (("pallas", "block_topk"),
                                ("fused", "segmented_topk")):
            before = LAUNCHES[kernel]
            got = select(v, layout, backend=backend)
            torch.cuda.synchronize()
            leaves = layout.compressed if select is SP.select_topk \
                else layout.topk_only
            assert LAUNCHES[kernel] - before == (
                len(leaves) if backend == "pallas" else int(bool(leaves)))
            for a, b in zip(got, want):
                assert torch.equal(a, b), (select.__name__, backend)


# the path's layers cut in M (K = 3, 192, 384, 768, 64); ragged K, N; a
# K past one 32-deep tile that is not a multiple of the mma's K-step of 8
@pytest.mark.parametrize("M,K,N", [(1000, 3, 64), (77, 192, 128),
                                   (300, 384, 256), (200, 768, 64),
                                   (5, 64, 4), (130, 17, 70),
                                   (97, 100, 64)])
@pytest.mark.parametrize("apply_lrelu", [True, False])
def test_matmul_bias_lrelu_kernel_matches_its_plain_version(
        card, M, K, N, apply_lrelu):
    """Ragged shapes (no padding to 128): to 1e-5 x max(1, max|y|), f32
    sums of K products in another order."""
    gen = torch.Generator(device=card).manual_seed(M + K + N)
    x, w, b = (torch.randn(s, generator=gen, device=card)
               for s in ((M, K), (K, N), (N,)))
    before = LAUNCHES["matmul_bias_lrelu"]
    y = MM.matmul_bias_lrelu(x, w, b, apply_lrelu)
    torch.cuda.synchronize()
    assert LAUNCHES["matmul_bias_lrelu"] == before + 1
    yp = MM.matmul_bias_lrelu_plain(x, w, b, apply_lrelu)
    tol = 1e-5 * max(1.0, float(yp.abs().max()))
    assert float((y - yp).abs().max()) <= tol


def test_matmul_bias_lrelu_kernel_propagates_non_finite_inputs(card):
    """inf and NaN in X and W: NaN and +-inf where the plain version has
    them, the finite outputs to the tolerance above."""
    gen = torch.Generator(device=card).manual_seed(11)
    x, w, b = (torch.randn(s, generator=gen, device=card)
               for s in ((130, 40), (40, 70), (70,)))
    x[3, 5], x[7, 9], x[7, 10], x[11, 0] = (float("inf"), float("inf"),
                                            -float("inf"), float("nan"))
    w[4, 6], w[20, 30] = -float("inf"), 0.0
    x[50, 4] = 0.0                             # 0 * inf
    y = MM.matmul_bias_lrelu(x, w, b)
    yp = MM.matmul_bias_lrelu_plain(x, w, b)
    for mask in (torch.isnan, torch.isposinf, torch.isneginf):
        assert torch.equal(mask(y), mask(yp))
    fin = yp.isfinite()
    tol = 1e-5 * max(1.0, float(yp[fin].abs().max()))
    assert float((y[fin] - yp[fin]).abs().max()) <= tol


def test_kernel_encoder_matches_conv_encoder(card):
    """lgc_encode_fast (im2col + five kernel launches) against the conv
    encoder lgc_encode, to 1e-5 x max(1, max|z|)."""
    gen = torch.Generator(device=card).manual_seed(3)
    ae = AE.init_lgc_autoencoder(gen, card)
    g = torch.randn((4096,), generator=gen, device=card)
    z = ops.lgc_encode_fast(ae, g)
    zp = AE.lgc_encode(ae, g)[0]
    assert z.shape == zp.shape == (256, 4)
    tol = 1e-5 * max(1.0, float(zp.abs().max()))
    assert float((z - zp).abs().max()) <= tol


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    x = torch.zeros((8, 4), device=card)
    w = torch.zeros((4, 3), device=card)
    b = torch.zeros((3,), device=card)
    with pytest.raises(ValueError):
        MM.matmul_bias_lrelu(x.double(), w, b)
    with pytest.raises(ValueError):
        MM.matmul_bias_lrelu(x.t().contiguous().t(), w, b)
    g = torch.zeros((2048,), device=card)
    seg = torch.zeros((2048,), dtype=torch.int32, device=card)
    kcap = torch.ones((1,), dtype=torch.int32, device=card)
    with pytest.raises(ValueError):                # block above 2^17
        EF.sparsify_ef_topk(g, g, g, seg, kcap, 0.9, True, 1, 1 << 18)
    with pytest.raises(ValueError):                # seg must be int32
        EF.sparsify_ef_topk(g, g, g, seg.long(), kcap, 0.9, True, 1, 1024)
    with pytest.raises(ValueError):                # block above 2^17
        ST.segmented_topk(g, seg, kcap, 1, 1 << 18)
    with pytest.raises(ValueError):                # block % 128 != 0
        BT.block_topk(torch.zeros((2, 200), device=card), 4)
    with pytest.raises(ValueError):                # kb above the block
        BT.block_topk(torch.zeros((2, 256), device=card), 257)
    with pytest.raises(ValueError):                # pack_bits takes int32
        BP.pack_bits(torch.zeros((40,), dtype=torch.int64, device=card), 5)
    with pytest.raises(ValueError):                # vals must be f32
        BP.quantize_pack(torch.zeros((40,), dtype=torch.float64,
                                     device=card),
                         torch.zeros((40,), dtype=torch.int32, device=card),
                         5, 256, Q._EPS)
    with pytest.raises(ValueError):                # a stack of stacks
        BP.unpack_bits(torch.zeros((2, 2, 5, 4), dtype=torch.int32,
                                   device=card), 100)
    with pytest.raises(ValueError):                # a non-contiguous stack
        BP.unpack_bits(torch.zeros((5, 2, 4), dtype=torch.int32,
                                   device=card).transpose(0, 1), 100)


# k: one value, under/at/over one word column, past one 128-word tile,
# past two tiles; and the path's topk/support k
BITPACK_K = [1, 31, 32, 33, 4096 + 7, 32 * 128 * 2 + 5, 243287]


def _ints(kind, k, width, seed):
    r = np.random.default_rng(seed)
    if kind == "random":
        x = r.integers(0, 2 ** width, k)
    elif kind == "max":
        x = np.full(k, 2 ** width - 1)
    else:
        x = np.zeros(k)
    return x.astype(np.int32)


@pytest.mark.parametrize("k", BITPACK_K)
@pytest.mark.parametrize("kind", ["random", "zeros", "max"])
def test_pack_unpack_kernels_are_bitwise_their_plain_versions(card, k, kind):
    """K5a and K5b at every width 1..31, each launched once per call."""
    for width in range(1, BP.MAX_WIDTH + 1):
        x = torch.from_numpy(_ints(kind, k, width, width)).to(card)
        before = (LAUNCHES["pack_bits"], LAUNCHES["unpack_bits"])
        words = BP.pack_bits(x, width)
        back = BP.unpack_bits(words, k)
        torch.cuda.synchronize()
        assert (LAUNCHES["pack_bits"], LAUNCHES["unpack_bits"]) == \
            (before[0] + 1, before[1] + 1)
        assert torch.equal(words.cpu(), BP.pack_bits_plain(x.cpu(), width))
        assert torch.equal(back, x), (width, k, kind)


@pytest.mark.parametrize("k", [1, 31, 32, 33, 1024, 2 * 32 * 32 + 5,
                               243296])
@pytest.mark.parametrize("width", [1, 16, 31])
def test_pack_bits_tile_kernel_is_bitwise_its_plain_version(card, k, width):
    """K5a, one CTA per 32-column tile, at the path's shape (243,296
    values) and around one and two tiles, on values whose bits above the
    width are set as well as on values in range; one launch a call."""
    r = np.random.default_rng(k + width)
    for x in (r.integers(-2 ** 31, 2 ** 31, k, dtype=np.int64),
              r.integers(0, 2 ** width, k)):
        xt = torch.from_numpy(x.astype(np.int32)).to(card)
        before = LAUNCHES["pack_bits"]
        words = BP.pack_bits(xt, width)
        torch.cuda.synchronize()
        assert LAUNCHES["pack_bits"] == before + 1
        assert words.shape == (width, BP.word_count(k))
        assert torch.equal(words.cpu(), BP.pack_bits_plain(xt.cpu(), width))


@pytest.mark.parametrize("k", [1, 255, 256, 257, 1000, 243287])
@pytest.mark.parametrize("scale_block", [256, 64, 1, 1000])
def test_quantize_pack_kernel_is_bitwise_its_plain_version(card, k,
                                                           scale_block):
    """K4 against its plain version on values with NaN/±Inf, an all-zero
    block, exact .5 ties of the scale, and random low index bits, at
    widths 1, 16 and 31."""
    r = np.random.default_rng(k)
    v = r.standard_normal(k).astype(np.float32)
    v[::97] = np.nan
    v[5::101] = np.inf
    v[7::103] = -np.inf
    if k > 2 * scale_block:
        v[scale_block:2 * scale_block] = 0.0
    if k > 320:                 # scale 1.0: x / scale = n + 0.5 exactly
        v[256:300] = np.arange(-22, 22, dtype=np.float32) + 0.5
        v[300] = 127.0
    vt = torch.from_numpy(v).to(card)
    for width in (1, 16, 31):
        idx = r.integers(0, 2 ** width, k).astype(np.int32)
        it = torch.from_numpy(idx).to(card)
        before = LAUNCHES["quantize_pack"]
        out = BP.quantize_pack(vt, it, width, scale_block, Q._EPS)
        torch.cuda.synchronize()
        assert LAUNCHES["quantize_pack"] == before + 1
        plain = BP.quantize_pack_plain(vt.cpu(), it.cpu(), width,
                                       scale_block, Q._EPS)
        for name, a, b in zip(("words", "q", "scales"), out, plain):
            assert _same_bits(a.cpu(), b), (name, width)


# the path's topk / support PackPlan: 243,296 pairs, 16 low bits, 7603
# words per plane
@pytest.mark.parametrize("k", BITPACK_K + [243296])
@pytest.mark.parametrize("batch", [2, 3])
def test_batched_unpack_kernel_is_bitwise_its_plain_version(card, k, batch):
    """K5b on a (B, width, W) stack of random words at every width 1..31:
    one launch per call, each row the plain version's."""
    r = np.random.default_rng(k + batch)
    for width in range(1, BP.MAX_WIDTH + 1):
        words = r.integers(-2 ** 31, 2 ** 31, (batch, width,
                                               BP.word_count(k)),
                           dtype=np.int64).astype(np.int32)
        wt = torch.from_numpy(words).to(card)
        before = LAUNCHES["unpack_bits"]
        got = BP.unpack_bits(wt, k)
        torch.cuda.synchronize()
        assert LAUNCHES["unpack_bits"] == before + 1
        assert got.shape == (batch, k)
        assert torch.equal(got.cpu(), BP.unpack_bits_plain(
            torch.from_numpy(words), k)), (width, k, batch)


def test_packed_codec_on_the_card_equals_the_cpu(card):
    """encode_sparse_fused / decode_sparse and encode_indices /
    decode_indices at the path's topk plan, on the card (K4, K5a, K5b)
    and on the CPU (their plain versions): the same payload and pairs."""
    n, k = 505_956_352, 243287
    plan = PK.make_plan(n, k)
    r = np.random.default_rng(0)
    idx = np.sort(r.choice(n, k - 3, replace=False))
    idx = np.concatenate([idx, [n, n, n]]).astype(np.int32)
    vals = (r.standard_normal(k) * 1e-3).astype(np.float32)
    perm = r.permutation(k)
    tv, ti = torch.from_numpy(vals[perm]), torch.from_numpy(idx[perm])
    enc = PK.encode_sparse_fused(tv.to(card), ti.to(card), plan)
    want = PK.encode_sparse_fused(tv, ti, plan)
    for a, b in zip(enc, want):
        assert torch.equal(a.cpu(), b)
    got_v, got_i = PK.decode_sparse(enc, plan)
    want_v, want_i = PK.decode_sparse(want, plan)
    assert torch.equal(got_v.cpu(), want_v) and torch.equal(got_i.cpu(),
                                                            want_i)
    assert torch.equal(got_i.cpu(), torch.from_numpy(idx))
    ienc = PK.encode_indices(torch.from_numpy(idx).to(card), plan)
    assert torch.equal(PK.decode_indices(ienc, plan).cpu(),
                       torch.from_numpy(idx))


def _ef_inputs(n, seed, dev):
    r = np.random.default_rng(seed)
    out = []
    for i, s in enumerate((1.0, 0.1, 0.3)):
        x = (r.standard_normal(n) * s).astype(np.float32)
        x[i::1013] = np.nan
        x[i + 3::1019] = np.inf
        x[i + 5::1021] = -np.inf
        x[i + 7::97] = 0.0
        x[i + 9::89] = -0.0
        out.append(torch.from_numpy(x).to(dev))
    return out


@pytest.mark.parametrize("n", [1, 3, 4096 + 517, 2 * 65536 + 999])
@pytest.mark.parametrize("tau", [0.0, 0.5, 10.0])
@pytest.mark.parametrize("m", [0.0, 0.9])
def test_sparsify_ef_kernel_is_bitwise_its_plain_version(card, n, tau, m):
    """K7 against its plain version on the same card tensors (float4 path
    and scalar tail), and against the plain version on the CPU; tau as a
    number and as a tensor on the card; offset views take the scalar
    path.  Bitwise, NaN payloads aside: a NaN is NaN in the same places
    (the card's FMA returns its canonical NaN, 0x7fffffff)."""
    g, u, v = _ef_inputs(n + 1, n, card)
    for off in (0, 1):
        gg, uu, vv = (x[off:off + n] for x in (g, u, v))
        want = EF.sparsify_ef_plain(gg, uu, vv, tau, m)
        cpu = EF.sparsify_ef_plain(gg.cpu(), uu.cpu(), vv.cpu(), tau, m)
        for t in (tau, torch.tensor(tau, device=card)):
            got = EF.sparsify_ef(gg, uu, vv, t, m)
            for a, b, c in zip(got, want, cpu):
                for x, y in ((a, b), (a.cpu(), c)):
                    nan = x.isnan()
                    assert torch.equal(nan, y.isnan())
                    assert torch.equal(x[~nan].view(torch.int32),
                                       y[~nan].view(torch.int32))


def test_ops_sparsify_ef_counts_its_launch(card):
    g, u, v = _ef_inputs(5000, 0, card)
    before = LAUNCHES["sparsify_ef"]
    tau = ops.estimate_threshold(v, 100)
    assert tau.device == g.device
    ops.sparsify_ef(g, u, v, tau, 0.9)
    assert LAUNCHES["sparsify_ef"] == before + 1


def test_fused_ef_topk_momentum_is_one_fma(card):
    """K1's u' = m*u + g is one FMA: equal to fma_f32 on the CPU and, on
    this data, not to the product and the sum rounded apart."""
    from repro_torch.utils import fma_f32
    layout = _layout("odd")
    _, block, seg, kcap, n_cand, _ = SP._fused_meta(layout, ROLES, "loop")
    n = layout.n_total
    g, u, v = (_vec("normal", n, 5 + i, card) for i in range(3))
    seg_t, kcap_t = (torch.from_numpy(a).to(card) for a in (seg, kcap))
    out = EF.sparsify_ef_topk(g, u, v, seg_t, kcap_t, 0.9, True, n_cand,
                              block)
    want = fma_f32(0.9, u.cpu(), g.cpu())
    assert torch.equal(out[0].cpu().view(torch.int32),
                       want.view(torch.int32))
    assert not torch.equal(want, 0.9 * u.cpu() + g.cpu())


@pytest.mark.parametrize("B", [2, 4, 5])
def test_bucketed_packed_gather_on_the_card_equals_the_cpu(card, B):
    """RingPackedTransport's bucketed gather (K = 2 nodes, each node's
    sorted pairs in B sentinel-padded buckets) on the card (B x K K4
    launches, one K5b for the gathered table) and on the CPU (their plain
    versions): the same dense scatters, bitwise, and the same byte rows."""
    from repro_torch.dist.transport import RingPackedTransport
    n, k, K = 5_000_003, 60_001, 2
    plan = PK.make_plan(n, k)
    r = np.random.default_rng(B)
    idx = np.stack([np.concatenate([r.choice(n, k - 2, replace=False),
                                    [n, n]]) for _ in range(K)])
    vals = (r.standard_normal((K, k)) * 1e-3).astype(np.float32)
    tv, ti = torch.from_numpy(vals), torch.from_numpy(idx.astype(np.int32))
    got, want = {}, {}
    for dev, res in ((card, got), (torch.device("cpu"), want)):
        t = RingPackedTransport(K, wire_buckets=B)
        before = (LAUNCHES["quantize_pack"], LAUNCHES["unpack_bits"])
        with t.wire_op("topk"):
            res["out"] = t.sparse_gather_packed(tv.to(dev), ti.to(dev), n,
                                                plan=plan).cpu()
        res["rows"] = t.tally
        res["launches"] = (LAUNCHES["quantize_pack"] - before[0],
                           LAUNCHES["unpack_bits"] - before[1])
    assert got["launches"] == (B * K, 1) and want["launches"] == (0, 0)
    assert _same_bits(got["out"], want["out"])
    assert got["rows"] == want["rows"] and len(got["rows"]) == B


def test_guarded_packed_gather_on_the_card_equals_the_cpu(card):
    """RingPackedTransport's gather under a guard, through the executor,
    with the checksum word and a NaN and an inf in node 1's values: on
    the card (K4 per node, each node's non-finites counted beside it, no
    K5a; one K5b launch for the gathered table, which the validation
    reads) and on the CPU, the same scrubbed scatters bitwise and the
    same per-node counts."""
    from repro_torch.dist import plan as XP
    from repro_torch.dist.transport import make_transport
    n, k, K = 5_000_003, 60_001, 2
    op = XP.PackedSparseExchange("topk", n_vec=n, k=k, k_rate=k,
                                 pack=PK.make_plan(n, k, checksum=True))
    plan = XP.Plan(method="dgc", phase="topk_ae", transport="ring_packed",
                   K=K, scale_block=Q.SCALE_BLOCK, ops=(op,))
    r = np.random.default_rng(7)
    idx = np.stack([np.concatenate([r.choice(n, k - 2, replace=False),
                                    [n, n]]) for _ in range(K)])
    vals = (r.standard_normal((K, k)) * 1e-3).astype(np.float32)
    vals[1, 3], vals[1, 99] = np.nan, np.inf
    tv, ti = torch.from_numpy(vals), torch.from_numpy(idx.astype(np.int32))
    got, want = {}, {}
    for dev, res in ((card, got), (torch.device("cpu"), want)):
        t = make_transport("ring_packed", K, guard="scrub")
        names = ("quantize_pack", "pack_bits", "unpack_bits")
        before = [LAUNCHES[nm] for nm in names]
        env = XP.execute(plan, t, {"topk": lambda env: (tv.to(dev),
                                                        ti.to(dev))})
        res["out"] = env["topk"].cpu()
        res["bad"] = env["__guard__"]["bad"]["topk"].tolist()
        res["launches"] = tuple(LAUNCHES[nm] - b
                                for nm, b in zip(names, before))
    assert got["launches"] == (K, 0, 1) and want["launches"] == (0, 0, 0)
    assert _same_bits(got["out"], want["out"])
    assert got["bad"] == want["bad"] == [0, 2]


@pytest.mark.parametrize("wire", ["ring_packed", "ring_q8"])
def test_guarded_exchange_does_not_wait_for_the_card(card, wire):
    """The executor under a guard on the chaos wire (bit flips, NaNs and
    an inf on the op's result, a NaN in node 1's input) queues its work
    without waiting for the card: ``torch.cuda.set_sync_debug_mode
    ("error")`` raises on any call that synchronises, and the guard's
    counts stay tensors on the card.  The scrubbed result and the
    per-node counts are bitwise the CPU's."""
    from repro_torch.dist import chaos as CH
    from repro_torch.dist import plan as XP
    from repro_torch.dist.transport import make_transport
    n, k, K = 5_000_003, 60_001, 2
    r = np.random.default_rng(11)
    if wire == "ring_packed":
        op = XP.PackedSparseExchange("topk", n_vec=n, k=k, k_rate=k,
                                     pack=PK.make_plan(n, k, checksum=True))
        idx = np.stack([np.concatenate([r.choice(n, k - 2, replace=False),
                                        [n, n]]) for _ in range(K)])
        vals = (r.standard_normal((K, k)) * 1e-3).astype(np.float32)
        vals[1, 3] = np.nan
        inputs = (torch.from_numpy(vals),
                  torch.from_numpy(idx.astype(np.int32)))
    else:
        op = XP.Reduce("topk", n_vals=k, wire="q8")
        x = (r.standard_normal((K, k)) * 1e-3).astype(np.float32)
        x[1, 3] = np.nan
        inputs = (torch.from_numpy(x),)
    plan = XP.Plan(method="dgc", phase="topk_ae", transport=wire, K=K,
                   scale_block=Q.SCALE_BLOCK, ops=(op,))
    spec = CH.FaultSpec(seed=3, bitflips=2, nans=2, infs=1)
    got = {}
    for dev in (card, torch.device("cpu")):
        t = make_transport("chaos:" + wire, K, guard="scrub", fault=spec)
        args = tuple(a.to(dev) for a in inputs)
        torch.cuda.synchronize(card)
        torch.cuda.set_sync_debug_mode("error" if dev.type == "cuda"
                                       else "default")
        try:
            env = XP.execute(plan, t, {"topk": lambda env: args})
        finally:
            torch.cuda.set_sync_debug_mode("default")
        got[dev.type] = (env["topk"].cpu(),
                         env["__guard__"]["bad"]["topk"].cpu())
    assert _same_bits(got["cuda"][0], got["cpu"][0])
    assert torch.equal(got["cuda"][1], got["cpu"][1])
    assert got["cpu"][1].tolist()[1] > got["cpu"][1].tolist()[0] > 0


# -- ConvNet5 (config(): n = 588,008) and serving -------------------------------


def _convnet5_layout(sparsity):
    from repro_torch.configs.convnet5 import config
    from repro_torch.models.convnet import init_convnet5
    return SP.build_layout(init_convnet5(torch.Generator(), config()),
                           sparsity)


@pytest.mark.parametrize("sparsity", [0.001, 0.05])
@pytest.mark.parametrize("kind", ["normal", "special"])
def test_fused_ef_topk_kernel_at_convnet5_shapes(card, sparsity, kind):
    """K1 at ConvNet5's layout (14 slots; BN leaves of 64-256 entries with
    k from 1): every output bitwise its plain version, u' NaN payloads
    aside, as above."""
    layout = _convnet5_layout(sparsity)
    _, block, seg, kcap, n_cand, _ = SP._fused_meta(layout, ROLES, "auto")
    n = layout.n_total
    g, u, v = (_vec(kind, n, 10 * i + 7, card) for i in range(3))
    seg_t, kcap_t = (torch.from_numpy(a).to(card) for a in (seg, kcap))
    args = (g, u, v, seg_t, kcap_t, 0.9, True, n_cand, block)
    out = EF.sparsify_ef_topk(*args)
    torch.cuda.synchronize()
    plain = EF.sparsify_ef_topk_plain(*args)
    nan = out[0].isnan()
    assert torch.equal(nan, plain[0].isnan())
    assert _same_bits(out[0][~nan], plain[0][~nan]), "u"
    for name, a, b in zip(("v", "vals", "idx", "seg"), out[1:], plain[1:]):
        assert _same_bits(a, b), name


@pytest.mark.parametrize("sparsity", [0.001, 0.01])
@pytest.mark.parametrize("kind", ["normal", "ties"])
def test_block_topk_kernel_at_convnet5_shapes(card, sparsity, kind):
    """K6 at every (n_blocks, block, kb) the pallas backend gives
    ConvNet5's compressed and top-k-only leaves (k = 1 on the 64-entry BN
    leaves at alpha = 0.01), and the selections through it equal the
    torch.topk backend."""
    import torch.nn.functional as F
    layout = _convnet5_layout(sparsity)
    for leaf in layout.compressed + layout.topk_only:
        block = SP.pallas_block(leaf.k)
        nb, kb = -(-leaf.size // block), min(leaf.k, block)
        x = _vec(kind, leaf.size, leaf.size, card)
        xb = F.pad(x, (0, nb * block - leaf.size)).view(nb, block)
        out = BT.block_topk(xb, kb)
        torch.cuda.synchronize()
        vals, idx = BT.block_topk_plain(xb, kb)
        assert torch.equal(out[0].view(torch.int32), vals.view(torch.int32))
        assert torch.equal(out[1], idx), leaf.path
    v = _vec(kind, layout.n_total, 3, card)
    for select in (SP.select_topk, SP.select_topk_last):
        for a, b in zip(select(v, layout, backend="pallas"),
                        select(v, layout, backend="jnp")):
            assert torch.equal(a, b), select.__name__


@pytest.mark.parametrize("sparsity", [0.001, 0.05])
def test_kernel_encoder_at_convnet5_shapes(card, sparsity):
    """K3's five layers at ConvNet5's mu_pad (544: below one tile; 26,784)
    against their plain versions, and the kernel encoder against the conv
    encoder, to 1e-5 x max(1, max|y|)."""
    mu_pad = _convnet5_layout(sparsity).mu_pad
    gen = torch.Generator(device=card).manual_seed(mu_pad)
    ae = AE.init_lgc_autoencoder(gen, card)
    x = torch.randn((mu_pad, 1), generator=gen, device=card) * 1e-3
    g = x[:, 0].clone()
    for p, (_c, k, s) in zip(ae["encoder"], AE.ENCODER_SPEC):
        cols = ops._im2col_1d(x, k, s).contiguous()
        w = p["w"].reshape(-1, p["w"].shape[-1]).contiguous()
        b = torch.randn(p["b"].shape, generator=gen, device=card) * 0.1
        y = MM.matmul_bias_lrelu(cols, w, b)
        yp = MM.matmul_bias_lrelu_plain(cols, w, b)
        assert float((y - yp).abs().max()) <= \
            1e-5 * max(1.0, float(yp.abs().max()))
        x = y
    z, zp = ops.lgc_encode_fast(ae, g), AE.lgc_encode(ae, g)[0]
    assert z.shape == zp.shape == (mu_pad // 16, 4)
    assert float((z - zp).abs().max()) <= 1e-5 * max(1.0,
                                                      float(zp.abs().max()))


# ConvNet5's runs on the packed ring, as chip_smoke runs them at K = 4
CONVNET5_PACKED = {
    "lgc_ps": dict(method="lgc_ps", sparsity=0.05, innovation_sparsity=0.005,
                   transport="ring_packed"),
    "dgc": dict(method="dgc", sparsity=0.01, transport="ring_packed"),
}


@pytest.mark.parametrize("method", sorted(CONVNET5_PACKED))
def test_bitpack_kernels_at_convnet5_pack_plans(card, method):
    """K4, K5a and K5b bitwise their plain versions at every PackPlan that
    build_plan gives ConvNet5's run of ``method`` at K = 4 in its
    sparsified phases (k 514 to 26,784 at 8 to 15 low bits): K4 and K5a
    on each of 4 payloads (one with special values), K5b on one payload
    and on the 4-payload table."""
    from repro_torch.configs.base import CompressionConfig
    from repro_torch.core.phases import PHASE_TOPK_AE
    from repro_torch.dist import plan as XP
    cc = CompressionConfig(**CONVNET5_PACKED[method])
    layout = _convnet5_layout(cc.sparsity)
    plans = {op.pack for phase in {PHASE_TOPK_AE, XP.steady_phase(method)}
             for op in XP.build_plan(cc, layout, 4, phase=phase).ops
             if getattr(op, "pack", None) is not None}
    assert len(plans) >= 2 and not any(p.raw_index for p in plans)
    r = np.random.default_rng(len(method))
    for plan in sorted(plans, key=lambda p: (p.n, p.k)):
        k, lo, sb = plan.k, plan.lo_bits, plan.scale_block
        los = []
        for j in range(4):
            idx = np.sort(r.choice(plan.n + 1, k, replace=False))
            x = torch.from_numpy((idx & ((1 << lo) - 1)).astype(np.int32)
                                 ).to(card)
            v = _vec("special" if j == 1 else "normal", k, j, card)
            out = BP.quantize_pack(v, x, lo, sb, Q._EPS)
            words = BP.pack_bits(x, lo)
            torch.cuda.synchronize()
            plain = BP.quantize_pack_plain(v.cpu(), x.cpu(), lo, sb, Q._EPS)
            for name, a, b in zip(("words", "q", "scales"), out, plain):
                assert _same_bits(a.cpu(), b), (name, plan)
            assert torch.equal(words.cpu(), BP.pack_bits_plain(x.cpu(), lo))
            los.append(x)
        table = torch.stack([BP.pack_bits(x, lo) for x in los])
        assert torch.equal(BP.unpack_bits(table[0], k), los[0]), plan
        assert torch.equal(BP.unpack_bits(table, k), torch.stack(los)), plan
        assert torch.equal(BP.unpack_bits(table, k).cpu(),
                           BP.unpack_bits_plain(table.cpu(), k)), plan


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_from_cache_equals_prefill_on_the_card(card, dtype):
    """The dense decoder on the card (the llama3.2-1b smoke config, 2
    blocks): prefill 28 tokens into a 32-slot cache, decode 4; each
    step's logits equal a full prefill's last-token logits of the same
    prefix, to 1e-5 of the largest in f32 (TF32 off) and to 0.05 of it in
    bf16 (chip_smoke's SERVE_REL: single bf16 steps differ between the
    two shapes' matmuls)."""
    from repro_torch.configs import get_arch
    from repro_torch.models.model import build_model
    model = build_model(get_arch("llama3.2-1b").reduced(dtype=dtype))
    params = model.init(torch.Generator(device=card).manual_seed(0), card)
    toks = torch.randint(0, 512, (2, 32), device=card,
                         generator=torch.Generator(device=card).manual_seed(1))
    rel = 1e-5 if dtype == "float32" else 0.05
    with torch.no_grad():
        _, cache = model.prefill(params, {"tokens": toks[:, :28]},
                                 cache_len=32)
        for pos in range(28, 32):
            logits, cache = model.decode_step(params, cache,
                                              toks[:, pos:pos + 1], pos)
            full, _ = model.prefill(params, {"tokens": toks[:, :pos + 1]})
            assert float((logits - full).abs().max()) <= \
                rel * float(full.abs().max()), pos
