"""The port's exchange plan and byte pricing against the JAX reference:
the op sequence per (method, phase), the per-op and per-kind wire bytes,
the paper-style rate terms and ``rate_report``, the packed exchanges'
PackPlans and their byte counts (all exact: bytes do not depend on the
hardware), and ``execute``'s both-ways feed check."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.configs.base import CompressionConfig as RCC
from repro.core import rate as RRATE
from repro.core import sparsify as RSP
from repro.dist import packed as RPK
from repro.dist import plan as RXP
from repro.dist import quantize as RQ
from repro.kernels import bitpack as RBP
from repro.models.model import Model as RefModel
from repro_torch.configs import get_arch
from repro_torch.configs.base import CompressionConfig
from repro_torch.core import rate as RATE
from repro_torch.core import sparsify as SP
from repro_torch.dist import packed as PK
from repro_torch.dist import plan as XP
from repro_torch.dist import quantize as Q
from repro_torch.dist.transport import SimTransport
from repro_torch.kernels import bitpack as BP
from repro_torch.models.model import build_model

PHASES = ("warmup", "topk_ae", "compressed")
SHAPES = {"embed": {"w": (11, 3)}, "block1": {"w": (57, 31), "b": (13,)},
          "fc": {"w": (17, 19)}}


def _layouts(which, sparsity):
    if which == "odd":
        ref = {k: {n: jnp.zeros(s) for n, s in d.items()}
               for k, d in SHAPES.items()}
        ours = {k: {n: torch.zeros(s) for n, s in d.items()}
                for k, d in SHAPES.items()}
        return SP.build_layout(ours, sparsity), RSP.build_layout(ref,
                                                                 sparsity)
    # llama3.2-1b at published widths, 4 layers, from shapes only
    cfg = dataclasses.replace(get_arch("llama3.2-1b"), n_layers=4)
    rcfg = dataclasses.replace(ref_get_arch("llama3.2-1b"), n_layers=4)
    return (SP.build_layout(build_model(cfg).init(torch.Generator(), "meta"),
                            sparsity),
            RSP.build_layout(jax.eval_shape(RefModel(rcfg).init,
                                            jax.random.PRNGKey(0)), sparsity))


@pytest.mark.parametrize("which,sparsity", [("odd", 0.05),
                                            ("llama4", 0.001)])
@pytest.mark.parametrize("method", ["none", "sparse_gd", "dgc", "lgc_rar"])
@pytest.mark.parametrize("K", [2, 4])
def test_plan_and_pricing_match_reference(which, sparsity, method, K):
    layout, rlayout = _layouts(which, sparsity)
    cc, rcc = CompressionConfig(method=method), RCC(method=method)
    for phase in PHASES + (None,):            # None: the steady phase
        plan = XP.build_plan(cc, layout, K, transport="mesh", phase=phase)
        rplan = RXP.build_plan(rcc, rlayout, K, transport="mesh",
                               phase=phase)
        assert (plan.phase, plan.labels) == (rplan.phase, rplan.labels)
        assert XP.wire_terms_by_op(plan) == RXP.wire_terms_by_op(rplan)
        assert XP.wire_terms(plan) == RXP.wire_terms(rplan)
        for count_exempt in (True, False):
            assert XP.rate_terms(plan, count_exempt=count_exempt) == \
                RXP.rate_terms(rplan, count_exempt=count_exempt)
    idx = np.arange(0, layout.n_total, 997, dtype=np.int32)[:layout.mu_pad]
    for count_exempt in (True, False):
        for indices in (None, idx):
            assert dataclasses.astuple(RATE.rate_report(
                cc, layout, K, indices=indices, count_exempt=count_exempt)) \
                == dataclasses.astuple(RRATE.rate_report(
                    rcc, rlayout, K, indices=indices,
                    count_exempt=count_exempt, transport="mesh"))


@pytest.mark.parametrize("which,sparsity", [("odd", 0.05),
                                            ("llama4", 0.001)])
@pytest.mark.parametrize("method", ["sparse_gd", "dgc"])
def test_packed_exchanges_carry_the_reference_packplans(which, sparsity,
                                                        method):
    """The sparse methods' exchanges are PackedSparseExchange ops whose
    PackPlans equal the reference's field for field, with the same wire
    and index byte counts."""
    layout, rlayout = _layouts(which, sparsity)
    plan = XP.build_plan(CompressionConfig(method=method), layout, 2,
                         transport="mesh")
    rplan = RXP.build_plan(RCC(method=method), rlayout, 2, transport="mesh")
    assert plan.phase == rplan.phase == "topk_ae"
    for op, rop in zip(plan.ops, rplan.ops):
        assert type(op).__name__ == type(rop).__name__
        if not isinstance(op, XP.PackedSparseExchange):
            continue
        assert (op.label, op.n_vec, op.k, op.k_rate, op.mode) == \
            (rop.label, rop.n_vec, rop.k, rop.k_rate, rop.mode)
        if op.pack is None:
            assert rop.pack is None and op.k == 0
            continue
        assert dataclasses.astuple(op.pack) == dataclasses.astuple(rop.pack)
        assert op.pack.hi_bits == rop.pack.hi_bits
        assert PK.wire_nbytes(op.pack) == RPK.wire_nbytes(rop.pack)
        assert PK.index_nbytes(op.pack) == RPK.index_nbytes(rop.pack)


@pytest.mark.parametrize("scale_block", [0, 64])
def test_packplan_arithmetic_matches_reference(scale_block):
    """make_plan, bucket_plan and the byte counts over a sweep of (n, k),
    from the few-index raw fallback to k = n, sentinel width included."""
    for n in (1, 7, 100, 1023, 1024, 65537, 505_956_352):
        for k in sorted({1, 2, 5, 8, 9, 33, 257, 4096, n} - {0}):
            if k > n:
                continue
            for checksum in (False, True):
                p = PK.make_plan(n, k, scale_block, checksum=checksum)
                rp = RPK.make_plan(n, k, scale_block, checksum=checksum)
                assert dataclasses.astuple(p) == dataclasses.astuple(rp)
                assert PK.wire_nbytes(p) == RPK.wire_nbytes(rp)
                assert PK.index_nbytes(p) == RPK.index_nbytes(rp)
                if not p.raw_index:
                    for kb in {1, (k + 1) // 2, k}:
                        assert dataclasses.astuple(PK.bucket_plan(p, kb)) \
                            == dataclasses.astuple(RPK.bucket_plan(rp, kb))
            assert BP.packed_nbytes(k, BP.bit_width(n)) == \
                RBP.packed_nbytes(k, RBP.bit_width(n))
            assert Q.wire_nbytes(k, scale_block or Q.SCALE_BLOCK) == \
                RQ.wire_nbytes(k, scale_block or RQ.SCALE_BLOCK)


@pytest.mark.parametrize("K", [2, 3, 5])
def test_sim_transport_sparse_exchanges_match_reference(K):
    """The exact oracle of the packed wire (gather and mean), the exact
    f32 wire and the dense mean, on pairs with sentinel entries, against
    the reference's SimTransport, bitwise: the means over nodes sum node
    after node and multiply by f32(1/K), as XLA compiles jnp.mean (a true
    division by 3 or 5 would differ by an ulp).  Tallied like the exact
    exchange."""
    from repro.dist.transport import SimTransport as RSim
    r = np.random.default_rng(K)
    n, k = 97, 12
    idx = np.stack([np.concatenate([r.choice(n, k - 2, replace=False),
                                    [n, n]]) for _ in range(K)]
                   ).astype(np.int32)
    vals = r.standard_normal((K, k)).astype(np.float32)
    dense = r.standard_normal((K, 4099)).astype(np.float32)
    t, rt = SimTransport(K), RSim(K)
    pack = PK.make_plan(n, k)
    tv, ti = torch.from_numpy(vals), torch.from_numpy(idx)
    jv, ji = jnp.asarray(vals), jnp.asarray(idx)
    for ours, ref in (
            (t.sparse_gather_packed(tv, ti, n, plan=pack),
             rt.sparse_gather_packed(jv, ji, n)),
            (t.sparse_mean_packed(tv, ti, n, plan=pack),
             rt.sparse_mean_packed(jv, ji, n)),
            (t.sparse_mean(tv, ti, n), rt.sparse_mean(jv, ji, n)),
            (t.mean(torch.from_numpy(dense)), rt.mean(jnp.asarray(dense)))):
        ref = np.asarray(ref)
        np.testing.assert_array_equal(ours.numpy().view(np.int32),
                                      ref.view(np.int32))
    t = SimTransport(K)
    with t.wire_op("topk"):
        t.sparse_mean_packed(tv, ti, n, plan=pack)
    assert t.tally == {"topk": {"all_gather": (K - 1) * k * 8.0}}


@pytest.mark.parametrize("which,sparsity", [("odd", 0.05),
                                            ("llama4", 0.001)])
@pytest.mark.parametrize("method", ["sparse_gd", "dgc", "lgc_rar"])
@pytest.mark.parametrize("K", [2, 3])
@pytest.mark.parametrize("transport", ["ring", "ring_packed"])
def test_ring_pricing_matches_reference(which, sparsity, method, K,
                                        transport):
    """Per-op and per-kind wire bytes, rate terms and rate_report on the
    ring and the packed ring, for every phase, equal the reference's;
    the lgc support carries the reference's PackPlan."""
    layout, rlayout = _layouts(which, sparsity)
    cc, rcc = CompressionConfig(method=method), RCC(method=method)
    for phase in PHASES:
        plan = XP.build_plan(cc, layout, K, transport=transport, phase=phase)
        rplan = RXP.build_plan(rcc, rlayout, K, transport=transport,
                               phase=phase)
        assert plan.labels == rplan.labels
        assert XP.wire_terms_by_op(plan) == RXP.wire_terms_by_op(rplan)
        assert XP.wire_terms(plan) == RXP.wire_terms(rplan)
        for count_exempt in (True, False):
            assert XP.rate_terms(plan, count_exempt=count_exempt) == \
                RXP.rate_terms(rplan, count_exempt=count_exempt)
        for op, rop in zip(plan.ops, rplan.ops):
            if isinstance(op, XP.IndexBroadcast):
                assert dataclasses.astuple(op.pack) == \
                    dataclasses.astuple(rop.pack)
    assert dataclasses.astuple(RATE.rate_report(
        cc, layout, K, transport=transport)) == dataclasses.astuple(
        RRATE.rate_report(rcc, rlayout, K, transport=transport))


def test_execute_checks_feeds_both_ways():
    layout, _ = _layouts("odd", 0.05)
    plan = XP.build_plan(CompressionConfig(method="lgc_rar"), layout, 2,
                         transport="sim", phase="compressed")
    feeds = {label: (lambda env: None) for label in plan.labels}
    with pytest.raises(ValueError, match="missing feeds"):
        XP.execute(plan, SimTransport(2),
                   {k: f for k, f in feeds.items() if k != "encoding"})
    with pytest.raises(ValueError, match="unplanned feeds"):
        XP.execute(plan, SimTransport(2), {**feeds, "topk": feeds["support"]})
