"""Gradient sparsification (paper Section V-A, Algorithms 1-2); counterpart
of ``repro.core.sparsify``.

Per-layer top-k at rate alpha with DGC-style momentum-corrected residual
accumulation (u <- m*u + g, v <- v + u; send top-k(v); zero u, v where
sent), over the *flat* gradient vector in the reference's leaf order.
The host half (layout, roles, the fused sweep's block/slot metadata) is
the reference's arithmetic unchanged, so offsets, block sizes and
candidate budgets agree field for field.  The device half takes torch
tensors; top-k selections use unique int64 keys (magnitude bits, then
position), which give ``lax.top_k``'s order — |value| descending, lowest
index first — exactly (``torch.topk`` alone does not keep that tie order).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, List, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops as K_ops
from repro_torch.kernels.segmented_topk import (BLOCK as _SEG_BLOCK,
                                                active_blocks,
                                                magnitude_rank, next_pow2)
from repro_torch.utils import fma_f32
from repro_torch.utils.tree import keystr_path, tree_leaves_with_path

ROLE_DENSE = "dense"            # exempt: raw dense gradient (first layer)
ROLE_TOPK_ONLY = "topk_only"    # top-k transmitted, but not AE-compressed
ROLE_COMPRESSED = "compressed"  # top-k -> autoencoder

AE_ALIGN = 16                   # encoder downsamples by 16


@dataclass(frozen=True)
class LeafSpec:
    path: str
    offset: int
    size: int
    role: str
    k: int                      # top-k count (0 for dense leaves)


@dataclass(frozen=True)
class GradientLayout:
    leaves: Tuple[LeafSpec, ...]
    n_total: int
    mu: int                     # sum of k over COMPRESSED leaves
    mu_pad: int                 # mu rounded up to AE_ALIGN
    k_last: int                 # sum of k over TOPK_ONLY leaves

    @property
    def compressed(self) -> Tuple[LeafSpec, ...]:
        return tuple(l for l in self.leaves if l.role == ROLE_COMPRESSED)

    @property
    def topk_only(self) -> Tuple[LeafSpec, ...]:
        return tuple(l for l in self.leaves if l.role == ROLE_TOPK_ONLY)

    @property
    def dense(self) -> Tuple[LeafSpec, ...]:
        return tuple(l for l in self.leaves if l.role == ROLE_DENSE)


def default_role_fn(path: str, index: int, n_leaves: int) -> str:
    """Paper Section VI-A: first layer dense, last layer top-k w/o AE."""
    segments = path.lower().split("/")
    if "embed" in segments or "conv0" in segments:
        return ROLE_DENSE
    if "lm_head" in segments or "fc" in segments:
        return ROLE_TOPK_ONLY
    return ROLE_COMPRESSED


def build_layout(params_template, sparsity: float,
                 role_fn: Callable[[str, int, int], str] = default_role_fn,
                 ) -> GradientLayout:
    """``params_template``: a param tree of anything with ``.shape``
    (tensors, meta tensors)."""
    flat = tree_leaves_with_path(params_template)
    specs: List[LeafSpec] = []
    offset = 0
    for i, (path, leaf) in enumerate(flat):
        pstr = keystr_path(path)
        size = int(np.prod(leaf.shape)) if len(leaf.shape) else 1
        role = role_fn(pstr, i, len(flat))
        k = 0
        if role in (ROLE_COMPRESSED, ROLE_TOPK_ONLY):
            k = max(1, int(round(size * sparsity)))
        specs.append(LeafSpec(pstr, offset, size, role, k))
        offset += size
    mu = sum(l.k for l in specs if l.role == ROLE_COMPRESSED)
    mu_pad = ((mu + AE_ALIGN - 1) // AE_ALIGN) * AE_ALIGN
    k_last = sum(l.k for l in specs if l.role == ROLE_TOPK_ONLY)
    return GradientLayout(tuple(specs), offset, mu, mu_pad, k_last)


# ---------------------------------------------------------------------------
# error feedback (DGC momentum correction)


def momentum_correct(u, v, g, m: float):
    """u' = m*u + g as one FMA (the reference's jitted arithmetic, see
    :func:`repro_torch.utils.fma_f32`), v' = v + u'."""
    u_new = fma_f32(m, u, g)
    v_new = v + u_new
    return u_new, v_new


def clear_sent_merged(u, v, idx_a, idx_b, n: int):
    """Zero u and v, IN PLACE, at idx_a ∪ idx_b; entries >= n (the
    sentinel n) are dropped, as ``.at[].set(mode="drop")`` drops them.
    In place because at full width each accumulator is gigabytes."""
    idx = torch.cat([idx_a.reshape(-1), idx_b.reshape(-1)]).long()
    idx = idx[idx < n]
    u.index_fill_(0, idx, 0.0)
    v.index_fill_(0, idx, 0.0)
    return u, v


# ---------------------------------------------------------------------------
# top-k selection per leaf


def _leaf_topk(seg: torch.Tensor, k: int, offset: int):
    key = magnitude_rank(seg) << 32 | torch.arange(
        seg.shape[0], device=seg.device)
    idx = torch.topk(key, k, largest=False, sorted=True).indices
    return seg[idx], idx + offset


_PALLAS_BLOCK = 8192            # smallest per-leaf global_topk block


def pallas_block(k: int) -> int:
    """The reference's per-leaf global_topk block for a leaf's k:
    max(8192, k rounded up to 128)."""
    return max(_PALLAS_BLOCK, ((k + 127) // 128) * 128)


def _leaf_topk_pallas(seg: torch.Tensor, k: int, offset: int):
    """Same contract as :func:`_leaf_topk` through the block top-k kernel
    (K6) and its merge (``kernels.ops.global_topk``)."""
    vals, idx = K_ops.global_topk(seg, k, block=pallas_block(k))
    return vals, idx + offset


SELECT_BACKENDS = ("jnp", "pallas", "fused")

FUSED_BLOCK = _SEG_BLOCK
FUSED_BLOCK_MAX = 128 * 1024
EXTRACT_BACKENDS = ("auto", "loop", "bitonic")


def _resolve_extract(extract: str, slots) -> str:
    assert extract in EXTRACT_BACKENDS, extract
    if extract != "auto":
        return extract
    k_max = max((l.k for l in slots), default=1)
    return "bitonic" if 8 * k_max > FUSED_BLOCK_MAX else "loop"


def _fused_block(slots, extract: str = "loop") -> int:
    """Per-layout sweep block: the reference's rule (loop: >= 8*k_max,
    1024-rounded; bitonic: next power of two >= k_max; both capped at
    FUSED_BLOCK_MAX), so the candidate triples match its own."""
    k_max = max((l.k for l in slots), default=1)
    if extract == "bitonic":
        return min(FUSED_BLOCK_MAX, next_pow2(max(FUSED_BLOCK, k_max)))
    want = -(-8 * k_max // FUSED_BLOCK) * FUSED_BLOCK
    return max(FUSED_BLOCK, min(FUSED_BLOCK_MAX, want))


@functools.lru_cache(maxsize=64)
def _fused_meta(layout: GradientLayout, roles: Tuple[str, ...],
                extract: str = "auto"):
    """(extract, block, seg (n,) numpy, kcap, n_cand, slots): the
    reference's static sweep metadata, computed the same way."""
    slots = tuple(l for role in roles for l in layout.leaves
                  if l.role == role)
    ex = _resolve_extract(extract, slots)
    block = _fused_block(slots, ex)
    n_pad = -(-layout.n_total // block) * block
    seg = np.full((n_pad,), -1, np.int32)
    for j, leaf in enumerate(slots):
        seg[leaf.offset:leaf.offset + leaf.size] = j
    kcap = np.asarray([l.k for l in slots], np.int32)
    budget = np.zeros((n_pad // block,), np.int64)
    for leaf in slots:
        b0 = leaf.offset // block
        b1 = (leaf.offset + leaf.size - 1) // block
        bs = np.arange(b0, b1 + 1)
        pieces = (np.minimum(leaf.offset + leaf.size, (bs + 1) * block)
                  - np.maximum(leaf.offset, bs * block))
        budget[b0:b1 + 1] += np.minimum(pieces, leaf.k)
    n_cand = max(1, int(budget.max(initial=0)))
    return ex, block, seg[:layout.n_total], kcap, n_cand, slots


@functools.lru_cache(maxsize=8)
def _device_meta(layout: GradientLayout, roles: Tuple[str, ...],
                 extract: str, device: torch.device):
    """The sweep metadata as tensors on ``device`` (seg, kcap, and the
    kernel's active-block map on the card), uploaded once per run."""
    _, block, seg, kcap, _, _ = _fused_meta(layout, roles, extract)
    seg_t = torch.from_numpy(seg).to(device)
    active = active_blocks(seg_t, block) if device.type == "cuda" else None
    return seg_t, torch.from_numpy(kcap).to(device), active


def fused_plan_info(layout: GradientLayout,
                    roles: Tuple[str, ...] = (ROLE_COMPRESSED,
                                              ROLE_TOPK_ONLY),
                    extract: str = "auto") -> dict:
    ex, block, _, _, n_cand, _ = _fused_meta(layout, roles, extract)
    return {"fused_block": block, "n_cand": n_cand, "extract_backend": ex}


def _merge_candidates(cvals, cidx, cseg, slots):
    """Exact per-slot top-k from the sweep's candidate pool: per slot, the
    k smallest unique keys (magnitude rank, position in the pool)."""
    mag = magnitude_rank(cvals)
    vals_list, idx_list = [], []
    for j, leaf in enumerate(slots):
        pos = (cseg == j).nonzero().squeeze(1)
        key = mag[pos] << 32 | torch.arange(pos.shape[0], device=pos.device)
        top = pos[torch.topk(key, leaf.k, largest=False, sorted=True).indices]
        vals_list.append(cvals[top])
        idx_list.append(cidx[top].to(torch.int32))
    return vals_list, idx_list


def _fused_select_lists(v, layout, roles, extract: str = "auto"):
    """Per-leaf (vals, idx) lists for all leaves of ``roles`` through ONE
    segmented sweep without the EF accumulate (kernel K2), then the
    merge."""
    ex, block, _, _, n_cand, slots = _fused_meta(layout, roles, extract)
    if not slots:
        return [], []
    seg, kcap, active = _device_meta(layout, roles, extract, v.device)
    cv, ci, cs = K_ops.segmented_topk(v, seg, kcap, n_cand, block=block,
                                      extract=ex, active=active)
    return _merge_candidates(cv, ci, cs, slots)


def _per_leaf_select(v, leaves, backend: str):
    """Per-leaf (vals, idx) lists, one top-k per leaf: ``torch.topk`` on
    unique keys ("jnp") or the block top-k kernel ("pallas")."""
    topk = _leaf_topk_pallas if backend == "pallas" else _leaf_topk
    vals_list, idx_list = [], []
    for leaf in leaves:
        vals, idx = topk(v[leaf.offset:leaf.offset + leaf.size], leaf.k,
                         leaf.offset)
        vals_list.append(vals)
        idx_list.append(idx)
    return vals_list, idx_list


def _check_backend(backend: str) -> None:
    if backend not in SELECT_BACKENDS:
        raise ValueError(f"unknown topk backend {backend!r}; known: "
                         f"{SELECT_BACKENDS}")


def _pad_compressed(vals_list, idx_list, layout, dtype):
    device = vals_list[0].device if vals_list else None
    pad = layout.mu_pad - layout.mu
    if pad:
        vals_list = vals_list + [torch.zeros((pad,), dtype=dtype,
                                             device=device)]
        idx_list = idx_list + [torch.full((pad,), layout.n_total,
                                          dtype=torch.int32, device=device)]
    return (torch.cat(vals_list),
            torch.cat([i.to(torch.int32) for i in idx_list]))


def select_topk(v, layout: GradientLayout, backend: str = "jnp",
                extract: str = "auto"):
    """Top-k per compressed leaf of the residual ``v``: (values (mu_pad,),
    indices (mu_pad,) int32); padding entries carry 0 and the sentinel
    index n_total.  ``backend``: "jnp" (one ``torch.topk`` per leaf),
    "pallas" (the block top-k kernel K6, one launch per leaf) or "fused"
    (the segmented sweep kernel K2, one launch for the whole vector); all
    exact, in the same order (|value| descending, lowest index first)."""
    _check_backend(backend)
    if backend == "fused":
        vals_list, idx_list = _fused_select_lists(
            v, layout, (ROLE_COMPRESSED,), extract)
    else:
        vals_list, idx_list = _per_leaf_select(v, layout.compressed,
                                               backend)
    return _pad_compressed(vals_list, idx_list, layout, v.dtype)


def select_topk_last(v, layout: GradientLayout, backend: str = "jnp",
                     extract: str = "auto"):
    """Top-k over the exempt last layer(s) (sent raw, no AE)."""
    _check_backend(backend)
    if not layout.topk_only:
        return (torch.zeros((0,), dtype=v.dtype, device=v.device),
                torch.zeros((0,), dtype=torch.int32, device=v.device))
    if backend == "fused":
        vals_list, idx_list = _fused_select_lists(
            v, layout, (ROLE_TOPK_ONLY,), extract)
    else:
        vals_list, idx_list = _per_leaf_select(v, layout.topk_only,
                                               backend)
    return (torch.cat(vals_list),
            torch.cat([i.to(torch.int32) for i in idx_list]))


def fused_accumulate_select(g, u, v, layout: GradientLayout, momentum: float,
                            use_momentum: bool = True, extract: str = "auto"):
    """THE fused hot path (``topk_backend="fused"``): one kernel sweep
    does the EF accumulate and the segmented top-k over compressed and
    topk_only leaves, then a small merge over the candidate pool.

    Returns (u', v', vals (mu_pad,), idx (mu_pad,), last_vals (k_last,),
    last_idx (k_last,))."""
    roles = (ROLE_COMPRESSED, ROLE_TOPK_ONLY)
    ex, block, _, _, n_cand, slots = _fused_meta(layout, roles, extract)
    empty = (torch.zeros((0,), dtype=v.dtype, device=v.device),
             torch.zeros((0,), dtype=torch.int32, device=v.device))
    if not slots:                        # nothing selectable
        u2, v2 = momentum_correct(u, v, g, momentum) if use_momentum \
            else (u, v + g)
        return (u2, v2) + empty + empty
    seg, kcap, active = _device_meta(layout, roles, extract, g.device)
    u2, v2, cv, ci, cs = K_ops.fused_ef_topk(
        g, u, v, seg, kcap, momentum, bool(use_momentum), n_cand,
        block=block, extract=ex, active=active)
    vals_list, idx_list = _merge_candidates(cv, ci, cs, slots)
    del cv, ci, cs
    nc = len(layout.compressed)
    vals, idx = _pad_compressed(vals_list[:nc], idx_list[:nc], layout,
                                v.dtype)
    if layout.topk_only:
        last = (torch.cat(vals_list[nc:]), torch.cat(idx_list[nc:]))
    else:
        last = empty
    return (u2, v2, vals, idx) + last


def dense_segments(g, layout: GradientLayout):
    """Only the exempt-dense leaf segments, concatenated."""
    if not layout.dense:
        return torch.zeros((0,), dtype=g.dtype, device=g.device)
    return torch.cat([g[l.offset:l.offset + l.size] for l in layout.dense])


def scatter_dense_segments(vec, layout: GradientLayout, n: int):
    """Inverse of :func:`dense_segments` into a length-n dense vector."""
    out = torch.zeros((n,), dtype=vec.dtype, device=vec.device)
    off = 0
    for l in layout.dense:
        out[l.offset:l.offset + l.size] = vec[off:off + l.size]
        off += l.size
    return out


def scatter_to_dense(values, indices, n: int):
    """Scatter-add sparse (values, indices) into a length-n vector;
    indices >= n (the sentinel) are dropped."""
    out = torch.zeros((n + 1,), dtype=values.dtype, device=values.device)
    out.index_add_(0, indices.long().clamp(0, n), values)
    return out[:n]


def gather_at(v, indices):
    """Gather v at indices; a sentinel index (>= len(v)) yields 0."""
    n = v.shape[0]
    vals = v[indices.long().clamp(max=n - 1)]
    return torch.where(indices < n, vals, torch.zeros_like(vals))


def innovation_frac(innovation_sparsity: float, sparsity: float) -> float:
    """The PS innovation fraction of the top-k support."""
    return innovation_sparsity / max(sparsity, 1e-12)


def innovation_k(mu: int, frac: float) -> int:
    """Innovation count for a length-``mu`` support: one rounding for the
    compressor and the byte accounting."""
    return max(1, int(round(mu * frac)))


def select_innovation(values: torch.Tensor, frac: float):
    """PS innovation: the top ``frac`` of the support values by magnitude,
    kept in place (zeros elsewhere).  Returns (innovation vector (mu_pad,),
    local indices (k_inv,) int32 in ``lax.top_k`` order: |value|
    descending, lowest index first)."""
    k_inv = innovation_k(values.shape[0], frac)
    key = magnitude_rank(values) << 32 | torch.arange(
        values.shape[0], device=values.device)
    idx = torch.topk(key, k_inv, largest=False, sorted=True).indices
    inno = torch.zeros_like(values)
    inno[idx] = values[idx]
    return inno, idx.to(torch.int32)
