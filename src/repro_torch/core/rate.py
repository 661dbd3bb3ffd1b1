"""Transmission-rate accounting (paper Section VI-A), derived from the
exchange-plan IR; counterpart of ``repro.core.rate``.  Host-side
functions of the layout and, when given, the concrete index set (exact
DEFLATE size): ``rate_report`` prices one steady step's payload per node,
``total_information_tb`` sums it over the nodes and the steps, and
``wire_payload_terms`` predicts the transport's wire tally of one steady
step by collective kind."""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.configs.base import CompressionConfig
from repro_torch.core.sparsify import GradientLayout
from repro_torch.dist import plan as XP

BYTES_F32 = 4


def deflate_bytes(indices: Optional[np.ndarray], count: int, n: int) -> int:
    """Exact DEFLATE size when indices given; else the entropy estimate
    count*ceil(log2(n))/8 bytes."""
    if indices is not None and len(indices):
        return len(zlib.compress(np.asarray(indices, np.int32).tobytes(), 6))
    bits = max(1, int(np.ceil(np.log2(max(n, 2)))))
    return int(np.ceil(count * bits / 8))


@dataclass(frozen=True)
class RateReport:
    method: str
    bytes_per_node: float
    bytes_leader: float
    bytes_other: float
    baseline_bytes: float
    compression_ratio: float
    compression_ratio_leader: float
    compression_ratio_other: float


def rate_report(cc: CompressionConfig, layout: GradientLayout, K: int,
                indices: Optional[np.ndarray] = None,
                inno_indices: Optional[np.ndarray] = None,
                count_exempt: bool = True,
                transport: Optional[str] = None) -> RateReport:
    """Per-node payload of the method's steady phase, priced from the
    same ops the compressor executes, on ``transport`` (default
    ``cc.transport``): on ``ring_packed`` the packed exchanges and the
    index broadcast cost their real packed bytes, on ``ring_q8`` the q8
    reduction its int8 bytes.  ``indices`` / ``inno_indices`` price the
    support and the PS innovation set at their exact DEFLATE size.
    ``count_exempt=False`` is the paper's own accounting (exempt first
    layer left out).  ``lgc_ps`` reports the leader's payload (common
    encoding + innovation) apart from the others' (innovation only);
    every other method reports the average for all three."""
    plan = XP.build_plan(cc, layout, K, transport=transport)
    baseline = layout.n_total * BYTES_F32
    b_leader, b_other = XP.rate_terms(plan, indices=indices,
                                      inno_indices=inno_indices,
                                      count_exempt=count_exempt,
                                      deflate=deflate_bytes)
    b_avg = (b_leader + (K - 1) * b_other) / K
    if cc.method == "lgc_ps":
        return RateReport(cc.method, b_avg, b_leader, b_other, baseline,
                          baseline / b_avg, baseline / b_leader,
                          baseline / b_other)
    return RateReport(cc.method, b_avg, b_avg, b_avg, baseline,
                      baseline / b_avg, baseline / b_avg, baseline / b_avg)


def total_information_tb(bytes_per_node: float, K: int, steps: int) -> float:
    """Information all K nodes send over ``steps`` steps, in TB (the
    paper's Table IV "Information" column)."""
    return bytes_per_node * K * steps / 1e12


def wire_payload_terms(cc: CompressionConfig, layout: GradientLayout,
                       K: int, transport: Optional[str] = None,
                       axis_sizes: Optional[Sequence[int]] = None,
                       ) -> Dict[str, float]:
    """{collective kind: bytes} one steady-phase step of the method puts
    on a node's wire (``transport``, default ``cc.transport``), over a dp
    mesh of ``axis_sizes`` (default one axis of K): ``plan.wire_terms``
    of the same op list ``rate_report`` prices and the compressor runs.
    It differs from the rate by the ring's 2(K-1)/K factor and chunk
    padding, and on the float wires by gathering (K-1) raw f32 values
    and int32 indices where the rate prices one DEFLATE-coded send."""
    plan = XP.build_plan(cc, layout, K, transport=transport)
    return XP.wire_terms(plan, axis_sizes=axis_sizes)
