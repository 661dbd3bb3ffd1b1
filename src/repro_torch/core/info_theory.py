"""Section III: information plane of gradients in distributed training;
the port's own copy of ``repro.core.info_theory`` (numpy, host-side).

Histogram estimators for marginal entropy H(g2), conditional entropy
H(g2|g1) and mutual information I(g1;g2) between the gradient vectors of
two nodes (eq. 1).  The paper quantizes with a uniform quantizer and
builds the (joint) histogram; the bin count is a parameter (the paper's
nominal 2^32 levels collapse to the occupied bins, as in any practical
histogram).  The same inputs give the reference's ``InfoPlane``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _hist2d(a: np.ndarray, b: np.ndarray, bins: int):
    lo = min(a.min(), b.min())
    hi = max(a.max(), b.max())
    if hi <= lo:
        hi = lo + 1e-12
    joint, _, _ = np.histogram2d(a, b, bins=bins, range=[[lo, hi], [lo, hi]])
    return joint


def entropy(p: np.ndarray) -> float:
    p = p[p > 0]
    return float(-(p * np.log2(p)).sum())


@dataclass(frozen=True)
class InfoPlane:
    h_marginal: float        # H(g2)
    h_conditional: float     # H(g2 | g1)
    mutual_information: float
    mi_fraction: float       # I / H — the paper's ~80% finding


def gradient_information(g1, g2, bins: int = 256) -> InfoPlane:
    """Estimate H(g2), H(g2|g1) and I(g1;g2) from two same-layer gradient
    vectors of different nodes (paper eq. 1).  ``g1``, ``g2``: anything
    numpy reads (a CPU tensor, a numpy array)."""
    g1 = np.asarray(g1, np.float64).ravel()
    g2 = np.asarray(g2, np.float64).ravel()
    joint = _hist2d(g1, g2, bins)
    pj = joint / max(joint.sum(), 1.0)
    p1 = pj.sum(axis=1)
    p2 = pj.sum(axis=0)
    h2 = entropy(p2)
    h_joint = entropy(pj.ravel())
    h1 = entropy(p1)
    mi = max(h1 + h2 - h_joint, 0.0)
    h_cond = max(h2 - mi, 0.0)
    frac = mi / h2 if h2 > 0 else 0.0
    return InfoPlane(h2, h_cond, mi, frac)
