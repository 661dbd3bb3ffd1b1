"""The work of a step, counted from the configuration's shapes alone.

* ``n_params``: every weight of the family's ``params_spec``.
* ``train_flops``: 6 N tokens (forward 2, backward 4 multiply-adds per
  weight and token), the convention for a training step's useful work;
  attention's scores and the SSD scan's own products are left out.
* ``select_bytes``: what one node's error-feedback accumulate and top-k
  must move at the least, whatever kernel does it: over the selectable
  leaves (compressed and top-k-only) g read, u and v each read and
  written, in float32, and the k values (float32) and indices (int32)
  written."""
from __future__ import annotations

import math

from lgcref.lgc import layout


def n_params(spec) -> int:
    return sum(math.prod(shape) for _p, shape, _d, _i in spec)


def train_flops(spec, tokens: int) -> float:
    return 6.0 * n_params(spec) * tokens


def select_bytes(spec, sparsity: float) -> int:
    leaves = [l for l in layout(spec, sparsity) if l.role != "dense"]
    n_sel = sum(l.size for l in leaves)
    k_sel = sum(l.k for l in leaves)
    return 4 * 5 * n_sel + (4 + 4) * k_sel
