"""Faults planted in the program's step object, for the tests that see
``correct`` come out false with the timed path broken underneath, and
for the readings that set the limits' upper ends.  Each takes the
``LGCTrainStep`` the harness built and breaks it in place:

* ``frozen``: the step returns the weights and the optimizer's state it
  was given;
* ``half_batch``: every node computes on node 0's rows, so the mean is
  over half of the batch;
* ``no_exchange``: every exchange between the nodes is left out: each
  takes its own values, and the step's result is node 0's."""
from __future__ import annotations

import torch


def frozen(lts):
    step = lts.step

    def unchanged(params, opt_state, comp_state, batch, s, phase):
        _, _, comp_state, metrics = step(params, opt_state, comp_state,
                                         batch, s, phase)
        return params, opt_state, comp_state, metrics
    lts.step = unchanged


def half_batch(lts):
    node_grads = lts.node_grads

    def halved(params, batch):
        rows = next(iter(batch.values())).shape[0] // lts.K
        return node_grads(params, {k: torch.cat([x[:rows]] * lts.K)
                                   for k, x in batch.items()})
    lts.node_grads = halved


def _scatter0(vals, idx, n):
    out = torch.zeros(n + 1, dtype=vals.dtype, device=vals.device)
    out.index_add_(0, idx[0].long().clamp(0, n), vals[0])
    return out[:n]


def no_exchange(lts):
    comp = lts.compressor
    make = comp._transport

    def local(group=None):
        t = make(group)
        t.mean = lambda x: x[0].clone()
        t.mean_q8 = lambda x: x[0].clone()
        t.all_gather = lambda x: x[:1]
        t.from_leader = lambda x, leader: x[0]
        t.broadcast_packed = lambda idx, leader, n, plan=None: idx[0]
        t.sparse_mean = lambda vals, idx, n: _scatter0(vals, idx, n)
        t.sparse_mean_packed = \
            lambda vals, idx, n, plan=None: _scatter0(vals, idx, n)
        return t
    object.__setattr__(comp, "_transport", local)


FAULTS = {"frozen": frozen, "half_batch": half_batch,
          "no_exchange": no_exchange}
