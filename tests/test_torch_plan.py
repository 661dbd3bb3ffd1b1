"""The port's exchange plan and byte pricing against the JAX reference:
the op sequence per (method, phase), the per-op and per-kind wire bytes,
the paper-style rate terms and ``rate_report`` (all exact: bytes do not
depend on the hardware), and ``execute``'s both-ways feed check."""
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
from repro.dist import plan as RXP
from repro.models.model import Model as RefModel
from repro_torch.configs import get_arch
from repro_torch.configs.base import CompressionConfig
from repro_torch.core import rate as RATE
from repro_torch.core import sparsify as SP
from repro_torch.dist import plan as XP
from repro_torch.dist.transport import SimTransport
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
@pytest.mark.parametrize("method", ["none", "lgc_rar"])
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
