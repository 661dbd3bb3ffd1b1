"""The paper's Section III experiment: train ConvNet5 on two simulated
nodes and watch the per-layer mutual information between the nodes'
gradients, the empirical basis for LGC.  Counterpart of
``examples/information_plane.py``, with the same defaults (the smoke
config, 30 steps, 64 bins, batch 32 as two nodes of 16, SGD at lr 0.05,
image seed 5).

    PYTHONPATH=src python -m repro_torch.examples.information_plane \
        [--config full] [--device cpu]

``--config full`` trains ``config()``, the paper's widths, in place of
the reference example's smoke config.  Runs on the card unless
``--device cpu``; with no card it raises.  The weights are drawn from
``torch.Generator`` seed 0, not the reference's ``jax.random`` key 0, so
the printed fractions are the same experiment, not the same numbers; a
caller of :func:`mi_fractions` that passes the reference's weights gets
its numbers.
"""
from __future__ import annotations

import argparse
from typing import Dict, List

import torch

from repro_torch.configs.convnet5 import ConvNet5Config, config, smoke_config
from repro_torch.core.info_theory import gradient_information
from repro_torch.data import synthetic_image_batches
from repro_torch.launch.steps import node_grads
from repro_torch.models.convnet import convnet5_loss, init_convnet5
from repro_torch.utils import disable_tf32, resolve_device
from repro_torch.utils.tree import (tree_count_params, tree_map,
                                    tree_unflatten_vector)

NODES, BATCH, LR, BINS, DATA_SEED = 2, 32, 0.05, 64, 5


def mi_fractions(params, cfg: ConvNet5Config, steps: int = 30,
                 every: int = 5) -> Dict[int, List[float]]:
    """{step: [I/H of conv{i}/w's two node gradients, per layer]} at
    every ``every``-th of ``steps`` SGD steps on the two nodes' mean
    gradient, taken before that step's update; ``params`` on the device
    the run uses."""
    data = synthetic_image_batches(cfg.num_classes, BATCH, cfg.image_size,
                                   seed=DATA_SEED)
    device = next(iter(params["fc"].values())).device
    n = tree_count_params(params)

    def loss_fn(p, b):
        return convnet5_loss(p, cfg, b)

    out = {}
    for step in range(steps):
        b = {k: torch.from_numpy(x).to(device) for k, x in next(data).items()}
        g2, _ = node_grads(loss_fn, params, b, NODES, n)
        if step % every == 0:
            per_node = [tree_unflatten_vector(g2[k], params)
                        for k in range(NODES)]
            out[step] = [gradient_information(
                per_node[0][f"conv{i}"]["w"].cpu().numpy(),
                per_node[1][f"conv{i}"]["w"].cpu().numpy(),
                bins=BINS).mi_fraction for i in range(len(cfg.channels))]
        mean_g = tree_unflatten_vector(g2.mean(0), params)
        params = tree_map(lambda p, g: p - LR * g, params, mean_g)
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", default="smoke", choices=["smoke", "full"],
                   help="smoke_config() (the reference example's) or "
                        "config(), the paper's widths")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    disable_tf32()
    cfg = config() if args.config == "full" else smoke_config()
    params = init_convnet5(torch.Generator(device=device).manual_seed(0),
                           cfg, device)
    fracs = mi_fractions(params, cfg)
    print(f"{'step':>5s} " + " ".join(f"conv{i}:MI/H" for i in
                                      range(len(cfg.channels))))
    for step, row in fracs.items():
        print(f"{step:5d} " + " ".join(f"{f:10.2f}" for f in row))
    print("\nhigh MI fraction across middle layers ==> the common/innovation"
          "\ndecomposition that LGC's autoencoder exploits (paper Fig. 3/4).")
    return fracs


if __name__ == "__main__":
    main()
