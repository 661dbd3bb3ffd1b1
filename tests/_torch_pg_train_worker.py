"""One rank of tests/test_torch_pg_train.py: the port's trainer entry
point (``repro_torch.launch.train.main``) from given initial weights.

    RANK=r WORLD_SIZE=4 python tests/_torch_pg_train_worker.py INIT.npz \
        [train.py arguments]

INIT.npz holds the model's leaves p<i> and the AE's a<i> in tree order
(the reference's initial weights); ``LGCTrainStep.init`` is wrapped to
start from them, the AE momentum zero and the optimizer state fresh.
"""
import sys

import numpy as np
import torch

from repro_torch.launch import steps, train
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten


def start_from(path):
    """Wrap ``LGCTrainStep.init`` to load ``path``'s weights and AE."""
    init = steps.LGCTrainStep.init

    def wrapped(self, gen):
        params, _, comp_state = init(self, gen)
        d = np.load(path)

        def load(tree, prefix):
            return tree_unflatten(tree, [
                torch.from_numpy(d[f"{prefix}{i}"]).to(leaf.device,
                                                        leaf.dtype)
                for i, leaf in enumerate(tree_leaves(tree))])
        params = load(params, "p")
        comp_state["ae"] = load(comp_state["ae"], "a")
        comp_state["ae_mom"] = tree_map(torch.zeros_like, comp_state["ae"])
        return params, self.optimizer.init(params), comp_state
    steps.LGCTrainStep.init = wrapped


if __name__ == "__main__":
    torch.set_num_threads(1)
    start_from(sys.argv[1])
    train.main(sys.argv[2:])
    print("PASS")
