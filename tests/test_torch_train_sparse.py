"""sparse_gd and dgc: the port's trainer against the reference loop of
_torch_train_common.trajectory, 6 steps with K=2 nodes."""
import pytest

from _one_thread import one_thread  # noqa: F401  (autouse)
from _torch_train_common import trajectory


@pytest.mark.parametrize("backend", ["pallas", "fused"])
@pytest.mark.parametrize("method", ["sparse_gd", "dgc"])
def test_sparse_trajectory_matches_reference(method, backend):
    """sparse_gd and dgc, sparsified from the end of warm-up on: the
    reference with its jnp top-k beside the port's block top-k (K6's
    plain version, one per leaf) or fused sweep (K1's plain version,
    momentum off for sparse_gd); each node clears its own sent set."""
    assert trajectory(method, backend) == ["warmup"] * 2 + ["topk_ae"] * 4
