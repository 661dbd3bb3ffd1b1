"""The MoE and Mamba2 archs against the JAX reference: arctic-480b
(attention + MoE with the dense residual), mamba2-130m (Mamba2 blocks
alone) and jamba-v0.1-52b (the 8-position superblock of Mamba2 and
attention, MoE on every other position) at their ``reduced()`` configs
(_torch_arch_checks: loss, aux, every gradient, prefill, decode), and one
CPU run of the training entry point on each.  Their geometry is in
test_torch_archs.py; they sit in a file of their own so that file stays
short for an xdist worker."""
import numpy as np
import pytest

from _one_thread import one_thread  # noqa: F401  (autouse)
from _torch_arch_checks import check_loss_grads_prefill_decode

NEW_ARCHS = ["arctic-480b", "mamba2-130m", "jamba-v0.1-52b"]



@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_loss_grads_prefill_decode_match_reference(arch):
    check_loss_grads_prefill_decode(arch)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_train_entry_point_runs_on_cpu(arch):
    """train.main at the smoke config: lgc_rar with the kernel encoder
    (K3's plain version) and the fused sweep (K1's) on the expert stacks
    and the SSM leaves, through all three phases, finite losses.  jamba
    (16 smoke layers, ~16M parameters) takes the block top-k (K6's plain
    version): the fused sweep's plain version spends ~14 s a sparsified
    step on the CPU there, K6's ~4."""
    from repro_torch.launch import train
    topk = "pallas" if arch == "jamba-v0.1-52b" else "fused"
    history = train.main([
        "--arch", arch, "--smoke", "--steps", "3", "--batch", "2", "--seq",
        "16", "--compression", "lgc_rar", "--topk-backend", topk,
        "--ae-backend", "pallas", "--data-shards", "2", "--warmup-steps",
        "1", "--ae-train-steps", "1", "--log-every", "1", "--device",
        "cpu"])
    assert [h["phase"] for h in history] == ["warmup", "topk_ae",
                                             "compressed"]
    assert all(np.isfinite(h["loss"]) for h in history)
