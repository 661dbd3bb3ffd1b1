"""deepseek-v3-671b (latent attention, MoE with a shared expert, the MTP
head) and llama-3.2-vision-90b (four attention blocks and a
cross-attention block a superblock, reading encoder embeddings) against
the JAX reference at their ``reduced()`` configs (_torch_arch_checks:
the loss, aux, mtp_loss, every gradient, prefill and 3 decode steps;
vision's gates set to 0.5 in both trees), and one CPU run of the
training and of the serving entry point on each.  Their geometry is in
test_torch_archs.py, their flat layout in test_torch_layout.py."""
import numpy as np
import pytest

from _one_thread import one_thread  # noqa: F401  (autouse)
from _torch_arch_checks import check_loss_grads_prefill_decode

ARCHS = ["deepseek-v3-671b", "llama-3.2-vision-90b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_grads_prefill_decode_match_reference(arch):
    check_loss_grads_prefill_decode(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_entry_point_runs_on_cpu(arch):
    """train.main at the smoke config: lgc_rar with the kernel encoder
    (K3's plain version) through all three phases, the fused sweep (K1's
    plain version) on the MLA leaves and the MTP subtree; vision (10
    smoke layers) takes the block top-k (K6's) on its cross layers'
    (1,)-shaped gates and its encoder embeddings from the stream, as
    jamba does (the fused sweep's plain version costs seconds a step on
    the CPU there); finite losses, and deepseek's MTP loss in every
    record."""
    from repro_torch.launch import train
    topk = "pallas" if arch == "llama-3.2-vision-90b" else "fused"
    history = train.main([
        "--arch", arch, "--smoke", "--steps", "3", "--batch", "2", "--seq",
        "16", "--compression", "lgc_rar", "--topk-backend", topk,
        "--ae-backend", "pallas", "--data-shards", "2", "--warmup-steps",
        "1", "--ae-train-steps", "1", "--log-every", "1", "--device",
        "cpu"])
    assert [h["phase"] for h in history] == ["warmup", "topk_ae",
                                             "compressed"]
    assert all(np.isfinite(h["loss"]) for h in history)
    mtp = [h.get("mtp_loss") for h in history]
    if arch == "deepseek-v3-671b":
        assert all(np.isfinite(m) and 0 < m < h["loss"]
                   for m, h in zip(mtp, history))
    else:
        assert mtp == [None] * 3


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_entry_point_runs_on_cpu(arch):
    """serve.run at the smoke config, greedy: vision draws its encoder
    embeddings after the prompt and decodes from the cross cache; the
    generated tokens are in the vocabulary."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    cfg = get_arch(arch).reduced()
    out = serve.run(cfg, serve.parse_args([
        "--arch", arch, "--smoke", "--batch", "2", "--prompt-len", "12",
        "--gen", "4", "--device", "cpu"]))
    assert out["tokens"].shape == (2, 4)
    assert ((0 <= out["tokens"]) & (out["tokens"] < 512)).all()
    enc = out["encoder_embeds"]
    if arch == "llama-3.2-vision-90b":
        assert enc.shape == (2, 16, 128) and enc.dtype == np.float32
        rng = np.random.default_rng(0)
        rng.integers(0, 512, (2, 12))
        np.testing.assert_array_equal(enc, rng.normal(size=enc.shape)
                                      .astype(np.float32))
    else:
        assert enc is None
