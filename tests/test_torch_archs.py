"""The archs the port's decoder runs besides llama3.2-1b against the JAX
reference: qwen2-1.5b, granite-8b, phi3-medium-14b and musicgen-medium
(attention blocks), arctic-480b (attention + MoE with the dense
residual), mamba2-130m (Mamba2 blocks alone), jamba-v0.1-52b (the
8-position superblock of Mamba2 and attention, MoE on every other
position), deepseek-v3-671b (latent attention, MoE with a shared
expert, MTP) and llama-3.2-vision-90b (cross-attention over encoder
embeddings): their published geometry and every config field, the
registry (the reference's ten assigned archs) and the input shapes;
and for the four attention archs, at each one's ``reduced()`` config
(f32) with the reference's weights carried across (qwen2's QKV biases
drawn non-zero), the loss and every gradient leaf, prefill's logits and
cache, and 3 decode steps (_torch_arch_checks; the MoE and Mamba2
archs' are in test_torch_archs_moe_ssm.py, deepseek's and vision's in
test_torch_archs_mla_cross.py).
"""
import dataclasses

import pytest

from _torch_arch_checks import check_loss_grads_prefill_decode
from repro.configs import INPUT_SHAPES as REF_SHAPES
from repro.configs import get_arch as ref_get_arch
from repro_torch.configs import INPUT_SHAPES, get_arch, list_archs

ARCHS = ["qwen2-1.5b", "granite-8b", "phi3-medium-14b", "musicgen-medium",
         "arctic-480b", "mamba2-130m", "jamba-v0.1-52b", "deepseek-v3-671b",
         "llama-3.2-vision-90b"]
GEOMETRY = {
    "phi3-medium-14b": (40, 5120, 40, 10, 17920, 100352),
    "musicgen-medium": (48, 1536, 24, 24, 6144, 2048),
    "granite-8b": (36, 4096, 32, 8, 14336, 49152),
    "qwen2-1.5b": (28, 1536, 12, 2, 8960, 151936),
    "arctic-480b": (35, 7168, 56, 8, 4864, 32000),
    "mamba2-130m": (24, 768, 0, 0, 0, 50280),
    "jamba-v0.1-52b": (32, 4096, 32, 8, 14336, 65536),
    "deepseek-v3-671b": (61, 7168, 128, 128, 18432, 129280),
    "llama-3.2-vision-90b": (100, 8192, 64, 8, 28672, 128256),
}


def _same(a, b) -> bool:
    """Field equality across the two packages' dataclasses."""
    if dataclasses.is_dataclass(a):
        return dataclasses.is_dataclass(b) and \
            dataclasses.asdict(a) == dataclasses.asdict(b)
    return a == b


@pytest.mark.parametrize("arch", ARCHS)
def test_exact_published_geometry(arch):
    """The numbers of tests/test_archs_smoke.py::
    test_exact_assigned_geometry, and every field the port's config has
    equal to the reference's (name, family, source, rope, bias, tying,
    the MoE, SSM and MLA geometry, the encoder's, MTP), at full size and
    at ``reduced()``."""
    cfg = get_arch(arch)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_ff, cfg.vocab_size) == GEOMETRY[arch]
    ref = ref_get_arch(arch)
    for f in dataclasses.fields(cfg):
        assert _same(getattr(cfg, f.name), getattr(ref, f.name)), f.name
    for f in dataclasses.fields(cfg.reduced()):
        assert _same(getattr(cfg.reduced(), f.name),
                     getattr(ref.reduced(), f.name)), f.name
    pattern = {"mamba2-130m": ("mamba",),
               "jamba-v0.1-52b": ("mamba",) * 4 + ("attn",) + ("mamba",) * 3,
               "llama-3.2-vision-90b": ("attn",) * 4 + ("cross",)}
    assert cfg.block_pattern == pattern.get(arch, ("attn",))
    if arch == "arctic-480b":
        assert cfg.moe.num_experts == 128 and cfg.moe.top_k == 2
        assert cfg.moe.dense_residual_d_ff == 4864
        assert cfg.reduced().moe.capacity_factor == 8.0
    if arch == "jamba-v0.1-52b":
        assert cfg.moe.every_n_layers == 2 and cfg.ssm.d_state == 16
    if cfg.ssm is not None:
        s = cfg.reduced().ssm
        assert (s.d_state, s.head_dim, s.chunk_size) == (16, 32, 32)
    if arch == "qwen2-1.5b":
        assert cfg.qkv_bias and cfg.tie_embeddings
    if arch == "musicgen-medium":
        assert cfg.family == "audio" and cfg.n_heads == cfg.n_kv_heads
    if arch == "deepseek-v3-671b":
        m, mo = cfg.mla, cfg.moe
        assert (m.q_lora_rank, m.kv_lora_rank, m.qk_nope_head_dim,
                m.qk_rope_head_dim, m.v_head_dim) == (1536, 512, 128, 64, 128)
        assert (mo.num_experts, mo.top_k, mo.d_ff_expert,
                mo.num_shared_experts) == (256, 8, 2048, 1)
        assert cfg.mtp_depth == 1 and cfg.head_dim == 128
        m = cfg.reduced().mla
        assert (m.q_lora_rank, m.kv_lora_rank, m.qk_nope_head_dim,
                m.qk_rope_head_dim, m.v_head_dim) == (64, 32, 32, 16, 32)
    if arch == "llama-3.2-vision-90b":
        assert cfg.family == "vlm" and cfg.rope_theta == 500000.0
        assert (cfg.num_encoder_tokens, cfg.encoder_dim) == (1601, 1280)
        assert (cfg.reduced().num_encoder_tokens,
                cfg.reduced().encoder_dim) == (16, 128)
        assert cfg.n_blocks == 20 and cfg.reduced().n_layers == 10
    else:
        assert cfg.num_encoder_tokens == cfg.reduced().encoder_dim == 0


def test_registry_and_input_shapes():
    """The port's archs are the reference's assigned ten."""
    from repro.configs import ASSIGNED_ARCHS
    assert set(list_archs()) == set(ARCHS) | {"llama3.2-1b"}
    assert set(list_archs()) == set(ASSIGNED_ARCHS)
    assert len(list_archs()) == 10
    assert list_archs() == sorted(list_archs())
    assert INPUT_SHAPES.keys() == REF_SHAPES.keys()
    for name, shape in INPUT_SHAPES.items():
        assert dataclasses.astuple(shape) == dataclasses.astuple(
            REF_SHAPES[name])


@pytest.mark.parametrize("arch", ARCHS[:4])
def test_loss_grads_prefill_decode_match_reference(arch):
    """The attention archs (the MoE and Mamba2 ones: in
    test_torch_archs_moe_ssm.py)."""
    check_loss_grads_prefill_decode(arch)
