"""phi3-medium-14b [dense] — RoPE SwiGLU GQA [arXiv:2404.14219]."""
from repro_torch.configs.base import ModelConfig, register_arch


@register_arch("phi3-medium-14b")
def config() -> ModelConfig:
    return ModelConfig(
        name="phi3-medium-14b",
        family="dense",
        n_layers=40,
        d_model=5120,
        n_heads=40,
        n_kv_heads=10,
        d_ff=17920,
        vocab_size=100352,
        rope_theta=10000.0,
        source="arXiv:2404.14219",
    )
