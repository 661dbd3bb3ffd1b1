"""qwen2-1.5b [dense] — GQA, QKV bias [arXiv:2407.10671]."""
from repro_torch.configs.base import ModelConfig, register_arch


@register_arch("qwen2-1.5b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-1.5b",
        family="dense",
        n_layers=28,
        d_model=1536,
        n_heads=12,
        n_kv_heads=2,
        d_ff=8960,
        vocab_size=151936,
        rope_theta=1000000.0,
        qkv_bias=True,
        tie_embeddings=True,
        source="arXiv:2407.10671",
    )
