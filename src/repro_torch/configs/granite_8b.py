"""granite-8b [dense] — llama-arch, code [arXiv:2405.04324]."""
from repro_torch.configs.base import ModelConfig, register_arch


@register_arch("granite-8b")
def config() -> ModelConfig:
    return ModelConfig(
        name="granite-8b",
        family="dense",
        n_layers=36,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=49152,
        rope_theta=10000.0,
        source="arXiv:2405.04324",
    )
