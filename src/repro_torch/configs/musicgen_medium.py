"""musicgen-medium [audio] — decoder-only over EnCodec tokens
[arXiv:2306.05284].

Backbone only, as in the reference: the EnCodec codec frontend is
stubbed, and the tokens are codebook ids.  Its blocks are the default
attention pattern, so the port's decoder runs it.
"""
from repro_torch.configs.base import ModelConfig, register_arch


@register_arch("musicgen-medium")
def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium",
        family="audio",
        n_layers=48,
        d_model=1536,
        n_heads=24,
        n_kv_heads=24,
        d_ff=6144,
        vocab_size=2048,          # EnCodec codebook size
        source="arXiv:2306.05284",
    )
