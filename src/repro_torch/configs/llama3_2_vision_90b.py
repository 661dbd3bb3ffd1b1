"""llama-3.2-vision-90b [vlm] — cross-attention image layers
[hf:meta-llama/Llama-3.2-11B-Vision].

100 layers = 20 superblocks of (4 self-attention + 1 cross-attention).
The cross-attention layers read precomputed patch embeddings (B, 1601,
1280); the vision encoder and projector are a stub, and the data stream
draws the embeddings.
"""
from repro_torch.configs.base import ATTN, CROSS, ModelConfig, register_arch


@register_arch("llama-3.2-vision-90b")
def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b",
        family="vlm",
        n_layers=100,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=28672,
        vocab_size=128256,
        rope_theta=500000.0,
        block_pattern=(ATTN, ATTN, ATTN, ATTN, CROSS),
        num_encoder_tokens=1601,   # ViT-H/14 at 560 px: 1601 patch tokens
        encoder_dim=1280,
        source="hf:meta-llama/Llama-3.2-11B-Vision",
    )
