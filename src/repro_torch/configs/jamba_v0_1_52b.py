"""jamba-v0.1-52b [hybrid] — Mamba + attention 1:7 interleave, MoE 16
experts top-2 [arXiv:2403.19887].

32 layers = 4 superblocks of 8 (1 attention layer + 7 mamba layers, the
attention layer at position 4 of each, as in the paper).  MoE replaces
the MLP on every other layer (every_n_layers=2).
"""
from repro_torch.configs.base import (ATTN, MAMBA, ModelConfig, MoEConfig,
                                      SSMConfig, register_arch)


@register_arch("jamba-v0.1-52b")
def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=65536,
        block_pattern=(MAMBA, MAMBA, MAMBA, MAMBA, ATTN, MAMBA, MAMBA, MAMBA),
        moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=14336,
                      every_n_layers=2),
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64,
                      chunk_size=256),
        source="arXiv:2403.19887",
    )
