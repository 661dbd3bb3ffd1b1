"""mamba2-130m [ssm] — SSD (state-space duality) [arXiv:2405.21060]."""
from repro_torch.configs.base import (MAMBA, ModelConfig, SSMConfig,
                                      register_arch)


@register_arch("mamba2-130m")
def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m",
        family="ssm",
        n_layers=24,
        d_model=768,
        n_heads=0,                # attention-free
        n_kv_heads=0,
        d_ff=0,                   # no MLP: the mamba block expands itself
        vocab_size=50280,
        block_pattern=(MAMBA,),
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                      chunk_size=256),
        source="arXiv:2405.21060",
    )
