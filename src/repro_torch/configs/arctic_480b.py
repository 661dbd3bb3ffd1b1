"""arctic-480b [moe] — 128 experts top-2 + dense residual MLP
[hf:Snowflake/snowflake-arctic-base]."""
from repro_torch.configs.base import ModelConfig, MoEConfig, register_arch


@register_arch("arctic-480b")
def config() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b",
        family="moe",
        n_layers=35,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=4864,                # dense residual path width
        vocab_size=32000,
        moe=MoEConfig(num_experts=128, top_k=2, d_ff_expert=4864,
                      dense_residual_d_ff=4864),
        source="hf:Snowflake/snowflake-arctic-base",
    )
