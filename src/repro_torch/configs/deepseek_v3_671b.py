"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8, MTP
[arXiv:2412.19437].

61 layers, d_model 7168, 128 heads, expert width 2048, vocab 129280;
MoE on every block.  Attention is multi-head latent attention: queries,
keys and values pass through low-rank latents, and the decode cache
holds only the 512-wide latent and the 64-wide rope key of each token.
One multi-token prediction block predicts token t + 2.
"""
from repro_torch.configs.base import (MLAConfig, ModelConfig, MoEConfig,
                                      register_arch)


@register_arch("deepseek-v3-671b")
def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b",
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=128,
        n_kv_heads=128,           # MLA: every head reads the latent cache
        d_ff=18432,               # unused: MoE on every block
        vocab_size=129280,
        head_dim=128,
        mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                      qk_nope_head_dim=128, qk_rope_head_dim=64,
                      v_head_dim=128),
        moe=MoEConfig(num_experts=256, top_k=8, d_ff_expert=2048,
                      num_shared_experts=1, aux_loss_coef=0.0001),
        mtp_depth=1,
        source="arXiv:2412.19437",
    )
