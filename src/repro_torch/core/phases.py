"""Three-phase LGC training schedule (paper Section V-B); counterpart of
``repro.core.phases``."""
from repro_torch.configs.base import CompressionConfig

PHASE_WARMUP = "warmup"
PHASE_TOPK_AE = "topk_ae"
PHASE_COMPRESSED = "compressed"


def phase_for_step(step: int, cc: CompressionConfig) -> str:
    if cc.method == "none":
        return PHASE_WARMUP
    if step < cc.warmup_steps:
        return PHASE_WARMUP
    if cc.method in ("lgc_ps", "lgc_rar", "lgc_rar_q8"):
        if step < cc.warmup_steps + cc.ae_train_steps:
            return PHASE_TOPK_AE
        return PHASE_COMPRESSED
    # sparse_gd / dgc: sparsified from the end of warm-up onward
    return PHASE_TOPK_AE
