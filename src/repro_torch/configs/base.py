"""Config system: :class:`ModelConfig` (architecture), :class:`TrainConfig`
(optimizer/schedule) and :class:`CompressionConfig` (the paper's
technique), plus the arch registry and the reference's input shapes.
Counterpart of ``repro.configs.base``, cut to what the ported slices
run: superblocks of attention (or latent attention), Mamba2 and
cross-attention blocks with dense or MoE FFNs, the multi-token
prediction head, and the fields of the six compressors on the emulated
transports.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Callable, Dict, Optional, Sequence, Tuple

# layer kinds of a superblock pattern
ATTN = "attn"          # self-attention (GQA; sliding-window if window set)
MLA = "mla"            # a reference kind the model refuses (see Model)
MAMBA = "mamba"        # Mamba2 SSD block
CROSS = "cross"        # cross-attention over encoder embeddings


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int                 # hidden size of each expert MLP
    num_shared_experts: int = 0      # always-on shared experts
    dense_residual_d_ff: int = 0     # Arctic's parallel dense MLP (0 = off)
    aux_loss_coef: float = 0.001     # router load-balance loss
    every_n_layers: int = 1          # MoE on every n-th block position
    capacity_factor: float = 1.25    # per-expert capacity (train/prefill)


@dataclass(frozen=True)
class MLAConfig:
    """Latent attention geometry [arXiv:2412.19437]: with ``mla`` set,
    every ``ATTN`` position is latent attention."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 SSD geometry [arXiv:2405.21060]."""
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk_size: int = 256


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm |
                                     # audio; the model dispatches on
                                     # block_pattern
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    block_pattern: Tuple[str, ...] = (ATTN,)
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    qkv_bias: bool = False
    tie_embeddings: bool = False
    sliding_window: int = 0
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # cross-attention's encoder embeddings (B, num_encoder_tokens,
    # encoder_dim), drawn by the data stream (the frontend is a stub)
    num_encoder_tokens: int = 0
    encoder_dim: int = 0
    mtp_depth: int = 0               # multi-token prediction depth
    dtype: str = "bfloat16"
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def n_blocks(self) -> int:
        assert self.n_layers % len(self.block_pattern) == 0, self.name
        return self.n_layers // len(self.block_pattern)

    def reduced(self, **overrides) -> "ModelConfig":
        """The smoke-test variant (the reference's ``reduced``): 2 blocks,
        d_model 256, <= 4 experts, f32."""
        small: Dict = dict(
            n_layers=2 * len(self.block_pattern),
            d_model=256,
            n_heads=min(self.n_heads, 8) if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads else 0,
            d_ff=512 if self.d_ff else 0,
            vocab_size=512,
            head_dim=32 if self.n_heads else 0,
            num_encoder_tokens=16 if self.num_encoder_tokens else 0,
            encoder_dim=128 if self.encoder_dim else 0,
            name=self.name + "-smoke",
            dtype="float32",
        )
        if self.moe is not None:
            small["moe"] = replace(
                self.moe, num_experts=4, top_k=min(self.moe.top_k, 2),
                d_ff_expert=256,
                num_shared_experts=min(self.moe.num_shared_experts, 1),
                dense_residual_d_ff=256 if self.moe.dense_residual_d_ff else 0,
                capacity_factor=8.0)   # dropless at smoke scale
        if self.mla is not None:
            small["mla"] = MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                                     qk_nope_head_dim=32, qk_rope_head_dim=16,
                                     v_head_dim=32)
        if self.ssm is not None:
            small["ssm"] = replace(self.ssm, d_state=16, head_dim=32,
                                   chunk_size=32)
        if self.sliding_window:
            small["sliding_window"] = 64
        small.update(overrides)
        return replace(self, **small)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # "train" | "prefill" | "decode"


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class CompressionConfig:
    """The paper's technique (fields of ``repro.configs.base`` that the
    ported methods read)."""
    method: str = "none"   # none|sparse_gd|dgc|lgc_ps|lgc_rar|lgc_rar_q8
    sparsity: float = 0.001          # alpha = 0.1% top-k
    innovation_sparsity: float = 1e-5  # 0.001% coarse innovation (lgc_ps)
    warmup_steps: int = 200          # phase-1 raw-gradient updates
    ae_train_steps: int = 300        # phase-2 (AE online training) length
    ae_lr: float = 1e-3
    lambda_rec: float = 1.0          # lgc_ps AE loss weights (eq. 7)
    lambda_sim: float = 0.5
    momentum_correction: float = 0.9
    transport: str = "mesh"  # mesh | ring | ring_q8 | ring_hier | ring_packed
    wire_buckets: int = 1            # buckets per ring exchange
    q8_scale_block: int = 0          # 0 = SCALE_BLOCK
    # ring_hier's per-level message caps, in elements (0 = one message per
    # hop; bytes unchanged either way).  They act across processes
    # (``GradientCompressor.dist_step``); the emulated wires ignore them,
    # as a cap changes nothing on the stacked node axis
    ring_intra_chunk: int = 0
    ring_inter_chunk: int = 0
    topk_backend: str = "jnp"        # jnp | pallas | fused
    extract_backend: str = "auto"    # auto | loop | bitonic
    ae_backend: str = "jnp"          # jnp | pallas (the fused-matmul kernel)
    # exchange guard policy (dist.chaos.GUARD_POLICIES): off | scrub |
    # skip_round | fail_fast
    guard: str = "off"
    # one int32 checksum word on every packed payload (+4 bytes, priced)
    guard_checksum: bool = False
    # seeded fault injection (dist.chaos.FaultSpec); any count or node set
    # wraps the transport in chaos:<base>.  fault_ops: comma-separated
    # plan-op labels to target ("" = all ops)
    fault_seed: int = 0
    fault_bitflips: int = 0
    fault_nans: int = 0
    fault_infs: int = 0
    fault_drop_node: int = -1
    fault_stale_node: int = -1
    fault_ops: str = ""


@dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "sgd_momentum"
    learning_rate: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 1e-4
    adam_b1: float = 0.9
    adam_b2: float = 0.95
    grad_clip_norm: float = 0.0
    steps: int = 100
    seed: int = 0
    compression: CompressionConfig = field(default_factory=CompressionConfig)


ARCH_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register_arch(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        ARCH_REGISTRY[name] = fn
        return fn
    return deco


def get_arch(name: str) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (triggers registration)
    if name not in ARCH_REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: "
                       f"{sorted(ARCH_REGISTRY)}")
    return ARCH_REGISTRY[name]()


def list_archs() -> Sequence[str]:
    import repro_torch.configs  # noqa: F401
    return sorted(ARCH_REGISTRY)
