"""Architecture configs.  Importing this package registers the
reference's ten assigned archs."""
from repro_torch.configs.base import (ARCH_REGISTRY, INPUT_SHAPES,
                                      CompressionConfig, InputShape,
                                      ModelConfig, TrainConfig, get_arch,
                                      list_archs)
from repro_torch.configs import (  # noqa: F401
    arctic_480b,
    deepseek_v3_671b,
    granite_8b,
    jamba_v0_1_52b,
    llama3_2_1b,
    llama3_2_vision_90b,
    mamba2_130m,
    musicgen_medium,
    phi3_medium_14b,
    qwen2_1_5b,
)

# the reference's assigned pool (10 archs, 6 families), in its order: the
# dry run's --all iterates it
ASSIGNED_ARCHS = (
    "phi3-medium-14b",
    "deepseek-v3-671b",
    "musicgen-medium",
    "jamba-v0.1-52b",
    "arctic-480b",
    "llama3.2-1b",
    "llama-3.2-vision-90b",
    "mamba2-130m",
    "granite-8b",
    "qwen2-1.5b",
)

__all__ = ["ARCH_REGISTRY", "ASSIGNED_ARCHS", "INPUT_SHAPES",
           "CompressionConfig", "InputShape", "ModelConfig", "TrainConfig",
           "get_arch", "list_archs"]
