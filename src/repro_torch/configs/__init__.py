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

__all__ = ["ARCH_REGISTRY", "INPUT_SHAPES", "CompressionConfig",
           "InputShape", "ModelConfig", "TrainConfig", "get_arch",
           "list_archs"]
