"""Architecture configs.  Importing this package registers the ported
archs (the other arch families arrive with their model code)."""
from repro_torch.configs.base import (ARCH_REGISTRY, INPUT_SHAPES,
                                      CompressionConfig, InputShape,
                                      ModelConfig, TrainConfig, get_arch,
                                      list_archs)
from repro_torch.configs import (  # noqa: F401
    arctic_480b,
    granite_8b,
    jamba_v0_1_52b,
    llama3_2_1b,
    mamba2_130m,
    musicgen_medium,
    phi3_medium_14b,
    qwen2_1_5b,
)

__all__ = ["ARCH_REGISTRY", "INPUT_SHAPES", "CompressionConfig",
           "InputShape", "ModelConfig", "TrainConfig", "get_arch",
           "list_archs"]
