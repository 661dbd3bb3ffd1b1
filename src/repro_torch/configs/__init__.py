"""Architecture configs.  Importing this package registers the ported
archs (the other arch families arrive with their model code)."""
from repro_torch.configs.base import (ARCH_REGISTRY, CompressionConfig,
                                      ModelConfig, TrainConfig, get_arch)
from repro_torch.configs import llama3_2_1b  # noqa: F401

__all__ = ["ARCH_REGISTRY", "CompressionConfig", "ModelConfig",
           "TrainConfig", "get_arch"]
