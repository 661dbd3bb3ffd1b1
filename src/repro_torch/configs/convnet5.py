"""ConvNet5, the paper's own Section VI-E model (5 conv layers + BN +
ReLU); counterpart of ``repro.configs.convnet5``.

Not an arch of the registry, as in the reference: the paper-faithful
experiments (the information plane, the sparsification ablation) build
it directly, and the trainer has no ``--arch convnet5``.
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class ConvNet5Config:
    name: str = "convnet5"
    in_channels: int = 3
    channels: tuple = (32, 64, 128, 128, 256)
    num_classes: int = 200          # Tiny ImageNet classes (paper VI-E)
    image_size: int = 32


def config() -> ConvNet5Config:
    return ConvNet5Config()


def smoke_config() -> ConvNet5Config:
    return ConvNet5Config(name="convnet5-smoke", channels=(8, 16, 16, 16, 32),
                          num_classes=10, image_size=16)
