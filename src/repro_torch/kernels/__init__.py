"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

``LAUNCHES`` counts, per kernel, the launches its wrapper made on the
card; a run resets it with :func:`reset_launches` and reads it after to
show that its path went through the kernels.
"""
from collections import Counter

LAUNCHES: Counter = Counter()


def reset_launches() -> None:
    LAUNCHES.clear()
