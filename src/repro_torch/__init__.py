"""PyTorch + CUDA port of the LGC system (the JAX package ``repro`` is the
reference).  Imports torch, numpy and the standard library only."""
