"""PyTorch + CUDA port of the BMFRepair/MSRepair repair system.

Mirrors the JAX package `repro` module for module (same relative paths and
public names). Planning and simulation are host numpy code, as in the
reference; bytes are torch tensors, and on the card they move through the
hand-written CUDA kernels in `repro_torch/kernels/csrc`. Entry points take
`device=None`, meaning `cuda`, and raise when there is no card unless the
caller passes `device="cpu"`. This package never imports `jax` or `repro`.
"""
from repro_torch.device import resolve_device  # noqa: F401
