"""Device choice for the port's entry points.

`device=None` means the card (`cuda`). Without one, an entry point raises
instead of running on the CPU: the CPU path (the kernels' plain PyTorch
versions) is taken only when the caller asks for it with `device="cpu"`.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` -> `cuda` (raises when no card is visible); else `device`."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev
