"""Device choice for the port's entry points.

`device=None` means the card (`cuda`). Without one, an entry point raises
instead of running on the CPU: the CPU path (the kernels' plain PyTorch
versions) is taken only when the caller asks for it with `device="cpu"`.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """`None` -> `cuda` (raises when no card is visible); else `device`."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


def host_to_device(array: np.ndarray, device) -> torch.Tensor:
    """A host numpy array as a tensor on `device`.

    To a card the copy goes through pinned memory and does not block the
    host (`non_blocking=True`; PyTorch's pinned-memory cache keeps the
    staging buffer until the copy has run), so a loop that hands the card
    a small index table every step does not synchronise every step. On
    the CPU the tensor shares the array's memory.
    """
    host = torch.from_numpy(np.ascontiguousarray(array))
    device = torch.device(device)
    if device.type != "cuda":
        return host.to(device)
    return host.pin_memory().to(device, non_blocking=True)
