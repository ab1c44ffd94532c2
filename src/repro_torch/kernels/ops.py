"""Public byte-level entry points of the EC data plane.

Each takes and returns uint8 torch tensors on one device. A CUDA tensor
launches the CUDA kernels (`gf256_matmul_planes`, `xor_reduce_words`); a
CPU tensor takes their plain PyTorch versions through the same wrappers;
`use_kernel=False` picks the plain byte-domain version explicitly. The
byte contracts are those of the JAX package's `kernels/ops.py`. Bit-slicing
at the boundary (`bitplane.pack` / `unpack`) is plain torch on the device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.ec import bitplane
from repro_torch.kernels import ref
from repro_torch.kernels.gf256_matmul import gf256_matmul_planes
from repro_torch.kernels.xor_reduce import xor_reduce_words


def _check_bytes(x: torch.Tensor, name: str) -> None:
    if not isinstance(x, torch.Tensor) or x.dtype != torch.uint8 or x.dim() != 2:
        raise TypeError(f"{name} must be a 2-D uint8 torch tensor")


def gf256_matmul(
    coeff: np.ndarray,
    data: torch.Tensor,
    *,
    use_kernel: bool = True,
) -> torch.Tensor:
    """(m, k) uint8 GF coefficients x (k, nbytes) uint8 -> (m, nbytes) uint8.

    The workhorse of RS encode / decode / repair-term premultiplication.
    `coeff` is a host array (it parametrizes the bit-matrix masks).
    """
    _check_bytes(data, "data")
    coeff = np.asarray(coeff, dtype=np.uint8)
    if not use_kernel:
        return ref.gf256_matmul_bytes_ref(coeff, data)
    nbytes = data.shape[-1]
    masks = bitplane.coeff_to_masks(coeff, data.device)
    planes = bitplane.pack(data)
    out_planes = gf256_matmul_planes(masks, planes)
    return bitplane.unpack(out_planes, nbytes)


def xor_reduce(chunks: torch.Tensor, *, use_kernel: bool = True) -> torch.Tensor:
    """(k, nbytes) uint8 -> (nbytes,) uint8 XOR of all chunks."""
    _check_bytes(chunks, "chunks")
    if chunks.shape[0] == 1:
        return chunks[0]
    if not use_kernel:
        out = chunks[0]
        for i in range(1, chunks.shape[0]):
            out = out ^ chunks[i]
        return out
    nbytes = chunks.shape[-1]
    pad = -nbytes % 4
    if pad:
        chunks = torch.nn.functional.pad(chunks, (0, pad))
    words = chunks.contiguous().view(torch.int32)          # (k, W)
    out = xor_reduce_words(words)
    return out.view(torch.uint8)[:nbytes]


def rs_encode(parity_coeff: np.ndarray, data_blocks: torch.Tensor) -> torch.Tensor:
    """(n-k, k) coeffs x (k, nbytes) data -> (n-k, nbytes) parity."""
    return gf256_matmul(parity_coeff, data_blocks)


def rs_reconstruct(repair_coeff: np.ndarray, helper_blocks: torch.Tensor) -> torch.Tensor:
    """(f, k) repair coeffs x (k, nbytes) helpers -> (f, nbytes) lost blocks."""
    return gf256_matmul(repair_coeff, helper_blocks)
