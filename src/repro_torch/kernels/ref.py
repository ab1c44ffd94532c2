"""Plain PyTorch versions of the CUDA kernels.

Two *independent* formulations:
  * byte domain — dense `MUL_TABLE` Galois multiply + XOR accumulate,
  * plane domain — the same bit-matrix math as the kernel, in plain torch.
The numpy ground truth is `ec.gf256.gf_matmul_np`.

The kernel wrappers take the plane-domain versions for a tensor that lies
on the CPU; on the card they are what `chip_smoke.py` holds each kernel
against. Nothing on the main path calls them when a card is present.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.ec import gf256


def gf256_matmul_bytes_ref(coeff: np.ndarray, data: torch.Tensor) -> torch.Tensor:
    """(m,k) host uint8 coeffs x (k, nbytes) uint8 -> (m, nbytes) uint8.

    Byte-domain plain version: per-coefficient 256-entry table row gathered
    on the data's device, XOR-accumulated.
    """
    coeff = np.asarray(coeff, dtype=np.uint8)
    m, k = coeff.shape
    if data.shape[0] != k:
        raise ValueError(f"coeff {coeff.shape} vs data {tuple(data.shape)}")
    table = gf256.mul_table(data.device)
    idx = data.long()
    outs = []
    for o in range(m):
        acc = torch.zeros(data.shape[1:], dtype=torch.uint8, device=data.device)
        for i in range(k):
            c = int(coeff[o, i])
            if c == 0:
                continue
            if c == 1:
                acc ^= data[i]
            else:
                acc ^= table[c][idx[i]]
        outs.append(acc)
    return torch.stack(outs)


def gf256_matmul_planes_ref(masks: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """Plane-domain plain version of `gf256_matmul_planes`:
    out[o, bi, w] = XOR_{i, bj} planes[i, bj, w] & masks[o, i, bi, bj]."""
    m = masks.shape[0]
    k = planes.shape[0]
    outs = []
    for o in range(m):
        acc = torch.zeros((8, planes.shape[-1]), dtype=torch.int32,
                          device=planes.device)
        for i in range(k):
            for bj in range(8):
                acc ^= planes[i, bj][None, :] & masks[o, i, :, bj][:, None]
        outs.append(acc)
    return torch.stack(outs)


def xor_reduce_ref(words: torch.Tensor) -> torch.Tensor:
    """(k, W) int32 -> (W,) int32: plain version of `xor_reduce_words`."""
    out = words[0].clone()
    for i in range(1, words.shape[0]):
        out ^= words[i]
    return out
