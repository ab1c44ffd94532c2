"""Plain PyTorch versions of the CUDA kernels.

Two *independent* formulations:
  * byte domain — dense `MUL_TABLE` Galois multiply + XOR accumulate, the
    plain versions of the byte kernels `gf256_matmul_bytes`,
    `gf256_scale_bytes` and `gf256_reconstruct_stripes`,
  * plane domain — the same bit-matrix math as the plane kernels, in
    plain torch.
The numpy ground truth is `ec.gf256.gf_matmul_np`.

The kernel wrappers take these versions for a tensor that lies on the
CPU; on the card they are what `chip_smoke.py` holds each kernel against.
Nothing on the main path calls them when a card is present.
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


def gf256_reconstruct_stripes_ref(coeffs, patterns: np.ndarray, bufs: list,
                                  src_off: np.ndarray, dst_off: np.ndarray,
                                  n: int) -> list:
    """Plain version of `gf256_reconstruct_stripes`, stripe by stripe: the
    n-byte rows at `dst_off[s, o]` of the byte space `bufs` (the 1-D uint8
    tensors' concatenation, in order) = `gf256_matmul_bytes_ref` of
    pattern `patterns[s]`'s (f, k) coefficients `coeffs[p]` and the k rows
    at `src_off[s]`, written in place; returns `bufs`."""
    starts = np.cumsum([0] + [t.numel() for t in bufs])

    def row(off: int) -> torch.Tensor:
        j = int(np.searchsorted(starts, off, side="right")) - 1
        return bufs[j][off - starts[j]: off - starts[j] + n]

    for s, p in enumerate(np.asarray(patterns)):
        coeff = coeffs[p]
        out = gf256_matmul_bytes_ref(
            coeff, torch.stack([row(off) for off in src_off[s].tolist()]))
        for o, off in enumerate(dst_off[s, : coeff.shape[0]].tolist()):
            row(off).copy_(out[o])
    return bufs


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


def xor_reduce_ref(words) -> torch.Tensor:
    """(k, W) or a sequence of k (W,) rows -> (W,): plain version of
    `xor_reduce_words` (int32 words) and of its byte form (uint8)."""
    out = words[0].clone()
    for row in words[1:]:
        out ^= row
    return out


def gf256_scale_planes_ref(masks: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """Plane-domain plain version of `gf256_scale_planes`: row r scaled by
    its own coefficient, out[r, bi, w] = XOR_bj planes[r, bj, w] &
    masks[r, 0, bi, bj]; (M,1,8,8) x (M,8,W) -> (M,8,W) int32."""
    out = torch.zeros_like(planes)
    for bj in range(8):
        out ^= planes[:, bj][:, None, :] & masks[:, 0, :, bj][:, :, None]
    return out


def xor_reduce_groups_words_ref(words: torch.Tensor,
                                groups: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of `xor_reduce_groups_words`.

    Without `groups`: (G, K, W) int32 -> (G, W), XOR over axis 1. With
    `groups`, a (G, Kmax) int64 row-index table on the words' device (-1
    pads): (T, W) words -> (G, W), the XOR of each group's rows.
    """
    if groups is None:
        out = words[:, 0].clone()
        for i in range(1, words.shape[1]):
            out ^= words[:, i]
        return out
    out = torch.zeros((groups.shape[0], words.shape[1]), dtype=words.dtype,
                      device=words.device)
    for i in range(groups.shape[1]):
        rows = groups[:, i]
        live = rows >= 0
        out[live] ^= words[rows[live]]
    return out


def gf256_scale_batch_ref(coeffs: np.ndarray, data: torch.Tensor) -> torch.Tensor:
    """(M,) host uint8 coeffs x (M, nbytes) uint8 -> (M, nbytes) uint8.

    Byte-domain plain version of the batched premultiply: one `MUL_TABLE`
    gather on the data's device covers the whole batch.
    """
    coeffs = np.asarray(coeffs, dtype=np.uint8).reshape(-1)
    if data.shape[0] != coeffs.shape[0]:
        raise ValueError(f"coeffs {coeffs.shape} vs data {tuple(data.shape)}")
    rows = torch.from_numpy(coeffs.astype(np.int64)).to(data.device)
    return gf256.mul_table(data.device)[rows[:, None], data.long()]


def xor_reduce_segments_ref(chunks: torch.Tensor, groups: np.ndarray) -> torch.Tensor:
    """(T, nbytes) uint8 chunks + (G, Kmax) host row-index groups (-1
    padded) -> (G, nbytes) uint8: byte-domain XOR of each group's rows.

    Gathers the dense (G, Kmax, nbytes) copy, as `xor_reduce_segments_np`
    does; index -1 reads an all-zero row (the XOR identity).
    """
    groups = torch.from_numpy(np.asarray(groups, dtype=np.int64)).to(chunks.device)
    if groups.numel() == 0:
        return torch.zeros((groups.shape[0], chunks.shape[-1]),
                           dtype=torch.uint8, device=chunks.device)
    rows = chunks[groups.clamp(min=0)]
    rows[groups < 0] = 0
    out = rows[:, 0].clone()
    for i in range(1, rows.shape[1]):
        out ^= rows[:, i]
    return out
