"""Bit-plane (bit-sliced) layout for GF(256) arithmetic as AND/XOR work.

A GF(256) multiply by a constant c is linear over GF(2): viewing a byte as a
bit-vector, out = M_c @ in with M_c an 8x8 bit matrix (`gf256.mul_bitmatrix`).
If we slice a chunk of B bytes into 8 planes -- plane b holds bit b of every
byte, packed 32 bits per 32-bit word -- then multiply-accumulate over shards
becomes pure AND/XOR on word vectors (the `gf256_matmul_planes` kernel).

Packing convention: plane word w covers bytes [32w, 32w+32); byte 32w+j
contributes bit j of the word (little bit order). Chunks are padded to a
multiple of 32 bytes.

Torch words are `int32`: bit for bit the reference layout's uint32 words
(torch has no shifts on uint32). `>>` on int32 sign-extends, so every right
shift below is followed by `& 1`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.ec import gf256

BYTES_PER_WORD = 4
BYTES_PER_LANE = 32  # bits per 32-bit word


def padded_len(nbytes: int) -> int:
    return (nbytes + BYTES_PER_LANE - 1) // BYTES_PER_LANE * BYTES_PER_LANE


# --------------------------------------------------------------------- numpy
def pack_np(data: np.ndarray) -> np.ndarray:
    """(..., nbytes) uint8 -> (..., 8, W) uint32 bit-planes; W = nbytes/32."""
    data = np.asarray(data, dtype=np.uint8)
    nbytes = data.shape[-1]
    pad = padded_len(nbytes) - nbytes
    if pad:
        data = np.concatenate(
            [data, np.zeros(data.shape[:-1] + (pad,), dtype=np.uint8)], axis=-1
        )
    w = data.shape[-1] // BYTES_PER_LANE
    grouped = data.reshape(data.shape[:-1] + (w, BYTES_PER_LANE)).astype(np.uint32)
    shifts = np.arange(BYTES_PER_LANE, dtype=np.uint32)
    planes = []
    for b in range(8):
        bits = (grouped >> b) & 1
        planes.append((bits << shifts).sum(axis=-1, dtype=np.uint32))
    return np.stack(planes, axis=-2)  # (..., 8, W)


def unpack_np(planes: np.ndarray, nbytes: int) -> np.ndarray:
    """(..., 8, W) uint32 -> (..., nbytes) uint8."""
    planes = np.asarray(planes, dtype=np.uint32)
    w = planes.shape[-1]
    shifts = np.arange(BYTES_PER_LANE, dtype=np.uint32)
    out = np.zeros(planes.shape[:-2] + (w, BYTES_PER_LANE), dtype=np.uint8)
    for b in range(8):
        bits = (planes[..., b, :, None] >> shifts) & 1
        out |= (bits << b).astype(np.uint8)
    return out.reshape(planes.shape[:-2] + (w * BYTES_PER_LANE,))[..., :nbytes]


# --------------------------------------------------------------------- torch
def pack(data: torch.Tensor) -> torch.Tensor:
    """(..., nbytes) uint8 -> (..., 8, W) int32 bit-planes, on data's device.

    Bit for bit `pack_np` (int32 words are the uint32 words reinterpreted).
    """
    if data.dtype != torch.uint8:
        raise TypeError(f"pack takes uint8 bytes, got {data.dtype}")
    nbytes = data.shape[-1]
    pad = padded_len(nbytes) - nbytes
    if pad:
        data = torch.nn.functional.pad(data, (0, pad))
    w = data.shape[-1] // BYTES_PER_LANE
    grouped = data.reshape(data.shape[:-1] + (w, BYTES_PER_LANE)).to(torch.int32)
    shifts = torch.arange(BYTES_PER_LANE, dtype=torch.int32, device=data.device)
    planes = []
    for b in range(8):
        bits = (grouped >> b) & 1
        # the 32 shifted bits are distinct, so their sum is their OR; bit
        # 31 enters as -2^31, so the int64 sum is already the int32 word
        word = (bits << shifts).sum(dim=-1, dtype=torch.int64)
        planes.append(word.to(torch.int32))
    return torch.stack(planes, dim=-2)  # (..., 8, W)


def unpack(planes: torch.Tensor, nbytes: int) -> torch.Tensor:
    """(..., 8, W) int32 -> (..., nbytes) uint8, on planes' device."""
    if planes.dtype != torch.int32:
        raise TypeError(f"unpack takes int32 planes, got {planes.dtype}")
    w = planes.shape[-1]
    shifts = torch.arange(BYTES_PER_LANE, dtype=torch.int32,
                          device=planes.device)
    out = torch.zeros(planes.shape[:-2] + (w, BYTES_PER_LANE),
                      dtype=torch.uint8, device=planes.device)
    for b in range(8):
        bits = (planes[..., b, :, None] >> shifts) & 1
        out |= (bits << b).to(torch.uint8)
    return out.reshape(planes.shape[:-2] + (w * BYTES_PER_LANE,))[..., :nbytes]


# ------------------------------------------------------------------ bitmatrix
def coeff_to_masks_np(coeff: np.ndarray) -> np.ndarray:
    """(m, k) GF(256) coefficients -> (m, k, 8, 8) uint32 AND-masks.

    masks[o, i, bi, bj] = 0xFFFFFFFF if bit (bi, bj) of the multiply-by-
    coeff[o, i] bit-matrix is set else 0. Kernel computes
    out_plane[o, bi] ^= data_plane[i, bj] & masks[o, i, bi, bj].
    """
    coeff = np.asarray(coeff, dtype=np.uint8)
    m, k = coeff.shape
    masks = np.zeros((m, k, 8, 8), dtype=np.uint32)
    for o in range(m):
        for i in range(k):
            bm = gf256.mul_bitmatrix(int(coeff[o, i]))  # (8, 8) 0/1
            masks[o, i] = bm.astype(np.uint32) * np.uint32(0xFFFFFFFF)
    return masks


def coeff_to_masks(coeff: np.ndarray, device) -> torch.Tensor:
    """`coeff_to_masks_np` as a contiguous (m, k, 8, 8) int32 tensor on
    `device` (all-ones masks read as -1)."""
    masks = coeff_to_masks_np(coeff).view(np.int32)
    return torch.from_numpy(masks).to(device)
