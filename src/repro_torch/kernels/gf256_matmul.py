"""GF(256) matrix multiply and batched scale: the CUDA kernels' wrappers.

Computes out[o, :] = XOR_i ( C[o, i] (*) data[i, :] ) where (*) is GF(256)
multiplication, in two layouts, both in `csrc/gf256_matmul.cu`:

* bit-planes (`gf256_matmul_planes`, `gf256_scale_planes`; see
  repro_torch/ec/bitplane.py), the Pallas kernels' own contract:

    out_plane[o, bi, w] = XOR_{i, bj} plane[i, bj, w] & mask[o, i, bi, bj]

  with pre-expanded {0, ~0} int32 AND-masks of the 8x8 GF(2) bit-matrix of
  each coefficient;
* bytes (`gf256_matmul_bytes`, `gf256_scale_bytes`), the same functions on
  uint8 rows with no bit-slicing: column bj of the bit-matrix of c, read as
  a byte, is c (*) (1 << bj) (`coeff_to_columns`), and the kernel folds it
  under a mask of bit bj of every byte. The byte entry points in
  `kernels/ops.py` run these.

On a CUDA tensor a wrapper launches its hand-written kernel (built at
first use by `kernels.build`); on a CPU tensor it takes its plain version
in `kernels/ref.py`. There is no other path: a CUDA launch that fails
raises.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import host_to_device
from repro_torch.ec import gf256
from repro_torch.kernels import build, ref

# COLUMN_WORDS[c, bj]: c (*) (1 << bj), the byte of column bj of the
# multiply-by-c bit-matrix, replicated to the four bytes of a 32-bit word
COLUMN_WORDS = (gf256.MUL_TABLE[:, 1 << np.arange(8)].astype(np.uint32)
                * np.uint32(0x01010101))


def coeff_to_columns(coeff: np.ndarray) -> np.ndarray:
    """uint8 coefficients of any shape -> (..., 8) uint32 column words."""
    return COLUMN_WORDS[np.asarray(coeff, dtype=np.uint8)]


def _check(masks: torch.Tensor, planes: torch.Tensor) -> tuple[int, int, int]:
    if masks.dtype != torch.int32 or planes.dtype != torch.int32:
        raise TypeError(f"int32 masks and planes expected, got "
                        f"{masks.dtype}, {planes.dtype}")
    if masks.dim() != 4 or masks.shape[2:] != (8, 8):
        raise ValueError(f"masks must be (m, k, 8, 8), got {tuple(masks.shape)}")
    m, k = masks.shape[0], masks.shape[1]
    if planes.dim() != 3 or planes.shape[0] != k or planes.shape[1] != 8:
        raise ValueError(f"planes must be (k={k}, 8, W), got "
                         f"{tuple(planes.shape)}")
    if masks.device != planes.device:
        raise ValueError(f"masks on {masks.device}, planes on {planes.device}")
    return m, k, planes.shape[2]


def gf256_matmul_planes(masks: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """(m,k,8,8) int32 masks x (k,8,W) int32 planes -> (m,8,W) int32 planes.

    Each CUDA launch adds one to `gf256_matmul_planes.launches`.
    """
    m, k, w = _check(masks, planes)
    if planes.device.type == "cpu":
        return ref.gf256_matmul_planes_ref(masks, planes)
    if planes.device.type != "cuda":
        raise ValueError(f"no kernel for device {planes.device}")
    if not (masks.is_contiguous() and planes.is_contiguous()):
        raise ValueError("masks and planes must be contiguous")
    out = torch.empty((m, 8, w), dtype=torch.int32, device=planes.device)
    if w == 0 or m == 0:
        return out
    lib = build.load_library().lib
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.check_launch(lib.gf256_matmul_planes_launch(
            masks.data_ptr(), planes.data_ptr(), out.data_ptr(), m, k, w,
            stream), "gf256_matmul_planes")
    gf256_matmul_planes.launches += 1
    return out


gf256_matmul_planes.launches = 0


def gf256_scale_planes(masks: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """(M,1,8,8) int32 masks x (M,8,W) int32 planes -> (M,8,W) int32 planes.

    The batched premultiply: row r is scaled by its *own* coefficient mask
    (elementwise over rows, not an (m, k) contraction). A CUDA tensor
    launches the kernel in `csrc/gf256_matmul.cu`; a CPU tensor takes
    `ref.gf256_scale_planes_ref`. Each CUDA launch adds one to
    `gf256_scale_planes.launches`.
    """
    if masks.dtype != torch.int32 or planes.dtype != torch.int32:
        raise TypeError(f"int32 masks and planes expected, got "
                        f"{masks.dtype}, {planes.dtype}")
    if masks.dim() != 4 or masks.shape[1:] != (1, 8, 8):
        raise ValueError(f"masks must be (M, 1, 8, 8), got {tuple(masks.shape)}")
    m = masks.shape[0]
    if planes.dim() != 3 or planes.shape[:2] != (m, 8):
        raise ValueError(f"planes must be (M={m}, 8, W), got "
                         f"{tuple(planes.shape)}")
    if masks.device != planes.device:
        raise ValueError(f"masks on {masks.device}, planes on {planes.device}")
    if planes.device.type == "cpu":
        return ref.gf256_scale_planes_ref(masks, planes)
    if planes.device.type != "cuda":
        raise ValueError(f"no kernel for device {planes.device}")
    if not (masks.is_contiguous() and planes.is_contiguous()):
        raise ValueError("masks and planes must be contiguous")
    w = planes.shape[2]
    out = torch.empty_like(planes)
    if w == 0 or m == 0:
        return out
    lib = build.load_library().lib
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.check_launch(lib.gf256_scale_planes_launch(
            masks.data_ptr(), planes.data_ptr(), out.data_ptr(), m, w,
            stream), "gf256_scale_planes")
    gf256_scale_planes.launches += 1
    return out


gf256_scale_planes.launches = 0


def _check_coeff(coeff, ndim: int) -> np.ndarray:
    if not isinstance(coeff, np.ndarray) or coeff.dtype != np.uint8:
        raise TypeError("coefficients must be a host uint8 numpy array")
    if coeff.ndim != ndim:
        raise ValueError(f"coefficients must have {ndim} dimension(s), got "
                         f"shape {coeff.shape}")
    return coeff


def _check_rows(data: torch.Tensor) -> None:
    if not isinstance(data, torch.Tensor) or data.dtype != torch.uint8:
        raise TypeError("data must be a uint8 torch tensor")
    if data.dim() != 2:
        raise ValueError(f"data must be (rows, nbytes), got {tuple(data.shape)}")


def _launch(name: str, data: torch.Tensor, columns: np.ndarray,
            out: torch.Tensor, *shape: int) -> None:
    """Copy the column words to the card and launch `name` on the current
    stream; `data` and `out` are contiguous uint8 tensors on it."""
    lib = build.load_library().lib
    with torch.cuda.device(data.device):
        cols = host_to_device(columns.view(np.int32), data.device)
        stream = torch.cuda.current_stream().cuda_stream
        build.check_launch(getattr(lib, name + "_launch")(
            cols.data_ptr(), data.data_ptr(), out.data_ptr(), *shape,
            stream), name)


def gf256_matmul_bytes(coeff: np.ndarray, data: torch.Tensor) -> torch.Tensor:
    """(m, k) host uint8 coefficients x (k, nbytes) uint8 -> (m, nbytes).

    A CUDA tensor must be contiguous (a view of contiguous rows at any
    byte offset is; the kernel takes misaligned rows on a scalar path)
    and launches the kernel in `csrc/gf256_matmul.cu`; a CPU tensor takes
    `ref.gf256_matmul_bytes_ref`. Each CUDA launch adds one to
    `gf256_matmul_bytes.launches`.
    """
    coeff = _check_coeff(coeff, 2)
    _check_rows(data)
    m, k = coeff.shape
    if data.shape[0] != k:
        raise ValueError(f"coeff {coeff.shape} vs data {tuple(data.shape)}")
    if data.device.type == "cpu":
        return ref.gf256_matmul_bytes_ref(coeff, data)
    if data.device.type != "cuda":
        raise ValueError(f"no kernel for device {data.device}")
    if not data.is_contiguous():
        raise ValueError("data must be contiguous")
    n = data.shape[1]
    if k == 0:
        return torch.zeros((m, n), dtype=torch.uint8, device=data.device)
    out = torch.empty((m, n), dtype=torch.uint8, device=data.device)
    if m == 0 or n == 0:
        return out
    _launch("gf256_matmul_bytes", data, coeff_to_columns(coeff), out, m, k, n)
    gf256_matmul_bytes.launches += 1
    return out


gf256_matmul_bytes.launches = 0


def gf256_scale_bytes(coeffs: np.ndarray, data: torch.Tensor) -> torch.Tensor:
    """(M,) host uint8 coefficients x (M, nbytes) uint8 -> (M, nbytes):
    row r scaled by its own coefficient `coeffs[r]`.

    The batched premultiply. A CUDA tensor must be contiguous and launches
    the kernel in `csrc/gf256_matmul.cu`; a CPU tensor takes
    `ref.gf256_scale_batch_ref`. Each CUDA launch adds one to
    `gf256_scale_bytes.launches`.
    """
    coeffs = _check_coeff(coeffs, 1)
    _check_rows(data)
    if data.shape[0] != coeffs.shape[0]:
        raise ValueError(f"{coeffs.shape[0]} coeffs for {data.shape[0]} rows")
    if data.device.type == "cpu":
        return ref.gf256_scale_batch_ref(coeffs, data)
    if data.device.type != "cuda":
        raise ValueError(f"no kernel for device {data.device}")
    if not data.is_contiguous():
        raise ValueError("data must be contiguous")
    out = torch.empty_like(data)
    if data.numel() == 0:
        return out
    _launch("gf256_scale_bytes", data, coeff_to_columns(coeffs), out,
            data.shape[0], data.shape[1])
    gf256_scale_bytes.launches += 1
    return out


gf256_scale_bytes.launches = 0
