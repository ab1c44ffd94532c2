"""GF(256) matrix multiply over bit-sliced chunks: the CUDA kernel's wrapper.

Computes out[o, :] = XOR_i ( C[o, i] (*) data[i, :] ) where (*) is GF(256)
multiplication, in the bit-plane domain (see repro_torch/ec/bitplane.py):

  out_plane[o, bi, w] = XOR_{i, bj} plane[i, bj, w] & mask[o, i, bi, bj]

masks are pre-expanded {0, ~0} int32 AND-masks of the 8x8 GF(2) bit-matrix
of each coefficient. On a CUDA tensor the wrapper launches the hand-written
kernel in `csrc/gf256_matmul.cu` (built at first use by `kernels.build`);
on a CPU tensor it takes the plain version `ref.gf256_matmul_planes_ref`.
There is no other path: a CUDA launch that fails raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref


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
