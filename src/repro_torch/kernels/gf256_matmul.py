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
  `kernels/ops.py` run these; `gf256_reconstruct_stripes` runs the
  product of each of a batch of stripes, its rows read and written where
  they lie (the checkpoint load's repair, one launch a load).

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
    lib = build.load_library().lib
    with torch.cuda.device(data.device):
        cols = host_to_device(coeff_to_columns(coeff).view(np.int32),
                              data.device)
        stream = torch.cuda.current_stream().cuda_stream
        build.check_launch(lib.gf256_matmul_bytes_launch(
            cols.data_ptr(), data.data_ptr(), out.data_ptr(), m, k, n,
            stream), "gf256_matmul_bytes")
    gf256_matmul_bytes.launches += 1
    return out


gf256_matmul_bytes.launches = 0


def _out_table(out, out_rows, data: torch.Tensor) -> np.ndarray:
    """`out_rows` as a host (M,) int64 table of distinct rows of `out`
    that can take `data`'s M rows (see `gf256_scale_bytes`); raises
    ValueError otherwise."""
    if out is None or out_rows is None:
        raise ValueError("out and out_rows go together")
    _check_rows(out)
    if out.device != data.device:
        raise ValueError(f"out on {out.device}, data on {data.device}")
    if not out.is_contiguous() or out.shape[1] < data.shape[1]:
        raise ValueError(f"out must be contiguous rows of at least "
                         f"{data.shape[1]} bytes, got {tuple(out.shape)}")
    if (data.numel() and out.numel() and data.untyped_storage().data_ptr()
            == out.untyped_storage().data_ptr()):
        raise ValueError("data must not be a view of out")
    table = np.ascontiguousarray(np.asarray(out_rows), dtype=np.int64)
    m = data.shape[0]
    if table.shape != (m,):
        raise ValueError(f"out_rows must be ({m},), got {table.shape}")
    if m and (table.min() < 0 or table.max() >= out.shape[0]):
        raise ValueError(f"out_rows outside [0, {out.shape[0]})")
    if np.unique(table).size != m:
        raise ValueError("out_rows repeat a row")
    return table


def scale_into_rows(coeffs: np.ndarray, data: torch.Tensor, out: torch.Tensor,
                    out_rows) -> torch.Tensor:
    """Plain version of `gf256_scale_bytes` with `out`: the product of
    `ref.gf256_scale_batch_ref` index-written into rows `out_rows` of `out`
    (checked as there), on any device. Returns `out`."""
    table = _out_table(out, out_rows, data)
    out[host_to_device(table, out.device), :data.shape[1]] = (
        ref.gf256_scale_batch_ref(coeffs, data))
    return out


def gf256_scale_bytes(coeffs: np.ndarray, data: torch.Tensor,
                      out: torch.Tensor | None = None,
                      out_rows=None) -> torch.Tensor:
    """(M,) host uint8 coefficients x (M, nbytes) uint8 -> (M, nbytes):
    row r scaled by its own coefficient `coeffs[r]`.

    The batched premultiply. Given `out` (contiguous uint8 rows of at least
    nbytes, not sharing `data`'s memory) and `out_rows` (M distinct host
    row indices), row r of the product is written into the first nbytes of
    row `out_rows[r]` of `out` instead, and `out` is returned: no product
    tensor is made. A CUDA tensor must be contiguous and launches the
    kernel in `csrc/gf256_matmul.cu` (with `out`, its column words and row
    table copied to the card in one piece); a CPU tensor takes
    `ref.gf256_scale_batch_ref` (and `scale_into_rows` with `out`). Each
    CUDA launch adds one to `gf256_scale_bytes.launches`.
    """
    coeffs = _check_coeff(coeffs, 1)
    _check_rows(data)
    m, n = data.shape
    if m != coeffs.shape[0]:
        raise ValueError(f"{coeffs.shape[0]} coeffs for {m} rows")
    if data.device.type == "cpu":
        if out is None and out_rows is None:
            return ref.gf256_scale_batch_ref(coeffs, data)
        return scale_into_rows(coeffs, data, out, out_rows)
    table = None
    if out is not None or out_rows is not None:
        table = _out_table(out, out_rows, data)
    if data.device.type != "cuda":
        raise ValueError(f"no kernel for device {data.device}")
    if not data.is_contiguous():
        raise ValueError("data must be contiguous")
    if out is None:
        out = torch.empty_like(data)
    if data.numel() == 0:
        return out
    cols = coeff_to_columns(coeffs).view(np.int64)              # (M, 4)
    host = cols.ravel() if table is None else np.concatenate(
        [cols.ravel(), table])
    lib = build.load_library().lib
    with torch.cuda.device(data.device):
        tables = host_to_device(host, data.device)
        stream = torch.cuda.current_stream().cuda_stream
        dst = None if table is None else tables.data_ptr() + cols.nbytes
        build.check_launch(lib.gf256_scale_bytes_launch(
            tables.data_ptr(), data.data_ptr(), dst, out.data_ptr(), m, n,
            out.shape[1], stream), "gf256_scale_bytes")
    gf256_scale_bytes.launches += 1
    return out


gf256_scale_bytes.launches = 0


def byte_space(bufs) -> list:
    """`bufs` (a sequence of 1-D uint8 tensors on one device) as the list
    whose concatenation, in order, is the byte space that
    `gf256_reconstruct_stripes`' offsets index."""
    bufs = list(bufs)
    if not bufs:
        raise ValueError("no buffers")
    for t in bufs:
        if not isinstance(t, torch.Tensor) or t.dtype != torch.uint8:
            raise TypeError("buffers must be uint8 torch tensors")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError("buffers must be 1-D and contiguous")
        if t.device != bufs[0].device:
            raise ValueError(f"buffers on {bufs[0].device} and {t.device}")
    return bufs


def row_addresses(bufs: list, off: np.ndarray, n: int) -> np.ndarray:
    """The addresses of the n-byte rows at byte offsets `off` of the byte
    space `bufs` (-1 stays -1); raises where a row is not inside one
    buffer."""
    sizes = np.array([t.numel() for t in bufs], dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(sizes)])
    ptrs = np.array([t.data_ptr() for t in bufs], dtype=np.int64)
    live = off >= 0
    at = np.where(live, off, 0)
    j = np.clip(np.searchsorted(starts, at, side="right") - 1, 0,
                len(bufs) - 1)
    if (live & ((off < -1) | (at + n > starts[j + 1]))).any():
        raise ValueError(f"a row out of range of its buffer (buffers of "
                         f"{sizes.tolist()} bytes)")
    return np.where(live, ptrs[j] + at - starts[j], -1)


def stripe_tables(coeffs, patterns: np.ndarray, src_addr: np.ndarray,
                  dst_addr: np.ndarray,
                  base: int) -> tuple[np.ndarray, np.ndarray]:
    """The two tables of a `gf256_reconstruct_stripes` launch from `base`
    (the kernel's one base address): `cols` (P, fmax, k, 8) uint32, each
    pattern's column words (zero past its f outputs), and `rec` (S, k +
    fmax + 1) int64, each stripe's source rows' and destination rows'
    byte offsets from `base` (-1 past its f) and its pattern."""
    fmax = dst_addr.shape[1]
    k = src_addr.shape[1]
    cols = np.zeros((len(coeffs), fmax, k, 8), dtype=np.uint32)
    for p, coeff in enumerate(coeffs):
        cols[p, : coeff.shape[0]] = coeff_to_columns(coeff)
    rec = np.concatenate([src_addr - base,
                          np.where(dst_addr >= 0, dst_addr - base, -1),
                          patterns[:, None]], axis=1)
    return cols, np.ascontiguousarray(rec, dtype=np.int64)


def stripe_base(bufs: list) -> int:
    """The base address of a launch: the lowest of the buffers'."""
    return min(t.data_ptr() for t in bufs if t.numel())


def _check_stripes(coeffs, patterns, bufs, src_off, dst_off, n):
    """The host tables as numpy arrays and the rows' addresses, checked;
    raises on what the kernel does not take."""
    coeffs = [_check_coeff(c, 2) for c in coeffs]
    patterns = np.asarray(patterns, dtype=np.int64)
    src_off = np.asarray(src_off, dtype=np.int64)
    dst_off = np.asarray(dst_off, dtype=np.int64)
    if patterns.ndim != 1 or src_off.ndim != 2 or dst_off.ndim != 2:
        raise ValueError("patterns must be (S,), src_off (S, k), dst_off "
                         "(S, fmax)")
    s, k = src_off.shape
    fmax = dst_off.shape[1]
    if patterns.shape[0] != s or dst_off.shape[0] != s:
        raise ValueError(f"{patterns.shape[0]} patterns, {s} source rows "
                         f"and {dst_off.shape[0]} destination rows")
    if n < 0:
        raise ValueError(f"row length {n}")
    fs = np.array([c.shape[0] for c in coeffs], dtype=np.int64)
    for c in coeffs:
        if c.shape[1] != k:
            raise ValueError(f"coefficients {c.shape} for {k} source rows")
    if (fs < 1).any() or (fs > fmax).any():
        raise ValueError(f"a pattern repairs {fs.tolist()} rows; each must "
                         f"be 1 to {fmax} (the destination slots)")
    if ((patterns < 0) | (patterns >= len(coeffs))).any():
        raise ValueError(f"a pattern out of range [0, {len(coeffs)})")
    if s == 0 or n == 0:
        return coeffs, patterns, src_off, dst_off, None, None
    live = np.arange(fmax)[None, :] < fs[patterns][:, None]
    if (dst_off[~live] != -1).any():
        raise ValueError("destination slots past a pattern's outputs "
                         "must be -1")
    if (src_off < 0).any() or (dst_off[live] < 0).any():
        raise ValueError("a negative row offset")
    src_addr = row_addresses(bufs, src_off, n)
    dst_addr = row_addresses(bufs, dst_off, n)
    rows = np.sort(dst_addr[live])
    if (np.diff(rows) < n).any():
        raise ValueError("destination rows overlap")
    read = np.unique(src_addr)
    at = np.searchsorted(rows, read)
    after = np.where(at < rows.size, rows[np.minimum(at, rows.size - 1)],
                     np.iinfo(np.int64).max)
    before = np.where(at > 0, rows[np.maximum(at - 1, 0)],
                      np.iinfo(np.int64).min)
    if ((after < read + n) | (before > read - n)).any():
        raise ValueError("a destination row overlaps a source row")
    return coeffs, patterns, src_off, dst_off, src_addr, dst_addr


def gf256_reconstruct_stripes(coeffs, patterns, bufs, src_off, dst_off,
                              n: int) -> list:
    """Every stripe's reconstruct in one launch, rows read and written
    where they lie: for stripe s and output o < f of its pattern p =
    patterns[s],

        row(dst_off[s, o]) = XOR_i coeffs[p][o, i] (*) row(src_off[s, i])

    where row(x) is the n bytes at offset x of the byte space `bufs`: a
    sequence of 1-D uint8 tensors on one device taken as their
    concatenation in order (`byte_space`). `coeffs` are P host uint8
    (f_p, k) arrays; `patterns` (S,), `src_off` (S, k) and `dst_off`
    (S, fmax) host integer tables (-1 in `dst_off` past a pattern's f). A
    row lies inside one tensor; destination rows overlap neither each
    other nor a source row. Returns the buffers. CUDA tensors launch the
    kernel in `csrc/gf256_matmul.cu` (its tables, the rows' byte offsets
    from the lowest buffer's address, copied to the card once a launch);
    CPU tensors take `ref.gf256_reconstruct_stripes_ref`. An empty batch
    does nothing.
    Each CUDA launch adds one to `gf256_reconstruct_stripes.launches`.
    """
    bufs = byte_space(bufs)
    coeffs, patterns, src_off, dst_off, src_addr, dst_addr = _check_stripes(
        coeffs, patterns, bufs, src_off, dst_off, n)
    if patterns.shape[0] == 0 or n == 0:
        return bufs
    device = bufs[0].device
    if device.type == "cpu":
        return ref.gf256_reconstruct_stripes_ref(coeffs, patterns, bufs,
                                                 src_off, dst_off, n)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    base = stripe_base(bufs)
    cols, rec = stripe_tables(coeffs, patterns, src_addr, dst_addr, base)
    lib = build.load_library().lib
    with torch.cuda.device(device):
        cols_d = host_to_device(cols.view(np.int32), device)
        rec_d = host_to_device(rec, device)
        stream = torch.cuda.current_stream().cuda_stream
        build.check_launch(lib.gf256_reconstruct_stripes_launch(
            cols_d.data_ptr(), rec_d.data_ptr(), base, rec.shape[0],
            src_off.shape[1], dst_off.shape[1], n, stream),
            "gf256_reconstruct_stripes")
    gf256_reconstruct_stripes.launches += 1
    return bufs


gf256_reconstruct_stripes.launches = 0
