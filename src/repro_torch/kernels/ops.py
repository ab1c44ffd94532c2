"""Public byte-level entry points of the EC data plane.

Each takes and returns uint8 torch tensors on one device. A CUDA tensor
launches the CUDA kernels (`gf256_matmul_bytes`, `xor_reduce_words`, and
for the batched data plane `gf256_scale_bytes`, `xor_reduce_groups_words`;
for the checkpoint load's stripes `gf256_reconstruct_stripes`);
a CPU tensor takes their plain PyTorch versions through the same wrappers;
`use_kernel=False` picks the plain byte-domain version explicitly. The
byte contracts are those of the JAX package's `kernels/ops.py`, and every
output stays on its input's device. The GF(256) kernels work on the bytes
themselves: nothing is bit-sliced on the way (the bit-plane kernels
`gf256_matmul_planes` / `gf256_scale_planes` keep the Pallas contract
and are on no path here).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.gf256_matmul import (gf256_matmul_bytes,
                                              gf256_reconstruct_stripes,
                                              gf256_scale_bytes,
                                              scale_into_rows)
from repro_torch.kernels.xor_reduce import (as_rows, fold_into_rows,
                                            fold_rows,
                                            xor_reduce_groups_words)


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

    The workhorse of RS encode / decode / repair-term premultiplication:
    one `gf256_matmul_bytes` launch. `coeff` is a host array (it
    parametrizes the kernel's column words). A `data` view that is not
    contiguous is copied once (`.contiguous()`) before the launch.
    """
    _check_bytes(data, "data")
    coeff = np.asarray(coeff, dtype=np.uint8)
    if not use_kernel:
        return ref.gf256_matmul_bytes_ref(coeff, data)
    return gf256_matmul_bytes(coeff, data.contiguous())


def xor_reduce(chunks, *, use_kernel: bool = True) -> torch.Tensor:
    """(k, nbytes) uint8, or a sequence of k (nbytes,) uint8 rows ->
    (nbytes,) uint8 XOR of all chunks.

    One `xor_reduce_words` launch (for up to `KMAX` rows) reads the rows
    where they lie: separate tensors are not stacked, and a ragged
    `nbytes` is not padded. Every row must be contiguous.
    """
    rows = as_rows(chunks, torch.uint8, "chunks")
    if len(rows) == 1:
        return rows[0]
    if not use_kernel:
        return ref.xor_reduce_ref(rows)
    return fold_rows(rows)


def gf256_scale_batch(
    coeffs: np.ndarray,
    data: torch.Tensor,
    *,
    out: torch.Tensor | None = None,
    out_rows=None,
    use_kernel: bool = True,
) -> torch.Tensor:
    """(M,) uint8 coeffs x (M, nbytes) uint8 -> (M, nbytes): row i scaled
    by its own coefficient.

    The batched data-plane premultiply: one call covers every (job, helper)
    chunk of a plan batch, one `gf256_scale_bytes` launch with one block
    row per chunk. `coeffs` is a host array (it parametrizes the column
    words). A `data` view that is not contiguous is copied once first.
    With `out` (contiguous uint8 rows of at least nbytes, not sharing
    `data`'s memory) and `out_rows` ((M,) distinct host row indices), row
    i of the product goes into row `out_rows[i]` of `out`, which is
    returned, and no (M, nbytes) product is made.
    """
    _check_bytes(data, "data")
    coeffs = np.asarray(coeffs, dtype=np.uint8).reshape(-1)
    if coeffs.size != data.shape[0]:
        raise ValueError(f"{coeffs.size} coeffs for {data.shape[0]} rows")
    if out is None and out_rows is None:
        if coeffs.size == 0 or not use_kernel:
            return ref.gf256_scale_batch_ref(coeffs, data)
        return gf256_scale_bytes(coeffs, data.contiguous())
    if use_kernel:
        return gf256_scale_bytes(coeffs, data.contiguous(), out, out_rows)
    return scale_into_rows(coeffs, data, out, out_rows)


def xor_reduce_segments(
    chunks: torch.Tensor,
    groups: np.ndarray,
    *,
    out_rows=None,
    use_kernel: bool = True,
) -> torch.Tensor:
    """(T, nbytes) uint8 chunks + (G, Kmax) host row-index groups (-1
    padded) -> (G, nbytes): XOR-fold of each group's member rows.

    The batched data-plane merge: group g holds the rows arriving at one
    (case, destination) in a round. One `xor_reduce_groups_words` launch
    gathers and folds every group on the card; index -1 reads zero, the
    XOR identity. With `nbytes` a multiple of 4 the chunks are read in
    place; otherwise they are first padded to whole words (a copy).
    With `out_rows` ((G,) host row indices), group g's fold is written
    into row `out_rows[g]` of `chunks` itself, which is returned: a
    destination may be a member of its own group, never of another.
    `chunks` must then be contiguous rows of whole 32-bit words (raises
    ValueError otherwise), which the kernel writes where they lie.
    """
    _check_bytes(chunks, "chunks")
    groups = np.asarray(groups, dtype=np.int64)
    nbytes = chunks.shape[-1]
    pad = -nbytes % 4
    if out_rows is not None:
        if pad or not chunks.is_contiguous():
            raise ValueError("out_rows needs contiguous chunks of whole "
                             f"32-bit words, got {tuple(chunks.shape)}")
        words = chunks.view(torch.int32)
        if use_kernel:
            xor_reduce_groups_words(words, groups, out_rows)
        else:
            fold_into_rows(words, groups, out_rows)
        return chunks
    if not use_kernel or groups.shape[0] == 0:
        return ref.xor_reduce_segments_ref(chunks, groups)
    words = torch.nn.functional.pad(chunks, (0, pad)) if pad else chunks
    folded = xor_reduce_groups_words(
        words.contiguous().view(torch.int32), groups)       # (G, W)
    return folded.view(torch.uint8)[:, :nbytes]


def rs_encode(parity_coeff: np.ndarray, data_blocks: torch.Tensor) -> torch.Tensor:
    """(n-k, k) coeffs x (k, nbytes) data -> (n-k, nbytes) parity."""
    return gf256_matmul(parity_coeff, data_blocks)


def rs_reconstruct(repair_coeff: np.ndarray, helper_blocks: torch.Tensor) -> torch.Tensor:
    """(f, k) repair coeffs x (k, nbytes) helpers -> (f, nbytes) lost blocks."""
    return gf256_matmul(repair_coeff, helper_blocks)


def rs_reconstruct_stripes(repair_coeffs, patterns, space, helper_off,
                           out_off, nbytes: int) -> list:
    """`rs_reconstruct` for a batch of stripes, in one
    `gf256_reconstruct_stripes` launch: stripe s repairs with pattern p =
    `patterns[s]`, whose (f, k) coefficients are `repair_coeffs[p]`, from
    the k helper rows at byte offsets `helper_off[s]` into the f rows at
    `out_off[s, :f]` (-1 after). Offsets index `space`, a sequence of
    1-D uint8 tensors taken as their concatenation; rows are `nbytes`
    long and are read and written in place; returns `space` as a list.
    An empty batch does nothing."""
    return gf256_reconstruct_stripes(repair_coeffs, patterns, space,
                                     helper_off, out_off, nbytes)
