"""XOR-reduce k rows into one: the CUDA kernels' wrappers.

The PPR / BMFRepair aggregation step: helper partial results (already Galois-
premultiplied, c_i (*) B_i) combine by plain XOR. Operates on the raw bytes
(no bit-slicing needed: XOR is byte-order agnostic). The kernel in
`csrc/xor_reduce.cu` reads each row where it lies, from up to `KMAX` row
pointers a launch, so separate tensors fold without being stacked into one;
more rows fold in chained launches (`chain_plan`). On a CUDA tensor the
wrappers launch it; on a CPU tensor they take the plain version
`ref.xor_reduce_ref`.
"""
from __future__ import annotations

import ctypes
from collections.abc import Sequence

import numpy as np
import torch

from repro_torch.device import host_to_device
from repro_torch.kernels import build, ref

KMAX = 16        # rows one launch folds: kMaxRows in csrc/xor_reduce.cu


def chain_plan(k: int) -> list[list[int]]:
    """The launches that fold k rows, at most `KMAX` a launch: each a list
    of row indices, where -1 stands for the output of the launches before
    (always first, so it is row 0 of its launch)."""
    if k <= 0:
        raise ValueError(f"cannot fold {k} rows")
    plan = [list(range(min(k, KMAX)))]
    while plan[-1][-1] < k - 1:
        start = plan[-1][-1] + 1
        plan.append([-1, *range(start, min(k, start + KMAX - 1))])
    return plan


def as_rows(rows, dtype: torch.dtype, name: str = "rows") -> list[torch.Tensor]:
    """A (k, n) tensor or a sequence of k (n,) tensors -> the k rows.

    Every row has `dtype`, one length and one device, and is contiguous
    (a (k, n) tensor may have any row stride); no copy is made. Raises
    TypeError for something that is not a tensor, else ValueError.
    """
    if isinstance(rows, torch.Tensor):
        if rows.dim() != 2:
            raise ValueError(f"{name} must be (k, n) or a sequence of (n,) "
                             f"rows, got shape {tuple(rows.shape)}")
        rows = list(rows.unbind(0))
    elif isinstance(rows, Sequence):
        rows = list(rows)
    else:
        raise TypeError(f"{name} must be a torch tensor or a sequence of "
                        f"them, got {type(rows).__name__}")
    if not rows:
        raise ValueError(f"{name}: no rows")
    first = rows[0]
    for i, row in enumerate(rows):
        if not isinstance(row, torch.Tensor):
            raise TypeError(f"{name}[{i}] is a {type(row).__name__}, not a "
                            "torch tensor")
        if row.dtype != dtype or row.dim() != 1:
            raise ValueError(f"{name}[{i}] must be a 1-D {dtype} tensor, "
                             f"got {tuple(row.shape)} {row.dtype}")
        if row.shape != first.shape or row.device != first.device:
            raise ValueError(f"{name}[{i}] is {tuple(row.shape)} on "
                             f"{row.device}, {name}[0] {tuple(first.shape)} "
                             f"on {first.device}")
        if not row.is_contiguous():
            raise ValueError(f"{name}[{i}] is strided (stride "
                             f"{row.stride()[0]}); rows must be contiguous")
    return rows


def fold_rows(rows: list[torch.Tensor]) -> torch.Tensor:
    """XOR of rows that `as_rows` checked, of any dtype: the plain version
    on the CPU, else the kernel on their bytes, in the launches of
    `chain_plan`, each counted on `xor_reduce_words.launches`."""
    device = rows[0].device
    if device.type == "cpu":
        return ref.xor_reduce_ref(rows)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    out = torch.empty_like(rows[0])
    nbytes = out.numel() * out.element_size()
    if nbytes == 0:
        return out
    lib = build.load_library().lib
    ptrs = [row.data_ptr() for row in rows]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        for step in chain_plan(len(rows)):
            args = [out.data_ptr() if i < 0 else ptrs[i] for i in step]
            build.check_launch(lib.xor_reduce_rows_launch(
                (ctypes.c_void_p * len(args))(*args), len(args),
                out.data_ptr(), nbytes, stream), "xor_reduce_words")
            xor_reduce_words.launches += 1
    return out


def xor_reduce_words(words) -> torch.Tensor:
    """(k, W) int32, or a sequence of k (W,) int32 rows -> (W,) int32
    running XOR. The rows are read where they lie.

    Each CUDA launch adds one to `xor_reduce_words.launches` (one launch
    for up to `KMAX` rows).
    """
    return fold_rows(as_rows(words, torch.int32, "words"))


xor_reduce_words.launches = 0


def in_place_groups(groups: np.ndarray, out_rows, rows: int) -> np.ndarray:
    """`out_rows` as the (G,) destination table of an in-place grouped
    fold over `rows` rows, checked: distinct rows in range, none a member
    of another group (a destination may be a member of its own). Raises
    ValueError."""
    table = np.ascontiguousarray(np.asarray(out_rows), dtype=np.int64)
    n_groups = groups.shape[0]
    if table.shape != (n_groups,):
        raise ValueError(f"out_rows must be ({n_groups},), got {table.shape}")
    if n_groups == 0:
        return table
    if table.min() < 0 or table.max() >= rows:
        raise ValueError(f"out_rows outside [0, {rows})")
    order = np.argsort(table)
    ordered = table[order]
    if (np.diff(ordered) == 0).any():
        raise ValueError("out_rows repeat a row")
    gid, col = np.nonzero(groups >= 0)
    read = groups[gid, col]
    at = np.minimum(np.searchsorted(ordered, read), n_groups - 1)
    if ((ordered[at] == read) & (order[at] != gid)).any():
        raise ValueError("a group reads a row that another group writes")
    return table


def fold_into_rows(words: torch.Tensor, groups: np.ndarray,
                   out_rows) -> torch.Tensor:
    """Plain version of the in-place grouped fold, on any device: each
    group's XOR (`ref.xor_reduce_groups_words_ref`) index-written into its
    row `out_rows[g]` of the (T, W) `words`, checked by `in_place_groups`.
    Returns `words`."""
    dst = in_place_groups(groups, out_rows, words.shape[0])
    words[host_to_device(dst, words.device)] = ref.xor_reduce_groups_words_ref(
        words, host_to_device(groups, words.device))
    return words


def xor_reduce_groups_words(words: torch.Tensor, groups=None,
                            out_rows=None) -> torch.Tensor:
    """Per-group XOR of 32-bit word rows.

    * `xor_reduce_groups_words(words)`: (G, K, W) int32 -> (G, W), XOR over
      axis 1 — the JAX package's contract;
    * `xor_reduce_groups_words(words, groups)`: (T, W) int32 words and a
      (G, Kmax) host row-index table (numpy or CPU tensor, -1 pads) ->
      (G, W), the XOR of the rows each group names. The kernel gathers the
      rows itself, so no dense (G, Kmax, W) copy is made;
    * `xor_reduce_groups_words(words, groups, out_rows)`: the same folds
      written in place, group g's into row `out_rows[g]` of `words`, which
      is returned. A destination row may be a member of its own group but
      of no other (`in_place_groups` checks it).

    The index tables are checked on the host and copied to the card in one
    piece, without a synchronisation. A CUDA tensor launches the kernel in
    `csrc/xor_reduce.cu` (the first form on the (G*K, W) view with the
    identity table); a CPU tensor takes `ref.xor_reduce_groups_words_ref`
    (`fold_into_rows` in place). Each CUDA launch adds one to
    `xor_reduce_groups_words.launches`.
    """
    if words.dtype != torch.int32:
        raise TypeError(f"int32 words expected, got {words.dtype}")
    dst = None
    if groups is None:
        if out_rows is not None:
            raise ValueError("out_rows needs groups")
        if words.dim() != 3 or words.shape[1] == 0:
            raise ValueError(f"words must be (G, K>=1, W), got "
                             f"{tuple(words.shape)}")
        if words.device.type == "cpu":
            return ref.xor_reduce_groups_words_ref(words)
        g, k, w = words.shape
        table = np.arange(g * k, dtype=np.int64).reshape(g, k)
        words = words.reshape(g * k, w)
    else:
        if words.dim() != 2:
            raise ValueError(f"words must be (T, W) with groups, got "
                             f"{tuple(words.shape)}")
        table = np.ascontiguousarray(groups, dtype=np.int64)
        if table.ndim != 2:
            raise ValueError(f"groups must be (G, Kmax), got {table.shape}")
        if table.size and (table.min() < -1 or table.max() >= words.shape[0]):
            raise IndexError(f"groups index rows outside [-1, {words.shape[0]})")
        if words.device.type == "cpu":
            if out_rows is not None:
                return fold_into_rows(words, table, out_rows)
            return ref.xor_reduce_groups_words_ref(words,
                                                   torch.from_numpy(table))
        if out_rows is not None:
            dst = in_place_groups(table, out_rows, words.shape[0])
    if words.device.type != "cuda":
        raise ValueError(f"no kernel for device {words.device}")
    if not words.is_contiguous():
        raise ValueError("words must be contiguous")
    n_groups, kmax = table.shape
    w = words.shape[1]
    out = (torch.empty((n_groups, w), dtype=torch.int32, device=words.device)
           if dst is None else words)
    if n_groups == 0 or w == 0:
        return out
    host = table.ravel() if dst is None else np.concatenate([table.ravel(),
                                                             dst])
    lib = build.load_library().lib
    with torch.cuda.device(words.device):
        index = host_to_device(host, words.device)    # on the current stream
        stream = torch.cuda.current_stream().cuda_stream
        dst_ptr = None if dst is None else index.data_ptr() + table.nbytes
        build.check_launch(lib.xor_reduce_groups_launch(
            words.data_ptr(), index.data_ptr(), dst_ptr, out.data_ptr(),
            n_groups, kmax, w, stream), "xor_reduce_groups_words")
    xor_reduce_groups_words.launches += 1
    return out


xor_reduce_groups_words.launches = 0
