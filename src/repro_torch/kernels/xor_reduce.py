"""XOR-reduce k chunks into one: the CUDA kernel's wrapper.

The PPR / BMFRepair aggregation step: helper partial results (already Galois-
premultiplied, c_i (*) B_i) combine by plain XOR. Operates on raw 32-bit
words (no bit-slicing needed: XOR is byte-order agnostic). On a CUDA tensor
the wrapper launches the hand-written kernel in `csrc/xor_reduce.cu`; on a
CPU tensor it takes the plain version `ref.xor_reduce_ref`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import host_to_device
from repro_torch.kernels import build, ref


def xor_reduce_words(words: torch.Tensor) -> torch.Tensor:
    """(k, W) int32 -> (W,) int32 running XOR.

    Each CUDA launch adds one to `xor_reduce_words.launches`.
    """
    if words.dtype != torch.int32 or words.dim() != 2 or words.shape[0] == 0:
        raise ValueError(f"words must be (k>=1, W) int32, got "
                         f"{tuple(words.shape)} {words.dtype}")
    if words.device.type == "cpu":
        return ref.xor_reduce_ref(words)
    if words.device.type != "cuda":
        raise ValueError(f"no kernel for device {words.device}")
    if not words.is_contiguous():
        raise ValueError("words must be contiguous")
    k, w = words.shape
    out = torch.empty((w,), dtype=torch.int32, device=words.device)
    if w == 0:
        return out
    lib = build.load_library().lib
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.check_launch(lib.xor_reduce_words_launch(
            words.data_ptr(), out.data_ptr(), k, w, stream), "xor_reduce_words")
    xor_reduce_words.launches += 1
    return out


xor_reduce_words.launches = 0


def xor_reduce_groups_words(words: torch.Tensor, groups=None) -> torch.Tensor:
    """Per-group XOR of 32-bit word rows.

    * `xor_reduce_groups_words(words)`: (G, K, W) int32 -> (G, W), XOR over
      axis 1 — the JAX package's contract;
    * `xor_reduce_groups_words(words, groups)`: (T, W) int32 words and a
      (G, Kmax) host row-index table (numpy or CPU tensor, -1 pads) ->
      (G, W), the XOR of the rows each group names. The kernel gathers the
      rows itself, so no dense (G, Kmax, W) copy is made.

    The index table is checked on the host and copied to the card without
    a synchronisation. A CUDA tensor launches the kernel in
    `csrc/xor_reduce.cu` (the first form on the (G*K, W) view with the
    identity table); a CPU tensor takes `ref.xor_reduce_groups_words_ref`.
    Each CUDA launch adds one to `xor_reduce_groups_words.launches`.
    """
    if words.dtype != torch.int32:
        raise TypeError(f"int32 words expected, got {words.dtype}")
    if groups is None:
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
            return ref.xor_reduce_groups_words_ref(words, torch.from_numpy(table))
    if words.device.type != "cuda":
        raise ValueError(f"no kernel for device {words.device}")
    if not words.is_contiguous():
        raise ValueError("words must be contiguous")
    n_groups, kmax = table.shape
    w = words.shape[1]
    out = torch.empty((n_groups, w), dtype=torch.int32, device=words.device)
    if n_groups == 0 or w == 0:
        return out
    lib = build.load_library().lib
    with torch.cuda.device(words.device):
        index = host_to_device(table, words.device)   # on the current stream
        stream = torch.cuda.current_stream().cuda_stream
        build.check_launch(lib.xor_reduce_groups_launch(
            words.data_ptr(), index.data_ptr(), out.data_ptr(), n_groups,
            kmax, w, stream), "xor_reduce_groups_words")
    xor_reduce_groups_words.launches += 1
    return out


xor_reduce_groups_words.launches = 0
