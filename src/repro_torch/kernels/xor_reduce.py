"""XOR-reduce k chunks into one: the CUDA kernel's wrapper.

The PPR / BMFRepair aggregation step: helper partial results (already Galois-
premultiplied, c_i (*) B_i) combine by plain XOR. Operates on raw 32-bit
words (no bit-slicing needed: XOR is byte-order agnostic). On a CUDA tensor
the wrapper launches the hand-written kernel in `csrc/xor_reduce.cu`; on a
CPU tensor it takes the plain version `ref.xor_reduce_ref`.
"""
from __future__ import annotations

import torch

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
