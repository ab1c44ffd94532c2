"""Systematic Reed-Solomon (n, k) codes over GF(256).

Construction: Vandermonde matrix V[i, j] = alpha_i^j (alpha_i = i) reduced to
systematic form (top k rows = identity) by right-multiplying with the inverse
of its top k x k block. MDS for n <= 256: any k rows remain invertible.

Node indexing convention throughout the repo: nodes 0..k-1 hold data blocks
D1..Dk, nodes k..n-1 hold parity blocks P1..P(n-k).

Coefficients (generator, repair coefficients) are small host-side numpy
arrays; block bytes are uint8 torch tensors and stay on their device —
`encode`, `reconstruct` and `decode_all` go through `kernels.ops`, which
launches the GF(256) kernel for a CUDA tensor.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.ec import gf256


@functools.lru_cache(maxsize=None)
def generator_matrix(n: int, k: int) -> np.ndarray:
    """(n, k) systematic generator matrix; rows 0..k-1 are identity."""
    if not (0 < k < n <= 256):
        raise ValueError(f"invalid RS parameters (n={n}, k={k})")
    vander = np.zeros((n, k), dtype=np.uint8)
    for i in range(n):
        for j in range(k):
            vander[i, j] = gf256.gf_pow(i + 1, j)
    top_inv = gf256.gf_mat_inv(vander[:k, :k])
    gen = np.zeros((n, k), dtype=np.uint8)
    for i in range(n):
        # gen[i] = vander[i] @ top_inv over GF(256)
        acc = np.zeros(k, dtype=np.uint8)
        for j in range(k):
            c = int(vander[i, j])
            if c:
                acc ^= gf256.MUL_TABLE[c, top_inv[j]]
        gen[i] = acc
    assert np.array_equal(gen[:k], np.eye(k, dtype=np.uint8))
    return gen


@dataclasses.dataclass(frozen=True)
class RSCode:
    """An (n, k) systematic RS code with helpers for repair planning."""

    n: int
    k: int

    @property
    def m(self) -> int:
        return self.n - self.k

    @property
    def generator(self) -> np.ndarray:
        return generator_matrix(self.n, self.k)

    # ------------------------------------------------------------------ encode
    def encode(self, data_blocks: torch.Tensor) -> torch.Tensor:
        """(k, nbytes) uint8 data -> (n, nbytes) codeword (data || parity),
        on the data's device."""
        from repro_torch.kernels import ops

        _check_blocks(data_blocks, self.k)
        parity = ops.rs_encode(self.generator[self.k:], data_blocks)
        return torch.cat([data_blocks, parity], dim=0)

    def parity_coeffs(self) -> np.ndarray:
        """(n-k, k) coefficients mapping data blocks to parity blocks."""
        return self.generator[self.k:].copy()

    # ------------------------------------------------------------------ repair
    def repair_coeffs(
        self, failed: tuple[int, ...] | list[int], helpers: tuple[int, ...] | list[int]
    ) -> np.ndarray:
        """(|failed|, k) coefficients: lost block f = sum_j coeff[f, j] * helper_j.

        `helpers` must be exactly k surviving node ids. Works for any mix of
        data/parity failures (MDS property).
        """
        failed = tuple(failed)
        helpers = tuple(helpers)
        if len(helpers) != self.k:
            raise ValueError(f"need exactly k={self.k} helpers, got {len(helpers)}")
        if set(failed) & set(helpers):
            raise ValueError("helpers overlap failed nodes")
        gen = self.generator
        sub = gen[list(helpers), :]                     # (k, k): helpers in terms of data
        sub_inv = gf256.gf_mat_inv(sub)                 # data in terms of helpers
        # lost row i (in terms of data) composed with data-in-terms-of-helpers:
        out = np.zeros((len(failed), self.k), dtype=np.uint8)
        for fi, f in enumerate(failed):
            acc = np.zeros(self.k, dtype=np.uint8)
            for j in range(self.k):
                c = int(gen[f, j])
                if c:
                    acc ^= gf256.MUL_TABLE[c, sub_inv[j]]
            out[fi] = acc
        return out

    def repair_coeffs_batch(
        self, failed: np.ndarray, helpers: np.ndarray
    ) -> np.ndarray:
        """Batched single-failure repair coefficients.

        `failed` is (J,) lost block ids, `helpers` (J, k) helper block ids
        (each row exactly k distinct survivors of its own failure). Returns
        (J, k) uint8 coefficients, row j aligned with `helpers[j]` —
        identical to `repair_coeffs((failed[j],), helpers[j])[0]` but the
        whole batch shares one lockstep Gauss-Jordan
        (`gf256.gf_mat_inv_batch`) instead of J scalar inversions. This is
        the data-plane engine's entry point: one call covers every job of
        a batch of compiled plans.
        """
        failed = np.asarray(failed, dtype=np.int64).reshape(-1)
        helpers = np.asarray(helpers, dtype=np.int64)
        if failed.size == 0:
            return np.zeros((0, self.k), dtype=np.uint8)
        if helpers.shape != (failed.size, self.k):
            raise ValueError(
                f"helpers must be ({failed.size}, k={self.k}), "
                f"got {helpers.shape}")
        if (helpers == failed[:, None]).any():
            raise ValueError("helpers overlap failed nodes")
        gen = self.generator
        sub_inv = gf256.gf_mat_inv_batch(gen[helpers])      # (J, k, k)
        # out[j] = XOR_i gen[failed[j], i] (*) sub_inv[j, i, :]
        lost = gen[failed]                                  # (J, k)
        return np.bitwise_xor.reduce(
            gf256.MUL_TABLE[lost[:, :, None], sub_inv], axis=1)

    def reconstruct(
        self,
        failed: list[int],
        helpers: list[int],
        helper_blocks: torch.Tensor,
    ) -> torch.Tensor:
        """Decode lost blocks from k helper blocks. (|failed|, nbytes)."""
        from repro_torch.kernels import ops

        _check_blocks(helper_blocks, self.k)
        coeff = self.repair_coeffs(tuple(failed), tuple(helpers))
        return ops.rs_reconstruct(coeff, helper_blocks)

    def decode_all(self, present: dict[int, torch.Tensor]) -> torch.Tensor:
        """Recover the k data blocks from any >=k present blocks."""
        if len(present) < self.k:
            raise ValueError("not enough surviving blocks")
        helpers = sorted(present)[: self.k]
        blocks = torch.stack([present[h] for h in helpers])
        failed = [i for i in range(self.k) if i not in present]
        if not failed:
            return torch.stack([present[i] for i in range(self.k)])
        repaired = self.reconstruct(failed, helpers, blocks)
        out = []
        ri = 0
        for i in range(self.k):
            if i in present:
                out.append(present[i])
            else:
                out.append(repaired[ri])
                ri += 1
        return torch.stack(out)


def _check_blocks(blocks, k: int) -> None:
    if not isinstance(blocks, torch.Tensor) or blocks.dtype != torch.uint8:
        raise TypeError("blocks must be a uint8 torch tensor, "
                        f"got {type(blocks).__name__}")
    if blocks.dim() != 2 or blocks.shape[0] != k:
        raise ValueError(f"blocks must be (k={k}, nbytes), "
                         f"got {tuple(blocks.shape)}")
