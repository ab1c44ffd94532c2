"""Stripe construction & placement across failure domains.

Used by the EC checkpoint layer: a logical blob is split into fixed-size
chunks; every k consecutive chunks form a stripe, extended with n-k parity
chunks. Placement rotates the parity position RAID-5 style so repair load
spreads, and guarantees the n blocks of a stripe land on n distinct failure
domains (hosts or pods).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.ec.rs import RSCode


@dataclasses.dataclass(frozen=True)
class Stripe:
    stripe_id: int
    code: RSCode
    # block b of this stripe (0..n-1; <k data, >=k parity) lives on node_ids[b]
    node_ids: tuple[int, ...]

    @property
    def data_nodes(self) -> tuple[int, ...]:
        return self.node_ids[: self.code.k]

    @property
    def parity_nodes(self) -> tuple[int, ...]:
        return self.node_ids[self.code.k:]

    def block_on_node(self, node: int) -> int | None:
        try:
            return self.node_ids.index(node)
        except ValueError:
            return None

    def block_map(self, num_domains: int) -> np.ndarray:
        """(num_domains,) node -> block position under this placement
        (-1 for domains holding no block of this stripe) — the `block_of`
        argument the byte data plane executes against."""
        if num_domains < self.code.n:
            raise ValueError(
                f"stripe spans {self.code.n} domains, have {num_domains}")
        out = np.full(num_domains, -1, dtype=np.int64)
        out[list(self.node_ids)] = np.arange(self.code.n)
        return out

    def perm(self, num_domains: int) -> np.ndarray:
        """(num_domains,) permutation from planner node ids (block b on
        node b, relays after) to this stripe's failure domains: block
        holders map onto `node_ids`, the relay pool onto the remaining
        domains in sorted order — the relabelling that replays a
        logical plan against the placed stripe."""
        n = self.code.n
        if num_domains < n:
            raise ValueError(
                f"stripe spans {n} domains, have {num_domains}")
        out = np.full(num_domains, -1, dtype=np.int64)
        out[:n] = self.node_ids
        out[n:] = sorted(set(range(num_domains)) - set(self.node_ids))
        return out


def place_stripes(
    num_stripes: int, code: RSCode, num_domains: int, *, rotate: bool = True
) -> list[Stripe]:
    """Assign each stripe's n blocks to n distinct failure domains."""
    if num_domains < code.n:
        raise ValueError(
            f"need >= n={code.n} failure domains, have {num_domains}"
        )
    stripes = []
    for s in range(num_stripes):
        base = (s * code.n) % num_domains if rotate else 0
        nodes = tuple((base + i) % num_domains for i in range(code.n))
        stripes.append(Stripe(stripe_id=s, code=code, node_ids=nodes))
    return stripes


def split_blob(blob: np.ndarray, k: int, chunk_bytes: int) -> np.ndarray:
    """Flatten a byte blob into (num_stripes, k, chunk_bytes), zero-padded."""
    blob = np.asarray(blob, dtype=np.uint8).reshape(-1)
    stripe_bytes = k * chunk_bytes
    num_stripes = max(1, -(-blob.size // stripe_bytes))
    padded = np.zeros(num_stripes * stripe_bytes, dtype=np.uint8)
    padded[: blob.size] = blob
    return padded.reshape(num_stripes, k, chunk_bytes)


def join_blob(chunks: np.ndarray, total_bytes: int) -> np.ndarray:
    """(num_stripes, k, chunk_bytes) -> original byte blob."""
    return np.asarray(chunks, dtype=np.uint8).reshape(-1)[:total_bytes]
