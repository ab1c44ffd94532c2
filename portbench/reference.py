"""Plain reference of the repair's bytes: GF(2^8) and systematic RS codes.

A frozen, independent copy of the arithmetic the benchmark judges the
port by. It imports numpy and torch only (nothing of the port, nothing
of the JAX package) and takes nothing the port made: the field is built
here from its polynomial, the code's generator here from its
construction, and the expected bytes are computed here from the
benchmark's own inputs.

Field: GF(2^8) modulo x^8 + x^4 + x^3 + x^2 + 1 (0x11d), generated by 2.
Code (n, k): the Vandermonde matrix V[i, j] = (i + 1)^j, made systematic
by right-multiplying with the inverse of its top k x k block, so rows
0..k-1 are the identity (data) and rows k..n-1 give the parity.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

POLY = 0x11D
CHUNK = 1 << 25                 # bytes of a row processed at a time on the card


def _tables() -> tuple[list[int], list[int]]:
    exp, log = [0] * 510, [0] * 256
    x = 1
    for i in range(255):
        exp[i] = exp[i + 255] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= POLY
    return exp, log


EXP, LOG = _tables()


def mul(a: int, b: int) -> int:
    """a * b in GF(2^8)."""
    if a == 0 or b == 0:
        return 0
    return EXP[LOG[a] + LOG[b]]


def inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("0 has no inverse in GF(2^8)")
    return EXP[255 - LOG[a]]


def power(a: int, e: int) -> int:
    out = 1
    for _ in range(e):
        out = mul(out, a)
    return out


def mat_inv(m: list[list[int]]) -> list[list[int]]:
    """Inverse of a square matrix over GF(2^8) by Gauss-Jordan."""
    k = len(m)
    a = [list(row) + [int(i == j) for j in range(k)] for i, row in enumerate(m)]
    for col in range(k):
        piv = next((r for r in range(col, k) if a[r][col]), None)
        if piv is None:
            raise ValueError("singular matrix over GF(2^8)")
        a[col], a[piv] = a[piv], a[col]
        s = inv(a[col][col])
        a[col] = [mul(s, x) for x in a[col]]
        for r in range(k):
            if r != col and a[r][col]:
                f = a[r][col]
                a[r] = [x ^ mul(f, y) for x, y in zip(a[r], a[col])]
    return [row[k:] for row in a]


def mat_mul(a: list[list[int]], b: list[list[int]]) -> list[list[int]]:
    out = []
    for row in a:
        acc = [0] * len(b[0])
        for c, brow in zip(row, b):
            if c:
                acc = [x ^ mul(c, y) for x, y in zip(acc, brow)]
        out.append(acc)
    return out


@functools.lru_cache(maxsize=None)
def generator(n: int, k: int) -> tuple[tuple[int, ...], ...]:
    """(n, k) systematic generator: rows 0..k-1 identity, then parity."""
    if not 0 < k < n <= 255:
        raise ValueError(f"invalid RS parameters ({n}, {k})")
    vander = [[power(i + 1, j) for j in range(k)] for i in range(n)]
    gen = mat_mul(vander, mat_inv(vander[:k]))
    return tuple(tuple(row) for row in gen)


def repair_coeffs(n: int, k: int, lost: int, helpers) -> list[int]:
    """Coefficients c with block `lost` = XOR_j c[j] * block helpers[j],
    for k distinct surviving block positions `helpers`."""
    helpers = [int(h) for h in helpers]
    if len(helpers) != k or len(set(helpers)) != k or lost in helpers:
        raise ValueError(f"need k={k} distinct helpers other than {lost}")
    gen = generator(n, k)
    data_of_helpers = mat_inv([list(gen[h]) for h in helpers])
    return mat_mul([list(gen[lost])], data_of_helpers)[0]


@functools.lru_cache(maxsize=8)
def _mul_rows(device: str) -> torch.Tensor:
    table = np.array([[mul(a, b) for b in range(256)] for a in range(256)],
                     dtype=np.uint8)
    return torch.from_numpy(table).to(device)


def combine(coeffs, rows) -> torch.Tensor:
    """XOR_j coeffs[j] * rows[j] over GF(2^8), by table lookups in chunks
    of `CHUNK` bytes; `rows` are equally long 1-D uint8 tensors."""
    nbytes = rows[0].shape[0]
    table = _mul_rows(str(rows[0].device))
    out = torch.zeros(nbytes, dtype=torch.uint8, device=rows[0].device)
    for lo in range(0, nbytes, CHUNK):
        hi = min(lo + CHUNK, nbytes)
        acc = out[lo:hi]
        for c, row in zip(coeffs, rows):
            if c:
                acc ^= table[int(c)].index_select(0, row[lo:hi].int())
    return out


def encode_parity(n: int, k: int, data: torch.Tensor) -> list[torch.Tensor]:
    """The n - k parity rows of a stripe's (k, nbytes) data."""
    gen = generator(n, k)
    return [combine(gen[i], list(data)) for i in range(k, n)]


def bytes_differing(a: torch.Tensor, b: torch.Tensor) -> int:
    """Count of positions at which two equally long uint8 rows differ
    (every position when the lengths differ)."""
    if a.shape != b.shape:
        return max(a.numel(), b.numel())
    total = 0
    for lo in range(0, a.numel(), CHUNK):
        total += int((a[lo:lo + CHUNK] != b[lo:lo + CHUNK]).sum())
    return total
