"""GF(2^8) arithmetic with the polynomial 0x11d (x^8 + x^4 + x^3 + x^2 + 1).

The polynomial is the one used by classic Reed-Solomon storage codes
(Jerasure, ISA-L default). Tables are built once in numpy on the host —
coefficient math (RS generators, repair coefficients, matrix inverses) is
scalar control work and stays there. `mul_table(device)` is the torch copy
of `MUL_TABLE` that the plain byte-domain data plane (`kernels/ref.py`)
gathers from on the tensor's own device.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

PRIM_POLY = 0x11D  # x^8 + x^4 + x^3 + x^2 + 1, primitive over GF(2)
FIELD = 256
GENERATOR = 2


def _build_tables() -> tuple[np.ndarray, np.ndarray]:
    """exp/log tables for the multiplicative group generated by 2."""
    exp = np.zeros(512, dtype=np.uint8)  # doubled to avoid mod-255 in hot path
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= PRIM_POLY
    for i in range(255, 512):
        exp[i] = exp[i - 255]
    log[0] = 0  # sentinel; never used for zero operands
    return exp, log


EXP_TABLE, LOG_TABLE = _build_tables()

# Full 256x256 multiplication table: MUL_TABLE[a, b] = a*b in GF(256).
_a = np.arange(256)[:, None]
_b = np.arange(256)[None, :]
_nz = (_a != 0) & (_b != 0)
MUL_TABLE = np.where(
    _nz, EXP_TABLE[(LOG_TABLE[_a] + LOG_TABLE[_b]) % 255], 0
).astype(np.uint8)
del _a, _b, _nz


@functools.lru_cache(maxsize=None)
def _mul_table_on(device: str) -> torch.Tensor:
    return torch.from_numpy(MUL_TABLE).to(device)


def mul_table(device) -> torch.Tensor:
    """(256, 256) uint8 `MUL_TABLE` on `device` (one copy per device)."""
    return _mul_table_on(str(torch.device(device)))


def gf_mul(a, b):
    """Scalar or ndarray GF(256) multiply via the dense table (numpy)."""
    return MUL_TABLE[np.asarray(a, dtype=np.uint8), np.asarray(b, dtype=np.uint8)]


def gf_mul_slow(a: int, b: int) -> int:
    """Russian-peasant multiply — independent ground truth for tests."""
    r = 0
    while b:
        if b & 1:
            r ^= a
        a <<= 1
        if a & 0x100:
            a ^= PRIM_POLY
        b >>= 1
    return r


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("GF(256) zero has no inverse")
    return int(EXP_TABLE[255 - LOG_TABLE[a]])


def gf_div(a: int, b: int) -> int:
    if b == 0:
        raise ZeroDivisionError
    if a == 0:
        return 0
    return int(EXP_TABLE[(LOG_TABLE[a] - LOG_TABLE[b]) % 255])


def gf_pow(a: int, n: int) -> int:
    if n == 0:
        return 1
    if a == 0:
        return 0
    return int(EXP_TABLE[(LOG_TABLE[a] * n) % 255])


def gf_matmul_np(coeff: np.ndarray, data: np.ndarray) -> np.ndarray:
    """(m,k) GF coefficients x (k, nbytes) uint8 data -> (m, nbytes).

    Numpy reference used by RS encode/decode tests and the plan executor's
    oracle path. XOR-accumulate of table lookups.
    """
    coeff = np.asarray(coeff, dtype=np.uint8)
    data = np.asarray(data, dtype=np.uint8)
    m, k = coeff.shape
    assert data.shape[0] == k, (coeff.shape, data.shape)
    out = np.zeros((m,) + data.shape[1:], dtype=np.uint8)
    for i in range(m):
        acc = np.zeros(data.shape[1:], dtype=np.uint8)
        for j in range(k):
            c = int(coeff[i, j])
            if c == 0:
                continue
            if c == 1:
                acc ^= data[j]
            else:
                acc ^= MUL_TABLE[c, data[j]]
        out[i] = acc
    return out


def gf_inv_np(a: np.ndarray) -> np.ndarray:
    """Vectorized GF(256) inverse of a uint8 array (no zeros allowed)."""
    a = np.asarray(a, dtype=np.uint8)
    if (a == 0).any():
        raise ZeroDivisionError("GF(256) zero has no inverse")
    return EXP_TABLE[(255 - LOG_TABLE[a]) % 255]


def gf_mat_inv_batch(mats: np.ndarray) -> np.ndarray:
    """Invert a (J, n, n) batch of GF(256) matrices in lockstep.

    Batched Gauss-Jordan: every elimination step (pivot search, row swap,
    normalization, elimination) runs across the whole batch as table
    gathers + XORs, so inverting J matrices costs n passes, not J*n.
    Matches `gf_mat_inv` row for row (the batched pivot picks the first
    non-zero row, like the scalar scan).
    """
    mats = np.array(mats, dtype=np.uint8)
    j, n, n2 = mats.shape
    assert n == n2, mats.shape
    if j == 0:
        return mats
    aug = np.concatenate(
        [mats, np.broadcast_to(np.eye(n, dtype=np.uint8), (j, n, n)).copy()],
        axis=2,
    )
    ji = np.arange(j)
    for col in range(n):
        colvals = aug[:, col:, col]
        nz = colvals != 0
        if not nz.any(axis=1).all():
            raise np.linalg.LinAlgError("singular GF(256) matrix in batch")
        piv = col + nz.argmax(axis=1)
        swap = aug[ji, piv].copy()
        aug[ji, piv] = aug[:, col]
        aug[:, col] = swap
        inv = gf_inv_np(aug[:, col, col])
        aug[:, col] = MUL_TABLE[inv[:, None], aug[:, col]]
        factors = aug[:, :, col].copy()
        factors[:, col] = 0
        aug ^= MUL_TABLE[factors[:, :, None], aug[:, col][:, None, :]]
    return aug[:, :, n:]


def gf_mat_inv(mat: np.ndarray) -> np.ndarray:
    """Invert a square GF(256) matrix by Gauss-Jordan elimination."""
    mat = np.array(mat, dtype=np.uint8)
    n = mat.shape[0]
    assert mat.shape == (n, n)
    aug = np.concatenate([mat, np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        # find pivot
        piv = None
        for row in range(col, n):
            if aug[row, col] != 0:
                piv = row
                break
        if piv is None:
            raise np.linalg.LinAlgError("singular GF(256) matrix")
        if piv != col:
            aug[[col, piv]] = aug[[piv, col]]
        inv = gf_inv(int(aug[col, col]))
        aug[col] = MUL_TABLE[inv, aug[col]]
        for row in range(n):
            if row != col and aug[row, col] != 0:
                aug[row] ^= MUL_TABLE[int(aug[row, col]), aug[col]]
    return aug[:, n:]


@functools.lru_cache(maxsize=None)
def _mulmat_gf2(c: int) -> tuple:
    """The 8x8 GF(2) bit-matrix of 'multiply by constant c' in GF(256).

    Column j is the byte c * (1<<j); entry (i, j) = bit i of that byte.
    Returned as a tuple of 8 ints (row bitmasks) for hashability.
    """
    cols = [gf_mul_slow(c, 1 << j) for j in range(8)]
    rows = []
    for i in range(8):
        mask = 0
        for j in range(8):
            if (cols[j] >> i) & 1:
                mask |= 1 << j
        rows.append(mask)
    return tuple(rows)


def mul_bitmatrix(c: int) -> np.ndarray:
    """(8,8) uint8 0/1 matrix M with out_bit[i] = XOR_j M[i,j] & in_bit[j]."""
    rows = _mulmat_gf2(int(c))
    out = np.zeros((8, 8), dtype=np.uint8)
    for i in range(8):
        for j in range(8):
            out[i, j] = (rows[i] >> j) & 1
    return out
