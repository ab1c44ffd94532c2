"""The byte-domain GF(256) kernels' arithmetic and wrappers held against repro.

`gf256_matmul_bytes` and `gf256_scale_bytes` compute the Pallas kernels'
functions (`gf256_matmul_planes`, `gf256_scale_planes` with the bit-slicing
around them) directly on bytes. Here: the host-side column words against
the JAX package's bit-matrices, a numpy model of the kernel's word-level
formula against the whole product table, and the wrappers on CPU tensors
(their plain versions) against the JAX `ops` with the Pallas kernels in
interpret mode and the numpy ground truth. The CUDA kernels themselves are
held against the same plain versions on the card by `chip_smoke.py`.
"""
import ctypes
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ec import gf256 as jgf256
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.ec import bitplane
from repro_torch.kernels import build, ops
from repro_torch.kernels.gf256_matmul import (COLUMN_WORDS, coeff_to_columns,
                                              gf256_matmul_bytes,
                                              gf256_matmul_planes,
                                              gf256_scale_bytes,
                                              gf256_scale_planes)
from repro_torch.kernels.xor_reduce import (xor_reduce_groups_words,
                                            xor_reduce_words)

NBYTES = [1, 33, 4099]


def _with_0_and_1(c: np.ndarray) -> np.ndarray:
    flat = c.reshape(-1)
    flat[0] = 1                    # coefficients 1 and 0 take part
    if flat.size > 1:
        flat[1] = 0
    return c


def _kernel_mul_words(words: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """The kernel's formula on uint32 words of 4 bytes: for each bit bj,
    shift bit bj of every byte up to bit 7 of its byte, replicate each
    byte's bit 7 over the byte (`prmt`, selector 0xBA98), AND with column
    word bj and XOR into the accumulator."""
    x = words.astype(np.uint64)
    acc = np.zeros_like(x)
    for bj in range(8):
        shifted = (x << np.uint64(7 - bj)) & np.uint64(0xFFFFFFFF)
        mask = ((shifted >> np.uint64(7)) & np.uint64(0x01010101)) * np.uint64(0xFF)
        acc ^= mask & np.uint64(cols[bj])
    return acc.astype(np.uint32)


# ------------------------------------------------------- the arithmetic
def test_column_words_are_the_bitmatrix_columns():
    assert COLUMN_WORDS.dtype == np.uint32 and COLUMN_WORDS.shape == (256, 8)
    for c in range(256):
        bm = jgf256.mul_bitmatrix(c)                   # (8, 8) 0/1, [bi, bj]
        col_bytes = (bm.astype(np.uint32) << np.arange(8, dtype=np.uint32)[:, None]).sum(0)
        words = COLUMN_WORDS[c]
        for shift in (0, 8, 16, 24):                  # replicated to 4 bytes
            assert np.array_equal((words >> np.uint32(shift)) & np.uint32(0xFF),
                                  col_bytes)


def test_coeff_to_columns_shapes():
    coeff = np.arange(6, dtype=np.uint8).reshape(2, 3)
    cols = coeff_to_columns(coeff)
    assert cols.shape == (2, 3, 8) and cols.dtype == np.uint32
    assert np.array_equal(cols[1, 2], COLUMN_WORDS[5])
    assert coeff_to_columns(np.array([7], np.uint8)).shape == (1, 8)


def test_word_formula_equals_mul_table_for_all_pairs():
    """All 256 x 256 products: the 256 byte values as 64 little-endian
    words, through the kernel's formula for every coefficient."""
    words = np.arange(256, dtype=np.uint8).view("<u4")
    for c in range(256):
        got = _kernel_mul_words(words, COLUMN_WORDS[c]).astype("<u4").view(np.uint8)
        assert np.array_equal(got, jgf256.MUL_TABLE[c]), c


def test_word_formula_folds_inputs_like_gf_matmul(rng):
    """Several inputs XOR-folded word by word equal the numpy matmul."""
    coeff = _with_0_and_1(rng.integers(0, 256, size=(3, 6), dtype=np.uint8))
    data = rng.integers(0, 256, size=(6, 64), dtype=np.uint8)
    words = data.view("<u4")
    cols = coeff_to_columns(coeff)
    out = np.zeros((3, 16), dtype=np.uint32)
    for o in range(3):
        for i in range(6):
            out[o] ^= _kernel_mul_words(words[i], cols[o, i])
    assert np.array_equal(out.astype("<u4").view(np.uint8),
                          jgf256.gf_matmul_np(coeff, data))


# ------------------------------------------------------- the wrappers
@pytest.mark.parametrize("m,k", [(1, 1), (3, 6), (2, 16), (5, 3)])
@pytest.mark.parametrize("nbytes", NBYTES)
def test_gf256_matmul_bytes_matches_reference(m, k, nbytes, rng):
    coeff = _with_0_and_1(rng.integers(0, 256, size=(m, k), dtype=np.uint8))
    data = rng.integers(0, 256, size=(k, nbytes), dtype=np.uint8)
    got = gf256_matmul_bytes(coeff, torch.from_numpy(data))
    assert got.dtype == torch.uint8 and got.shape == (m, nbytes)
    assert np.array_equal(got.numpy(), jref.gf256_matmul_np(coeff, data))
    pallas = np.asarray(jops.gf256_matmul(coeff, jnp.asarray(data),
                                          use_kernel=True, interpret=True))
    assert np.array_equal(got.numpy(), pallas)


@pytest.mark.parametrize("m", [1, 5])
@pytest.mark.parametrize("nbytes", NBYTES)
def test_gf256_scale_bytes_matches_reference(m, nbytes, rng):
    coeffs = _with_0_and_1(rng.integers(0, 256, size=m, dtype=np.uint8))
    data = rng.integers(0, 256, size=(m, nbytes), dtype=np.uint8)
    got = gf256_scale_bytes(coeffs, torch.from_numpy(data))
    assert got.dtype == torch.uint8 and got.shape == (m, nbytes)
    assert np.array_equal(got.numpy(), jref.gf256_scale_batch_np(coeffs, data))
    pallas = np.asarray(jops.gf256_scale_batch(coeffs, jnp.asarray(data),
                                               use_kernel=True, interpret=True))
    assert np.array_equal(got.numpy(), pallas)


def test_coefficients_0_and_1_write_zeros_and_copy(rng):
    data = torch.from_numpy(rng.integers(1, 256, size=(2, 33), dtype=np.uint8))
    scaled = gf256_scale_bytes(np.array([0, 1], np.uint8), data)
    assert not scaled[0].any() and torch.equal(scaled[1], data[1])
    product = gf256_matmul_bytes(np.array([[0, 0], [1, 0]], np.uint8), data)
    assert not product[0].any() and torch.equal(product[1], data[0])


def test_ops_take_views_at_any_offset(rng):
    """A row view at an odd byte offset and a strided view give the
    ground truth through the byte entry points (the strided one is copied
    once by `ops`)."""
    flat = rng.integers(0, 256, size=3 + 3 * 4099, dtype=np.uint8)
    coeff = _with_0_and_1(rng.integers(0, 256, size=(2, 3), dtype=np.uint8))
    view = torch.from_numpy(flat)[3:].view(3, 4099)
    want = jgf256.gf_matmul_np(coeff, flat[3:].reshape(3, 4099))
    assert np.array_equal(ops.gf256_matmul(coeff, view).numpy(), want)
    strided = torch.from_numpy(flat[3:].reshape(3, 4099))[:, ::2]
    assert not strided.is_contiguous()
    want = jgf256.gf_matmul_np(coeff, flat[3:].reshape(3, 4099)[:, ::2])
    assert np.array_equal(ops.gf256_matmul(coeff, strided).numpy(), want)
    coeffs = coeff[0, :3].copy()
    want = jref.gf256_scale_batch_np(coeffs, flat[3:].reshape(3, 4099)[:, ::2])
    assert np.array_equal(ops.gf256_scale_batch(coeffs, strided).numpy(), want)


def test_ops_do_not_bit_slice(rng, monkeypatch):
    def no_planes(*_):
        raise AssertionError("a byte entry point bit-sliced its input")

    monkeypatch.setattr(bitplane, "pack", no_planes)
    monkeypatch.setattr(bitplane, "unpack", no_planes)
    coeff = _with_0_and_1(rng.integers(0, 256, size=(3, 3), dtype=np.uint8))
    data = rng.integers(0, 256, size=(3, 99), dtype=np.uint8)
    got = ops.rs_encode(coeff, torch.from_numpy(data))
    assert np.array_equal(got.numpy(), jgf256.gf_matmul_np(coeff, data))
    got = ops.gf256_scale_batch(coeff[0], torch.from_numpy(data))
    assert np.array_equal(got.numpy(), jref.gf256_scale_batch_np(coeff[0], data))


BAD_MATMUL = [
    (np.zeros((1, 2), np.int64), torch.zeros((2, 4), dtype=torch.uint8), TypeError),
    ([[1, 2]], torch.zeros((2, 4), dtype=torch.uint8), TypeError),
    (np.zeros((1, 2), np.uint8), torch.zeros((2, 4), dtype=torch.int32), TypeError),
    (np.zeros((1, 2), np.uint8), np.zeros((2, 4), np.uint8), TypeError),
    (np.zeros((1, 2), np.uint8), torch.zeros(8, dtype=torch.uint8), ValueError),
    (np.zeros(2, np.uint8), torch.zeros((2, 4), dtype=torch.uint8), ValueError),
    (np.zeros((1, 2), np.uint8), torch.zeros((3, 4), dtype=torch.uint8), ValueError),
    (np.zeros((1, 2), np.uint8), torch.zeros((2, 4), dtype=torch.uint8,
                                             device="meta"), ValueError),
]


@pytest.mark.parametrize("coeff,data,error", BAD_MATMUL)
def test_gf256_matmul_bytes_rejects_bad_inputs(coeff, data, error):
    with pytest.raises(error):
        gf256_matmul_bytes(coeff, data)


BAD_SCALE = [
    (np.zeros(2, np.int32), torch.zeros((2, 4), dtype=torch.uint8), TypeError),
    (np.zeros(2, np.uint8), torch.zeros((2, 4), dtype=torch.int64), TypeError),
    (np.zeros((2, 1), np.uint8), torch.zeros((2, 4), dtype=torch.uint8), ValueError),
    (np.zeros(2, np.uint8), torch.zeros((2, 4, 1), dtype=torch.uint8), ValueError),
    (np.zeros(3, np.uint8), torch.zeros((2, 4), dtype=torch.uint8), ValueError),
    (np.zeros(2, np.uint8), torch.zeros((2, 4), dtype=torch.uint8,
                                        device="meta"), ValueError),
]


@pytest.mark.parametrize("coeffs,data,error", BAD_SCALE)
def test_gf256_scale_bytes_rejects_bad_inputs(coeffs, data, error):
    with pytest.raises(error):
        gf256_scale_bytes(coeffs, data)


def test_cpu_calls_never_launch_or_build(rng, monkeypatch):
    def no_build():
        raise AssertionError("a CPU call tried to build the CUDA kernels")

    monkeypatch.setattr(build, "load_library", no_build)
    wrappers = (gf256_matmul_bytes, gf256_scale_bytes, gf256_matmul_planes,
                gf256_scale_planes, xor_reduce_words, xor_reduce_groups_words)
    for fn in wrappers:
        monkeypatch.setattr(fn, "launches", 0)
    coeff = _with_0_and_1(rng.integers(0, 256, size=(2, 3), dtype=np.uint8))
    data = torch.from_numpy(rng.integers(0, 256, size=(3, 99), dtype=np.uint8))
    ops.gf256_matmul(coeff, data)
    ops.rs_reconstruct(coeff, data)
    ops.gf256_scale_batch(coeff[0], data)
    gf256_matmul_bytes(coeff, data)
    gf256_scale_bytes(coeff[0], data)
    assert [fn.launches for fn in wrappers] == [0] * len(wrappers)


def test_build_binds_the_byte_launchers():
    src = (build.CSRC / "gf256_matmul.cu").read_text()
    assert 'extern "C" int gf256_matmul_bytes_launch' in src
    assert 'extern "C" int gf256_scale_bytes_launch' in src

    class FakeLib:
        def __getattr__(self, name):
            fn = types.SimpleNamespace()
            setattr(self, name, fn)
            return fn

    lib = FakeLib()
    build._bind(lib)
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # (cols, in, out, m, k, n, stream) and (cols, in, dst, out, M, n, ld,
    # stream)
    assert lib.gf256_matmul_bytes_launch.argtypes == [p, p, p, i32, i32, i64, p]
    assert lib.gf256_scale_bytes_launch.argtypes == [p, p, p, p, i32, i64, i64,
                                                     p]
    assert lib.gf256_matmul_bytes_launch.restype is i32
    assert lib.gf256_scale_bytes_launch.restype is i32
