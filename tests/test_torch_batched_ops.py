"""The batched data-plane kernels and entry points held against repro.

`gf256_scale_planes` and `xor_reduce_groups_words` on the CPU (their plain
PyTorch versions) against the Pallas functions in interpret mode, and
`ops.gf256_scale_batch` / `ops.xor_reduce_segments` against the reference
`ops` on both of its paths, bit for bit. The CUDA kernels themselves are
held against the same plain versions on the card by `chip_smoke.py`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ec import bitplane as jbitplane
from repro.ec import gf256 as jgf256
from repro.kernels import ops as jops
from repro.kernels.gf256_matmul import gf256_scale_planes as j_gf256_scale_planes
from repro.kernels.xor_reduce import xor_reduce_groups_words as j_xor_groups
from repro_torch.ec import bitplane
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.gf256_matmul import (gf256_matmul_planes,
                                              gf256_scale_planes)
from repro_torch.kernels.xor_reduce import (xor_reduce_groups_words,
                                            xor_reduce_words)

# ragged (-1 padded) groups, a K=1 row, rows repeated across groups
GROUPS = np.array([[0, 1, 2, -1],
                   [3, -1, -1, -1],
                   [4, 5, -1, -1],
                   [6, 2, 0, 1],
                   [-1, -1, -1, -1]])


def _u32(x: torch.Tensor) -> np.ndarray:
    return x.numpy().view(np.uint32)


def _coeffs(rng, m):
    c = rng.integers(0, 256, size=m, dtype=np.uint8)
    c[0] = 1                       # coefficients 1 and 0 take part
    if m > 1:
        c[1] = 0
    return c


# ------------------------------------------------------ gf256_scale_planes
@pytest.mark.parametrize("m", [1, 5])
@pytest.mark.parametrize("w", [1, 513])
def test_gf256_scale_planes_matches_pallas(m, w, rng):
    coeffs = _coeffs(rng, m)
    masks_np = jbitplane.coeff_to_masks_np(coeffs[:, None])
    planes_np = rng.integers(0, 1 << 32, size=(m, 8, w), dtype=np.uint32)
    want = np.asarray(j_gf256_scale_planes(
        jnp.asarray(masks_np), jnp.asarray(planes_np), interpret=True))
    got = gf256_scale_planes(bitplane.coeff_to_masks(coeffs[:, None], "cpu"),
                             torch.from_numpy(planes_np.view(np.int32)))
    assert got.dtype == torch.int32 and got.shape == (m, 8, w)
    assert np.array_equal(_u32(got), want)


def test_gf256_scale_planes_is_rowwise_matmul(rng):
    """Row r of the batched scale equals a (1, 1) `gf256_matmul_planes`."""
    coeffs = _coeffs(rng, 4)
    masks = bitplane.coeff_to_masks(coeffs[:, None], "cpu")
    planes = torch.from_numpy(
        rng.integers(-(1 << 31), 1 << 31, size=(4, 8, 70), dtype=np.int32))
    got = gf256_scale_planes(masks, planes)
    for r in range(4):
        assert torch.equal(got[r], gf256_matmul_planes(masks[r:r + 1],
                                                       planes[r:r + 1])[0])


# ------------------------------------------------- xor_reduce_groups_words
@pytest.mark.parametrize("g,k", [(1, 1), (3, 2), (4, 5)])
@pytest.mark.parametrize("w", [1, 1025])
def test_xor_reduce_groups_words_matches_pallas(g, k, w, rng):
    words_np = rng.integers(0, 1 << 32, size=(g, k, w), dtype=np.uint32)
    want = np.asarray(j_xor_groups(jnp.asarray(words_np), interpret=True))
    got = xor_reduce_groups_words(torch.from_numpy(words_np.view(np.int32)))
    assert got.dtype == torch.int32 and got.shape == (g, w)
    assert np.array_equal(_u32(got), want)


@pytest.mark.parametrize("w", [1, 513, 1024])
def test_xor_reduce_groups_gather_form_matches_pallas(w, rng):
    """The index-table form equals the Pallas kernel on the dense copy the
    JAX package gathers (`-1` reads an all-zero row)."""
    words_np = rng.integers(0, 1 << 32, size=(7, w), dtype=np.uint32)
    padded = np.concatenate([words_np, np.zeros((1, w), np.uint32)])
    dense = padded[np.where(GROUPS >= 0, GROUPS, 7)]
    want = np.asarray(j_xor_groups(jnp.asarray(dense), interpret=True))
    got = xor_reduce_groups_words(torch.from_numpy(words_np.view(np.int32)),
                                  GROUPS)
    assert got.shape == (5, w)
    assert np.array_equal(_u32(got), want)
    assert not _u32(got)[4].any()                # an all -1 group is zero
    # a CPU tensor index table is taken like the numpy one
    again = xor_reduce_groups_words(torch.from_numpy(words_np.view(np.int32)),
                                    torch.from_numpy(GROUPS))
    assert torch.equal(again, got)


def test_xor_reduce_groups_words_rejects_bad_tables():
    words = torch.zeros((3, 4), dtype=torch.int32)
    with pytest.raises(IndexError):
        xor_reduce_groups_words(words, np.array([[0, 3]]))
    with pytest.raises(IndexError):
        xor_reduce_groups_words(words, np.array([[-2]]))
    with pytest.raises(ValueError):
        xor_reduce_groups_words(words, np.array([0, 1]))
    with pytest.raises(ValueError):
        xor_reduce_groups_words(torch.zeros((2, 0, 4), dtype=torch.int32))
    with pytest.raises(TypeError):
        xor_reduce_groups_words(words.to(torch.int64), np.array([[0]]))
    with pytest.raises(ValueError):
        gf256_scale_planes(torch.zeros((2, 1, 8, 8), dtype=torch.int32),
                           torch.zeros((3, 8, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        gf256_scale_planes(torch.zeros((2, 2, 8, 8), dtype=torch.int32),
                           torch.zeros((2, 8, 4), dtype=torch.int32))


# ------------------------------------------------------- gf256_scale_batch
@pytest.mark.parametrize("m,nbytes", [(1, 1), (1, 32), (5, 100), (7, 4099),
                                      (16, 1024)])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_ops_gf256_scale_batch_matches_reference(m, nbytes, use_kernel, rng):
    coeffs = _coeffs(rng, m)
    data = rng.integers(0, 256, size=(m, nbytes), dtype=np.uint8)
    want = np.stack([jgf256.MUL_TABLE[coeffs[i], data[i]] for i in range(m)])
    got = ops.gf256_scale_batch(coeffs, torch.from_numpy(data),
                                use_kernel=use_kernel)
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    assert got.shape == (m, nbytes)
    assert np.array_equal(got.numpy(), want)
    for ref_kernel in (False, True):   # the reference's numpy and Pallas paths
        theirs = np.asarray(jops.gf256_scale_batch(
            coeffs, data, use_kernel=ref_kernel, interpret=True))
        assert np.array_equal(got.numpy(), theirs)
    if m > 1:
        assert not got[1].any()                       # coefficient 0
    assert np.array_equal(got[0].numpy(), data[0])    # coefficient 1


def test_ops_gf256_scale_batch_empty_and_mismatch(rng):
    out = ops.gf256_scale_batch(np.zeros(0, np.uint8),
                                torch.zeros((0, 9), dtype=torch.uint8))
    assert out.shape == (0, 9)
    with pytest.raises(ValueError):
        ops.gf256_scale_batch(np.ones(2, np.uint8),
                              torch.zeros((3, 9), dtype=torch.uint8))


# ---------------------------------------------------- xor_reduce_segments
@pytest.mark.parametrize("nbytes", [1, 4, 96, 1000, 4099])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_ops_xor_reduce_segments_matches_reference(nbytes, use_kernel, rng):
    chunks = rng.integers(0, 256, size=(7, nbytes), dtype=np.uint8)
    want = np.stack([
        np.bitwise_xor.reduce(chunks[[r for r in g if r >= 0]], axis=0)
        if (g >= 0).any() else np.zeros(nbytes, np.uint8) for g in GROUPS])
    got = ops.xor_reduce_segments(torch.from_numpy(chunks), GROUPS,
                                  use_kernel=use_kernel)
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    assert got.shape == (5, nbytes)
    assert np.array_equal(got.numpy(), want)
    for ref_kernel in (False, True):
        theirs = np.asarray(jops.xor_reduce_segments(
            chunks, GROUPS, use_kernel=ref_kernel, interpret=True))
        assert np.array_equal(got.numpy(), theirs)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_ops_xor_reduce_segments_empty_groups(use_kernel, rng):
    chunks = torch.from_numpy(rng.integers(0, 256, size=(3, 16), dtype=np.uint8))
    out = ops.xor_reduce_segments(chunks, np.zeros((0, 2), dtype=np.int64),
                                  use_kernel=use_kernel)
    assert out.shape == (0, 16) and out.dtype == torch.uint8
    theirs = np.asarray(jops.xor_reduce_segments(
        chunks.numpy(), np.zeros((0, 2), dtype=np.int64)))
    assert theirs.shape == (0, 16)


# ------------------------------------------ writing the rows where they lie
# a held destination in its own group (row 2 -> row 2), -1 pads, a K=1
# group, a destination outside every group (row 7)
IN_PLACE = np.array([[2, 0, 5, -1],
                     [4, -1, -1, -1],
                     [1, 6, 3, -1]])
IN_PLACE_DST = np.array([2, 7, 1])


@pytest.mark.parametrize("nbytes", [1, 100, 4099])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_ops_gf256_scale_batch_into_rows(nbytes, use_kernel, rng):
    """With `out` and `out_rows` the product lands in the named rows of a
    wider buffer; no other byte of it changes."""
    coeffs = _coeffs(rng, 5)
    data = rng.integers(0, 256, size=(5, nbytes), dtype=np.uint8)
    width = nbytes + 7
    out = torch.full((9, width), 0xAB, dtype=torch.uint8)
    rows = np.array([6, 0, 3, 8, 2])
    got = ops.gf256_scale_batch(coeffs, torch.from_numpy(data), out=out,
                                out_rows=rows, use_kernel=use_kernel)
    assert got is out
    want = np.full((9, width), 0xAB, dtype=np.uint8)
    want[rows, :nbytes] = jgf256.MUL_TABLE[coeffs[:, None], data]
    assert np.array_equal(out.numpy(), want)
    fresh = ops.gf256_scale_batch(coeffs, torch.from_numpy(data),
                                  use_kernel=use_kernel)
    assert torch.equal(out[torch.from_numpy(rows), :nbytes], fresh)


def test_ops_gf256_scale_batch_into_rows_rejects_bad_tables(rng):
    data = torch.from_numpy(rng.integers(0, 256, size=(2, 8), dtype=np.uint8))
    out = torch.zeros((4, 8), dtype=torch.uint8)
    c = np.ones(2, np.uint8)
    for use_kernel in (True, False):
        for rows in ([0, 0], [0, 4], [-1, 1], [0]):
            with pytest.raises(ValueError):
                ops.gf256_scale_batch(c, data, out=out, out_rows=rows,
                                      use_kernel=use_kernel)
        with pytest.raises(ValueError):           # narrower than the data
            ops.gf256_scale_batch(c, data, out=out[:, :4].contiguous(),
                                  out_rows=[0, 1], use_kernel=use_kernel)
        with pytest.raises(ValueError):           # data inside out
            ops.gf256_scale_batch(c, out[:2], out=out, out_rows=[2, 3],
                                  use_kernel=use_kernel)
    with pytest.raises(ValueError):
        ops.gf256_scale_batch(c, data, out_rows=[0, 1])


@pytest.mark.parametrize("nbytes", [4, 96, 4099])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_ops_xor_reduce_segments_in_place(nbytes, use_kernel, rng):
    """With `out_rows` each group's fold is written over its row of the
    chunks themselves, rows padded to whole words as the data plane pads
    them (a ragged `nbytes` too); the other rows keep their bytes."""
    width = nbytes + (-nbytes % 4)
    chunks = rng.integers(0, 256, size=(8, width), dtype=np.uint8)
    want = chunks.copy()
    for g, row in zip(IN_PLACE, IN_PLACE_DST):
        want[row] = np.bitwise_xor.reduce(chunks[g[g >= 0]], axis=0)
    fresh = ops.xor_reduce_segments(torch.from_numpy(chunks[:, :nbytes]),
                                    IN_PLACE, use_kernel=use_kernel)
    buf = torch.from_numpy(chunks.copy())
    got = ops.xor_reduce_segments(buf, IN_PLACE, out_rows=IN_PLACE_DST,
                                  use_kernel=use_kernel)
    assert got is buf
    assert np.array_equal(buf.numpy(), want)
    assert torch.equal(buf[torch.from_numpy(IN_PLACE_DST), :nbytes], fresh)
    theirs = np.asarray(jops.xor_reduce_segments(chunks[:, :nbytes], IN_PLACE,
                                                 use_kernel=False))
    assert np.array_equal(want[IN_PLACE_DST, :nbytes], theirs)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_ops_xor_reduce_segments_in_place_rejects_bad_tables(use_kernel, rng):
    chunks = torch.from_numpy(rng.integers(0, 256, size=(8, 16), dtype=np.uint8))
    before = chunks.clone()
    for dst in ([2, 7], [2, 2, 1], [2, 7, 8], [2, 7, -1],
                [2, 6, 1]):                    # row 6 is read by group 2
        with pytest.raises(ValueError):
            ops.xor_reduce_segments(chunks, IN_PLACE, out_rows=dst,
                                    use_kernel=use_kernel)
    # rows that are not whole words, or not contiguous
    for bad in (chunks[:, :15], chunks[:, ::2]):
        with pytest.raises(ValueError, match="whole 32-bit words"):
            ops.xor_reduce_segments(bad, IN_PLACE, out_rows=IN_PLACE_DST,
                                    use_kernel=use_kernel)
    assert torch.equal(chunks, before)


def test_xor_reduce_groups_words_in_place(rng):
    words = torch.from_numpy(rng.integers(-2**31, 2**31, size=(8, 33),
                                          dtype=np.int64).astype(np.int32))
    want = words.clone()
    want[torch.from_numpy(IN_PLACE_DST)] = xor_reduce_groups_words(
        words, IN_PLACE)
    assert xor_reduce_groups_words(words, IN_PLACE, IN_PLACE_DST) is words
    assert torch.equal(words, want)
    with pytest.raises(ValueError):
        xor_reduce_groups_words(torch.zeros((2, 3, 4), dtype=torch.int32),
                                out_rows=[0, 1])


def test_plain_versions_agree_with_each_other(rng):
    coeffs = _coeffs(rng, 6)
    data = torch.from_numpy(rng.integers(0, 256, size=(6, 300), dtype=np.uint8))
    by_bytes = ref.gf256_scale_batch_ref(coeffs, data)
    by_planes = bitplane.unpack(ref.gf256_scale_planes_ref(
        bitplane.coeff_to_masks(coeffs[:, None], "cpu"), bitplane.pack(data)),
        300)
    assert torch.equal(by_bytes, by_planes)
    words = data[:, :296].contiguous().view(torch.int32)
    by_index = ref.xor_reduce_groups_words_ref(words, torch.from_numpy(GROUPS[:, :3] % 6))
    dense = words[torch.from_numpy(GROUPS[:, :3] % 6)]
    assert torch.equal(by_index, ref.xor_reduce_groups_words_ref(dense))


def test_cpu_calls_never_launch_or_build(rng, monkeypatch):
    def no_build():
        raise AssertionError("a CPU call tried to build the CUDA kernels")

    monkeypatch.setattr(build, "load_library", no_build)
    wrappers = (gf256_matmul_planes, gf256_scale_planes, xor_reduce_words,
                xor_reduce_groups_words)
    for fn in wrappers:
        monkeypatch.setattr(fn, "launches", 0)
    coeffs = _coeffs(rng, 4)
    data = torch.from_numpy(rng.integers(0, 256, size=(4, 99), dtype=np.uint8))
    ops.gf256_scale_batch(coeffs, data)
    ops.xor_reduce_segments(data, GROUPS[:, :2] % 4)
    xor_reduce_groups_words(torch.zeros((2, 3, 5), dtype=torch.int32))
    buf = torch.zeros((6, 100), dtype=torch.uint8)
    ops.gf256_scale_batch(coeffs, data, out=buf, out_rows=[5, 0, 1, 2])
    ops.xor_reduce_segments(buf, GROUPS[:1, :2] % 4, out_rows=[4])
    assert [fn.launches for fn in wrappers] == [0, 0, 0, 0]


def test_build_binds_the_new_launchers():
    srcs = {p.name: p.read_text() for p in build.CSRC.glob("*.cu")}
    assert 'extern "C" int gf256_scale_planes_launch' in srcs["gf256_matmul.cu"]
    assert 'extern "C" int xor_reduce_groups_launch' in srcs["xor_reduce.cu"]
    import inspect

    bind = inspect.getsource(build._bind)
    assert "gf256_scale_planes_launch" in bind
    assert "xor_reduce_groups_launch" in bind
