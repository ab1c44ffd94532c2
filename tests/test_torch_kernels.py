"""repro_torch.kernels held against repro.kernels (Pallas in interpret mode).

On the CPU the wrappers take their kernels' plain PyTorch versions; these
tests pin those, and the byte-level `ops` around them, to the JAX kernels
bit for bit. The CUDA kernels themselves are held against the same plain
versions on the card by `chip_smoke.py`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ec import bitplane as jbitplane
from repro.ec import gf256 as jgf256
from repro.kernels import ops as jops
from repro.kernels.gf256_matmul import gf256_matmul_planes as j_gf256_matmul_planes
from repro.kernels.xor_reduce import xor_reduce_words as j_xor_reduce_words
from repro_torch.ec import bitplane
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.gf256_matmul import gf256_matmul_planes
from repro_torch.kernels.xor_reduce import xor_reduce_words


def _u32(x: torch.Tensor) -> np.ndarray:
    return x.numpy().view(np.uint32)


@pytest.mark.parametrize("m,k", [(1, 1), (3, 6), (2, 16)])
@pytest.mark.parametrize("w", [1, 513])
def test_gf256_matmul_planes_matches_pallas(m, k, w, rng):
    coeff = rng.integers(0, 256, size=(m, k), dtype=np.uint8)
    masks_np = jbitplane.coeff_to_masks_np(coeff)
    planes_np = rng.integers(0, 1 << 32, size=(k, 8, w), dtype=np.uint32)
    want = np.asarray(j_gf256_matmul_planes(
        jnp.asarray(masks_np), jnp.asarray(planes_np), interpret=True))
    got = gf256_matmul_planes(bitplane.coeff_to_masks(coeff, "cpu"),
                              torch.from_numpy(planes_np.view(np.int32)))
    assert got.dtype == torch.int32 and got.shape == (m, 8, w)
    assert np.array_equal(_u32(got), want)


@pytest.mark.parametrize("k", [2, 5])
@pytest.mark.parametrize("w", [1, 1025])
def test_xor_reduce_words_matches_pallas(k, w, rng):
    words_np = rng.integers(0, 1 << 32, size=(k, w), dtype=np.uint32)
    want = np.asarray(j_xor_reduce_words(jnp.asarray(words_np), interpret=True))
    got = xor_reduce_words(torch.from_numpy(words_np.view(np.int32)))
    assert got.dtype == torch.int32 and got.shape == (w,)
    assert np.array_equal(_u32(got), want)


@pytest.mark.parametrize("m,k,nbytes", [(1, 1, 1), (1, 1, 4099), (2, 3, 33),
                                         (3, 6, 1000)])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_ops_gf256_matmul_bytes(m, k, nbytes, use_kernel, rng):
    coeff = rng.integers(0, 256, size=(m, k), dtype=np.uint8)
    coeff[0, 0] = 1
    if k > 1:
        coeff[0, 1] = 0
    data = rng.integers(0, 256, size=(k, nbytes), dtype=np.uint8)
    want = jgf256.gf_matmul_np(coeff, data)
    got = ops.gf256_matmul(coeff, torch.from_numpy(data), use_kernel=use_kernel)
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    assert np.array_equal(got.numpy(), want)
    # repro's ops on its plain jnp path (the Pallas body is pinned above)
    ref_jax = np.asarray(jops.gf256_matmul(coeff, jnp.asarray(data),
                                           use_kernel=False))
    assert np.array_equal(got.numpy(), ref_jax)


@pytest.mark.parametrize("k,nbytes", [(1, 7), (2, 1), (2, 4099), (5, 7)])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_ops_xor_reduce_bytes(k, nbytes, use_kernel, rng):
    chunks = rng.integers(0, 256, size=(k, nbytes), dtype=np.uint8)
    want = np.bitwise_xor.reduce(chunks, axis=0)
    got = ops.xor_reduce(torch.from_numpy(chunks), use_kernel=use_kernel)
    assert got.dtype == torch.uint8 and got.shape == (nbytes,)
    assert np.array_equal(got.numpy(), want)
    ref_jax = np.asarray(jops.xor_reduce(jnp.asarray(chunks), use_kernel=False))
    assert np.array_equal(got.numpy(), ref_jax)


def test_rs_entry_points_bytes(rng):
    coeff = rng.integers(0, 256, size=(3, 6), dtype=np.uint8)
    data = rng.integers(0, 256, size=(6, 257), dtype=np.uint8)
    want = jgf256.gf_matmul_np(coeff, data)
    assert np.array_equal(ops.rs_encode(coeff, torch.from_numpy(data)).numpy(),
                          want)
    assert np.array_equal(
        ops.rs_reconstruct(coeff, torch.from_numpy(data)).numpy(), want)


def test_plain_versions_agree_with_each_other(rng):
    coeff = rng.integers(0, 256, size=(2, 4), dtype=np.uint8)
    data = torch.from_numpy(rng.integers(0, 256, size=(4, 300), dtype=np.uint8))
    by_bytes = ref.gf256_matmul_bytes_ref(coeff, data)
    by_planes = bitplane.unpack(ref.gf256_matmul_planes_ref(
        bitplane.coeff_to_masks(coeff, "cpu"), bitplane.pack(data)), 300)
    assert torch.equal(by_bytes, by_planes)


def test_cpu_calls_never_launch_or_build(rng, monkeypatch):
    def no_build():
        raise AssertionError("a CPU call tried to build the CUDA kernels")

    monkeypatch.setattr(build, "load_library", no_build)
    monkeypatch.setattr(gf256_matmul_planes, "launches", 0)
    monkeypatch.setattr(xor_reduce_words, "launches", 0)
    coeff = rng.integers(0, 256, size=(2, 3), dtype=np.uint8)
    data = torch.from_numpy(rng.integers(0, 256, size=(3, 99), dtype=np.uint8))
    ops.gf256_matmul(coeff, data)
    ops.xor_reduce(data)
    assert gf256_matmul_planes.launches == 0
    assert xor_reduce_words.launches == 0


def test_wrappers_reject_bad_inputs():
    masks = torch.zeros((1, 2, 8, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        gf256_matmul_planes(masks, torch.zeros((3, 8, 4), dtype=torch.int32))
    with pytest.raises(TypeError):
        gf256_matmul_planes(masks, torch.zeros((2, 8, 4), dtype=torch.int64))
    with pytest.raises(ValueError):
        xor_reduce_words(torch.zeros((2, 4), dtype=torch.uint8))
    with pytest.raises(TypeError):
        ops.xor_reduce(np.zeros((2, 4), dtype=np.uint8))


def test_build_is_keyed_on_sources():
    srcs = sorted(p.name for p in build.CSRC.glob("*.cu"))
    assert srcs == ["event_loop.cu", "gf256_matmul.cu", "xor_reduce.cu"]
    digest = build.source_digest()
    assert len(digest) == 16 and digest == build.source_digest()
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
