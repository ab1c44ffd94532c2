"""repro_torch.ec held against repro.ec: tables, bit-planes, RS codes (exact)."""
import numpy as np
import pytest
import torch

from repro.ec import bitplane as jbitplane
from repro.ec import gf256 as jgf256
from repro.ec import rs as jrs
from repro.ec import stripe as jstripe
from repro_torch.ec import bitplane, gf256, rs, stripe


def test_mul_table_and_scalar_ops_equal():
    assert np.array_equal(gf256.MUL_TABLE, jgf256.MUL_TABLE)
    assert np.array_equal(gf256.EXP_TABLE, jgf256.EXP_TABLE)
    assert np.array_equal(gf256.mul_table("cpu").numpy(), jgf256.MUL_TABLE)
    for a in range(1, 256):
        assert gf256.gf_inv(a) == jgf256.gf_inv(a)
        assert gf256.gf_pow(a, 7) == jgf256.gf_pow(a, 7)
        assert np.array_equal(gf256.mul_bitmatrix(a), jgf256.mul_bitmatrix(a))


@pytest.mark.parametrize("n", [1, 3, 6, 16])
def test_gf_mat_inv_batch_equal(n, rng):
    cand = rng.integers(0, 256, size=(40, n, n), dtype=np.uint8)
    if n > 1:
        cand[:, 0, 0] = 0                # every inversion needs a row swap
    mats = []
    for m in cand:
        try:
            jgf256.gf_mat_inv(m)
        except np.linalg.LinAlgError:
            continue
        mats.append(m)
    mats = np.stack(mats[:12])
    got = gf256.gf_mat_inv_batch(mats)
    assert np.array_equal(got, jgf256.gf_mat_inv_batch(mats))
    for j in range(len(mats)):
        assert np.array_equal(got[j], jgf256.gf_mat_inv(mats[j]))


def test_gf_matmul_np_equal(rng):
    coeff = rng.integers(0, 256, size=(3, 5), dtype=np.uint8)
    coeff[0, :2] = (0, 1)
    data = rng.integers(0, 256, size=(5, 99), dtype=np.uint8)
    assert np.array_equal(gf256.gf_matmul_np(coeff, data),
                          jgf256.gf_matmul_np(coeff, data))


@pytest.mark.parametrize("nbytes", [1, 31, 32, 33, 4099])
def test_pack_unpack_bit_exact(nbytes, rng):
    data = rng.integers(0, 256, size=(3, nbytes), dtype=np.uint8)
    planes = bitplane.pack(torch.from_numpy(data))
    assert planes.dtype == torch.int32
    want = jbitplane.pack_np(data)
    assert np.array_equal(planes.numpy().view(np.uint32), want)
    assert np.array_equal(bitplane.pack_np(data), want)
    back = bitplane.unpack(planes, nbytes)
    assert np.array_equal(back.numpy(), jbitplane.unpack_np(want, nbytes))
    assert np.array_equal(back.numpy(), data)
    assert np.array_equal(bitplane.unpack_np(want, nbytes), data)


def test_coeff_to_masks_equal(rng):
    coeff = rng.integers(0, 256, size=(3, 6), dtype=np.uint8)
    coeff[0, :2] = (0, 1)
    want = jbitplane.coeff_to_masks_np(coeff)
    assert np.array_equal(bitplane.coeff_to_masks_np(coeff), want)
    masks = bitplane.coeff_to_masks(coeff, "cpu")
    assert masks.dtype == torch.int32 and masks.is_contiguous()
    assert np.array_equal(masks.numpy().view(np.uint32), want)


@pytest.mark.parametrize("n,k", [(6, 3), (7, 4)])
def test_rs_code_equal(n, k, rng):
    code, ref = rs.RSCode(n, k), jrs.RSCode(n, k)
    assert np.array_equal(code.generator, ref.generator)
    data = rng.integers(0, 256, size=(k, 257), dtype=np.uint8)
    cw = code.encode(torch.from_numpy(data))
    want = ref.encode(data)
    assert cw.dtype == torch.uint8 and np.array_equal(cw.numpy(), want)

    survivors = [x for x in range(n) if x != 0]
    helpers = tuple(survivors[:k])
    assert np.array_equal(code.repair_coeffs((0,), helpers),
                          ref.repair_coeffs((0,), helpers))
    failed = np.arange(n)
    helper_rows = np.stack([
        [x for x in range(n) if x != f][:k] for f in failed])
    assert np.array_equal(code.repair_coeffs_batch(failed, helper_rows),
                          ref.repair_coeffs_batch(failed, helper_rows))

    lost = code.reconstruct([0], list(helpers),
                            torch.from_numpy(want[list(helpers)]))
    assert np.array_equal(lost.numpy()[0], want[0])

    present = {i: want[i] for i in range(n) if i not in (0, k - 1)}
    got = code.decode_all({i: torch.from_numpy(b) for i, b in present.items()})
    assert np.array_equal(got.numpy(), ref.decode_all(present))
    assert np.array_equal(got.numpy(), data)


def test_rs_encode_takes_tensors_only(rng):
    data = rng.integers(0, 256, size=(3, 8), dtype=np.uint8)
    with pytest.raises(TypeError):
        rs.RSCode(6, 3).encode(data)
    with pytest.raises(ValueError):
        rs.RSCode(6, 3).encode(torch.from_numpy(data[:2]))


def test_stripe_placement_equal():
    code, ref = rs.RSCode(6, 3), jrs.RSCode(6, 3)
    got = stripe.place_stripes(5, code, 9)
    want = jstripe.place_stripes(5, ref, 9)
    assert [s.node_ids for s in got] == [s.node_ids for s in want]
    for g, w in zip(got, want):
        assert np.array_equal(g.block_map(11), w.block_map(11))
        assert np.array_equal(g.perm(11), w.perm(11))
