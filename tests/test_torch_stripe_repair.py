"""The batched stripe reconstruct held against repro on the CPU.

`ops.rs_reconstruct_stripes` (the wrapper `gf256_reconstruct_stripes`,
on CPU tensors its plain version) repairs a batch of stripes in one call,
reading each stripe's helper rows and writing its lost rows at their byte
offsets in one byte space (a list of buffers taken as their
concatenation), as the checkpoint load lays them out: the blob and the
spare rows beside it. The batches are `chip_smoke.small_stripe_batches`,
phase 2's on the card. Here they are held against the JAX package's
`ops.rs_reconstruct`, run stripe by stripe (the Pallas kernel in
interpret mode) for batches of up to 4 stripes, and against the JAX
package's numpy oracle `gf256_matmul_np` for 37: patterns with one and
two lost rows mixed, rows of 4096 and 4099 bytes, helper rows 0, 1 and 3
bytes past 16-byte alignment, destination rows interleaved with rows that
must stay as they were. Bad tables raise. The CUDA kernel is held against
the same plain version by emulation on the CPU
(`tests/test_torch_stripe_repair_emulated.py`) and on the card
(`chip_smoke.py` phase 2).
"""
import ctypes
import sys
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.gf256_matmul import (gf256_reconstruct_stripes,
                                              row_addresses, stripe_base,
                                              stripe_tables)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import small_stripe_batches  # noqa: E402


def batches(stripes: int, n: int, seed: int = 19) -> list:
    """The (plan, bufs) of phase 2's small batches of `stripes` stripes
    and `n`-byte rows, helper rows aligned, 3 bytes past alignment, and 0,
    1 and 3 past it mixed."""
    return [(plan, bufs) for _, plan, bufs, _ in
            small_stripe_batches("cpu", (stripes,), (n,), seed)]


def expected(plan, bufs, n, oracle) -> np.ndarray:
    """The byte space after the batch, stripe by stripe through
    `oracle(coeff, (k, n) helpers)`."""
    want = torch.cat(bufs).numpy().copy()
    for s, p in enumerate(plan.patterns):
        helpers = np.stack([want[o: o + n] for o in plan.src_off[s]])
        rows = np.asarray(oracle(plan.coeffs[p], helpers))
        for o in range(plan.coeffs[p].shape[0]):
            want[plan.dst_off[s, o]: plan.dst_off[s, o] + n] = rows[o]
    return want


def run(plan, bufs, n) -> np.ndarray:
    out = [t.clone() for t in bufs]
    got = ops.rs_reconstruct_stripes(plan.coeffs, plan.patterns, out,
                                     plan.src_off, plan.dst_off, n)
    assert len(got) == len(out) and all(a is b for a, b in zip(got, out))
    return torch.cat(out).numpy()


def pallas(coeff, helpers):
    return jops.rs_reconstruct(coeff, jnp.asarray(helpers))


@pytest.mark.parametrize("stripes", [1, 4])
@pytest.mark.parametrize("n", [4096, 4099])
def test_small_batches_equal_pallas_stripe_by_stripe(stripes, n):
    for plan, bufs in batches(stripes, n):
        assert np.array_equal(run(plan, bufs, n),
                              expected(plan, bufs, n, pallas))


@pytest.mark.parametrize("n", [4096, 4099])
def test_37_stripes_equal_the_numpy_oracle(n):
    seen = set()
    for plan, bufs in batches(37, n):
        seen |= set(plan.patterns.tolist())
        want = expected(plan, bufs, n, jref.gf256_matmul_np)
        assert np.array_equal(run(plan, bufs, n), want)
        # the untouched rows are the input's
        was = torch.cat(bufs).numpy()
        live = np.zeros(was.size, dtype=bool)
        for off in plan.dst_off[plan.dst_off >= 0]:
            live[off: off + n] = True
        assert not np.array_equal(want[live], was[live])
        assert np.array_equal(want[~live], was[~live])
    assert seen == set(range(len(plan.coeffs)))


def test_matches_the_per_stripe_entry_point():
    """The batch equals `ops.rs_reconstruct` called once a stripe."""
    n = 999

    def per_stripe(coeff, helpers):
        return ops.rs_reconstruct(coeff, torch.from_numpy(helpers)).numpy()

    for plan, bufs in batches(6, n, seed=7):
        assert np.array_equal(run(plan, bufs, n),
                              expected(plan, bufs, n, per_stripe))


def test_empty_batch_is_a_no_op():
    plan, bufs = batches(2, 64)[0]
    out = [t.clone() for t in bufs]
    ops.rs_reconstruct_stripes([], np.zeros(0, np.int64), out,
                               np.zeros((0, 4), np.int64),
                               np.zeros((0, 2), np.int64), 64)
    assert all(torch.equal(a, b) for a, b in zip(out, bufs))
    ops.rs_reconstruct_stripes(plan.coeffs, np.zeros(0, np.int64), out,
                               np.zeros((0, 4), np.int64),
                               np.zeros((0, 2), np.int64), 64)
    assert all(torch.equal(a, b) for a, b in zip(out, bufs))


def _bad(plan, buffers, **change):
    args = dict(coeffs=plan.coeffs, patterns=plan.patterns.copy(),
                bufs=[t.clone() for t in buffers], src_off=plan.src_off.copy(),
                dst_off=plan.dst_off.copy())
    for key, fn in change.items():
        args[key] = fn(args[key])
    return args


def _set(index, value):
    def fn(a):
        a[index] = value
        return a
    return fn


BAD = {
    "source row past the end": (dict(src_off=_set((0, 1), 10 ** 9)), ValueError),
    "negative source row": (dict(src_off=_set((1, 0), -1)), ValueError),
    "destination row past the end": (dict(dst_off=_set((0, 0), 10 ** 9)),
                                     ValueError),
    "destination slot past f not -1": (dict(dst_off=_set((0, 1), 0)),
                                       ValueError),
    "overlapping destination rows": (dict(dst_off=lambda a: _set(
        (1, 0), a[0, 0] + 50)(a)), ValueError),
    "pattern out of range": (dict(patterns=_set(1, 4)), ValueError),
    "negative pattern": (dict(patterns=_set(0, -1)), ValueError),
    "f above the destination slots": (dict(dst_off=lambda a: a[:, :1]),
                                      ValueError),
    "coefficients not uint8": (dict(coeffs=lambda c: [x.astype(np.int32)
                                                      for x in c]), TypeError),
    "coefficients of another k": (dict(coeffs=lambda c: [x[:, :3] for x in c]),
                                  ValueError),
    "int32 buffer": (dict(bufs=lambda b: [b[0][:5120].view(torch.int32),
                                          b[1]]), TypeError),
    "2-D buffer": (dict(bufs=lambda b: [b[0][:-7].view(-1, 1), b[1]]),
                   ValueError),
    "tables of other lengths": (dict(patterns=lambda a: a[:-1]), ValueError),
    "no buffers": (dict(bufs=lambda b: []), ValueError),
    "a row across two buffers": (dict(src_off=lambda a: _set(
        (0, 0), 5127 - 50)(a)), ValueError),
    "a destination row on a source row": (dict(dst_off=lambda a: _set(
        (2, 0), 0)(a)), ValueError),
}


@pytest.mark.parametrize("name", list(BAD))
def test_bad_tables_raise(name):
    plan, bufs = batches(5, 100)[0]
    assert bufs[0].numel() == 5127             # the blob "a row across" ends
    change, error = BAD[name]
    args = _bad(plan, bufs, **change)
    with pytest.raises(error):
        gf256_reconstruct_stripes(n=100, **args)
    if name == "a destination row on a source row":
        with pytest.raises(error, match="overlaps a source row"):
            gf256_reconstruct_stripes(n=100, **args)


def test_src_and_dst_may_not_overlap():
    """Rows are told apart by where they lie: two views of one tensor as
    the byte space, a destination row in the second on a source row of
    the first, raise."""
    plan, _ = batches(2, 32)[0]
    buf = torch.zeros(10 ** 4, dtype=torch.uint8)
    src_off = plan.src_off % 4000
    dst_off = np.where(plan.dst_off >= 0, 5000 + 64 * np.arange(4).reshape(
        2, 2), -1)
    with pytest.raises(ValueError, match="overlaps a source row"):
        gf256_reconstruct_stripes(plan.coeffs, plan.patterns,
                                  [buf[:5000], buf[int(src_off[0, 0]):]],
                                  src_off, dst_off, 32)
    gf256_reconstruct_stripes(plan.coeffs, plan.patterns,
                              [buf[:5000], buf[5000:]], src_off, dst_off, 32)


def test_cpu_calls_never_launch_or_build(monkeypatch):
    def no_build():
        raise AssertionError("a CPU call tried to build the CUDA kernels")

    monkeypatch.setattr(build, "load_library", no_build)
    monkeypatch.setattr(gf256_reconstruct_stripes, "launches", 0)
    for plan, bufs in batches(3, 77):
        run(plan, bufs, 77)
    assert gf256_reconstruct_stripes.launches == 0


def test_tables_and_tiles():
    """The launch's tables: each pattern's column words, and a record a
    stripe of its rows' byte offsets from the lowest buffer's address
    (the launch itself sizes the blocks a stripe from the row length
    alone: the kernel's threads stride over the row, whatever its
    alignment)."""
    coeffs = [c for c in batches(2, 16)[0][0].coeffs[:2]]
    patterns = np.array([1, 0])
    bufs = [torch.zeros(200, dtype=torch.uint8),
            torch.zeros(8200, dtype=torch.uint8)]
    src_off = np.array([[0, 16, 32, 48], [64, 80, 96, 200]])
    dst_off = np.array([[216, 4296], [8216, -1]])
    a, b = (t.data_ptr() for t in bufs)
    src_addr = row_addresses(bufs, src_off, 16)
    dst_addr = row_addresses(bufs, dst_off, 16)
    assert src_addr.tolist() == [[a, a + 16, a + 32, a + 48],
                                 [a + 64, a + 80, a + 96, b]]
    assert dst_addr.tolist() == [[b + 16, b + 4096], [b + 8016, -1]]
    base = stripe_base(bufs)
    assert base == min(a, b)
    cols, rec = stripe_tables(coeffs, patterns, src_addr, dst_addr, base)
    assert cols.shape == (2, 2, 4, 8) and cols.dtype == np.uint32
    assert not cols[0, 1].any() and cols[1, 1].any()
    assert rec.dtype == np.int64
    assert rec.tolist() == [[*(src_addr[0] - base), *(dst_addr[0] - base), 1],
                            [*(src_addr[1] - base), dst_addr[1, 0] - base,
                             -1, 0]]
    with pytest.raises(ValueError, match="out of range"):
        row_addresses(bufs, np.array([190]), 16)      # across the two
    src = (build.CSRC / "gf256_matmul.cu").read_text()
    assert "u0 += step" in src and "const long long tiles = " in src


def test_build_binds_the_stripe_launcher():
    src = (build.CSRC / "gf256_matmul.cu").read_text()
    assert 'extern "C" int gf256_reconstruct_stripes_launch' in src

    class FakeLib:
        def __getattr__(self, name):
            fn = types.SimpleNamespace()
            setattr(self, name, fn)
            return fn

    lib = FakeLib()
    build._bind(lib)
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # (cols, rec, base, stripes, k, fmax, n, stream)
    assert lib.gf256_reconstruct_stripes_launch.argtypes == [
        p, p, p, i64, i32, i32, i64, p]
    assert lib.gf256_reconstruct_stripes_launch.restype is i32


def test_plain_version_is_the_cpu_route(monkeypatch):
    calls = []
    plain = ref.gf256_reconstruct_stripes_ref

    def counted(*args):
        calls.append(len(args[1]))
        return plain(*args)

    monkeypatch.setattr(ref, "gf256_reconstruct_stripes_ref", counted)
    plan, bufs = batches(5, 50)[0]
    run(plan, bufs, 50)
    assert calls == [5]
