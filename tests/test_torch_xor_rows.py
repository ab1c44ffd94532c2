"""The XOR fold over rows that lie where they are, held against repro.

`xor_reduce_words` takes the Pallas contract, a (k, W) int32 tensor, or a
sequence of k (W,) int32 rows; `ops.xor_reduce` the same two forms on
uint8 bytes. The CUDA kernel reads each row through its own pointer, at
most `KMAX` a launch (`chain_plan` chains more). Here, on the CPU: both
forms against the Pallas kernel in interpret mode and against the JAX
`ops`, the input checks, no build and no launch, the chaining plan
composed with the plain XOR, and the serial executor handing the fold its
buffers themselves. The kernel is held against the same plain version on
the card by `chip_smoke.py`.
"""
import ctypes
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bandwidth as jbw
from repro.core import executor as jexecutor
from repro.core import simulator as jsim
from repro.core import topology as jtopo
from repro.ec.rs import RSCode as JRSCode
from repro.kernels import ops as jops
from repro.kernels.xor_reduce import xor_reduce_words as j_xor_reduce_words
from repro_torch.core import bandwidth, executor, simulator
from repro_torch.ec.rs import RSCode
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.xor_reduce import (KMAX, as_rows, chain_plan,
                                            fold_rows, xor_reduce_words)


def _rows_at(host: np.ndarray, offsets, dtype) -> list[torch.Tensor]:
    """Row i of `host` as a view `offsets[i % len(offsets)]` elements into
    a larger tensor of its own."""
    rows = []
    for i, row in enumerate(host):
        off = offsets[i % len(offsets)]
        big = torch.zeros(off + row.size + 5, dtype=dtype)
        big[off:off + row.size] = torch.from_numpy(row)
        rows.append(big[off:off + row.size])
    return rows


# ------------------------------------------------------ both forms, Pallas
@pytest.mark.parametrize("k", [1, 2, 3, 5, 17])
@pytest.mark.parametrize("w", [1, 1025])
@pytest.mark.parametrize("offsets", [(1, 3), (3, 0, 1)])
def test_rows_and_dense_forms_match_pallas(k, w, offsets, rng):
    words_np = rng.integers(0, 1 << 32, size=(k, w), dtype=np.uint32)
    want = np.asarray(j_xor_reduce_words(jnp.asarray(words_np), interpret=True))
    as_i32 = words_np.view(np.int32)
    dense = xor_reduce_words(torch.from_numpy(as_i32))
    rows = _rows_at(as_i32, offsets, torch.int32)
    assert all(r.storage_offset() in offsets for r in rows)
    by_rows = xor_reduce_words(rows)
    by_tuple = xor_reduce_words(tuple(rows))
    # the dense form as a view at a word offset into a larger tensor
    big = torch.zeros(offsets[0] + k * w, dtype=torch.int32)
    big[offsets[0]:] = torch.from_numpy(as_i32).reshape(-1)
    dense_view = xor_reduce_words(big[offsets[0]:].view(k, w))
    for got in (dense, by_rows, by_tuple, dense_view):
        assert got.dtype == torch.int32 and got.shape == (w,)
        assert np.array_equal(got.numpy().view(np.uint32), want)
    # the rows are left as they were
    assert np.array_equal(torch.stack(rows).numpy(), as_i32)


def test_dense_rows_may_lie_apart(rng):
    """A (k, W) tensor whose rows are contiguous but not adjacent."""
    words = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, size=(3, 10),
                                          dtype=np.int32))
    apart = words[:, :7]
    assert not apart.is_contiguous() and apart.stride() == (10, 1)
    assert torch.equal(xor_reduce_words(apart),
                       apart[0] ^ apart[1] ^ apart[2])


# ---------------------------------------------------------- the byte form
@pytest.mark.parametrize("k", [2, 5, 17])
@pytest.mark.parametrize("nbytes", [1, 4099, 4096])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_ops_xor_reduce_rows_match_reference(k, nbytes, use_kernel, rng):
    chunks = rng.integers(0, 256, size=(k, nbytes), dtype=np.uint8)
    want = np.bitwise_xor.reduce(chunks, axis=0)
    theirs = np.asarray(jops.xor_reduce(jnp.asarray(chunks), use_kernel=False))
    assert np.array_equal(theirs, want)
    rows = _rows_at(chunks, (0, 1, 3), torch.uint8)
    for form in (rows, tuple(rows), torch.from_numpy(chunks)):
        got = ops.xor_reduce(form, use_kernel=use_kernel)
        assert got.dtype == torch.uint8 and got.shape == (nbytes,)
        assert got.device.type == "cpu"
        assert np.array_equal(got.numpy(), want)
    assert np.array_equal(fold_rows(rows).numpy(), want)


def test_ops_xor_reduce_one_row_is_that_row(rng):
    row = torch.from_numpy(rng.integers(0, 256, size=33, dtype=np.uint8))
    assert ops.xor_reduce([row]) is row
    assert ops.xor_reduce(row[None, :]).data_ptr() == row.data_ptr()


# ------------------------------------------------------------ bad inputs
def _w(n, dtype=torch.int32):
    return torch.zeros(n, dtype=dtype)


BAD_WORDS = [
    ([], ValueError),                                   # no rows
    ((), ValueError),
    (torch.zeros((0, 4), dtype=torch.int32), ValueError),
    ([_w(8)[::2], _w(4)], ValueError),                   # strided row
    (torch.zeros((2, 8), dtype=torch.int32)[:, ::2], ValueError),
    ([_w(4), _w(5)], ValueError),                        # mixed lengths
    ([_w(4), _w(4, torch.int64)], ValueError),           # mixed dtypes
    ([_w(4), torch.zeros(4, dtype=torch.int32, device="meta")], ValueError),
    ([torch.zeros((2, 4), dtype=torch.int32)], ValueError),  # a 2-D row
    ([torch.tensor(7, dtype=torch.int32)], ValueError),      # a 0-D row
    (torch.zeros((2, 3, 4), dtype=torch.int32), ValueError),
    (torch.zeros((2, 4), dtype=torch.uint8), ValueError),    # wrong dtype
    ([np.zeros(4, dtype=np.int32)], TypeError),          # not a tensor
    (np.zeros((2, 4), dtype=np.int32), TypeError),
    ([torch.zeros(4, dtype=torch.int32, device="meta")] * 2, ValueError),
]


@pytest.mark.parametrize("words,error", BAD_WORDS)
def test_xor_reduce_words_rejects_bad_inputs(words, error):
    with pytest.raises(error):
        xor_reduce_words(words)


BAD_CHUNKS = [
    ([], ValueError),
    ([_w(8, torch.uint8)[::2], _w(4, torch.uint8)], ValueError),
    (torch.zeros((2, 8), dtype=torch.uint8)[:, ::2], ValueError),
    ([_w(4, torch.uint8), _w(3, torch.uint8)], ValueError),
    ([_w(4, torch.uint8), _w(4)], ValueError),
    (torch.zeros((2, 4), dtype=torch.int32), ValueError),
    (np.zeros((2, 4), dtype=np.uint8), TypeError),
]


@pytest.mark.parametrize("chunks,error", BAD_CHUNKS)
@pytest.mark.parametrize("use_kernel", [True, False])
def test_ops_xor_reduce_rejects_bad_inputs(chunks, error, use_kernel):
    with pytest.raises(error):
        ops.xor_reduce(chunks, use_kernel=use_kernel)


def test_strided_rows_are_not_copied_silently(monkeypatch):
    def no_copy(self, *args, **kwargs):
        raise AssertionError("a wrapper copied a strided row")

    monkeypatch.setattr(torch.Tensor, "contiguous", no_copy)
    strided = torch.zeros((2, 8), dtype=torch.uint8)[:, ::2]
    with pytest.raises(ValueError, match="strided"):
        ops.xor_reduce(strided)
    with pytest.raises(ValueError, match="strided"):
        xor_reduce_words([_w(8)[::2], _w(4)])


def test_as_rows_makes_no_copy(rng):
    dense = torch.from_numpy(rng.integers(0, 256, size=(3, 7), dtype=np.uint8))
    rows = as_rows(dense, torch.uint8)
    assert [r.data_ptr() for r in rows] == [dense[i].data_ptr()
                                            for i in range(3)]
    seq = list(dense.unbind(0))
    assert all(a is b for a, b in zip(as_rows(seq, torch.uint8), seq))


# --------------------------------------------------- CPU: no build, launch
def test_cpu_calls_never_launch_or_build(rng, monkeypatch):
    def no_build():
        raise AssertionError("a CPU call tried to build the CUDA kernels")

    monkeypatch.setattr(build, "load_library", no_build)
    monkeypatch.setattr(xor_reduce_words, "launches", 0)
    words = torch.from_numpy(rng.integers(0, 9, size=(KMAX + 3, 5),
                                          dtype=np.int32))
    chunks = torch.from_numpy(rng.integers(0, 256, size=(3, 99),
                                           dtype=np.uint8))
    xor_reduce_words(words)
    xor_reduce_words(list(words))
    fold_rows(list(chunks))
    ops.xor_reduce(list(chunks))
    ops.xor_reduce(chunks)
    assert xor_reduce_words.launches == 0


# --------------------------------------------------------- the chain plan
@pytest.mark.parametrize("k", [1, 2, 15, 16, 17, 30, 31, 32, 33, 46, 47, 100])
def test_chain_plan_covers_every_row_once(k, rng):
    plan = chain_plan(k)
    assert all(2 <= len(step) <= KMAX for step in plan[1:])
    assert len(plan[0]) == min(k, KMAX) and -1 not in plan[0]
    assert all(step[0] == -1 and -1 not in step[1:] for step in plan[1:])
    flat = [i for step in plan for i in step if i >= 0]
    assert sorted(flat) == list(range(k))
    # as few launches as KMAX rows a launch allow
    assert len(plan) == 1 + max(0, -(-(k - KMAX) // (KMAX - 1)))
    # composed with the plain XOR, the chain is the fold of all k rows
    rows = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, size=(k, 9),
                                         dtype=np.int32))
    out = None
    for step in plan:
        out = ref.xor_reduce_ref([out if i < 0 else rows[i] for i in step])
    assert torch.equal(out, ref.xor_reduce_ref(rows))


@pytest.mark.parametrize("k", [0, -1])
def test_chain_plan_rejects_bad_arguments(k):
    with pytest.raises(ValueError):
        chain_plan(k)


def test_kmax_is_the_kernels_row_limit():
    src = (build.CSRC / "xor_reduce.cu").read_text()
    match = re.search(r"constexpr int kMaxRows = (\d+);", src)
    assert match and int(match.group(1)) == KMAX


# ------------------------------------------------------ the C entry point
def test_build_binds_the_row_launcher():
    src = (build.CSRC / "xor_reduce.cu").read_text()
    assert 'extern "C" int xor_reduce_rows_launch' in src
    # the old dense-only bodies went with the redesign
    for gone in ("xor_reduce_words_vec4", "xor_reduce_words_scalar",
                 "xor_reduce_words_launch"):
        assert gone not in src

    class FakeLib:
        def __getattr__(self, name):
            fn = types.SimpleNamespace()
            setattr(self, name, fn)
            return fn

    lib = FakeLib()
    build._bind(lib)
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # (row pointers, k, out, nbytes, stream)
    assert lib.xor_reduce_rows_launch.argtypes == [ctypes.POINTER(p), i32, p,
                                                   i64, p]
    assert lib.xor_reduce_rows_launch.restype is i32
    assert "xor_reduce_words_launch" not in vars(lib)
    # a host array of row pointers passes as the first argument
    ctypes.POINTER(p).from_param((p * 3)(1, 2, 3))


# ------------------------------------------- the serial executor's fold
def _scenario(bw_mod, sim_mod, rs):
    _, bw = jtopo.aliyun_matrix()
    bwp = bw_mod.BandwidthProcess(base=bw, change_interval=2.0, mode="markov",
                                  sigma=1.0, rho=0.9, seed=15)
    return sim_mod.Scenario(num_nodes=6, code=rs(6, 3), failed=(0,), bw=bwp,
                            ingress=bw_mod.IngressModel(seed=15, duplex=0.5),
                            chunk_mb=128)


@pytest.mark.parametrize("scheme", ["traditional", "ppr", "bmf"])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_serial_executor_folds_its_buffers_in_place(scheme, use_kernel,
                                                     monkeypatch):
    """`execute_plan` hands `ops.xor_reduce` the held buffer and the
    arriving one themselves: two 1-D rows whose memory is that of earlier
    premultiplies or folds, never a stacked copy."""
    real_matmul, real_xor = ops.gf256_matmul, ops.xor_reduce
    made, calls = set(), []

    def matmul_spy(*args, **kwargs):
        out = real_matmul(*args, **kwargs)
        made.add(out.data_ptr())
        return out

    def xor_spy(chunks, **kwargs):
        calls.append(chunks)
        assert isinstance(chunks, tuple) and len(chunks) == 2
        assert all(c.dim() == 1 for c in chunks)
        assert all(c.data_ptr() in made for c in chunks)
        out = real_xor(chunks, **kwargs)
        made.add(out.data_ptr())
        return out

    monkeypatch.setattr(ops, "gf256_matmul", matmul_spy)
    monkeypatch.setattr(ops, "xor_reduce", xor_spy)
    plan = simulator.RepairSimulator(
        _scenario(bandwidth, simulator, RSCode)).run(scheme).plan
    jplan = jsim.RepairSimulator(_scenario(jbw, jsim, JRSCode)).run(scheme).plan
    data = np.random.default_rng(7).integers(0, 256, size=(3, 4099),
                                             dtype=np.uint8)
    want_cw = JRSCode(6, 3).encode(data)
    code = RSCode(6, 3)
    got = executor.execute_plan(plan, code, code.encode(torch.from_numpy(data)),
                                use_kernel=use_kernel, device="cpu")
    want = jexecutor.execute_plan(jplan, JRSCode(6, 3), want_cw,
                                  use_kernel=use_kernel)
    helpers = sum(len(job.helpers) for job in plan.jobs)
    assert len(calls) == helpers - len(plan.jobs)
    assert got.verified is True and want.verified is True
    assert got.bytes_moved == want.bytes_moved
    for job_id, block in got.reconstructed.items():
        assert np.array_equal(block.numpy(), want.reconstructed[job_id])
