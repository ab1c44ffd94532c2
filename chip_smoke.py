"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py [--json PATH]

Phases (any failure is an uncaught exception and a non-zero exit):

0. the card's name and power limit (`nvidia-smi`), the torch version;
   raises when no CUDA device is visible;
1. build the CUDA kernels from `src/repro_torch/kernels/csrc` (nvcc, sm_90a);
2. hold each of the six kernels against its plain PyTorch version on the
   card, bit-exact, at the CPU-test shapes and the main paths' shapes, and
   time both beside the least time the card could take for the same work
   and, where one exists, one PyTorch call computing the same function
   (`library_ms`): a kernel's `ms` is its own device time from
   torch.profiler (mean of 20 launches), `ms_events` and `ms_single` the
   wrapper's call by CUDA events (20 back to back; the median of 20 single
   calls), the plain and library times 20 calls back to back; the
   byte-domain GF(256) kernels also at misaligned row offsets and against
   the plane route (`bitplane.pack`, plane kernel, `unpack`);
   `xor_reduce_words` in both its forms, a (k, W) tensor and k separate
   rows, at k up to 33 (chained launches), rows at word offsets 0, 1 and
   3, and on ragged byte rows through `ops.xor_reduce`; at 128 MiB rows
   (k = 2 and 3, both forms); the two-row folds (`xor_reduce_words`,
   the grouped fold at G=4 K=2) and their `torch.bitwise_xor` yardstick
   in turns, each by the profiler (the means of two windows: fold,
   yardstick, yardstick, fold) and the yardstick by events too;
3. the serial repair path at full size: the repair-demo scenario (RS(6,3)
   on the Aliyun Table III matrix under markov churn, 128 MB chunks)
   planned and simulated for every single-failure scheme, a 128 MiB-per-
   block stripe encoded on the card, the BMF plan's repair executed
   through the kernels and verified byte-exact; the kernels' launch
   counters (and calls of `bitplane.pack` / `unpack`, which must be 0)
   are set to 0 just before and read just after; then one more repair is
   traced with torch.profiler (device time by kernel, the device's idle
   share; no bit-slicing op may show, nor a `torch.stack` copy
   (`CatArray`) before a fold);
4. small-input checks: every scheme's plan executed on the card equals the
   CPU plain path byte for byte and verifies, serially and as one mixed
   batch (all 8 schemes, failures (0,) and (0, 4), 4099 bytes);
5. the batched data plane at full size: B=4 stripes of 3 x 128 MiB, one
   plan each (traditional, PPR, BMF, PPT), repaired by one
   `execute_plans_batch` call on the card and verified; counters set to 0
   just before and read just after; wall time (first call, median of 5),
   peak device memory, and one torch.profiler trace; then the same at
   B=8 (the four schemes twice: HDFS's default of 8 EC reconstruction
   threads per DataNode);
6. the Monte-Carlo repair sweep (`repro_torch.sim.sweep.run_sweep`) at the
   sizes the JAX package's sweep benchmarks run: the paper's Table II
   suite (1024 two-failure RS(7,4) cases frozen to 64-epoch traces), the
   stress suite (512 single-failure RS(14,10) 1024 MB cases frozen to
   256-epoch traces) and a live suite (128 such cases of 256 MB chunks
   under markov churn, four schemes), each through `executor="device"`
   (the torch device
   stepper on the card) and `executor="vectorized"` (numpy on the host);
   a frozen suite is built once and replayed by every run, the live one
   is built anew for each run (its epochs are sampled inside the run).
   Fails if a case's rounds, relay hops or time (1e-6 rtol) differ
   between the two, if any batch ran on the host steppers, if the live
   suite never grew its epoch horizon, if `verify_bytes=16` verifies not
   every pair, or if the sweep's launches (counters set to 0 just before,
   read just after) are not one `gf256_scale_bytes` and one
   `xor_reduce_groups_words` per data-plane round; prints wall time and
   cases/s of both executors (median of 3, in turns), host syncs, horizon
   doublings, and one torch.profiler trace of each device sweep (device
   busy time, idle share, top kernels).

The second-to-last line is the kernels' JSON record, the last line
`{"ok": true, "device": {...}}`. `--json PATH` also writes every record.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.core import executor, topology  # noqa: E402
from repro_torch.core.bandwidth import BandwidthProcess, IngressModel  # noqa: E402
from repro_torch.core.engine import dataplane, device_stepper  # noqa: E402
from repro_torch.core.engine.arrays import compile_plan, decompile  # noqa: E402
from repro_torch.core.ppt import build_ppt_tree, ppt_round_plan  # noqa: E402
from repro_torch.core.simulator import (MULTI_SCHEMES, SINGLE_SCHEMES,  # noqa: E402
                                        RepairSimulator, Scenario)
from repro_torch.ec import bitplane, gf256  # noqa: E402
from repro_torch.ec.rs import RSCode  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.build import load_library  # noqa: E402
from repro_torch.kernels.gf256_matmul import (gf256_matmul_bytes,  # noqa: E402
                                              gf256_matmul_planes,
                                              gf256_scale_bytes,
                                              gf256_scale_planes)
from repro_torch.kernels.xor_reduce import (chain_plan,  # noqa: E402
                                            xor_reduce_groups_words,
                                            xor_reduce_words)
from repro_torch.sim.suite import (MonteCarloSuite, SampleSpace,  # noqa: E402
                                   TraceSuite)
from repro_torch.sim.sweep import run_sweep  # noqa: E402

MIB = 1 << 20
BLOCK_BYTES = 128 * MIB            # the paper's 128 MB chunk; HDFS block size
W_PLANES = BLOCK_BYTES // 32       # plane words per 128 MiB block
W_WORDS = BLOCK_BYTES // 4         # 32-bit words per 128 MiB block
REPS = 20
PROFILE_ATTEMPTS = 3
HEAD = 4 * MIB                     # bytes compared with the host's copy
BATCHES = (4, 8)                   # phase 5: stripes in one batched repair
BATCH_SCHEMES = ("traditional", "ppr", "bmf", "ppt")
SWEEP_REPEATS = 3                  # phase 6: timed runs of each executor
SWEEP_VERIFY = 16                  # phase 6: cases byte-verified per sweep
# phase 6's suites: the parameters of the JAX package's sweep benchmarks
# (benchmarks/bench_table2.py:23-32, bench_sweep.py:62-73), copied since
# the benchmarks import that package. The live suite is the stress suite
# unfrozen, at HDFS's common 256 MB block size and with the four
# single-failure schemes (BMF replans, so a horizon overflow rolls its
# splices back): its repairs outrun the first 64-epoch horizon, and 128
# cases keep every batch's epoch stack under the stepper's budget up to a
# 1024-epoch horizon.
SWEEP_SUITES = {
    "table2_trace": dict(cases=1024, code=(7, 4), chunk_mb=32.0,
                         pattern="double", base_seed=0, epochs=64,
                         schemes=("mppr", "random", "msrepair")),
    "stress_trace": dict(cases=512, code=(14, 10), chunk_mb=1024.0,
                         pattern="single", base_seed=17, epochs=256,
                         schemes=("traditional", "ppr")),
    "stress_live": dict(cases=128, code=(14, 10), chunk_mb=256.0,
                        pattern="single", base_seed=17, epochs=None,
                        schemes=("traditional", "ppr", "ppt", "bmf")),
}

KERNELS = {
    "gf256_matmul_planes": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/gf256_matmul.cu",
        replaces="src/repro/kernels/gf256_matmul.py:40"),
    "xor_reduce_words": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/xor_reduce.cu",
        replaces="src/repro/kernels/xor_reduce.py:26"),
    "gf256_scale_planes": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/gf256_matmul.cu",
        replaces="src/repro/kernels/gf256_matmul.py:74"),
    "xor_reduce_groups_words": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/xor_reduce.cu",
        replaces="src/repro/kernels/xor_reduce.py:54"),
    "gf256_matmul_bytes": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/gf256_matmul.cu",
        replaces="src/repro/kernels/gf256_matmul.py:40"),
    "gf256_scale_bytes": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/gf256_matmul.cu",
        replaces="src/repro/kernels/gf256_matmul.py:74"),
}
WRAPPERS = {"gf256_matmul_planes": gf256_matmul_planes,
            "xor_reduce_words": xor_reduce_words,
            "gf256_scale_planes": gf256_scale_planes,
            "xor_reduce_groups_words": xor_reduce_groups_words,
            "gf256_matmul_bytes": gf256_matmul_bytes,
            "gf256_scale_bytes": gf256_scale_bytes}


def _counted(fn):
    def wrapper(*args, **kwargs):
        wrapper.calls += 1
        return fn(*args, **kwargs)

    wrapper.calls = 0
    return wrapper


# calls of the bit-slicing around the plane kernels; no main path makes any
bitplane.pack = _counted(bitplane.pack)
bitplane.unpack = _counted(bitplane.unpack)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def peak_rates(name: str) -> dict:
    """Published peaks used for `bound_ms` (NVIDIA data sheets; the CUDA
    programming guide's throughput table for 32-bit logic ops)."""
    mem = 2.0e12 if "PCIe" in name else 3.35e12       # H100 PCIe / SXM HBM
    try:
        clock_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    except (subprocess.SubprocessError, ValueError, IndexError):
        clock_hz = 1.98e9
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # compute capability 9.0: 64 results per clock per SM for 32-bit
    # bitwise ops; a 3-input LOP3 does one AND and one XOR
    return dict(mem_bytes_per_s=mem, lop3_per_s=sms * 64 * clock_hz,
                sms=sms, sm_clock_hz=clock_hz)


def bound(nbytes: float, ops: float, peaks: dict) -> tuple[float, str]:
    t_bytes = nbytes / peaks["mem_bytes_per_s"] * 1e3
    t_ops = ops / peaks["lop3_per_s"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(fn, reps: int = REPS) -> float:
    """Device time of one call: `reps` calls enqueued back to back between
    two CUDA events, after a warm-up call, over `reps`. The host's work
    around each launch overlaps the device's work of the previous one."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_single(fn, reps: int = REPS) -> float:
    """Median over `reps` single calls, each between two CUDA events: the
    device time plus whatever the device waits for the host to launch."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_device_ms(fn, label: str, reps: int = REPS,
                     attempts: int = PROFILE_ATTEMPTS) -> tuple[float, int]:
    """Mean device time of the one kernel each call of `fn` launches (its
    name holds `label`), over `reps` calls, from torch.profiler's CUDA
    activity records: the kernel alone, whatever the host does around it.
    Returns it with the number of profiled windows it took.

    The profiler now and then loses an activity record (one kernel of 20
    missing, seen on an H100). A window that shows fewer kernels than calls
    is profiled again, up to `attempts` windows; only a window with exactly
    one kernel per call is timed. More kernels than calls is a fault of the
    wrapper or the label and raises at once."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fn()
    torch.cuda.synchronize()
    seen = []
    for attempt in range(1, attempts + 1):
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        times = [ev.time_range.elapsed_us() / 1e3 for ev in prof.events()
                 if ev.device_type == torch.autograd.DeviceType.CUDA
                 and label in ev.name]
        if len(times) > reps:
            raise AssertionError(
                f"{len(times)} '{label}' kernels in {reps} calls")
        if len(times) == reps:
            return sum(times) / reps, attempt
        seen.append(len(times))
    raise AssertionError(f"'{label}' kernels in {attempts} windows of {reps} "
                         f"calls: {seen}")


def kernel_times(fn, label: str) -> dict:
    """A kernel wrapper's times: `ms` the kernel alone (profiler, with the
    windows it took in `profile_windows`), `ms_events` a call back to back
    and `ms_single` a single call (CUDA events, the wrapper's host work
    included where the card waits on it)."""
    ms, windows = kernel_device_ms(fn, label)
    return dict(ms=ms, profile_windows=windows, ms_events=cuda_ms(fn),
                ms_single=cuda_ms_single(fn))


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.long() - b.long()).abs().max())


def random_words(rng: np.random.Generator, shape) -> torch.Tensor:
    host = rng.integers(-(1 << 31), 1 << 31, size=shape, dtype=np.int32)
    return torch.from_numpy(host).cuda()


def device_bytes(seed: int, shape) -> torch.Tensor:
    """Random uint8 bytes made on the card from a seeded generator (the
    full-size inputs: several GiB, too slow to draw on the host)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda",
                         generator=gen)


def device_words(seed: int, shape) -> torch.Tensor:
    shape = tuple(shape)
    return device_bytes(seed, shape[:-1] + (4 * shape[-1],)).view(torch.int32)


def table_gather_ms(coeffs: np.ndarray, data: torch.Tensor) -> tuple[float, torch.Tensor]:
    """The one-call yardstick of the byte-level premultiply: a `MUL_TABLE`
    gather, row i of `data` through table row `coeffs[i]` (the int32 index
    copy of the bytes is made before the clock starts). Never used by the
    port."""
    table = gf256.mul_table(data.device)
    rows = torch.from_numpy(coeffs.astype(np.int64)).cuda()[:, None]
    index = data.int()
    ms = cuda_ms(lambda: table[rows, index])
    return ms, table[rows, index]


def with_0_and_1(coeffs: np.ndarray) -> np.ndarray:
    flat = coeffs.reshape(-1)
    flat[0] = 1                        # coefficients 1 and 0 take part too
    if flat.size > 1:
        flat[1] = 0
    return coeffs


def check_gf256(rng, peaks, m, k, w, timed):
    coeff = with_0_and_1(rng.integers(0, 256, size=(m, k), dtype=np.uint8))
    masks = bitplane.coeff_to_masks(coeff, "cuda")
    planes = random_words(rng, (k, 8, w))
    got = gf256_matmul_planes(masks, planes)
    torch.cuda.synchronize()
    want = ref.gf256_matmul_planes_ref(masks, planes)
    torch.cuda.synchronize()
    rec = dict(kernel="gf256_matmul_planes", shape=f"m={m} k={k} W={w}",
               max_abs_err=max_abs_err(got, want))
    if rec["max_abs_err"] != 0:
        raise AssertionError(f"gf256_matmul_planes disagrees: {rec}")
    if timed:
        nbytes = 4 * 8 * w * (k + m) + masks.numel() * 4
        lop3 = 64 * m * k * w
        bms, by = bound(nbytes, lop3, peaks)
        rec.update(**kernel_times(lambda: gf256_matmul_planes(masks, planes),
                                  "gf256_matmul_planes"),
                   plain_ms=cuda_ms(
                       lambda: ref.gf256_matmul_planes_ref(masks, planes)),
                   bound_ms=bms, bound_by=by, library_ms=None,
                   bytes=nbytes, lop3_ops=lop3)
        if (m, k) == (1, 1):   # the premultiply: one table gather of 128 MiB
            data = device_bytes(11, (1, 32 * w))
            rec["library_ms"], _ = table_gather_ms(coeff[:, 0], data)
            del data
    return rec


def check_scale(rng, peaks, m, w, timed):
    coeffs = with_0_and_1(rng.integers(0, 256, size=m, dtype=np.uint8))
    masks = bitplane.coeff_to_masks(coeffs[:, None], "cuda")
    planes = device_words(int(rng.integers(1 << 30)), (m, 8, w))
    got = gf256_scale_planes(masks, planes)
    torch.cuda.synchronize()
    want = ref.gf256_scale_planes_ref(masks, planes)
    torch.cuda.synchronize()
    rec = dict(kernel="gf256_scale_planes", shape=f"M={m} W={w}",
               max_abs_err=max_abs_err(got, want))
    if rec["max_abs_err"] != 0:
        raise AssertionError(f"gf256_scale_planes disagrees: {rec}")
    del got, want
    if timed:
        nbytes = 2 * m * 32 * w + masks.numel() * 4
        lop3 = 64 * m * w
        bms, by = bound(nbytes, lop3, peaks)
        rec.update(**kernel_times(lambda: gf256_scale_planes(masks, planes),
                                  "gf256_scale_planes"),
                   plain_ms=cuda_ms(
                       lambda: ref.gf256_scale_planes_ref(masks, planes)),
                   bound_ms=bms, bound_by=by, bytes=nbytes, lop3_ops=lop3)
        del planes
        torch.cuda.empty_cache()
        # the byte-level entry point (pack, kernel, unpack) on M chunks of
        # 32 * W bytes, against the one-call table gather on the same bytes
        data = device_bytes(12, (m, 32 * w))
        rec["ops_gf256_scale_batch_ms"] = cuda_ms(
            lambda: ops.gf256_scale_batch(coeffs, data), reps=5)
        by_op = ops.gf256_scale_batch(coeffs, data)
        torch.cuda.empty_cache()
        rec["library_ms"], by_table = table_gather_ms(coeffs, data)
        if not torch.equal(by_op, by_table):
            raise AssertionError("ops.gf256_scale_batch != MUL_TABLE gather")
        del data, by_op, by_table
        torch.cuda.empty_cache()
    return rec


def device_rows(rng: np.random.Generator, rows: int, n: int,
                offset: int = 0) -> torch.Tensor:
    """(rows, n) uint8 on the card from the host generator; with `offset`,
    a contiguous view `offset` bytes into a larger allocation, so its rows
    start off 16-byte alignment."""
    host = rng.integers(0, 256, size=offset + rows * n, dtype=np.uint8)
    return torch.from_numpy(host).cuda()[offset:].view(rows, n)


def byte_kernel_record(rec, peaks, n, ins, outs, pairs, time_kernel,
                       time_plain) -> None:
    """Times and bounds of a byte-domain GF(256) kernel: `ins` input and
    `outs` output rows of n bytes, `pairs` (output, input) products. The
    bound counts each row read or written once (plus 32 bytes of column
    words a pair) and 8 LOP3 a pair per 4 bytes, the bit-matrix product
    the plane kernels count too; `design_ops` is the kernel's own count,
    15 ops per input and 4 bytes to expand the bit masks besides."""
    nbytes = n * (ins + outs) + 32 * pairs
    lop3 = 2 * pairs * n
    design_ops = (n // 4) * (15 * ins + 8 * pairs)
    bms, by = bound(nbytes, lop3, peaks)
    rec.update(**kernel_times(time_kernel, rec["kernel"]),
               plain_ms=cuda_ms(time_plain),
               bound_ms=bms, bound_by=by, bytes=nbytes, lop3_ops=lop3,
               design_ops=design_ops,
               design_ops_ms=design_ops / peaks["lop3_per_s"] * 1e3,
               library_ms=None)


def draw_coeffs(rng, shape, timed) -> np.ndarray:
    """Coefficients for a check: 0 and 1 among them, or for a timed check
    none (the plain versions skip 0 and copy for 1; the kernels do not)."""
    if timed:
        return rng.integers(2, 256, size=shape, dtype=np.uint8)
    return with_0_and_1(rng.integers(0, 256, size=shape, dtype=np.uint8))


def check_matmul_bytes(rng, peaks, m, k, n, timed, offset=0):
    coeff = draw_coeffs(rng, (m, k), timed)
    data = (device_bytes(15, (k, n)) if timed
            else device_rows(rng, k, n, offset))
    got = gf256_matmul_bytes(coeff, data)
    torch.cuda.synchronize()
    want = ref.gf256_matmul_bytes_ref(coeff, data)
    torch.cuda.synchronize()
    rec = dict(kernel="gf256_matmul_bytes",
               shape=f"m={m} k={k} n={n} offset={offset}",
               max_abs_err=max_abs_err(got, want))
    if rec["max_abs_err"] != 0:
        raise AssertionError(f"gf256_matmul_bytes disagrees: {rec}")
    del want
    if timed:
        byte_kernel_record(
            rec, peaks, n, k, m, m * k,
            lambda: gf256_matmul_bytes(coeff, data),
            lambda: ref.gf256_matmul_bytes_ref(coeff, data))
        if (m, k) == (1, 1):   # the premultiply: one table gather of 128 MiB
            rec["library_ms"], by_table = table_gather_ms(coeff[:, 0], data)
            if not torch.equal(got, by_table):
                raise AssertionError("gf256_matmul_bytes != MUL_TABLE gather")
    return rec


def check_scale_bytes(rng, peaks, m, n, timed, offset=0):
    coeffs = draw_coeffs(rng, m, timed)
    data = (device_bytes(16, (m, n)) if timed
            else device_rows(rng, m, n, offset))
    got = gf256_scale_bytes(coeffs, data)
    torch.cuda.synchronize()
    want = ref.gf256_scale_batch_ref(coeffs, data)
    torch.cuda.synchronize()
    rec = dict(kernel="gf256_scale_bytes",
               shape=f"M={m} n={n} offset={offset}",
               max_abs_err=max_abs_err(got, want))
    if rec["max_abs_err"] != 0:
        raise AssertionError(f"gf256_scale_bytes disagrees: {rec}")
    del want
    if timed:
        byte_kernel_record(
            rec, peaks, n, m, m, m,
            lambda: gf256_scale_bytes(coeffs, data),
            lambda: ref.gf256_scale_batch_ref(coeffs, data))
        torch.cuda.empty_cache()
        rec["library_ms"], by_table = table_gather_ms(coeffs, data)
        if not torch.equal(got, by_table):
            raise AssertionError("gf256_scale_bytes != MUL_TABLE gather")
    return rec


def check_plane_route(rng, m, k, n):
    """The two ports of each Pallas kernel agree: the byte kernels against
    `bitplane.pack`, the plane kernel and `unpack` on the same bytes."""
    coeff = with_0_and_1(rng.integers(0, 256, size=(m, k), dtype=np.uint8))
    data = device_rows(rng, k, n)
    planes = gf256_matmul_planes(bitplane.coeff_to_masks(coeff, "cuda"),
                                 bitplane.pack(data))
    by_matmul = max_abs_err(gf256_matmul_bytes(coeff, data),
                            bitplane.unpack(planes, n))
    coeffs = coeff[0].copy()
    masks = bitplane.coeff_to_masks(coeffs[:, None], "cuda")
    planes = gf256_scale_planes(masks, bitplane.pack(data))
    by_scale = max_abs_err(gf256_scale_bytes(coeffs, data),
                           bitplane.unpack(planes, n))
    torch.cuda.synchronize()
    recs = [dict(kernel="gf256_matmul_bytes", max_abs_err=by_matmul,
                 shape=f"plane route m={m} k={k} n={n}"),
            dict(kernel="gf256_scale_bytes", max_abs_err=by_scale,
                 shape=f"plane route M={k} n={n}")]
    for rec in recs:
        if rec["max_abs_err"] != 0:
            raise AssertionError(f"byte and plane routes disagree: {rec}")
    return recs


def check_groups(peaks, words, table, timed, label):
    """`xor_reduce_groups_words` on (T, W) words with a (G, Kmax) index
    table (or, with `table=None`, on (G, K, W) words) against its plain
    version; bound: each referenced row read once, each output written."""
    index = None if table is None else torch.from_numpy(table).cuda()
    got = xor_reduce_groups_words(words, table)
    torch.cuda.synchronize()
    want = ref.xor_reduce_groups_words_ref(words, index)
    torch.cuda.synchronize()
    rec = dict(kernel="xor_reduce_groups_words", shape=label,
               max_abs_err=max_abs_err(got, want))
    if rec["max_abs_err"] != 0:
        raise AssertionError(f"xor_reduce_groups_words disagrees: {rec}")
    if timed:
        w = words.shape[-1]
        if table is None:
            g, k = words.shape[0], words.shape[1]
            rows, entries = g * k, g * k
        else:
            g = table.shape[0]
            live = table[table >= 0]
            rows, entries = np.unique(live).size, live.size
        nbytes = 4 * w * (rows + g)
        bms, by = bound(nbytes, max(entries - g, 0) * w, peaks)
        rec.update(**kernel_times(
                       lambda: xor_reduce_groups_words(words, table),
                       "xor_reduce_groups"),
                   plain_ms=cuda_ms(
                       lambda: ref.xor_reduce_groups_words_ref(words, index)),
                   bound_ms=bms, bound_by=by, bytes=nbytes,
                   rows_read=rows, groups=g)
        if table is None and words.shape[1] == 2:   # the one-call yardstick
            add_xor_yardstick(rec, lambda: xor_reduce_groups_words(words),
                              "xor_reduce_groups", words[:, 0], words[:, 1])
        else:
            rec["library_ms"] = None
    return rec


def add_xor_yardstick(rec: dict, fn, label: str, a: torch.Tensor,
                      b: torch.Tensor) -> None:
    """Time a two-row fold `fn` (its kernel's name holds `label`) against
    its one-call yardstick `torch.bitwise_xor(a, b)`, never used by the
    port, into `rec`: each kernel alone (profiler) in two windows, in turns
    (fold, yardstick, yardstick, fold), so that a drift of the card falls
    on both alike; on an H100 the first window after heavier work ran
    2-3 % slow. `ms` and `library_ms` become the means of the pairs (the
    window `kernel_times` took first is kept as `ms_first_window`); the
    yardstick is also timed back to back by CUDA events."""
    def yardstick():
        return torch.bitwise_xor(a, b)

    f1, _ = kernel_device_ms(fn, label)
    y1, _ = kernel_device_ms(yardstick, "BitwiseXor")
    y2, _ = kernel_device_ms(yardstick, "BitwiseXor")
    f2, _ = kernel_device_ms(fn, label)
    rec.update(ms_first_window=rec["ms"], ms=(f1 + f2) / 2,
               ms_in_turns=[f1, f2], library_ms=(y1 + y2) / 2,
               library_ms_in_turns=[y1, y2],
               library_ms_events=cuda_ms(yardstick))


def rows_on_card(host: np.ndarray, offsets, dtype) -> list[torch.Tensor]:
    """Row i of `host` on the card as a view `offsets[i % len(offsets)]`
    elements into an allocation of its own."""
    rows = []
    for i, row in enumerate(host):
        off = offsets[i % len(offsets)]
        big = torch.zeros(off + row.size + 3, dtype=dtype, device="cuda")
        big[off:off + row.size] = torch.from_numpy(row).cuda()
        rows.append(big[off:off + row.size])
    return rows


def check_xor(rng, k, w, offsets) -> dict:
    """`xor_reduce_words` in both forms against its plain version, bit for
    bit: the dense (k, W) form as a view `offsets[0]` words into a larger
    tensor, the rows form with row i `offsets[i % len]` words into its own
    allocation; each call launches once per step of `chain_plan(k)`."""
    host = rng.integers(-(1 << 31), 1 << 31, size=(k, w), dtype=np.int32)
    off = offsets[0]
    big = torch.zeros(off + k * w + 3, dtype=torch.int32, device="cuda")
    big[off:off + k * w] = torch.from_numpy(host.reshape(-1)).cuda()
    dense = big[off:off + k * w].view(k, w)
    rows = rows_on_card(host, offsets, torch.int32)
    want = ref.xor_reduce_ref(dense)
    before = xor_reduce_words.launches
    by_dense, by_rows = xor_reduce_words(dense), xor_reduce_words(rows)
    torch.cuda.synchronize()
    launched = xor_reduce_words.launches - before
    rec = dict(kernel="xor_reduce_words",
               shape=f"k={k} W={w} word offsets={offsets}",
               max_abs_err=max(max_abs_err(by_dense, want),
                               max_abs_err(by_rows, want)))
    if rec["max_abs_err"] != 0 or launched != 2 * len(chain_plan(k)):
        raise AssertionError(f"xor_reduce_words disagrees: {rec}, "
                             f"{launched} launches")
    return rec


def check_xor_bytes(rng, k, n, offsets) -> dict:
    """`ops.xor_reduce` on k uint8 rows of n bytes, row i `offsets[i % len]`
    bytes into its own allocation (the head, tail and misaligned paths of
    the kernel), against the plain version, bit for bit."""
    host = rng.integers(0, 256, size=(k, n), dtype=np.uint8)
    rows = rows_on_card(host, offsets, torch.uint8)
    got = ops.xor_reduce(rows)
    torch.cuda.synchronize()
    rec = dict(kernel="xor_reduce_words",
               shape=f"ops.xor_reduce k={k} nbytes={n} byte offsets={offsets}",
               max_abs_err=max_abs_err(got, ref.xor_reduce_ref(rows)))
    if rec["max_abs_err"] != 0 or not np.array_equal(
            got.cpu().numpy(), np.bitwise_xor.reduce(host, axis=0)):
        raise AssertionError(f"ops.xor_reduce disagrees: {rec}")
    return rec


def time_xor(peaks, k, form) -> dict:
    """`xor_reduce_words` on k rows of 128 MiB, as one (k, W) tensor
    (`form="dense"`) or as k separate allocations (`"rows"`, the serial
    repair's form), checked against its plain version and timed; at k = 2
    beside the `torch.bitwise_xor` yardstick. Bound: each row read once,
    the output written once."""
    dense = device_words(17, (k, W_WORDS))
    words = dense if form == "dense" else [row.clone() for row in dense]
    if form == "rows":
        del dense
    got = xor_reduce_words(words)
    torch.cuda.synchronize()
    want = ref.xor_reduce_ref(words)
    rec = dict(kernel="xor_reduce_words", shape=f"k={k} W={W_WORDS} {form}",
               max_abs_err=max_abs_err(got, want))
    if rec["max_abs_err"] != 0:
        raise AssertionError(f"xor_reduce_words disagrees: {rec}")
    del got, want
    nbytes = 4 * W_WORDS * (k + 1)
    bms, by = bound(nbytes, (k - 1) * W_WORDS, peaks)
    rec.update(**kernel_times(lambda: xor_reduce_words(words),
                              "xor_reduce_words"),
               plain_ms=cuda_ms(lambda: ref.xor_reduce_ref(words)),
               bound_ms=bms, bound_by=by, bytes=nbytes)
    if k == 2:
        add_xor_yardstick(rec, lambda: xor_reduce_words(words),
                          "xor_reduce_words", words[0], words[1])
    else:
        rec["library_ms"] = None
    del words
    torch.cuda.empty_cache()
    return rec


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
    bitplane.pack.calls = bitplane.unpack.calls = 0


def read_launches() -> dict:
    """Each kernel's launches since `reset_launches`; raises if anything
    bit-sliced its bytes in that time."""
    if bitplane.pack.calls or bitplane.unpack.calls:
        raise AssertionError(f"bitplane.pack ran {bitplane.pack.calls} and "
                             f"unpack {bitplane.unpack.calls} times")
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def demo_scenario(failed=(0,)) -> tuple:
    cluster, bw = topology.aliyun_matrix()
    code = RSCode(6, 3)
    bwp = BandwidthProcess(base=bw, change_interval=2.0, mode="markov",
                           sigma=1.0, rho=0.9, seed=15)
    sc = Scenario(num_nodes=6, code=code, failed=failed, bw=bwp,
                  ingress=IngressModel(seed=15, duplex=0.5), chunk_mb=128)
    return cluster, code, sc


# device kernels grouped under short labels: the port's own kernels, the
# plain-torch ops of the bit-slicing around the plane kernels, then the rest
KERNEL_LABELS = ("gf256_matmul_bytes", "gf256_scale_bytes",
                 "gf256_matmul_planes", "xor_reduce_words",
                 "gf256_scale_planes", "xor_reduce_groups", "sum_functor",
                 "lshift", "rshift", "BitwiseAndFunctor", "BitwiseOrFunctor",
                 "BitwiseXorFunctor", "copy", "Fill", "CatArray", "index")
# the labels of `bitplane.pack` / `unpack`'s ops: no profiled path has any
PACK_LABELS = ("sum_functor", "lshift", "rshift", "BitwiseAndFunctor",
               "BitwiseOrFunctor")


def profile_repair(repair, phase: str = "profile_repair",
                   forbid: tuple = ()) -> dict:
    """One repair under torch.profiler: device kernel time by label, and the
    device's idle share of the repair's wall time (one stream: kernels do
    not overlap, so busy time is their sum). Raises if a label of `forbid`
    or of the bit-slicing shows."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        tic = time.perf_counter()
        repair()
        wall_ms = (time.perf_counter() - tic) * 1e3
    by_label: dict[str, float] = {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        label = next((lb for lb in KERNEL_LABELS if lb in ev.name), "other")
        by_label[label] = (by_label.get(label, 0.0)
                           + ev.time_range.elapsed_us() / 1e3)
    busy_ms = sum(by_label.values())
    if busy_ms <= 0:
        raise AssertionError("profiled repair shows no device time")
    packing = sorted(set(by_label) & set(PACK_LABELS))
    if packing:
        raise AssertionError(f"{phase}: bit-slicing ops on the card: "
                             f"{packing}")
    shown = sorted(set(by_label) & set(forbid))
    if shown:
        raise AssertionError(f"{phase}: {shown} on the card: {by_label}")
    rec = dict(phase=phase, wall_ms=wall_ms, device_busy_ms=busy_ms,
               device_idle_share=1.0 - busy_ms / wall_ms,
               device_ms_by_label=dict(sorted(by_label.items(),
                                              key=lambda kv: -kv[1])))
    print(json.dumps(rec))
    return rec


def main_path(records: list) -> dict:
    """Phase 3: plan + simulate every single-failure scheme, encode a
    128 MiB-per-block stripe on the card, execute the BMF repair there."""
    cluster, code, sc = demo_scenario()
    sim = RepairSimulator(sc)
    results = {}
    for scheme in ("traditional", "ppr", "ppt", "bmf"):
        r = sim.run(scheme)
        results[scheme] = r
        print(f"-- {scheme}: {float(r.total_time)!r} s simulated over "
              f"{r.num_rounds} round(s)")
        if r.plan:
            for i, rnd in enumerate(r.plan.rounds):
                print(f"   round {i + 1}: " + ", ".join(
                    "->".join(cluster.name(x) for x in t.path)
                    for t in rnd.transfers))
        for line in r.log:
            print("   " + line)
    bmf = results["bmf"]

    rng = np.random.default_rng(0)
    data_np = rng.integers(0, 256, size=(code.k, BLOCK_BYTES), dtype=np.uint8)
    data = torch.from_numpy(data_np).cuda()
    torch.cuda.synchronize()

    reset_launches()
    tic = time.perf_counter()
    codeword = code.encode(data)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - tic
    tic = time.perf_counter()
    ex = executor.execute_plan(bmf.plan, code, codeword, device="cuda")
    torch.cuda.synchronize()
    repair_s = time.perf_counter() - tic
    launches = read_launches()

    head = 4 * MIB
    want_parity = gf256.gf_matmul_np(code.generator[code.k:],
                                     data_np[:, :head])
    if not np.array_equal(codeword[code.k:, :head].cpu().numpy(), want_parity):
        raise AssertionError("encoded parity (first 4 MiB) disagrees with "
                             "gf_matmul_np")
    lost = ex.reconstructed[0]
    if not (ex.verified is True and lost.is_cuda
            and lost.shape == (BLOCK_BYTES,)):
        raise AssertionError(f"BMF repair not verified: {ex.verified}")
    if not np.array_equal(lost[:head].cpu().numpy(), data_np[0, :head]):
        raise AssertionError("repaired block (first 4 MiB) != lost data")
    # the encode and one premultiply per helper, in bytes; no plane kernel;
    # one fold of two buffers for each helper but the first of a job
    helpers = sum(len(job.helpers) for job in bmf.plan.jobs)
    if (launches["gf256_matmul_bytes"] != 1 + helpers
            or launches["xor_reduce_words"] != helpers - len(bmf.plan.jobs)
            or launches["gf256_matmul_planes"] or launches["gf256_scale_planes"]
            or launches["gf256_scale_bytes"]
            or launches["xor_reduce_groups_words"]):
        raise AssertionError(f"serial path launches {launches}")

    encode_steady = []            # the counted first call also grew the allocator
    for _ in range(5):
        tic = time.perf_counter()
        code.encode(data)
        torch.cuda.synchronize()
        encode_steady.append(time.perf_counter() - tic)

    def repair():
        executor.execute_plan(bmf.plan, code, codeword, device="cuda")
        torch.cuda.synchronize()

    steady = []                   # the first call above also grew the allocator
    for _ in range(5):
        tic = time.perf_counter()
        repair()
        steady.append(time.perf_counter() - tic)
    rec = dict(phase="main_path", block_bytes=BLOCK_BYTES,
               verified=ex.verified, bytes_moved=ex.bytes_moved,
               encode_wall_s=encode_s,
               encode_wall_s_median_of_5=statistics.median(encode_steady),
               repair_wall_s=repair_s,
               repair_wall_s_median_of_5=statistics.median(steady),
               launches=launches,
               simulated_s={s: float(r.total_time) for s, r in results.items()},
               bmf_log=bmf.log)
    print(json.dumps(rec))
    records.append(rec)
    # the fold reads its two buffers in place: no `torch.stack` copy
    records.append(profile_repair(repair, forbid=("CatArray",)))
    del data, codeword, ex, lost
    torch.cuda.empty_cache()
    return launches


def small_checks(records: list) -> None:
    """Phase 4: every scheme's plan, card vs CPU plain path, 4099 bytes."""
    rng = np.random.default_rng(1)
    for failed, schemes in (((0,), ("traditional", "ppr", "bmf",
                                    "bmf_static")),
                            ((0, 4), MULTI_SCHEMES)):
        _, code, sc = demo_scenario(failed)
        data = torch.from_numpy(
            rng.integers(0, 256, size=(code.k, 4099), dtype=np.uint8))
        cw_cpu = code.encode(data)
        cw_gpu = code.encode(data.cuda())
        if not torch.equal(cw_gpu.cpu(), cw_cpu):
            raise AssertionError("encode: card != CPU plain path")
        for scheme in schemes:
            plan = RepairSimulator(sc).run(scheme).plan
            on_gpu = executor.execute_plan(plan, code, cw_gpu, device="cuda")
            on_cpu = executor.execute_plan(plan, code, cw_cpu, device="cpu")
            same = all(torch.equal(on_gpu.reconstructed[j].cpu(),
                                   on_cpu.reconstructed[j])
                       for j in on_cpu.reconstructed)
            if not (on_gpu.verified and on_cpu.verified and same
                    and on_gpu.bytes_moved == on_cpu.bytes_moved):
                raise AssertionError(f"{scheme} failed={failed}: card and "
                                     "CPU repairs disagree")
    # one mixed batch: all 8 schemes under both failure patterns
    plans, cws = [], []
    for failed in ((0,), (0, 4)):
        _, code, sc = demo_scenario(failed)
        for scheme in SINGLE_SCHEMES + MULTI_SCHEMES:
            plans.append(scheme_plan(sc, scheme))
            cws.append(code.encode(torch.from_numpy(
                rng.integers(0, 256, size=(code.k, 4099), dtype=np.uint8))))
    code = RSCode(6, 3)
    on_cpu = dataplane.execute_plans_batch(plans, code, cws, device="cpu")
    on_gpu = dataplane.execute_plans_batch(
        plans, code, [cw.cuda() for cw in cws], device="cuda")
    same = all(torch.equal(on_gpu.reconstructed[b][j].cpu(), blk)
               for b, rec in enumerate(on_cpu.reconstructed)
               for j, blk in rec.items())
    if not (on_gpu.all_verified and on_cpu.all_verified and same
            and np.array_equal(on_gpu.bytes_moved, on_cpu.bytes_moved)):
        raise AssertionError("mixed batch: card and CPU plain path disagree")
    rec = dict(phase="small_checks", ok=True, mixed_batch_cases=len(plans))
    print(json.dumps(rec))
    records.append(rec)


def scheme_plan(sc, scheme: str):
    """The executed plan of one scheme; PPT plans a pipeline tree, whose
    bytes move through its store-and-forward lowering `ppt_round_plan`."""
    if scheme == "ppt":
        return ppt_round_plan(build_ppt_tree(sc.make_jobs()[0],
                                             sc.bw.matrix_at(0.0)))
    return RepairSimulator(sc).run(scheme).plan


def batch_layout(batch: int):
    """Phase 5's plans (one per stripe, the four schemes in turn),
    compiled, with the batch's round tables as `execute_plans_batch`
    lowers them on the host."""
    _, code, sc = demo_scenario()
    schemes = [BATCH_SCHEMES[b % len(BATCH_SCHEMES)] for b in range(batch)]
    plans = [compile_plan(scheme_plan(sc, s)) for s in schemes]
    n_nodes = max(pa.num_nodes for pa in plans)
    slots = max(pa.num_jobs for pa in plans) * n_nodes
    _, steps, _ = dataplane._schedule(plans, n_nodes, slots)
    return code, plans, slots, steps


def batched_path(records: list, batch: int) -> dict:
    """Phase 5: `batch` stripes of 3 x 128 MiB, one plan each, repaired by
    one `execute_plans_batch` call on the card."""
    code, plans, slots, steps = batch_layout(batch)
    rng = np.random.default_rng(5)
    heads, cws = [], []
    for _ in range(batch):
        data = np.frombuffer(bytearray(rng.bytes(code.k * BLOCK_BYTES)),
                             dtype=np.uint8).reshape(code.k, BLOCK_BYTES)
        heads.append(data[0, :HEAD].copy())
        cws.append(code.encode(torch.from_numpy(data).cuda()))
        del data
    torch.cuda.synchronize()
    serial_moved = []
    for pa, cw in zip(plans, cws):
        ex = executor.execute_plan(decompile(pa), code, cw, device="cuda")
        if not ex.verified:
            raise AssertionError("serial repair of a batch plan not verified")
        serial_moved.append(ex.bytes_moved)
        del ex
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    def run():
        return dataplane.execute_plans_batch(plans, code, cws, device="cuda")

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    tic = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - tic
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()

    if not res.all_verified:
        raise AssertionError(f"batched repair not verified: {res.verified}")
    for b, rec in enumerate(res.reconstructed):
        lost = rec[0]
        if not (lost.is_cuda and lost.shape == (BLOCK_BYTES,)
                and np.array_equal(lost[:HEAD].cpu().numpy(), heads[b])):
            raise AssertionError(f"case {b}: repaired block != lost data")
    if res.bytes_moved.tolist() != serial_moved:
        raise AssertionError(f"bytes_moved {res.bytes_moved.tolist()} != "
                             f"serial {serial_moved}")
    want = {name: 0 for name in WRAPPERS}
    want.update(gf256_scale_bytes=1, xor_reduce_groups_words=len(steps))
    if launches != want:
        raise AssertionError(f"batched path launches {launches} != {want}")
    del res, lost
    steady = []
    for _ in range(5):
        tic = time.perf_counter()
        run()
        torch.cuda.synchronize()
        steady.append(time.perf_counter() - tic)
    rec = dict(phase="batched_path", stripes=batch,
               schemes=[BATCH_SCHEMES[b % len(BATCH_SCHEMES)]
                        for b in range(batch)],
               block_bytes=BLOCK_BYTES, all_verified=True,
               bytes_moved=serial_moved, rounds=len(steps),
               groups_per_round=[int(s.groups.shape[0]) for s in steps],
               kmax_per_round=[int(s.groups.shape[1]) for s in steps],
               wall_s_first=first_s, wall_s_median_of_5=statistics.median(steady),
               wall_s_all=steady, max_memory_allocated=peak,
               launches=launches)
    print(json.dumps(rec))
    records.append(rec)

    def traced():
        run()
        torch.cuda.synchronize()

    records.append(profile_repair(traced,
                                  phase=f"profile_batched_path_b{batch}"))
    del cws
    torch.cuda.empty_cache()
    return launches


def make_suite(name: str):
    """A phase-6 suite: 14 nodes under hot (2 s markov) churn; frozen to
    recorded traces where `epochs` is set."""
    p = SWEEP_SUITES[name]
    space = SampleSpace(codes=(p["code"],), cluster_sizes=(14,),
                        chunk_mb=(p["chunk_mb"],), regimes=("hot2s",),
                        failure_patterns=(p["pattern"],))
    live = MonteCarloSuite(name, p["cases"], space, schemes=p["schemes"],
                           base_seed=p["base_seed"])
    if p["epochs"] is None:
        return live
    return TraceSuite.freeze(live, num_epochs=p["epochs"], name=name)


def sweep_max_rel_err(got, want, name: str) -> float:
    """Raises unless every case and scheme has the same rounds and relay
    hops and a time within 1e-6 rtol; returns the largest relative error."""
    worst = 0.0
    for cg, cw in zip(got.cases, want.cases, strict=True):
        if set(cg.results) != set(cw.results):
            raise AssertionError(f"{name} case {cw.index}: schemes differ")
        for s, rw in cw.results.items():
            rg = cg.results[s]
            rel = abs(rg.total_time - rw.total_time) / abs(rw.total_time)
            if (rg.num_rounds != rw.num_rounds
                    or rg.relay_hops != rw.relay_hops or not rel <= 1e-6):
                raise AssertionError(
                    f"{name} case {cw.index} {s}: device "
                    f"({rg.num_rounds}, {rg.relay_hops}, {rg.total_time!r}) "
                    f"!= vectorized ({rw.num_rounds}, {rw.relay_hops}, "
                    f"{rw.total_time!r})")
            worst = max(worst, rel)
    return worst


def profile_device(fn, phase: str) -> dict:
    """One call of `fn` under torch.profiler: device busy time (kernels of
    one stream do not overlap, so it is their sum), the idle share of the
    wall time, kernel launches and the kernels that took the most time."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        tic = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - tic) * 1e3
    by_name: dict[str, list] = {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        rec = by_name.setdefault(ev.name[:80], [0, 0.0])
        rec[0] += 1
        rec[1] += ev.time_range.elapsed_us() / 1e3
    busy_ms = sum(ms for _, ms in by_name.values())
    if busy_ms <= 0:
        raise AssertionError(f"{phase}: no device time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return dict(phase=phase, wall_ms_profiled=wall_ms, device_busy_ms=busy_ms,
                device_idle_share=1.0 - busy_ms / wall_ms,
                device_kernels=sum(n for n, _ in by_name.values()),
                top_kernels_ms={k: ms for k, (_, ms) in top})


def sweep_suite(records: list, name: str, device: str = "cuda") -> dict:
    """Phase 6 for one suite: checks, timings and a trace; returns the
    launches of its byte-verified device sweep."""
    counts = device_stepper.COUNTS
    p = SWEEP_SUITES[name]
    start = time.perf_counter()
    frozen = make_suite(name) if p["epochs"] else None
    build_s = time.perf_counter() - start

    def suite():
        return frozen or make_suite(name)

    vec = run_sweep(suite(), executor="vectorized")
    reset_launches()
    counts.reset()
    dev = run_sweep(suite(), executor="device",
                    verify_bytes=SWEEP_VERIFY, device=device)
    torch.cuda.synchronize()
    launches = read_launches()
    checked = counts.as_dict()
    worst = sweep_max_rel_err(dev, vec, name)
    bv = dev.byte_verification
    if not bv.verified or len({i for i, _ in bv.checked}) != SWEEP_VERIFY:
        raise AssertionError(f"{name}: byte verification {bv}")
    # one data-plane call: one premultiply, one segment fold per round
    want = {k: 0 for k in WRAPPERS}
    want.update(gf256_scale_bytes=1, xor_reduce_groups_words=bv.rounds)
    if launches != want:
        raise AssertionError(f"{name}: sweep launches {launches} != {want}")
    if checked["host_batches"] or not checked["device_batches"]:
        raise AssertionError(f"{name}: batch routes {checked}")
    if p["epochs"] is None and not checked["horizon_grows"]:
        raise AssertionError(f"{name}: the live suite never grew its "
                             f"epoch horizon: {checked}")

    walls: dict[str, list] = {"vectorized": [], "device": []}
    timed_counts = []
    for i in range(SWEEP_REPEATS):        # in turns: v, d, d, v, v, d
        for ex in (("vectorized", "device") if i % 2 == 0
                   else ("device", "vectorized")):
            runs_on = suite()
            counts.reset()
            tic = time.perf_counter()
            run_sweep(runs_on, executor=ex, device=device)
            torch.cuda.synchronize()
            walls[ex].append(time.perf_counter() - tic)
            if ex == "device":
                timed_counts.append(counts.as_dict())
                if counts.host_batches:
                    raise AssertionError(f"{name}: host batches {counts}")
    runs_on = suite()
    counts.reset()
    prof = profile_device(lambda: run_sweep(runs_on, executor="device",
                                            device=device),
                          f"profile_sweep_{name}")
    if counts.host_batches:
        raise AssertionError(f"{name}: host batches {counts}")
    prof.update(counts=counts.as_dict())
    cases = len(vec.cases)
    wall = {ex: statistics.median(w) for ex, w in walls.items()}
    rec = dict(phase="sweep", suite=name, cases=cases,
               schemes=list(p["schemes"]), epochs=p["epochs"],
               build_s=build_s, phase_s=time.perf_counter() - start,
               max_rel_err=worst, wall_s_median_of_3=wall, wall_s_all=walls,
               cases_per_s={ex: cases / w for ex, w in wall.items()},
               device_over_vectorized=wall["vectorized"] / wall["device"],
               counts_checked_run=checked, counts_timed_runs=timed_counts,
               planning_s={ex: sum(r.planning_time for c in sw.cases
                                   for r in c.results.values())
                           for ex, sw in (("vectorized", vec),
                                          ("device", dev))},
               byte_verification=dict(pairs=len(bv.checked), nbytes=bv.nbytes,
                                      verified=bv.verified,
                                      rounds=bv.rounds),
               launches=launches, profile=prof)
    print(json.dumps(rec))
    records.append(rec)
    return launches


def sweep_phase(records: list, device: str = "cuda") -> dict:
    """Phase 6: the three suites; returns their summed launches."""
    total = {k: 0 for k in WRAPPERS}
    for name in SWEEP_SUITES:
        for k, n in sweep_suite(records, name, device).items():
            total[k] += n
    return total


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", type=Path, default=None,
                        help="also write every record to this file")

    args = parser.parse_args()

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = nvidia_smi("name,power.limit")
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {name}")
    peaks = peak_rates(name)
    records: list = [dict(phase="device", nvidia_smi=smi, torch=torch.__version__,
                          **peaks)]

    lib = load_library()
    print(f"kernels built in {lib.build_seconds:.1f} s -> {lib.path}")
    print(lib.log)

    rng = np.random.default_rng(0)
    timed: dict[str, dict] = {}
    errs = {name: 0 for name in KERNELS}
    for m, k in ((1, 1), (3, 6), (2, 16)):
        for w in (1, 513):
            rec = check_gf256(rng, peaks, m, k, w, timed=False)
            errs["gf256_matmul_planes"] = max(errs["gf256_matmul_planes"],
                                              rec["max_abs_err"])
    # the fold in both forms, chained past KMAX rows, at word offsets 0, 1
    # and 3 (alike and mixed), then on ragged and misaligned byte rows
    for k in (2, 3, 5, 16, 17, 33):
        for w in (1, 513, 1024):
            for offsets in ((0,), (1,), (3,), (1, 3, 0)):
                records.append(check_xor(rng, k, w, offsets))
    for k in (2, 3, 17):
        for n in (1, 33, 4099, 4096, 4112):
            for offsets in ((0,), (3,), (0, 1, 3)):
                records.append(check_xor_bytes(rng, k, n, offsets))
    # main-path shapes: the helper premultiply (1,1) and the RS(6,3) encode
    # (3,3) at 128 MiB blocks, plus a six-data-block encode (3,6)
    for m, k in ((1, 1), (3, 3), (3, 6)):
        rec = check_gf256(rng, peaks, m, k, W_PLANES, timed=True)
        print(json.dumps(rec))
        records.append(rec)
        timed.setdefault("gf256_matmul_planes", rec)   # (1,1) is the repair's
        torch.cuda.empty_cache()
    for k in (2, 3):
        for form in ("rows", "dense"):
            rec = time_xor(peaks, k, form)
            print(json.dumps(rec))
            records.append(rec)
            timed.setdefault("xor_reduce_words", rec)   # k=2 rows: the repair's

    # the batched data plane's kernels: CPU-test shapes, then full width
    for m in (1, 5):
        for w in (1, 513):
            records.append(check_scale(rng, peaks, m, w, timed=False))
    tables = (np.array([[0, 1, 2, -1], [3, -1, -1, -1], [4, 5, -1, -1],
                        [6, 2, 0, 1], [-1, -1, -1, -1]]),   # ragged, K=1, repeats
              np.array([[5], [5], [0]]))                     # K=1 only
    for w in (1, 513, 1024):
        words = device_words(int(rng.integers(1 << 30)), (7, w))
        for table in tables:
            records.append(check_groups(peaks, words, table, False,
                                        f"T=7 G={table.shape[0]} W={w}"))
        records.append(check_groups(peaks, words.reshape(7, 1, w), None,
                                    False, f"dense G=7 K=1 W={w}"))
    batch = BATCHES[0]
    rec = check_scale(rng, peaks, 3 * batch, W_PLANES, timed=True)
    print(json.dumps(rec))
    records.append(rec)
    timed["gf256_scale_planes"] = rec
    _, _, slots, steps = batch_layout(batch)
    big = max(steps, key=lambda s: int((s.groups >= 0).sum()))
    words = device_words(13, (batch * slots, W_WORDS))
    rec = check_groups(peaks, words, big.groups, True,
                       f"largest batch round: T={batch * slots} "
                       f"G={big.groups.shape[0]} Kmax={big.groups.shape[1]} "
                       f"W={W_WORDS}")
    print(json.dumps(rec))
    records.append(rec)
    del words
    torch.cuda.empty_cache()
    words = device_words(14, (4, 2, W_WORDS))
    rec = check_groups(peaks, words, None, True, f"dense G=4 K=2 W={W_WORDS}")
    print(json.dumps(rec))
    records.append(rec)
    timed["xor_reduce_groups_words"] = rec
    del words
    torch.cuda.empty_cache()

    # the byte-domain GF(256) kernels the byte entry points launch: the
    # CPU-test shapes, at a 16-byte aligned and a misaligned row offset,
    # the plane route, then full width
    for n in (1, 33, 4099, 4096 + 16):
        for offset in (0, 3):
            for m, k in ((1, 1), (3, 6), (2, 16), (5, 3)):
                records.append(check_matmul_bytes(rng, peaks, m, k, n, False,
                                                  offset))
            for m in (1, 5):
                records.append(check_scale_bytes(rng, peaks, m, n, False,
                                                 offset))
    records.extend(check_plane_route(rng, 3, 6, 4099))
    for m, k in ((1, 1), (3, 3), (3, 6)):
        rec = check_matmul_bytes(rng, peaks, m, k, BLOCK_BYTES, True)
        print(json.dumps(rec))
        records.append(rec)
        timed.setdefault("gf256_matmul_bytes", rec)    # (1,1) is the repair's
        torch.cuda.empty_cache()
    rec = check_scale_bytes(rng, peaks, 3 * batch, BLOCK_BYTES, True)
    print(json.dumps(rec))
    records.append(rec)
    timed["gf256_scale_bytes"] = rec
    torch.cuda.empty_cache()
    for rec in records[1:]:
        errs[rec["kernel"]] = max(errs[rec["kernel"]], rec["max_abs_err"])

    serial_launches = main_path(records)
    small_checks(records)
    batch_launches = [batched_path(records, b) for b in BATCHES]
    sweep_launches = sweep_phase(records)
    print(json.dumps({"launches": {"serial": serial_launches,
                                   **{f"batched_b{b}": lc for b, lc in
                                      zip(BATCHES, batch_launches)},
                                   "sweep": sweep_launches}}))
    # each kernel's launches on the path that runs it, the batched ones at
    # B=4 (a new dict: the phases' records keep their own counts); the
    # plane kernels run on no path
    launches = {**serial_launches,
                **{k: batch_launches[0][k] for k in ("gf256_scale_planes",
                                                     "gf256_scale_bytes",
                                                     "xor_reduce_groups_words")}}

    kernels = []
    for kname, meta in KERNELS.items():
        t = timed[kname]
        kernels.append(dict(
            name=kname, **meta, launches=launches[kname],
            launches_sweep=sweep_launches[kname],
            max_abs_err=errs[kname], ms=t["ms"], ms_events=t["ms_events"],
            ms_single=t["ms_single"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=t["library_ms"],
            library_ms_events=t.get("library_ms_events"), shape=t["shape"]))
    device = {"platform": "gpu", "kind": name,
              "count": torch.cuda.device_count()}
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(
            dict(records=records, kernels=kernels, device=device), indent=1))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
