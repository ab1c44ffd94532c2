"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--json PATH]

Phases (any failure is an uncaught exception and a non-zero exit):

0. the card's name and power limit (`nvidia-smi`), the torch version;
   raises when no CUDA device is visible;
1. build the CUDA kernels from `src/repro_torch/kernels/csrc` (nvcc, sm_90a);
2. hold each kernel against its plain PyTorch version on the card,
   bit-exact, at the CPU-test shapes and the main path's shapes, and time
   both (CUDA events, median of 20) beside the least time the card could
   take for the same work;
3. the main path at full size: the repair-demo scenario (RS(6,3) on the
   Aliyun Table III matrix under markov churn, 128 MB chunks) planned and
   simulated for every single-failure scheme, a 128 MiB-per-block stripe
   encoded on the card, the BMF plan's repair executed through the
   kernels and verified byte-exact; the kernels' launch counters are set
   to 0 just before and read just after;
   then one more repair is traced with torch.profiler (device time by
   kernel, the device's idle share);
4. small-input checks: every scheme's plan executed on the card equals the
   CPU plain path byte for byte and verifies.

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
from repro_torch.core.simulator import (MULTI_SCHEMES, RepairSimulator,  # noqa: E402
                                        Scenario)
from repro_torch.ec import bitplane, gf256  # noqa: E402
from repro_torch.ec.rs import RSCode  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.build import load_library  # noqa: E402
from repro_torch.kernels.gf256_matmul import gf256_matmul_planes  # noqa: E402
from repro_torch.kernels.xor_reduce import xor_reduce_words  # noqa: E402

MIB = 1 << 20
BLOCK_BYTES = 128 * MIB            # the paper's 128 MB chunk; HDFS block size
W_PLANES = BLOCK_BYTES // 32       # plane words per 128 MiB block
W_WORDS = BLOCK_BYTES // 4         # 32-bit words per 128 MiB block
REPS = 20

KERNELS = {
    "gf256_matmul_planes": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/gf256_matmul.cu",
        replaces="src/repro/kernels/gf256_matmul.py:40"),
    "xor_reduce_words": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/xor_reduce.cu",
        replaces="src/repro/kernels/xor_reduce.py:26"),
}


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
    """Median over `reps` runs of one call, timed with CUDA events."""
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


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.long() - b.long()).abs().max())


def random_words(rng: np.random.Generator, shape) -> torch.Tensor:
    host = rng.integers(-(1 << 31), 1 << 31, size=shape, dtype=np.int32)
    return torch.from_numpy(host).cuda()


def check_gf256(rng, peaks, m, k, w, timed):
    coeff = rng.integers(0, 256, size=(m, k), dtype=np.uint8)
    coeff.flat[0] = 1                   # coefficients 1 and 0 take part too
    if coeff.size > 1:
        coeff.flat[1] = 0
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
        rec.update(ms=cuda_ms(lambda: gf256_matmul_planes(masks, planes)),
                   plain_ms=cuda_ms(
                       lambda: ref.gf256_matmul_planes_ref(masks, planes)),
                   bound_ms=bms, bound_by=by, library_ms=None,
                   bytes=nbytes, lop3_ops=lop3)
    return rec


def check_xor(rng, peaks, k, w, timed):
    words = random_words(rng, (k, w))
    got = xor_reduce_words(words)
    torch.cuda.synchronize()
    want = ref.xor_reduce_ref(words)
    torch.cuda.synchronize()
    rec = dict(kernel="xor_reduce_words", shape=f"k={k} W={w}",
               max_abs_err=max_abs_err(got, want))
    if rec["max_abs_err"] != 0:
        raise AssertionError(f"xor_reduce_words disagrees: {rec}")
    if timed:
        nbytes = 4 * w * (k + 1)
        bms, by = bound(nbytes, (k - 1) * w, peaks)
        rec.update(ms=cuda_ms(lambda: xor_reduce_words(words)),
                   plain_ms=cuda_ms(lambda: ref.xor_reduce_ref(words)),
                   bound_ms=bms, bound_by=by, bytes=nbytes)
        if k == 2:   # the yardstick: one PyTorch call, never used by the port
            rec["library_ms"] = cuda_ms(
                lambda: torch.bitwise_xor(words[0], words[1]))
        else:
            rec["library_ms"] = None
    return rec


def demo_scenario(failed=(0,)) -> tuple:
    cluster, bw = topology.aliyun_matrix()
    code = RSCode(6, 3)
    bwp = BandwidthProcess(base=bw, change_interval=2.0, mode="markov",
                           sigma=1.0, rho=0.9, seed=15)
    sc = Scenario(num_nodes=6, code=code, failed=failed, bw=bwp,
                  ingress=IngressModel(seed=15, duplex=0.5), chunk_mb=128)
    return cluster, code, sc


# device kernels grouped under short labels: the port's own kernels, then
# the plain-torch ops of the bit-slicing around them
KERNEL_LABELS = ("gf256_matmul_planes", "xor_reduce_words", "sum_functor",
                 "lshift", "rshift", "BitwiseAndFunctor", "BitwiseOrFunctor",
                 "BitwiseXorFunctor", "copy", "Fill", "CatArray", "index")


def profile_repair(repair) -> dict:
    """One repair under torch.profiler: device kernel time by label, and the
    device's idle share of the repair's wall time (one stream: kernels do
    not overlap, so busy time is their sum)."""
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
    rec = dict(phase="profile_repair", wall_ms=wall_ms, device_busy_ms=busy_ms,
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

    gf256_matmul_planes.launches = 0
    xor_reduce_words.launches = 0
    tic = time.perf_counter()
    codeword = code.encode(data)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - tic
    tic = time.perf_counter()
    ex = executor.execute_plan(bmf.plan, code, codeword, device="cuda")
    torch.cuda.synchronize()
    repair_s = time.perf_counter() - tic
    launches = {"gf256_matmul_planes": gf256_matmul_planes.launches,
                "xor_reduce_words": xor_reduce_words.launches}

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
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"main path never launched {name}")

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
               encode_wall_s=encode_s, repair_wall_s=repair_s,
               repair_wall_s_median_of_5=statistics.median(steady),
               launches=launches,
               simulated_s={s: float(r.total_time) for s, r in results.items()},
               bmf_log=bmf.log)
    print(json.dumps(rec))
    records.append(rec)
    records.append(profile_repair(repair))
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
    rec = dict(phase="small_checks", ok=True)
    print(json.dumps(rec))
    records.append(rec)


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
    for k in (2, 5):
        for w in (1, 513, 1024):
            rec = check_xor(rng, peaks, k, w, timed=False)
            errs["xor_reduce_words"] = max(errs["xor_reduce_words"],
                                           rec["max_abs_err"])
    # main-path shapes: the helper premultiply (1,1) and the RS(6,3) encode
    # (3,3) at 128 MiB blocks, plus a six-data-block encode (3,6)
    for m, k in ((1, 1), (3, 3), (3, 6)):
        rec = check_gf256(rng, peaks, m, k, W_PLANES, timed=True)
        print(json.dumps(rec))
        records.append(rec)
        timed.setdefault("gf256_matmul_planes", rec)   # (1,1) is the repair's
        torch.cuda.empty_cache()
    rec = check_xor(rng, peaks, 2, W_WORDS, timed=True)
    print(json.dumps(rec))
    records.append(rec)
    timed["xor_reduce_words"] = rec
    torch.cuda.empty_cache()
    for rec in records[1:]:
        errs[rec["kernel"]] = max(errs[rec["kernel"]], rec["max_abs_err"])

    launches = main_path(records)
    small_checks(records)

    kernels = []
    for kname, meta in KERNELS.items():
        t = timed[kname]
        kernels.append(dict(
            name=kname, **meta, launches=launches[kname],
            max_abs_err=errs[kname], ms=t["ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=t["library_ms"], shape=t["shape"]))
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
