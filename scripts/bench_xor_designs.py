"""Time the candidate designs of the two-row XOR fold on one NVIDIA GPU.

    python3 scripts/bench_xor_designs.py [--json PATH] [--mib 128] [--passes 4]
                                         [--placements MIB|segment ...]

Builds `scripts/xor_designs.cu` (nvcc, sm_90a, the port's flags) into
`build/xor_designs/`, then on two rows of `--mib` MiB checks every design
bit for bit against `a ^ b` and times it beside the port's shipped kernel
(`xor_reduce_words` on the two rows) and `torch.bitwise_xor` (on the
bytes, and on their int32 view as `chip_smoke.py` times it): each the
kernel alone (torch.profiler, mean of 20 launches) and 20 calls back to
back between CUDA events, every call writing a fresh output as the
wrappers do. After one warm-up call of each, the list is timed
`--passes` times, forward and backward in turn, so that a drift of the
card shows as a spread between passes. Where the rows and outputs lie
can move a time by a few per cent on an H100, so the whole is repeated
for each of `--placements`: the MiB allocated before the rows, or
`segment` for the two rows as halves of one allocation. Prints the
card's name and power limit, one JSON line per design, placement and
pass, and a summary line of medians.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.xor_reduce import xor_reduce_words  # noqa: E402

SOURCE = ROOT / "scripts" / "xor_designs.cu"


def load_designs() -> ctypes.CDLL:
    out_dir = ROOT / "build" / "xor_designs"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "libxor_designs.so"
    proc = subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, "-shared", str(SOURCE), "-o",
         str(lib_path)], capture_output=True, text=True)
    print(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed on scripts/xor_designs.cu")
    lib = ctypes.CDLL(str(lib_path))
    p = ctypes.c_void_p
    lib.xd_count.restype = ctypes.c_int
    lib.xd_name.argtypes = [ctypes.c_int]
    lib.xd_name.restype = ctypes.c_char_p
    lib.xd_launch.argtypes = [ctypes.c_int, p, p, p, ctypes.c_longlong, p]
    lib.xd_launch.restype = ctypes.c_int
    return lib


def time_designs(lib, n: int, passes: int, bound_ms: float,
                 placement: str) -> list[dict]:
    """Check and time every design on two rows of n bytes: allocated apart
    after a pad of `placement` MiB (a number), or, with "segment", as the
    two halves of one allocation, n bytes apart."""
    if placement == "segment":
        pad = chip_smoke.device_bytes(21, (2 * n,))
        a, b = pad[:n], pad[n:]
    else:
        pad = torch.empty((int(placement) << 20,), dtype=torch.uint8,
                          device="cuda")
        a = chip_smoke.device_bytes(21, (n,))
        b = chip_smoke.device_bytes(22, (n,))
    want = a ^ b
    stream = torch.cuda.current_stream().cuda_stream

    def design(i):
        # a fresh output each call, as the port's wrappers and PyTorch's
        # own ops allocate one
        def fn():
            out = torch.empty_like(a)
            build.check_launch(lib.xd_launch(i, a.data_ptr(), b.data_ptr(),
                                             out.data_ptr(), n, stream),
                               lib.xd_name(i).decode())
            return out
        return fn

    cases = [("shipped xor_reduce_words", "xor_reduce_words",
              lambda: xor_reduce_words([a.view(torch.int32),
                                        b.view(torch.int32)]).view(torch.uint8)),
             ("torch.bitwise_xor", "BitwiseXor", lambda: torch.bitwise_xor(a, b)),
             ("torch.bitwise_xor int32", "BitwiseXor",
              lambda: torch.bitwise_xor(a.view(torch.int32),
                                        b.view(torch.int32)).view(torch.uint8))]
    cases += [(lib.xd_name(i).decode(), lib.xd_name(i).decode(), design(i))
              for i in range(lib.xd_count())]
    for name, _, fn in cases:
        if not torch.equal(fn(), want):
            raise AssertionError(f"{name} disagrees with a ^ b")
    for _, _, fn in cases:                       # warm the card up
        chip_smoke.cuda_ms(fn)
    results = []
    for pass_no in range(passes):
        order = cases if pass_no % 2 == 0 else cases[::-1]
        for name, label, fn in order:
            ms, windows = chip_smoke.kernel_device_ms(fn, label, attempts=8)
            rec = dict(design=name, placement=placement, pass_no=pass_no,
                       ms=ms, profile_windows=windows,
                       ms_events=chip_smoke.cuda_ms(fn), bound_ms=bound_ms,
                       share_of_bound=bound_ms / ms, nbytes=n)
            print(json.dumps(rec))
            results.append(rec)
    del pad, a, b, want
    torch.cuda.empty_cache()
    return results


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", type=Path, default=None)
    parser.add_argument("--mib", type=int, default=128)
    parser.add_argument("--passes", type=int, default=4,
                        help="timing passes, forward and backward in turn")
    parser.add_argument("--placements", nargs="+", default=["0"],
                        help="one run each: the MiB allocated before the "
                             "rows, or 'segment' for both rows in one "
                             "allocation")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_xor_designs: no CUDA device")
    smi = chip_smoke.nvidia_smi("name,power.limit")
    print(smi)
    peaks = chip_smoke.peak_rates(torch.cuda.get_device_name(0))
    lib = load_designs()
    n = args.mib << 20
    bound_ms, _ = chip_smoke.bound(3 * n, n / 4, peaks)
    results = []
    for placement in args.placements:
        results += time_designs(lib, n, args.passes, bound_ms, placement)
    summary = {}
    for name in dict.fromkeys(r["design"] for r in results):
        medians = [statistics.median(r["ms"] for r in results
                                     if r["design"] == name
                                     and r["placement"] == p)
                   for p in args.placements]
        summary[name] = dict(median_ms_by_placement=medians,
                             mean_of_medians_ms=statistics.mean(medians))
    print(json.dumps({"device": smi, "bound_ms": bound_ms,
                      "passes": args.passes, "placements": args.placements,
                      "summary": summary}))
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(dict(device=smi, results=results,
                                             summary=summary), indent=1))


if __name__ == "__main__":
    main()
