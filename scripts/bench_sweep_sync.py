"""Time the device sweep at several host-sync intervals on one GPU.

    python3 scripts/bench_sweep_sync.py [--every 1 8 64] [--repeats 3]
                                        [--device cuda] [--json PATH]

The device stepper (`repro_torch.core.engine.device_stepper`) reads its
event loop's completion and overflow flags on the host once every
`_SYNC_EVERY` steps. This script runs the suites of `chip_smoke.py`'s
phase 6 through `run_sweep(executor="device")` at each interval, the
intervals in turns (1, 8, 64, then 64, 8, 1, ...), and prints for each
suite and interval the median wall time, host syncs, event steps and host
seconds in the loops. Every interval must give the first interval's
results (rounds, relay hops, time within 1e-6 rtol) and run every batch
on the device, or the script fails. It needs one CUDA device
(`--device cpu` runs the same ops on the CPU, for a rehearsal).
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from repro_torch.core.engine import device_stepper  # noqa: E402
from repro_torch.sim.sweep import run_sweep  # noqa: E402


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--every", type=int, nargs="+", default=[1, 8, 64])
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--json", type=Path, default=None)
    args = parser.parse_args()
    on_card = args.device == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("bench_sweep_sync: no CUDA device")
    smi = chip_smoke.nvidia_smi("name,power.limit")
    print(smi)
    counts = device_stepper.COUNTS
    default_every = device_stepper._SYNC_EVERY
    records = []
    try:
        for name, p in chip_smoke.SWEEP_SUITES.items():
            frozen = chip_smoke.make_suite(name) if p["epochs"] else None
            first = None
            walls = {e: [] for e in args.every}
            seen = {e: [] for e in args.every}
            for i in range(args.repeats):
                order = args.every if i % 2 == 0 else args.every[::-1]
                for every in order:
                    device_stepper._SYNC_EVERY = every
                    suite = frozen or chip_smoke.make_suite(name)
                    counts.reset()
                    tic = time.perf_counter()
                    out = run_sweep(suite, executor="device",
                                    device=args.device)
                    if on_card:
                        torch.cuda.synchronize()
                    walls[every].append(time.perf_counter() - tic)
                    if counts.host_batches or not counts.device_batches:
                        raise AssertionError(f"{name}: routes {counts}")
                    if first is None:
                        first = out
                    chip_smoke.sweep_max_rel_err(out, first, name)
                    seen[every].append(counts.as_dict())
            for every in args.every:
                c = seen[every][0]
                rec = dict(suite=name, sync_every=every,
                           wall_s_median=statistics.median(walls[every]),
                           wall_s_all=walls[every], host_syncs=c["host_syncs"],
                           steps=c["steps"],
                           loop_s_all=[s["loop_s"] for s in seen[every]],
                           nvidia_smi=smi)
                print(json.dumps(rec))
                records.append(rec)
    finally:
        device_stepper._SYNC_EVERY = default_every
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(records, indent=1))


if __name__ == "__main__":
    main()
