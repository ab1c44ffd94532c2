"""Where an event step's cycles go on the card, for both routes of both
event-loop kernels.

    python3 scripts/event_loop_breakdown.py [--check] [--warps 1 2 8]
        [--json results/breakdown.json]

Builds `scripts/event_loop_profiled.cu`, the profiled copy of
`csrc/event_loop.cu` (each kernel there also adds the `clock64()` cycles
of each part of a step to a per-case record; the package's kernels have
no stamps), into a temporary directory, after checking that the copy less
its stamps is the package's source. Records the largest engine batch of
`stress_trace` and `stress_live` at R = 1 and R > 1 as `chip_smoke.py`'s
phase 2 does (their sweeps through `executor="device"` on the shipped
kernels), and runs each batch on each route of the profiled build. For
each it prints the cycles a step of each part, over all the batch's cases
and for its slowest case, and the loads of the steps on which the case's
epoch flipped against the others'. It times the shipped kernels on the
same batches (the kernel's device time from torch.profiler, the routes in
turns: warp, block, block, warp) beside the step yardstick
(`chip_smoke.step_floor_us`), and for each `--warps` value a build of
`csrc/event_loop.cu` with that many cases a block (`kCaseWarps`) on the
warp route against the shipped one, in turns. It prints ptxas's registers
and spills of the event-loop kernels built as the library builds them.
`--check` first runs phase 2's event-loop checks
(`chip_smoke.event_loop_checks`: both routes held to the plain versions
on the hand-made and suite batches). Needs a card; builds with `nvcc`.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.kernels import build, event_loop  # noqa: E402
from repro_torch.sim.sweep import run_sweep  # noqa: E402

SUITES = ("stress_trace", "stress_live")
PARTS = {"epoch": 0, "epoch_index": 12, "loads": 1, "groups": 2,
         "group_max": 14, "rates": 3, "dt_min": 4, "debit_end": 5,
         "min_scan": 6}
FLIP_LOADS, FLIPS, STEPS, REST, WHOLE, LEVELS = 7, 8, 9, 10, 11, 13
JUMPS, REDUCED = 15, 16
SLOTS = 17                                   # kProfSlots
PROFILED = Path(__file__).resolve().parent / "event_loop_profiled.cu"
CASE_WARPS = "constexpr int kCaseWarps = 4;"
STAMP = re.compile(r"^\s*PROF(_[A-Z]+)?(\(.*\))?;\s*$")


def without_stamps(text: str) -> str:
    """The profiled copy less its stamps: the lines from `// >>> profile`
    to `// <<< profile` and every `PROF...;` line dropped. Equals the
    package's `csrc/event_loop.cu`."""
    out, skip = [], False
    for line in text.splitlines(keepends=True):
        if line.startswith("// >>> profile"):
            skip = True
        elif line.startswith("// <<< profile"):
            skip = False
        elif not skip and not STAMP.match(line):
            out.append(line)
    return "".join(out)


def with_case_warps(text: str, warps: int) -> str:
    """The source with `warps` cases a block on the warp route."""
    if text.count(CASE_WARPS) != 1:
        raise ValueError(f"no single `{CASE_WARPS}` in the source")
    return text.replace(CASE_WARPS, f"constexpr int kCaseWarps = {warps};")


def ptxas_usage(log: str) -> dict:
    """{kernel: {registers, spill_stores, spill_loads}} from nvcc's
    `-Xptxas -v` output (the event-loop kernels only)."""
    usage, kernel = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            names = [k for k in chip_smoke.EVENT_KERNELS.values()
                     if k in m.group(1)]
            kernel = max(names, key=len) if names else None
            continue
        if kernel is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            usage.setdefault(kernel, {}).update(
                spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            usage.setdefault(kernel, {})["registers"] = int(m.group(1))
    return usage


def nvcc_builds(out: Path, variants: dict) -> dict:
    """Build each variant ({label: CUDA source text}), all at once;
    returns {label: (ctypes library, nvcc's output)}."""
    nvcc = build._nvcc()
    procs = {}
    for label, text in variants.items():
        src, so = out / f"{label}.cu", out / f"lib_{label}.so"
        src.write_text(text)
        procs[label] = (so, subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-shared", str(src), "-o", str(so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for label, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {label}:\n{log}")
        lib = ctypes.CDLL(str(so))
        build._bind_event_loops(lib)
        libs[label] = (lib, log)
    return libs


class using:
    """Within the block, the wrappers launch from `lib`."""

    def __init__(self, lib):
        self.lib = lib

    def __enter__(self):
        self.saved = build.load_library
        build.load_library = lambda: build.KernelLibrary(
            lib=self.lib, path=Path("."), build_seconds=0.0, log="")

    def __exit__(self, *exc):
        build.load_library = self.saved


def recorded_batches() -> dict:
    """{(suite, kernel, R > 1): (ctx, tables, t0)}: the largest engine
    batches, as chip_smoke.py's phase 2 records them."""
    batches = {}
    for suite in SUITES:
        made = (chip_smoke.frozen_suite(suite)[0]
                if chip_smoke.SWEEP_SUITES[suite]["epochs"]
                else chip_smoke.make_suite(suite))
        with chip_smoke.recorded_event_loops() as kept:
            run_sweep(made, executor="device", device="cuda")
        for (name, multi), batch in kept.items():
            batches[suite, name, multi] = batch
    torch.cuda.synchronize()
    return batches


def profile(lib, name, batch, route) -> dict:
    """One launch of the profile build: each part's cycles a step."""
    ctx, tables, t0 = batch
    B = ctx.stack.shape[0]
    buf = torch.zeros((B, SLOTS), dtype=torch.int64, device="cuda")
    build.check_launch(lib.event_loop_profile_buffer(
        ctypes.c_void_p(buf.data_ptr())), "event_loop_profile_buffer")
    with using(lib):
        out = chip_smoke.WRAPPERS[name](ctx, *tables, t0,
                                        guard=chip_smoke.EVENT_GUARD,
                                        _route=route)
    torch.cuda.synchronize()
    prof = buf.cpu().numpy().astype(np.float64)
    steps = prof[:, STEPS]
    slow = int(np.argmax(prof[:, WHOLE]))
    flips = prof[:, FLIPS].sum()
    row = dict(
        lanes=chip_smoke.event_lanes(name, tables),
        chain_steps=chip_smoke.event_steps(out.cpu().numpy()),
        case_steps=float(steps.sum()),
        cycles_a_step={p: prof[:, i].sum() / steps.sum()
                       for p, i in PARTS.items()},
        levels_a_step=prof[:, LEVELS].sum() / steps.sum(),
        jump_rounds_a_step=prof[:, JUMPS].sum() / steps.sum(),
        reduced_groups_a_step=prof[:, REDUCED].sum() / steps.sum(),
        rest_cycles_a_case=float(prof[:, REST].mean()),
        slowest_case=dict(
            steps=float(steps[slow]),
            whole_cycles_a_step=prof[slow, WHOLE] / steps[slow],
            cycles_a_step={p: prof[slow, i] / steps[slow]
                           for p, i in PARTS.items()}),
        flip_share=flips / steps.sum(),
        loads_cycles_flip_step=prof[:, FLIP_LOADS].sum() / max(flips, 1),
        loads_cycles_other_step=((prof[:, 1].sum() - prof[:, FLIP_LOADS].sum())
                                 / max(steps.sum() - flips, 1)))
    row["cycles_a_step_sum"] = sum(row["cycles_a_step"].values())
    return row


def timed(name, batch, libs: dict, turns) -> dict:
    """The kernel's device ms (torch.profiler, mean of 20 launches) of each
    (library label, route) in `turns`, in that order; {(label, route):
    [ms, ...]}."""
    ctx, tables, t0 = batch
    times = {}
    for label, route in turns:
        with using(libs[label]):
            ms, _ = chip_smoke.kernel_device_ms(
                lambda: chip_smoke.WRAPPERS[name](
                    ctx, *tables, t0, guard=chip_smoke.EVENT_GUARD,
                    _route=route), chip_smoke.EVENT_KERNELS[name, route])
        times.setdefault((label, route), []).append(ms)
    return times


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--check", action="store_true")
    parser.add_argument("--warps", type=int, nargs="*", default=[])
    parser.add_argument("--json", type=Path)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("event_loop_breakdown: no card")
    smi = chip_smoke.nvidia_smi("name,power.limit")
    print(f"{torch.cuda.get_device_name(0)} ({smi}), torch "
          f"{torch.__version__}")
    shipped = build.load_library()
    report = dict(nvidia_smi=smi)
    peaks = chip_smoke.peak_rates(torch.cuda.get_device_name(0))
    if args.check:
        records = []
        chip_smoke.event_loop_checks(records, peaks)
        report["checks"] = records
    floor_us = chip_smoke.step_floor_us()
    report["step_floor_us"] = floor_us
    print(f"step yardstick: {floor_us:.4f} us a step")
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        source = (build.CSRC / "event_loop.cu").read_text()
        profiled = PROFILED.read_text()
        if without_stamps(profiled) != source:
            raise SystemExit(f"{PROFILED.name} less its stamps is not "
                             "csrc/event_loop.cu: bring the copy up to date")
        variants = {"plain": source, "profile": profiled}
        variants.update({f"warps{w}": with_case_warps(source, w)
                         for w in args.warps})
        built = nvcc_builds(Path(tmp), variants)
        # the shipped build's flags: its registers and spills (a library
        # already built logs none)
        report["ptxas"] = ptxas_usage(built["plain"][1])
        report["ptxas_profile"] = ptxas_usage(built["profile"][1])
        print("ptxas:", json.dumps(report["ptxas"]))
        libs = {"shipped": shipped.lib,
                **{k: lib for k, (lib, _) in built.items()}}
        batches = recorded_batches()
        rows = []
        for (suite, name, multi), batch in sorted(batches.items()):
            shape = f"{suite} ({batch[0].stack.shape[0]}, " \
                    f"{np.shape(batch[1][0])[1] if name == 'round_events' else 1})"
            for route in event_loop.ROUTES:
                row = dict(suite=suite, kernel=name, batch=shape, route=route,
                           **profile(libs["profile"], name, batch, route))
                rows.append(row)
                print(json.dumps(row))
            turns = [("shipped", "warp"), ("shipped", "block"),
                     ("shipped", "block"), ("shipped", "warp")]
            for w in args.warps:
                turns += [("shipped", "warp"), (f"warps{w}", "warp"),
                          (f"warps{w}", "warp"), ("shipped", "warp")]
            times = timed(name, batch, libs, turns)
            steps = rows[-1]["chain_steps"]
            t = dict(suite=suite, kernel=name, batch=shape, chain_steps=steps,
                     chain_floor_ms=steps * floor_us * 1e-3,
                     ms={f"{lb} {r}": ms for (lb, r), ms in times.items()},
                     us_a_step={f"{lb} {r}": statistics.mean(ms) * 1e3 / steps
                                for (lb, r), ms in times.items()})
            rows.append(t)
            print(json.dumps(t))
    report["rows"] = rows
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
