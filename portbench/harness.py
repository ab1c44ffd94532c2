"""One run of one cell: set-up, the timed window, the trace, the check.

The window is a closed loop of repair batches, the way a DataNode's
reconstruction workers take the next stripe of a lost node's backlog as
soon as the last is done. Each batch

1. draws B stripes' scenarios from the seed (`traffic.draw_case`),
2. plans them with the port's sweep engine
   (`run_sweep(..., executor="auto", keep_plans=True)`),
3. lowers each plan (`compile_plan`, `relabel_plan_nodes` through the
   stripe's placement from `place_stripes`),
4. repairs the bytes on the card (`execute_plans_batch`) from the next B
   stripes of the pool that set-up made and encoded,
5. synchronises.

A batch's latency runs from 1 to 5. With `--trace 1` a further stretch
of batches runs under torch.profiler after the window, and the run
prints the per-layer metrics in place of the end-to-end ones.

Before the result, a `samples` line gives the window's counts (batches,
stripes, batches beyond the p95, restored blocks offered and sampled,
traced batches) and what it says about where the time went
(`portbench/diagnose.py`); no metric reads it:

* `plan_ms_mean`, `plan_ms_median`: steps 2-3 of a batch (planning and
  lowering), over its stripes, in ms: the mean and the median over the
  window's batches.
* `dataplane_ms_mean`, `dataplane_ms_median`: steps 4-5 (the data plane
  through the synchronise) a stripe, the same way.
* `repair_GBps_halves`: `repair_GBps` over the first and the second half
  of the window's batches, each from its first batch's start to its last
  batch's end.
* `gc_full`, `gc_full_s`: full (generation 2) collections of Python's
  garbage collector inside the window, and their seconds.
* `gc_young`: the younger generations' collections inside the window.
* `cpu_affinity`: the CPUs the process may run on, as a list of ranges
  (`0-7`).
* `cpus_ran_on`: the CPU the main thread was on when a batch ended
  (libc's `sched_getcpu`: field 39 of `/proc/thread-self/stat`) and in
  how many batches.
* `clocks_sm_MHz`, `temperature_C`: the card's SM clock and temperature
  (`nvidia-smi`) just after the window; null off the card.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from portbench import (check, diagnose, faults, guard, inputs, spec, timing,
                       trace, traffic)
from portbench.traffic import STRIPES, TRACED, WARM, WINDOW
from repro_torch.core.engine import dataplane
from repro_torch.core.engine.arrays import compile_plan, relabel_plan_nodes
from repro_torch.ec.rs import RSCode
from repro_torch.ec.stripe import place_stripes
from repro_torch.sim import sweep

PROFILE_ATTEMPTS = 3       # the profiler can lose a window's device records


@dataclasses.dataclass
class Batch:
    start: float               # perf_counter at step 1
    end: float                 # perf_counter after step 5
    plan_s: float              # steps 2-3: planning and lowering
    dataplane_s: float         # steps 4-5: the data plane through the synchronise
    stripes: int
    lost_bytes: int            # bytes of the lost blocks it restored
    bytes_moved: int           # the data plane's count, relays included
    plans: list | None = None  # the lowered plans (traced batches only)

    @property
    def latency_s(self) -> float:
        return self.end - self.start


@dataclasses.dataclass
class Traced:
    batches: list[Batch]
    profile: trace.Profile
    port_kernels: tuple[str, ...]

    @property
    def window_s(self) -> float:
        return self.profile.span[1] - self.profile.span[0]

    @property
    def busy_s(self) -> float:
        return trace.busy_seconds(self.profile.ops)


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    device_name: str
    nbytes: int
    setup_s: float
    window_s: float
    batches: list[Batch]
    traced: Traced | None


class Bench:
    """The cell's state: its pool of stripes on the device and its draws."""

    def __init__(self, cell: spec.Cell, seed: int, device: torch.device,
                 nbytes: int):
        cfg, trf = cell.config, cell.traffic
        self.cfg, self.trf, self.seed, self.device = cfg, trf, seed, device
        self.nbytes = nbytes
        self.code = RSCode(cfg["n"], cfg["k"])
        self.batch_size = cfg["reconstruction_threads"]
        self.placement = place_stripes(cfg["backlog_stripes"], self.code,
                                       cfg["cluster_nodes"])
        self.pool: list[torch.Tensor] = []
        self.sample = check.Reservoir(trf["sampled_jobs"], seed)
        self.lost_most = 0

    def make_pool(self) -> None:
        """Each pool stripe's data from the seed, encoded by the port."""
        for s in range(len(self.placement)):
            data = inputs.stripe_data(self.seed, STRIPES, s, self.code.k,
                                      self.nbytes, self.device)
            self.pool.append(self.code.encode(data))
            del data

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def batch(self, stream: int, index: int, marked: bool = False) -> Batch:
        mark = ((lambda name: record_function(trace.PREFIX + name)) if marked
                else (lambda name: contextlib.nullcontext()))
        B, nodes, scheme = self.batch_size, self.cfg["cluster_nodes"], self.trf["scheme"]
        start = time.perf_counter()
        with mark("draw"):
            cases = [traffic.draw_case(self.cfg, self.trf, self.seed, stream,
                                       index * B + b) for b in range(B)]
        t_plan = time.perf_counter()
        with mark("plan"):
            result = sweep.run_sweep(
                traffic.BatchSuite(self.trf["name"], cases, scheme),
                schemes=(scheme,), executor="auto", keep_plans=True)
        with mark("lower"):
            slots = [(index * B + b) % len(self.pool) for b in range(B)]
            plans = [relabel_plan_nodes(
                compile_plan(case.results[scheme].plan),
                self.placement[s].perm(nodes))
                for case, s in zip(result.cases, slots)]
            block_maps = [self.placement[s].block_map(nodes) for s in slots]
        t_data = time.perf_counter()
        with mark("dataplane"):
            out = dataplane.execute_plans_batch(
                plans, self.code, [self.pool[s] for s in slots],
                block_of=block_maps, device=self.device)
        with mark("sync"):
            self.sync()
        end = time.perf_counter()
        lost = [case.scenario.failed for case in cases]
        self.lost_most = max(self.lost_most, *map(len, lost))
        if stream == WINDOW:
            for b, s in enumerate(slots):
                for j, position in enumerate(lost[b]):
                    self.sample.offer(check.Job(s, position,
                                                out.reconstructed[b][j]))
        return Batch(start=start, end=end, plan_s=t_data - t_plan,
                     dataplane_s=end - t_data, stripes=B,
                     lost_bytes=self.nbytes * sum(map(len, lost)),
                     bytes_moved=int(np.sum(out.bytes_moved)),
                     plans=plans if marked else None)


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="portbench/run.py",
                                description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True, help="cell name in BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True, help="timed window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", default="cuda",
                   help="'cpu' runs the port's plain versions, for the tests")
    p.add_argument("--block-bytes", type=int, default=None,
                   help="override the configuration's block size (tests)")
    p.add_argument("--fault", choices=faults.NAMES, default=None,
                   help="break the timed path: the control and the faults "
                        "that the checks must catch")
    return p.parse_args(argv)


def fail(message: str, code: int = 2) -> int:
    print(f"portbench: {message}", file=sys.stderr)
    return code


def profile_stretch(bench: Bench, count: int) -> Traced:
    """`count` batches of the traced stream under torch.profiler; the
    same batches again if the profiler shows no device op."""
    activities = [ProfilerActivity.CPU]
    if bench.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    csrc = Path(sys.modules["repro_torch"].__file__).parent / "kernels" / "csrc"
    for _ in range(PROFILE_ATTEMPTS):
        with profile(activities=activities) as prof:
            with record_function(trace.PREFIX + "window"):
                batches = [bench.batch(TRACED, i, marked=True)
                           for i in range(count)]
        traced = Traced(batches, trace.reduce(prof, "window"),
                        trace.port_kernel_names(csrc))
        if traced.profile.ops or bench.device.type != "cuda":
            return traced
    raise RuntimeError(f"no device op in {PROFILE_ATTEMPTS} profiled stretches")


def breakdown(traced: Traced) -> dict:
    ops = sorted(trace.seconds_by_name(traced.profile.ops).items(),
                 key=lambda kv: -kv[1])[:10]
    gaps = trace.idle_gaps(traced.profile)[:10]
    return {"device_ops": [[name[:160], s] for name, s in ops],
            "idle_gaps": [[name, s] for name, s in gaps]}


def main(argv, t0: float) -> int:
    args = parse(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: no card, no result")
    if device.type != "cuda" and args.block_bytes is None:
        return fail("a run off the card needs --block-bytes (tests only)")
    root = Path(__file__).resolve().parents[1]
    program = Path(sys.modules["repro_torch"].__file__).resolve()
    if root / "src" not in program.parents:
        return fail(f"the program {program} is not this checkout's {root / 'src'}")
    cell = spec.load_cell(args.workload)
    if device.type == "cuda" and torch.cuda.device_count() < cell.chips:
        return fail(f"{args.workload} needs {cell.chips} cards, "
                    f"{torch.cuda.device_count()} visible")
    seed = args.seed % (1 << 64)
    nbytes = args.block_bytes or cell.config["block_bytes"]
    setup = {"imports_s": time.perf_counter() - t0}

    tic = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=device)
        torch.cuda.synchronize(device)
    setup["context_s"] = time.perf_counter() - tic
    tic = time.perf_counter()
    if device.type == "cuda":
        from repro_torch.kernels.build import load_library

        setup["library_built_s"] = load_library().build_seconds
    setup["library_s"] = time.perf_counter() - tic
    if args.fault:
        faults.install(args.fault)
    bench = Bench(cell, seed, device, nbytes)
    tic = time.perf_counter()
    bench.make_pool()
    bench.sync()
    setup["stripes_s"] = time.perf_counter() - tic
    tic = time.perf_counter()
    bench.batch(WARM, 0)
    setup["warm_batch_s"] = time.perf_counter() - tic
    found = guard.loaded()
    if found:
        return fail(f"the JAX package or JAX is loaded after set-up: {found}", 4)
    setup_s = time.perf_counter() - t0
    print(json.dumps({"setup_s": setup_s, "parts": setup}), flush=True)

    watch = diagnose.Watch()
    start = time.perf_counter()
    batches = []
    while not batches or batches[-1].end - start < args.seconds:
        batches.append(bench.batch(WINDOW, len(batches)))
        watch.batch_done()
    window_s = batches[-1].end - start
    watched = watch.close(device.type)
    traced = (profile_stretch(bench, cell.traffic["traced_batches"])
              if args.trace else None)
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    found = guard.loaded()
    if found:
        return fail(f"the JAX package or JAX is loaded after the window: {found}", 4)
    latencies = sorted(b.latency_s for b in batches)
    p95 = float(np.percentile(latencies, 95))
    print(json.dumps({"samples": {
        "batches": len(batches), "stripes": sum(b.stripes for b in batches),
        "beyond_p95": sum(x > p95 for x in latencies),
        "restored_blocks_sampled": len(bench.sample.jobs),
        "restored_blocks_offered": bench.sample.offered,
        "traced_batches": len(traced.batches) if traced else 0,
        **diagnose.batches(batches), **watched}}), flush=True)

    tic = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = check.compare(bench.pool, bench.sample.jobs, bench.code.n,
                           bench.code.k, seed, bench.lost_most)
    print(json.dumps({"reference_s": time.perf_counter() - tic}), flush=True)

    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    run = Run(device_name=name, nbytes=nbytes, setup_s=setup_s,
              window_s=window_s, batches=batches, traced=traced)
    metrics = {}
    for metric in (cell.per_layer if args.trace else cell.end_to_end):
        value = metric.reader.read(run)
        if value is not None:
            metrics[metric.name] = {"value": float(value),
                                    "unit": metric.entry["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": name, "count": cell.chips, "memory_peak_bytes": memory_peak}
    if device.type == "cuda":
        dev["power_limit"] = timing.nvidia_smi("power.limit")
    if traced:
        dev.update(busy_s=traced.busy_s, window_s=traced.window_s)
    result = {"correct": all(check.within(c) for c in checks.values()),
              "attempted": bench.sample.offered,
              "failed": checks["restored_blocks_wrong"]["value"],
              "metrics": metrics, "device": dev}
    if traced and traced.profile.ops:
        result["breakdown"] = breakdown(traced)
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                        | ({"at_least": True} if c.get("at_least") else {})
                        for k, c in checks.items()}
    print(json.dumps(result), flush=True)
    for k, c in checks.items():
        print(f"check {k} {c['value']} {'>=' if c.get('at_least') else '<='} "
              f"{c['limit']}", file=sys.stderr, flush=True)
    return 0
