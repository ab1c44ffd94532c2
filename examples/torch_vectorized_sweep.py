"""Vectorized sweep walkthrough: the batched array engine end to end.

1. compiles a repair plan to its structure-of-arrays form and back,
2. runs the same Monte-Carlo suite under the serial (object) engine and
   the vectorized (batched array) executor and checks they agree,
3. times both on an execution-bound trace-frozen suite, where batching
   pays most,
4. times both on a planner-bound Table II-style suite (multi-node
   scheduling dominates): since the array-native planner layer landed —
   batched MSRepair scheduling, batched plan lowering, in-stepper BMF
   replanning — these suites vectorize too instead of pinning at serial
   speed.

    PYTHONPATH=src python examples/torch_vectorized_sweep.py [--device cpu]

Both executors are host numpy; `--device` names the device the sweeps
are given (the card unless `--device cpu`; without a card it raises).
"""
import argparse
import time

from repro_torch.core.engine import compile_plan, decompile
from repro_torch.core.msrepair import plan_msrepair, select_helpers_multi
from repro_torch.core.plan import Job
from repro_torch.device import resolve_device
from repro_torch.sim import MonteCarloSuite, SampleSpace, TraceSuite, run_sweep


def show_plan_compilation():
    helpers = select_helpers_multi(7, 4, [0, 1])
    jobs = [Job(job_id=i, failed_node=f, requestor=f, helpers=helpers[i])
            for i, f in enumerate((0, 1))]
    plan = plan_msrepair(jobs)
    pa = compile_plan(plan)
    print(f"plan: {pa.num_jobs} jobs, {pa.num_rounds} rounds, "
          f"{pa.num_transfers} transfers")
    print(f"  round offsets   {pa.round_start.tolist()}")
    print(f"  term bitmasks   {[hex(int(m)) for m in pa.t_terms]}")
    assert decompile(pa) == plan, "compile/decompile must round-trip exactly"
    print("  decompile(compile_plan(plan)) == plan  ✓")


def sweep_parity(dev):
    space = SampleSpace(
        codes=((6, 3), (7, 4)), cluster_sizes=(10,), chunk_mb=(8.0,),
        regimes=("hot2s",), failure_patterns=("single", "double"),
    )
    suite = MonteCarloSuite("demo", 24, space, base_seed=3)
    serial = run_sweep(suite, executor="serial", device=dev)
    vec = run_sweep(suite, executor="vectorized", device=dev)
    worst = max(
        abs(cs.results[s].total_time - cv.results[s].total_time)
        / cs.results[s].total_time
        for cs, cv in zip(serial.cases, vec.cases) for s in cs.results
    )
    print(f"\n24-case sweep, serial vs vectorized: max relative "
          f"difference = {worst:.2e}")
    print(vec.summary_table())


def throughput(dev):
    space = SampleSpace(
        codes=((14, 10),), cluster_sizes=(14,), chunk_mb=(512.0,),
        regimes=("hot2s",), failure_patterns=("single",),
    )
    live = MonteCarloSuite("stress", 40, space,
                           schemes=("traditional", "ppr"), base_seed=17)
    frozen = TraceSuite.freeze(live, num_epochs=256)
    timings = {}
    for executor in ("serial", "vectorized"):
        t0 = time.perf_counter()
        run_sweep(frozen, executor=executor, device=dev)
        timings[executor] = time.perf_counter() - t0
    print(f"\nexecution-bound 40-case suite: "
          f"serial {timings['serial']:.2f}s, "
          f"vectorized {timings['vectorized']:.2f}s "
          f"({timings['serial'] / timings['vectorized']:.1f}x)")


def planner_bound_throughput(dev):
    """Table II-style suite: RS(7,4) double failures, hot churn — almost
    all wall-clock is multi-node scheduling, the planner layer's turf."""
    space = SampleSpace(
        codes=((7, 4),), cluster_sizes=(14,), chunk_mb=(32.0,),
        regimes=("hot2s",), failure_patterns=("double",),
    )
    suite = MonteCarloSuite("table2ish", 60, space,
                            schemes=("mppr", "random", "msrepair"),
                            base_seed=0)
    frozen = TraceSuite.freeze(suite, num_epochs=64)
    timings = {}
    for executor in ("serial", "vectorized"):
        t0 = time.perf_counter()
        run_sweep(frozen, executor=executor, device=dev)
        timings[executor] = time.perf_counter() - t0
    print(f"\nplanner-bound 60-case Table II suite: "
          f"serial {timings['serial'] * 1e3:.0f}ms, "
          f"vectorized {timings['vectorized'] * 1e3:.0f}ms "
          f"({timings['serial'] / timings['vectorized']:.1f}x — batched "
          f"planning, not just batched execution)")


def main(device=None):
    dev = resolve_device(device)
    show_plan_compilation()
    sweep_parity(dev)
    throughput(dev)
    planner_bound_throughput(dev)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' for the CPU)")
    main(ap.parse_args().device)
