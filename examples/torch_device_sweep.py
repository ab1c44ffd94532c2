"""Device executor walkthrough: the torch device steppers end to end.

1. runs one Monte-Carlo suite under the serial (object) engine and
   `executor="device"` (the event loops of
   `repro_torch.core.engine.device_stepper` as torch float64 programs on
   the card) and checks they agree,
2. times the numpy vectorized executor against the device executor on an
   execution-bound trace-frozen suite, both warm,
3. shows where the batches ran: `device_stepper.COUNTS` (batches on the
   device, batches handed back to the numpy steppers, host syncs). A
   batch the device stepper declines runs on the numpy steppers with
   identical results, and is counted and warned of.

The JAX package's walkthrough (`examples/jax_sweep.py`) names the
executor `"jax"`; here it is `"device"`, and `"jax"` raises. Its
`"auto"` picks the jax stepper for large frozen suites on an
accelerator; this package's `"auto"` never picks the device stepper,
which measured slower than the vectorized engine on the H100.

    PYTHONPATH=src python examples/torch_device_sweep.py [--device cpu]

The device is the card unless `--device cpu` runs the device stepper's
torch ops on the CPU; without a card it raises.
"""
import argparse
import time

from repro_torch.core.engine import device_stepper
from repro_torch.device import resolve_device
from repro_torch.sim import MonteCarloSuite, SampleSpace, TraceSuite, run_sweep


def device_parity(dev):
    space = SampleSpace(
        codes=((6, 3), (7, 4)), cluster_sizes=(10,), chunk_mb=(8.0,),
        regimes=("hot2s",), failure_patterns=("single", "double"),
    )
    suite = MonteCarloSuite("jaxdemo", 16, space, base_seed=3)
    serial = run_sweep(suite, executor="serial")
    on_device = run_sweep(suite, executor="device", device=dev)
    worst = max(
        abs(cs.results[s].total_time - cd.results[s].total_time)
        / cs.results[s].total_time
        for cs, cd in zip(serial.cases, on_device.cases) for s in cs.results
    )
    print(f"16-case sweep, serial vs executor='device': max relative "
          f"difference = {worst:.2e}")
    print(on_device.summary_table())
    return worst


def device_throughput(dev):
    """Execution-bound suite (star fan-in, large chunks, frozen traces):
    where event stepping, not planning, is the bottleneck."""
    space = SampleSpace(
        codes=((14, 10),), cluster_sizes=(14,), chunk_mb=(512.0,),
        regimes=("hot2s",), failure_patterns=("single",),
    )
    live = MonteCarloSuite("stress", 24, space,
                           schemes=("traditional", "ppr"), base_seed=17)
    frozen = TraceSuite.freeze(live, num_epochs=256)
    timings = {}
    for executor in ("vectorized", "device"):
        run_sweep(frozen, executor=executor, device=dev)      # warm
        t0 = time.perf_counter()
        run_sweep(frozen, executor=executor, device=dev)
        timings[executor] = time.perf_counter() - t0
    print(f"\nexecution-bound 24-case suite (warm): "
          f"numpy vectorized {timings['vectorized'] * 1e3:.0f}ms, "
          f"device {timings['device'] * 1e3:.0f}ms on {dev}")


def main(device=None):
    dev = resolve_device(device)
    device_stepper.COUNTS.reset()
    worst = device_parity(dev)
    assert worst < 1e-6, "device executor must match the reference engine"
    device_throughput(dev)
    c = device_stepper.COUNTS
    print(f"device stepper routes: {c.device_batches} device batches, "
          f"{c.host_batches} host batches, {c.host_syncs} host syncs")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "device stepper's torch ops on the CPU)")
    main(ap.parse_args().device)
