"""Scenario-sweep walkthrough: Monte-Carlo evaluation of the paper's claim.

Samples 40 repair scenarios (codes, cluster sizes, volatility regimes,
correlated failures), runs every applicable scheme on each via the batched
sweep engine, and prints per-scheme distributions plus the BMF-vs-PPR and
MSRepair-vs-mPPR speedup CDFs — the statistical version of paper
Figs. 9/10.

    PYTHONPATH=src python examples/torch_sweep_demo.py [--device cpu]

The sweep's default executor is the vectorized engine (numpy on the
host); `--device` names the device the sweep is given (the card unless
`--device cpu`; without a card it raises).
"""
import argparse

from repro_torch.device import resolve_device
from repro_torch.sim import MonteCarloSuite, SampleSpace, TraceSuite, run_sweep


def main(device=None):
    dev = resolve_device(device)
    space = SampleSpace(
        codes=((4, 2), (6, 3), (7, 4)),
        cluster_sizes=(10, 14),
        chunk_mb=(8.0, 32.0),
        regimes=("cold5s", "hot2s", "wan_drift"),
        failure_patterns=("single", "double", "rack"),
    )
    suite = MonteCarloSuite("demo", 40, space, base_seed=7)
    print(f"== sweeping {len(suite)} Monte-Carlo scenarios ==")
    sweep = run_sweep(suite, device=dev)

    print("\nper-scheme repair-time distributions:")
    print(sweep.summary_table())

    for base, scheme in (("ppr", "bmf"), ("mppr", "msrepair")):
        spd = sweep.speedups(base, scheme)
        if not len(spd):
            continue
        print(f"\n{scheme} vs {base}: mean reduction "
              f"{sweep.reduction_pct(base, scheme):.1f}% over {len(spd)} "
              f"paired scenarios")
        for q in (10, 50, 90):
            print(f"  speedup p{q:02d} = "
                  f"{sweep.speedup_percentile(base, scheme, q):.2f}x")

    # trace replay: freeze the bandwidth sample paths and re-run — results
    # are reproducible epoch-for-epoch, the A/B substrate for new planners
    frozen = TraceSuite.freeze(suite, num_epochs=64)
    sweep2 = run_sweep(frozen, device=dev)
    print(f"\ntrace-replay sweep over the same {len(frozen)} scenarios:")
    print(sweep2.summary_table())


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' for the CPU)")
    main(ap.parse_args().device)
