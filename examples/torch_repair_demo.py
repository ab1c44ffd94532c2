"""Repair-scheme walkthrough on the paper's own topologies, on the card.

Shows, for one failure on the measured Aliyun ECS matrix (paper Table III)
under hot churn: the plans traditional / PPR / PPT / BMFRepair produce,
their simulated repair times, and the actual byte-verified data-plane
execution of the BMF plan with the GF(256) CUDA kernels (the encode and
each helper's premultiply by `gf256_matmul_bytes`, each fan-in's fold by
`xor_reduce_words`).

    PYTHONPATH=src python examples/torch_repair_demo.py [--device cpu]

The device is the card unless `--device cpu` asks for the kernels' plain
PyTorch versions; without a card it raises.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import executor, topology
from repro_torch.core.bandwidth import BandwidthProcess, IngressModel
from repro_torch.core.simulator import RepairSimulator, Scenario
from repro_torch.device import resolve_device
from repro_torch.ec.rs import RSCode


def main(device=None):
    dev = resolve_device(device)
    cluster, bw = topology.aliyun_matrix()
    code = RSCode(6, 3)
    bwp = BandwidthProcess(base=bw, change_interval=2.0, mode="markov",
                           sigma=1.0, rho=0.9, seed=15)
    sc = Scenario(num_nodes=6, code=code, failed=(0,), bw=bwp,
                  ingress=IngressModel(seed=15, duplex=0.5), chunk_mb=128)
    sim = RepairSimulator(sc)

    print(f"== repairing {cluster.name(0)}'s block, RS(6,3), 128 MB, "
          "Aliyun Table III bandwidths, hot churn ==")
    results = {}
    for scheme in ("traditional", "ppr", "ppt", "bmf"):
        r = sim.run(scheme)
        results[scheme] = r
        print(f"\n-- {scheme}: {r.total_time:.2f}s over {r.num_rounds} "
              f"round(s), planning {r.planning_time * 1e3:.2f} ms")
        if r.plan:
            for i, rnd in enumerate(r.plan.rounds):
                desc = ", ".join(
                    "->".join(cluster.name(x) for x in t.path)
                    for t in rnd.transfers)
                print(f"   round {i + 1}: {desc}")
        for line in r.log:
            print("   " + line)

    bmf, ppr = results["bmf"], results["ppr"]
    print(f"\nBMFRepair vs PPR: {100 * (1 - bmf.total_time / ppr.total_time):.1f}% "
          f"faster (paper: ~15.9% avg on Aliyun)")

    print("\n== executing the BMF plan on real data (GF(256) kernels) ==")
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, size=(3, 1 << 16), dtype=np.uint8)
    cw = code.encode(torch.from_numpy(data).to(dev))
    ex = executor.execute_plan(bmf.plan, code, cw, device=dev)
    print(f"  reconstructed {ex.reconstructed[0].nbytes} bytes, "
          f"byte-exact: {ex.verified}, network bytes moved: {ex.bytes_moved}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "kernels' plain PyTorch versions)")
    main(ap.parse_args().device)
