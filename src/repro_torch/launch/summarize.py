"""Summarize the port's dry-run records into the reference's two tables
(per-cell dry run, and the roofline of each mesh).

    PYTHONPATH=src python -m repro_torch.launch.summarize \\
        results/dryrun_torch [--md]

The columns are the reference's. The memory column is the record's
`per_device_bytes` (its arguments' local shards plus the step's tracked
eager peak) and the "compile s" column the step's eager run on fake
tensors (see each record's `analysis`). The limiter notes name the
H100's units: tensor-core GEMMs, HBM, NVLink collectives.
"""
from __future__ import annotations

import glob
import json
import sys

LIMITER_NOTES = {
    "memory": "HBM traffic (eager, unfused: every op's operands and "
              "result)",
    "compute": "tensor-core GEMMs",
    "collective": "NVLink collectives",
}


def fmt_bytes(b):
    return f"{b / 2**30:.2f}"


def load(dirname):
    rows = []
    for path in sorted(glob.glob(f"{dirname}/*.json")):
        with open(path) as f:
            rows.append(json.load(f))
    order = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2, "long_500k": 3}
    rows.sort(key=lambda r: (r["arch"], order.get(r["shape"], 9), r["mesh"]))
    return rows


def dryrun_table(rows):
    print("| arch | shape | mesh | chips | fits (GiB/chip) | HLO GFLOPs/dev | "
          "HBM GB/dev | coll GB/dev (top kind) | compile s |")
    print("|---|---|---|---|---|---|---|---|---|")
    for r in rows:
        h = r["hlo_analysis"]
        coll = h["collective_by_kind"]
        top = max(coll, key=coll.get) if coll else "-"
        gib = r.get("per_device_bytes", 0) / 2**30
        outs = r["memory_analysis"].get("output_size_in_bytes", 0) / 2**30
        print(f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['chips']} "
              f"| {gib:.1f}(+{outs:.1f} out) "
              f"| {h['flops_per_device'] / 1e9:.1f} "
              f"| {h['bytes_per_device'] / 1e9:.1f} "
              f"| {h['collective_bytes_per_device'] / 1e9:.2f} ({top}) "
              f"| {r['compile_s']:.0f} |")


def roofline_table(rows, mesh="single"):
    print("| arch | shape | compute s | memory s | collective s | dominant | "
          "MODEL_FLOPS | useful ratio | limiter note |")
    print("|---|---|---|---|---|---|---|---|---|")
    for r in rows:
        if r["mesh"] != mesh:
            continue
        rf = r["roofline"]
        u = r.get("useful_compute_ratio")
        dom = rf["dominant"].replace("_s", "")
        note = LIMITER_NOTES[dom]
        print(f"| {r['arch']} | {r['shape']} | {rf['compute_s']:.3f} "
              f"| {rf['memory_s']:.3f} | {rf['collective_s']:.3f} | {dom} "
              f"| {r['model_flops_global']:.2e} "
              f"| {u if u is None else f'{u:.3f}'} | {note} |")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    dirname = argv[0] if argv else "results/dryrun_torch"
    rows = load(dirname)
    print(f"## Dry-run: {len(rows)} cells\n")
    dryrun_table(rows)
    print("\n## Roofline (single-pod 16x16, 256 chips)\n")
    roofline_table(rows, "single")
    print("\n## Roofline (multi-pod 2x16x16, 512 chips)\n")
    roofline_table(rows, "multi")


if __name__ == "__main__":
    main()
