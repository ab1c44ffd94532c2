"""What a dry-run cell holds at its eager peak: the largest live storages.

    python3 scripts/dryrun_peak_snapshot.py --arch smollm_360m \\
        --shape train_4k [--mesh single] [--device cuda] [--top 25]
        [--json PATH]

Runs one cell of `repro_torch.launch.dryrun` (fake tensors on a fake
world: nothing is allocated) under `launch/hlo_analysis.Analyzer` with
one addition: each local storage the step makes is noted with the op
that made it (and the autograd node running, in the backward), and the
storages still alive when the tracked live bytes pass their highest mark
(by more than 1 %: the last note is within 1 % of the peak) are kept.
Prints the cell's record (per-device bytes, eager peak) and those
storages grouped by (op, node, shape, dtype), largest first. The
analyzer sweeps dead storages every 32 ops, so its peak counts those
freed since its last sweep; the snapshot lists only the live ones and
says their sum beside the tracked bytes.
"""
from __future__ import annotations

import argparse
import collections
import heapq
import json
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch import dryrun, hlo_analysis  # noqa: E402


class SnapshotAnalyzer(hlo_analysis.Analyzer):
    """`Analyzer` that also keeps the live storages near its peak."""

    def __init__(self):
        super().__init__()
        self._meta: dict[int, tuple] = {}
        self._op = None
        self.snapshot: list = []
        self.snapshot_bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self._op = func
        return super().__torch_dispatch__(func, types, args, kwargs)

    def _track(self, outs, ins) -> None:
        node = torch._C._current_autograd_node()
        node = type(node).__name__ if node is not None else "forward"
        known = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            storage = t.untyped_storage()
            if storage._cdata not in known:
                self._meta[storage._cdata] = (
                    str(self._op), node, tuple(t.shape), str(t.dtype))
        super()._track(outs, ins)
        if self._live_bytes > 1.01 * max(self.snapshot_bytes, 1):
            alive = [(n, self._meta.get(ref.cdata, ("?",) * 4))
                     for ref, n in self._live if not ref.expired()]
            self.snapshot = alive
            self.snapshot_bytes = self._live_bytes

    def _sweep(self) -> None:
        super()._sweep()
        alive = {ref.cdata for ref, _ in self._live}
        self._meta = {k: v for k, v in self._meta.items() if k in alive}


def grouped(snapshot, top: int) -> list[dict]:
    groups: dict[tuple, list] = collections.defaultdict(lambda: [0, 0])
    for n, meta in snapshot:
        groups[meta][0] += 1
        groups[meta][1] += n
    largest = heapq.nlargest(top, groups.items(), key=lambda kv: kv[1][1])
    return [{"op": m[0], "node": m[1], "shape": list(m[2]), "dtype": m[3],
             "count": c, "bytes": b} for m, (c, b) in largest]


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--arch", required=True)
    parser.add_argument("--shape", required=True)
    parser.add_argument("--mesh", default="single",
                        choices=["single", "multi"])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--top", type=int, default=25)
    parser.add_argument("--json", type=Path, default=None)
    args = parser.parse_args()

    made = []

    def analyzer():
        made.append(SnapshotAnalyzer())
        return made[-1]

    hlo_analysis.Analyzer = analyzer
    with tempfile.TemporaryDirectory() as out:
        record = dryrun.run_cell(args.arch, args.shape, args.mesh, out,
                                 skip_existing=False, device=args.device)
    mode = made[-1]
    live = sum(n for n, _ in mode.snapshot)
    result = {"arch": args.arch, "shape": args.shape, "mesh": args.mesh,
              "per_device_bytes": record["per_device_bytes"],
              "memory_analysis": record["memory_analysis"],
              "snapshot_tracked_bytes": mode.snapshot_bytes,
              "snapshot_live_bytes": live,
              "largest": grouped(mode.snapshot, args.top)}
    for g in result["largest"]:
        print(f"  {g['bytes']:>15,d} B  x{g['count']:<4d} {g['op']} "
              f"[{g['node']}] {g['shape']} {g['dtype']}")
    print(json.dumps({k: v for k, v in result.items() if k != "largest"}))
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
