"""Time the EC checkpoint's load stage by stage at full width.

    python3 scripts/bench_checkpoint_load.py [--root DIR] [--lost 1,5 3]
        [--staging pageable pinned pinned pageable] [--json PATH]

Builds phase 7's state of `chip_smoke.py` on the card (smollm_360m at full
width with its AdamW moments, 3,618,211,204 bytes, from the train
launcher's init at seed 0), saves it through the train launcher's
checkpointer (RS(6,4), 256 KiB chunks, 8 failure domains) into a
temporary directory, then loads it with each `--lost` set of domains
lost, in turns over `--staging`: `pinned` reads the domain files into
pinned host memory (the load's own `_host_buffer`), `pageable` into plain
numpy memory (`_host_buffer` replaced here). Prints each load's stages
(`last_load`), its wall time, its peak device memory above what was
held before it (`max_memory_allocated`; the template state among what
was held) and that peak over the state's bytes, the stripes it repaired
and the kernel launches it made, and fails if a restored leaf differs
from the state.
`--root` imports `chip_smoke` and `repro_torch` from another checkout
(for example `git archive <commit> | tar -x -C build/parent`), so one
call on one card can time an older load beside this one; a checkout
without `_host_buffer` runs its own load whatever `--staging` says.
Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", type=Path,
                        default=Path(__file__).resolve().parents[1])
    parser.add_argument("--lost", nargs="+", default=["1,5", "3"],
                        help="domains lost by each load, comma-separated")
    parser.add_argument("--staging", nargs="+",
                        default=["pageable", "pinned", "pinned", "pageable"],
                        choices=("pinned", "pageable"))
    parser.add_argument("--json", type=Path, default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_checkpoint_load: torch.cuda.is_available() "
                         "is false")
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import chip_smoke
    from repro_torch.checkpoint import ECCheckpointer
    from repro_torch.launch import train as train_launch
    from repro_torch.train.train_step import init_state

    smi = chip_smoke.nvidia_smi("name,power.limit")
    pinned_buffer = getattr(ECCheckpointer, "_host_buffer", None)
    work = Path(tempfile.mkdtemp(prefix="bench_load_"))
    records = []
    try:
        largs = train_launch.parse_args([*chip_smoke.TRAIN_ARGS, "--ckpt-dir",
                                         str(work), "--device", "cuda"])
        cfg, _, tcfg = train_launch.configs(largs)
        state = init_state(largs.seed, cfg, tcfg, device="cuda")
        ck = train_launch.checkpointer(largs, "cuda")
        tic = time.perf_counter()
        ck.save(1, state, wait=True)
        state_bytes = sum(x.numel() * x.element_size()
                          for x in chip_smoke.tree.leaves(state))
        print(f"{smi}; root {root}; save {time.perf_counter() - tic:.3f} s: "
              + json.dumps(ck.last_save))
        for staging in args.staging:
            if pinned_buffer is not None:
                ECCheckpointer._host_buffer = (
                    pinned_buffer if staging == "pinned"
                    else lambda self, n: np.empty(n, dtype=np.uint8))
            for lost in args.lost:
                domains = tuple(int(x) for x in lost.split(","))
                chip_smoke.reset_launches()
                torch.cuda.synchronize()
                held = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                tic = time.perf_counter()
                restored, report = ck.load(state, lost_domains=domains)
                torch.cuda.synchronize()
                wall = time.perf_counter() - tic
                peak = torch.cuda.max_memory_allocated() - held
                launches = {k: v for k, v in chip_smoke.read_launches().items()
                            if v}
                if not chip_smoke.same_bytes(restored, state):
                    raise AssertionError(f"load {domains}: a leaf differs")
                del restored
                torch.cuda.empty_cache()
                rec = dict(root=str(root), nvidia_smi=smi,
                           staging=staging if pinned_buffer else "own",
                           lost=list(domains), load_wall_s=wall,
                           peak_bytes=peak, state_bytes=state_bytes,
                           peak_over_state=peak / state_bytes,
                           stages_s=dict(ck.last_load),
                           stripes_repaired=report.stripes_repaired,
                           blocks_repaired=report.blocks_repaired,
                           launches=launches)
                print(json.dumps(rec))
                records.append(rec)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(records, indent=1))


if __name__ == "__main__":
    main()
