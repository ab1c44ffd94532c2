"""Peak device memory of full-width train steps, from a given checkout.

    python3 scripts/train_peak_memory.py [--root DIR] [--arch whisper_medium]
                                         [--json PATH]

Runs `chip_smoke.family_train` (phase 9d of `chip_smoke.py`: B=8, three
AdamW steps at full width on the synthetic stream, then one more step
traced) for each `--arch`, importing `chip_smoke` and `repro_torch` from
`--root` (default: the checkout this script is in). So one call on one
card can run a checkout and an older one unpacked beside it (for example
`git archive <commit> | tar -x -C build/parent`), in turns, and compare
them. Prints, per run, the card's name and power limit, the root, the
losses, the median step time and `torch.cuda.max_memory_allocated` over
the init and the three steps. Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", type=Path,
                        default=Path(__file__).resolve().parents[1])
    parser.add_argument("--arch", nargs="+", default=["whisper_medium"])
    parser.add_argument("--json", type=Path, default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("train_peak_memory: torch.cuda.is_available() is "
                         "false")
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import chip_smoke

    smi = chip_smoke.nvidia_smi("name,power.limit")
    records = []
    for arch in args.arch:
        rec = chip_smoke.family_train(arch, chip_smoke.FAMILY_TRAIN[arch],
                                      "cuda")
        rec = {k: v for k, v in rec.items() if k != "profile"}
        rec.update(root=str(root), nvidia_smi=smi)
        print(json.dumps(rec))
        records.append(rec)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(records, indent=1))


if __name__ == "__main__":
    main()
