"""Helpers: run the benchmark's entry script in a subprocess."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
TINY = ["--device", "cpu", "--block-bytes", "4096"]


def run(args, root: Path = ROOT, timeout: float = 240) -> tuple[int, list[str], list[str]]:
    """(exit code, stdout lines, stderr lines) of `run.py args`."""
    proc = subprocess.run([sys.executable, str(root / "portbench" / "run.py"), *args],
                          capture_output=True, text=True, timeout=timeout, cwd=root)
    return proc.returncode, proc.stdout.splitlines(), proc.stderr.splitlines()


def result(args, root: Path = ROOT) -> tuple[dict, list[str]]:
    """The result line of a run that exits 0, and its stderr lines."""
    code, out, err = run(args, root)
    assert code == 0, "\n".join(err[-30:])
    return json.loads(out[-1]), err


def cell_args(cell: str, seed: int = 2**31 + 7, seconds: float = 1.0,
              trace: int = 0) -> list[str]:
    return ["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
            "--trace", str(trace), *TINY]
