"""The batched stripe reconstruct's CUDA source, run on the CPU by emulation.

`scripts/emulate_stripe_repair.py` compiles `csrc/gf256_matmul.cu` with
g++ against the event-loop emulation's stub CUDA runtime (a `std::thread`
a CUDA thread, `__syncthreads` a barrier) and passes `chip_smoke.py`'s
small batches of phase 2 through `gf256_reconstruct_stripes_launch`: one
and two lost rows mixed, rows of 1, 17, 4096 and 4099 bytes in a byte
space of two buffers, helper rows aligned, all 3 bytes past alignment, or
0, 1 and 3 bytes past it mixed (4-byte groups over the row, more items
than one pass of a stripe's blocks takes), destination rows among rows
that must stay as they were. Every launch must give the plain version's
bytes, write its rows and change no byte outside them, in batches of 1,
4 and 37 stripes. The card runs the same batches and the full-width load
layouts in `chip_smoke.py` phase 2. Skipped where g++ 11 or later is
missing.
"""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "scripts" / "emulate_stripe_repair.py"
SIZES = (1, 17, 4096, 4099)
CASES = [f"S={s} n={n} misalign={m}" for s in (1, 4, 37) for n in SIZES
         for m in ((0,), (3,), (0, 1, 3))]


def _gxx_major(gxx: str) -> int:
    out = subprocess.run([gxx, "-dumpversion"], capture_output=True,
                         text=True, timeout=60)
    return int(out.stdout.strip().split(".")[0] or 0)


@pytest.fixture(scope="module")
def runs(tmp_path_factory) -> list:
    """The rows of two emulated runs, and whether each refused a launch
    of no stripes."""
    gxx = shutil.which("g++")
    if gxx is None or _gxx_major(gxx) < 11:
        pytest.skip("the emulation needs g++ 11 or later (C++20 barriers)")
    tmp = tmp_path_factory.mktemp("emulated")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), *filter(None, [os.environ.get("PYTHONPATH")])]))
    sizes = [str(n) for n in SIZES]
    argvs = (["--stripes", "1", "4", "--sizes", *sizes],
             ["--stripes", "37", "--sizes", *sizes])
    procs = [(tmp / f"run{i}.json", subprocess.Popen(
        [sys.executable, str(SCRIPT), *argv, "--json", str(tmp / f"run{i}.json")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env))
        for i, argv in enumerate(argvs)]
    out = []
    for path, proc in procs:
        log, _ = proc.communicate(timeout=600)
        assert path.exists(), log[-4000:]
        out.append(json.loads(path.read_text()))
    return out


@pytest.mark.parametrize("label", CASES)
def test_emulated_kernel_equals_the_plain_version(runs, label):
    got = [r for run in runs for r in run["rows"] if r["label"] == label]
    assert len(got) == 1
    row = got[0]
    assert row["launch"] == 0
    assert row["same"], row
    assert row["untouched"] and row["rows_written"], row


def test_a_launch_of_no_stripes_is_refused(runs):
    assert all(run["refused"] for run in runs)
