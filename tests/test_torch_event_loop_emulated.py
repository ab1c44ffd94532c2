"""The event-loop kernels' CUDA source, run on the CPU by emulation.

`scripts/emulate_event_loop.py` compiles `csrc/event_loop.cu` with g++
against a stub CUDA runtime (a `std::thread` a CUDA thread; block
barriers, and the warp route's votes, shuffles, `__match_any_sync`,
`__reduce_max_sync` and `__syncwarp` through per-warp exchanges that
abort on a mask a lane is not in or that its lanes name differently) and
passes event-loop calls through its launch functions on both routes. Each
must give the plain version's packed output bit for bit (end clocks, step
counts, no flag), or raise the same error from its flags: here the calls
of small CPU sweeps of phase 6's suites, and `chip_smoke.py`'s hand-made
batches of phase 2 at three cases each, the two above the warp route's 32
lanes included (which the warp route must refuse). The card runs the same
checks at full size in `chip_smoke.py` phase 2. Skipped where g++ 11 or
later is missing.
"""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "scripts" / "emulate_event_loop.py"
ROUTES = ("warp", "block")
ROUND, TREE = "round_events", "pipeline_events"
HAND = ((ROUND, "hand R=1 T=13 H=1"), (ROUND, "hand R=1 T=9 H=4"),
        (ROUND, "hand R=6 T=12 H=3"), (TREE, "hand tree zero"),
        (TREE, "hand tree flat"), (TREE, "hand tree mixed"),
        (TREE, "hand tree deep"), (TREE, "hand tree scrambled"),
        (ROUND, "hand horizon overflow"),
        (TREE, "hand horizon overflow"), (ROUND, "hand guard 3"),
        (TREE, "hand guard 3"), (ROUND, "hand N=48 R=2 T=40 H=3"),
        (TREE, "hand N=48 tree mixed"))
ABOVE_WARP = ("hand N=48 R=2 T=40 H=3", "hand N=48 tree mixed")


def _gxx_major(gxx: str) -> int:
    out = subprocess.run([gxx, "-dumpversion"], capture_output=True,
                         text=True, timeout=60)
    return int(out.stdout.strip().split(".")[0] or 0)


@pytest.fixture(scope="module")
def rows(tmp_path_factory) -> list:
    """Every (call, route) row of one emulated run."""
    gxx = shutil.which("g++")
    if gxx is None or _gxx_major(gxx) < 11:
        pytest.skip("the emulation needs g++ 11 or later (C++20 barriers)")
    out = tmp_path_factory.mktemp("emulated") / "rows.json"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), *filter(None, [os.environ.get("PYTHONPATH")])]))
    run = subprocess.run(
        [sys.executable, str(SCRIPT), "--cases", "8", "4", "4", "--hand", "3",
         "--json", str(out)], capture_output=True, text=True, env=env,
        timeout=600)
    assert out.exists(), run.stdout[-4000:] + run.stderr[-4000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("name", [ROUND, TREE])
def test_recorded_sweep_calls_equal_the_plain_version(rows, name, route):
    got = [r for r in rows if " call " in r["label"] and r["name"] == name
           and r["route"] == route]
    assert got, f"the sweeps made no {name} call"
    assert all(r["lanes"] <= 32 for r in got)
    assert [r for r in got if not r["same"]] == []
    assert any(r["result"].startswith("chain") for r in got)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("name,label", HAND)
def test_hand_batches_equal_the_plain_version(rows, name, label, route):
    got = [r for r in rows if r["label"] == label and r["name"] == name
           and r["route"] == route]
    assert len(got) == 1
    row = got[0]
    assert row["same"], row
    if label in ABOVE_WARP and route == "warp":
        assert row["result"] == "refused"
    elif "overflow" in label:
        assert row["result"] == "raised EpochHorizonError"
    elif "guard" in label:
        assert row["result"] == "raised RuntimeError"
    else:
        assert row["result"].startswith("chain")
