"""The port's example programs (`examples/torch_*.py`) held against the
JAX package's (`examples/*.py`) on the CPU, by their printed lines.

* repair demo, sweep demo, vectorized sweep: the same lines, with only
  the wall-clock numbers masked (planning milliseconds, `plan=` columns,
  the throughput lines' timings). The plans, simulated times, BMF's
  reroute log, the repaired bytes, `byte-exact: True` and the network
  bytes moved are equal to the printed digit.
* device sweep: the reference (`examples/jax_sweep.py`) cannot run on
  jax 0.9, so its parity line is held to 1e-6 and its summary table to
  the reference's `run_sweep(executor="serial")` table of the same suite,
  masked; no batch leaves the device stepper.
* quickstart and multinode recovery: the same lines once every decimal
  number is masked (the steps printed, the checkpoint line, the blocks
  and stripes repaired, the rounds, the elastic batch, the restored step,
  `done.`); the priced repairs equal the reference's at rtol 1e-6; the
  losses are finite and not compared, since the packages draw their
  initial params from different generators.
* serve demo: a 4x16 block of in-range tokens for each arch (greedy
  parity with the reference is `tests/test_torch_serve.py`'s).
* every example: importing it pulls in neither `jax` nor `repro`, and
  `main()` with no device raises without a card.

The torch side runs on one thread: its tiny eager ops are slower than
their thread pool's hand-offs when other processes hold the cores.
"""
import contextlib
import importlib.util
import io
import json
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.sim import MonteCarloSuite, SampleSpace, run_sweep

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
PORTS = ("repair_demo", "device_sweep", "quickstart", "multinode_recovery",
         "serve_demo", "sweep_demo", "vectorized_sweep")
FLOAT = r"-?\d+\.\d+(e[+-]\d+)?"
RTOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _printed(name: str, **kw) -> list[str]:
    """The lines `main` of `examples/<name>.py` prints."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        _load(name).main(**kw)
    return out.getvalue().splitlines()


def _port(name: str) -> list[str]:
    return _printed(f"torch_{name}", device="cpu")


def _masked(lines, pattern, repl="X") -> list[str]:
    return [re.sub(pattern, repl, line) for line in lines]


def _floats(lines, pattern) -> list[float]:
    return [float(x) for line in lines for x in re.findall(pattern, line)]


# ------------------------------------------------- host-exact examples
def test_repair_demo_matches_reference():
    got, want = _port("repair_demo"), _printed("repair_demo")
    plan_ms = r"planning \d+\.\d+ ms"
    assert _masked(got, plan_ms) == _masked(want, plan_ms)
    assert got[-1] == ("  reconstructed 65536 bytes, byte-exact: True, "
                       "network bytes moved: 327680")


def test_sweep_demo_matches_reference():
    got, want = _port("sweep_demo"), _printed("sweep_demo")
    plan = r"plan=\d+\.\d+ms \(\d+\.\d+%\)"
    assert _masked(got, plan) == _masked(want, plan)
    assert len(got) > 20


def test_vectorized_sweep_matches_reference():
    got, want = _port("vectorized_sweep"), _printed("vectorized_sweep")
    plan = r"plan=\d+\.\d+ms \(\d+\.\d+%\)"
    timing = ("execution-bound", "planner-bound")

    def masked(lines):
        return [re.sub(r"\d+(\.\d+)?", "X", line)
                if line.startswith(timing) else line
                for line in _masked(lines, plan)]

    assert masked(got) == masked(want)
    assert "  decompile(compile_plan(plan)) == plan  ✓" in got
    assert sum(line.startswith(timing) for line in got) == 2


def test_device_sweep_matches_serial_reference():
    got = _port("device_sweep")
    parity = [line for line in got if line.startswith("16-case sweep")]
    assert parity and float(parity[0].rsplit("= ", 1)[1]) < RTOL
    space = SampleSpace(
        codes=((6, 3), (7, 4)), cluster_sizes=(10,), chunk_mb=(8.0,),
        regimes=("hot2s",), failure_patterns=("single", "double"),
    )
    suite = MonteCarloSuite("jaxdemo", 16, space, base_seed=3)
    table = run_sweep(suite, executor="serial").summary_table().splitlines()
    plan = r"plan=\d+\.\d+ms \(\d+\.\d+%\)"
    start = got.index(parity[0]) + 1
    assert _masked(got[start:start + len(table)], plan) == \
        _masked(table, plan)
    assert got[start + len(table) + 1].startswith(
        "execution-bound 24-case suite (warm): numpy vectorized ")
    routes = re.fullmatch(r"device stepper routes: (\d+) device batches, "
                          r"(\d+) host batches, (\d+) host syncs", got[-1])
    assert routes and int(routes.group(1)) > 0 and routes.group(2) == "0"


# ----------------------------------------------------- model examples
def _model_lines_match(got, want, priced):
    """Equal lines with decimals masked; the priced repair times (the
    `priced` pattern's numbers) equal at RTOL; every loss finite."""
    assert _masked(got, FLOAT) == _masked(want, FLOAT)
    assert _floats(got, priced)
    np.testing.assert_allclose(_floats(got, priced), _floats(want, priced),
                               rtol=RTOL)
    losses = _floats(got, r"loss (-?(?:\d+\.\d+|nan|inf))")
    assert losses and all(math.isfinite(x) for x in losses)


def test_quickstart_matches_reference_structure():
    got, want = _port("quickstart"), _printed("quickstart")
    _model_lines_match(got, want, r"rounds, (\d+\.\d+)s simulated")
    assert "  repaired 4 blocks across 4 stripes" in got
    assert "  restored train state at step 61 — resuming" in got
    assert got[-1] == "done."


def test_multinode_recovery_matches_reference_structure():
    got = _port("multinode_recovery")
    want = _printed("multinode_recovery")
    _model_lines_match(got, want, r"(?:msrepair|m-ppr) (\d+\.\d+)s")
    assert "   checkpoint repaired: 2 blocks, byte-verified" in got
    assert "   elastic re-mesh: 14 hosts remain, global batch 16 -> 14" in got
    assert got[-1] == "done."


def test_serve_demo_generates_in_range_tokens():
    from repro_torch.configs import get_arch
    got = _port("serve_demo")
    assert len(got) == 3
    for line, arch in zip(got, ("qwen2_15b", "rwkv6_16b", "zamba2_7b")):
        m = re.fullmatch(rf"{arch} +generated 4x16 tokens in +{FLOAT}s — "
                         r"sample: \[([\d, ]+)\]", line)
        assert m, line
        tokens = [int(t) for t in m.group(2).split(",")]
        vocab = get_arch(arch).reduced().vocab_size
        assert len(tokens) == 8 and all(0 <= t < vocab for t in tokens)


# ----------------------------------------------------------- every port
@pytest.fixture(scope="module")
def imported_modules():
    """For each port, in turn in one process: the modules of `jax` or
    `repro` that importing it pulled in."""
    code = (
        "import importlib.util, json, sys\n"
        "out = {}\n"
        f"for name in {list(PORTS)!r}:\n"
        f"    path = {str(EXAMPLES)!r} + f'/torch_{{name}}.py'\n"
        "    spec = importlib.util.spec_from_file_location(name, path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "    out[name] = sorted(m for m in sys.modules if m.split('.')[0]\n"
        "                      in ('jax', 'jaxlib', 'repro'))\n"
        "print(json.dumps(out))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(EXAMPLES.parent / "src")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.splitlines()[-1])


@pytest.mark.parametrize("name", PORTS)
def test_port_imports_neither_jax_nor_repro(imported_modules, name):
    assert imported_modules[name] == []


@pytest.mark.parametrize("name", PORTS)
def test_port_without_a_card_raises(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load(f"torch_{name}").main()
