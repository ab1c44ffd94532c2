"""The port's single-failure repair path as a whole, held against repro.

The repair-demo scenario (RS(6,3), Aliyun Table III matrix, markov churn,
128 MB chunks) runs through both packages; the BMF plan's repair executes
over real bytes in both, and the reconstructed bytes, `verified` and
`bytes_moved` must be identical. Also: the port imports neither `jax` nor
`repro`, and an entry point given no device on a machine without a card
raises instead of running on the CPU.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import bandwidth as jbw
from repro.core import executor as jexecutor
from repro.core import simulator as jsim
from repro.core import topology as jtopo
from repro.core.plan import Job as JJob
from repro.core.plan import RepairPlan as JRepairPlan
from repro.core.plan import Round as JRound
from repro.core.plan import Transfer as JTransfer
from repro.ec.rs import RSCode as JRSCode
from repro_torch import convert
from repro_torch.core import bandwidth, executor, simulator
from repro_torch.ec.rs import RSCode

SRC = Path(__file__).resolve().parent.parent / "src"


def _demo(bw_mod, sim_mod, rs):
    _, bw = jtopo.aliyun_matrix()
    bwp = bw_mod.BandwidthProcess(base=bw, change_interval=2.0, mode="markov",
                                  sigma=1.0, rho=0.9, seed=15)
    return sim_mod.Scenario(num_nodes=6, code=rs(6, 3), failed=(0,), bw=bwp,
                            ingress=bw_mod.IngressModel(seed=15, duplex=0.5),
                            chunk_mb=128)


@pytest.fixture(scope="module")
def demo_results():
    sc = _demo(bandwidth, simulator, RSCode)
    jsc = _demo(jbw, jsim, JRSCode)
    out = {}
    for scheme in ("traditional", "ppr", "ppt", "bmf"):
        out[scheme] = (simulator.RepairSimulator(sc).run(scheme),
                       jsim.RepairSimulator(jsc).run(scheme))
    return out


@pytest.mark.parametrize("scheme", ["traditional", "ppr", "ppt", "bmf"])
def test_demo_schemes_match(demo_results, scheme):
    got, want = demo_results[scheme]
    np.testing.assert_allclose(got.total_time, want.total_time, rtol=1e-6)
    assert got.num_rounds == want.num_rounds and got.log == want.log
    if want.plan is not None:
        assert [[t.path for t in r.transfers] for r in got.plan.rounds] == \
            [[t.path for t in r.transfers] for r in want.plan.rounds]


@pytest.mark.parametrize("nbytes", [4096, 4099])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_bmf_repair_bytes_identical(demo_results, nbytes, use_kernel):
    got_sim, want_sim = demo_results["bmf"]
    rng = np.random.default_rng(nbytes)
    data = rng.integers(0, 256, size=(3, nbytes), dtype=np.uint8)
    want_cw = JRSCode(6, 3).encode(data)
    want = jexecutor.execute_plan(want_sim.plan, JRSCode(6, 3), want_cw,
                                  use_kernel=use_kernel)
    code = RSCode(6, 3)
    cw = code.encode(convert.codeword_to_device(data, "cpu"))
    assert np.array_equal(cw.numpy(), want_cw)
    got = executor.execute_plan(got_sim.plan, code, cw, use_kernel=use_kernel,
                                device="cpu")
    assert got.verified is True and want.verified is True
    assert got.bytes_moved == want.bytes_moved
    assert got.reconstructed.keys() == want.reconstructed.keys()
    for job_id, block in got.reconstructed.items():
        assert block.device.type == "cpu"
        assert np.array_equal(block.numpy(), want.reconstructed[job_id])
    # the reference's own plan, carried across, executes identically
    carried = executor.execute_plan(convert.plan_from_reference(want_sim.plan),
                                    code, want_cw, device="cpu")
    assert carried.verified and carried.bytes_moved == want.bytes_moved


def _plans(mod_job, mod_round, mod_transfer, mod_plan):
    job = mod_job(job_id=0, failed_node=0, requestor=0, helpers=(1, 2, 3))
    # node 1 forwards its fragment in round 0, then is asked to send again
    rounds = [mod_round(transfers=[mod_transfer(1, 2, 0, frozenset({1}))]),
              mod_round(transfers=[mod_transfer(1, 0, 0, frozenset({1}))])]
    consumed = mod_plan(jobs=[job], rounds=rounds)
    return consumed, job


def test_value_error_paths_reproduce():
    from repro_torch.core.plan import Job, RepairPlan, Round, Transfer

    cw = np.random.default_rng(0).integers(0, 256, size=(6, 64), dtype=np.uint8)
    consumed, job = _plans(Job, Round, Transfer, RepairPlan)
    jconsumed, jjob = _plans(JJob, JRound, JTransfer, JRepairPlan)
    with pytest.raises(ValueError, match="holds no buffer") as ours:
        executor.execute_plan(consumed, RSCode(6, 3), cw, device="cpu")
    with pytest.raises(ValueError, match="holds no buffer") as theirs:
        jexecutor.execute_plan(jconsumed, JRSCode(6, 3), cw)
    assert str(ours.value) == str(theirs.value)

    block_of = np.array([0, 1, -1, 3, 4, 5])      # helper 2 holds no block
    plan = RepairPlan(jobs=[job], rounds=[])
    jplan = JRepairPlan(jobs=[jjob], rounds=[])
    with pytest.raises(ValueError, match="holds no block") as ours:
        executor.execute_plan(plan, RSCode(6, 3), cw, block_of=block_of,
                              device="cpu")
    with pytest.raises(ValueError, match="holds no block") as theirs:
        jexecutor.execute_plan(jplan, JRSCode(6, 3), cw, block_of=block_of)
    assert str(ours.value) == str(theirs.value)


def test_port_imports_neither_jax_nor_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "             or n == 'repro' or n.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "for m in ('repro_torch.serve.serve_step', 'repro_torch.launch.serve',\n"
        "          'repro_torch.launch.cells', 'repro_torch.models.transformer'):\n"
        "    assert m in sys.modules, m\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_device_none_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sc = _demo(bandwidth, simulator, RSCode)
    plan = simulator.run_scheme(sc, "bmf").plan
    code = RSCode(6, 3)
    cw = code.encode(torch.zeros((3, 32), dtype=torch.uint8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        executor.execute_plan(plan, code, cw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.codeword_to_device(cw.numpy())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        executor.execute_plan(plan, code, cw, device="cuda")
