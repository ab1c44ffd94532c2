"""repro_torch.core.simulator held against repro.core.simulator.

Simulated times within rtol=1e-6 (the reference's own parity bar; the same
numpy float64 code gives them exactly), identical rounds, relays, logs and
executed plans, for all 8 schemes under jitter, redraw and markov churn.
`planning_time` is wall-clock and not compared.
"""
import numpy as np
import pytest

from repro.core import bandwidth as jbw
from repro.core import ppt as jppt
from repro.core import simulator as jsim
from repro.core import topology as jtopo
from repro.ec.rs import RSCode as JRSCode
from repro_torch.core import bandwidth, ppt, simulator
from repro_torch.ec.rs import RSCode


def norm_plan(p):
    """A RepairPlan (either package) as plain tuples, for equality."""
    return (tuple((j.job_id, j.failed_node, j.requestor, tuple(j.helpers))
                  for j in p.jobs),
            tuple(tuple((t.src, t.dst, t.job, tuple(sorted(t.terms)),
                         tuple(t.path)) for t in rnd.transfers)
                  for rnd in p.rounds),
            dict(p.meta))


def _scenario(bw_mod, sim_mod, rs, mode, failed):
    base = jtopo.heterogeneous_matrix(9, low=3, high=30, seed=2)
    bwp = bw_mod.BandwidthProcess(base=base, change_interval=2.0, mode=mode,
                                  seed=5)
    return sim_mod.Scenario(num_nodes=9, code=rs(7, 4), failed=failed, bw=bwp,
                            ingress=bw_mod.IngressModel(seed=5), chunk_mb=8.0)


@pytest.mark.parametrize("mode", ["jitter", "redraw", "markov"])
@pytest.mark.parametrize("scheme", jsim.ALL_SCHEMES)
def test_run_scheme_matches(scheme, mode):
    failed = (0, 3) if scheme in jsim.MULTI_SCHEMES else (2,)
    sc = _scenario(bandwidth, simulator, RSCode, mode, failed)
    jsc = _scenario(jbw, jsim, JRSCode, mode, failed)
    got = simulator.RepairSimulator(sc, random_seed=3).run(scheme)
    want = jsim.RepairSimulator(jsc, random_seed=3).run(scheme)
    np.testing.assert_allclose(got.total_time, want.total_time, rtol=1e-6)
    np.testing.assert_allclose(got.round_times, want.round_times, rtol=1e-6)
    assert got.num_rounds == want.num_rounds
    assert got.relay_hops == want.relay_hops
    assert got.log == want.log
    if want.plan is None:
        assert got.plan is None
    else:
        assert norm_plan(got.plan) == norm_plan(want.plan)


@pytest.mark.parametrize("mode", ["jitter", "markov"])
def test_round_and_pipeline_engines_match(mode):
    sc = _scenario(bandwidth, simulator, RSCode, mode, (1,))
    jsc = _scenario(jbw, jsim, JRSCode, mode, (1,))
    job, jjob = sc.make_jobs()[0], jsc.make_jobs()[0]
    rnd = simulator.plan_for_scheme("traditional", [job]).rounds[0]
    jrnd = jsim.plan_for_scheme("traditional", [jjob]).rounds[0]
    assert simulator.execute_round(rnd.transfers, 0.5, sc.bw, sc.ingress, 8.0) \
        == jsim.execute_round(jrnd.transfers, 0.5, jsc.bw, jsc.ingress, 8.0)
    tree = ppt.build_ppt_tree(job, sc.bw.matrix_at(0.0))
    jtree = jppt.build_ppt_tree(jjob, jsc.bw.matrix_at(0.0))
    assert simulator.execute_pipeline(tree, 0.0, sc.bw, sc.ingress, 8.0) == \
        jsim.execute_pipeline(jtree, 0.0, jsc.bw, jsc.ingress, 8.0)
    assert simulator.pipeline_fill_latency(tree, sc.bw.matrix_at(0.0), 8.0) == \
        jsim.pipeline_fill_latency(jtree, jsc.bw.matrix_at(0.0), 8.0)


def test_bmf_optimize_all_matches():
    sc = _scenario(bandwidth, simulator, RSCode, "markov", (0,))
    jsc = _scenario(jbw, jsim, JRSCode, "markov", (0,))
    got = simulator.run_scheme(sc, "bmf", bmf_optimize_all=True)
    want = jsim.run_scheme(jsc, "bmf", bmf_optimize_all=True)
    assert got.total_time == want.total_time and got.log == want.log
    assert simulator.ALL_SCHEMES == jsim.ALL_SCHEMES
