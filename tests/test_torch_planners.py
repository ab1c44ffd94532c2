"""repro_torch.core planners and bandwidth held against repro.core (exact)."""
import dataclasses

import numpy as np
import pytest

from repro.core import bandwidth as jbw
from repro.core import bmf as jbmf
from repro.core import msrepair as jmsrepair
from repro.core import plan as jplan
from repro.core import ppt as jppt
from repro.core import simulator as jsim
from repro.core import topology as jtopo
from repro.core.engine import planner_arrays as jpa
from repro.ec.rs import RSCode as JRSCode
from repro_torch import convert
from repro_torch.core import bandwidth, bmf, msrepair, plan, ppt, simulator, topology
from repro_torch.core.engine import planner_arrays as pa
from repro_torch.ec.rs import RSCode

TOPOLOGIES = {
    "aliyun": (lambda: jtopo.aliyun_matrix()[1], 6, (6, 3)),
    "hetero9": (lambda: jtopo.heterogeneous_matrix(9, low=3, high=30, seed=4),
                9, (7, 4)),
    "pod2x4": (lambda: jtopo.tpu_pod_dcn_matrix(4, 2, seed=1)[1], 8, (6, 3)),
}


def norm_plan(p):
    """A RepairPlan (either package) as plain tuples, for equality."""
    jobs = tuple((j.job_id, j.failed_node, j.requestor, tuple(j.helpers))
                 for j in p.jobs)
    rounds = tuple(
        tuple((t.src, t.dst, t.job, tuple(sorted(t.terms)), tuple(t.path))
              for t in rnd.transfers)
        for rnd in p.rounds)
    return jobs, rounds, dict(p.meta)


def _scenarios(topo, failed, mode="markov", seed=3):
    make, nodes, (n, k) = TOPOLOGIES[topo]
    base = make()
    out = []
    for bw_mod, sim_mod, rs in ((jbw, jsim, JRSCode), (bandwidth, simulator, RSCode)):
        bwp = bw_mod.BandwidthProcess(base=base, change_interval=2.0,
                                      mode=mode, seed=seed)
        out.append(sim_mod.Scenario(
            num_nodes=nodes, code=rs(n, k), failed=failed, bw=bwp,
            ingress=bw_mod.IngressModel(seed=seed), chunk_mb=16.0))
    return out


def test_topology_tables_equal():
    assert np.array_equal(topology.aliyun_matrix()[1], jtopo.aliyun_matrix()[1])
    got, want = topology.aliyun_matrix()[0], jtopo.aliyun_matrix()[0]
    assert (got.num_nodes, got.names) == (want.num_nodes, want.names)
    assert np.array_equal(topology.table1_matrix()[1], jtopo.table1_matrix()[1])
    assert np.array_equal(topology.uniform_matrix(5), jtopo.uniform_matrix(5))
    assert np.array_equal(topology.heterogeneous_matrix(7, seed=2),
                          jtopo.heterogeneous_matrix(7, seed=2))
    got, want = topology.tpu_pod_dcn_matrix(3, 2), jtopo.tpu_pod_dcn_matrix(3, 2)
    assert got[0].names == want[0].names and np.array_equal(got[1], want[1])


@pytest.mark.parametrize("mode", ["jitter", "redraw", "markov"])
def test_bandwidth_arrays_identical(mode):
    base = jtopo.heterogeneous_matrix(6, seed=1)
    kw = dict(base=base, change_interval=1.5, mode=mode, seed=9)
    got, want = bandwidth.BandwidthProcess(**kw), jbw.BandwidthProcess(**kw)
    for t in (0.0, 1.4, 1.5, 7.9, 60.0):
        assert np.array_equal(got.matrix_at(t), want.matrix_at(t))
        assert got.epoch_of(t) == want.epoch_of(t)
        assert got.epoch_end(t) == want.epoch_end(t)
    assert np.array_equal(got.sample_epochs(40, start_epoch=3),
                          want.sample_epochs(40, start_epoch=3))
    assert np.array_equal(got.epochs_prefix(37), want.epochs_prefix(37))
    assert np.array_equal(got.epochs_block(9)[1], want.epochs_block(9)[1])
    trace = bandwidth.BandwidthTrace.record(got, 5)
    jtrace = jbw.BandwidthTrace.record(want, 5)
    for t in (0.0, 4.0, 20.0):
        assert np.array_equal(trace.matrix_at(t), jtrace.matrix_at(t))


def test_ingress_model_identical():
    for persistent in (True, False):
        got = bandwidth.IngressModel(seed=5, persistent_shares=persistent)
        want = jbw.IngressModel(seed=5, persistent_shares=persistent)
        for m in (1, 2, 4):
            for epoch in (0, 3):
                assert np.array_equal(got.share_weights(m, 2, epoch),
                                      want.share_weights(m, 2, epoch))
        links = np.array([10.0, 30.0, 5.0])
        assert np.array_equal(got.effective_rates(links, 1, 0),
                              want.effective_rates(links, 1, 0))
        assert np.array_equal(
            got.node_allocations(links, ("rx", "tx", "rx"), 1, 0),
            want.node_allocations(links, ("rx", "tx", "rx"), 1, 0))


@pytest.mark.parametrize("topo", sorted(TOPOLOGIES))
@pytest.mark.parametrize("scheme", jsim.ALL_SCHEMES)
def test_plans_equal(topo, scheme):
    multi = scheme in jsim.MULTI_SCHEMES
    failed = (0, 2) if multi else (1,)
    jsc, sc = _scenarios(topo, failed)
    jobs, jjobs = sc.make_jobs(), jsc.make_jobs()
    assert [(j.failed_node, j.helpers) for j in jobs] == \
        [(j.failed_node, j.helpers) for j in jjobs]
    if scheme == "ppt":
        tree = ppt.build_ppt_tree(jobs[0], sc.bw.matrix_at(0.0))
        jtree = jppt.build_ppt_tree(jjobs[0], jsc.bw.matrix_at(0.0))
        assert tree.parent == jtree.parent and tree.children == jtree.children
        assert norm_plan(ppt.ppt_round_plan(tree)) == \
            norm_plan(jppt.ppt_round_plan(jtree))
        return
    static = simulator.plan_for_scheme(scheme, jobs, random_seed=7)
    jstatic = jsim.plan_for_scheme(scheme, jjobs, random_seed=7)
    assert norm_plan(static) == norm_plan(jstatic)
    # the plan the simulator executed, BMF reroutes included
    got = simulator.run_scheme(sc, scheme, random_seed=7).plan
    want = jsim.run_scheme(jsc, scheme, random_seed=7).plan
    assert norm_plan(got) == norm_plan(want)
    assert norm_plan(convert.plan_from_reference(want)) == norm_plan(want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bmf_search_and_round_optimizer_equal(seed):
    rng = np.random.default_rng(seed)
    bw = rng.uniform(1.0, 60.0, size=(8, 8))
    np.fill_diagonal(bw, 0.0)
    idle = [5, 6, 7, 4]
    assert bmf.find_min_time_path(0, 1, idle, bw, 16.0, np.inf) == \
        jbmf.find_min_time_path(0, 1, idle, bw, 16.0, np.inf)
    job = plan.Job(job_id=0, failed_node=0, requestor=0, helpers=(1, 2, 3))
    jjob = jplan.Job(job_id=0, failed_node=0, requestor=0, helpers=(1, 2, 3))
    for optimize_all in (False, True):
        rnd, stats = bmf.optimize_round(
            plan.Round(transfers=[plan.Transfer(1, 0, 0, frozenset({1})),
                                  plan.Transfer(3, 2, 0, frozenset({3}))]),
            bw, idle, 16.0, optimize_all=optimize_all)
        jrnd, jstats = jbmf.optimize_round(
            jplan.Round(transfers=[jplan.Transfer(1, 0, 0, frozenset({1})),
                                   jplan.Transfer(3, 2, 0, frozenset({3}))]),
            bw, idle, 16.0, optimize_all=optimize_all)
        assert [t.path for t in rnd.transfers] == [t.path for t in jrnd.transfers]
        assert dataclasses.asdict(stats) == dataclasses.asdict(jstats)
    assert pa.ppr_schedule(job) == jpa.ppr_schedule(jjob)


def test_multi_node_schedulers_equal():
    for n, k, failed in ((7, 4, [0, 1]), (9, 4, [0, 3, 5]), (6, 3, [2, 4])):
        helpers = msrepair.select_helpers_multi(n, k, failed)
        assert helpers == jmsrepair.select_helpers_multi(n, k, failed)
        jobs = [plan.Job(i, f, f, h) for i, (f, h) in enumerate(zip(failed, helpers))]
        jjobs = [jplan.Job(i, f, f, h) for i, (f, h) in enumerate(zip(failed, helpers))]
        assert pa.msrepair_schedule(jobs) == jpa.msrepair_schedule(jjobs)
        for seed in (0, 11):
            assert pa.random_schedule(jobs, seed=seed) == \
                jpa.random_schedule(jjobs, seed=seed)
        assert pa.mppr_schedule(jobs) == jpa.mppr_schedule(jjobs)
        assert msrepair.node_sets(jobs) == jmsrepair.node_sets(jjobs)
    assert pa.RANDOM_SCHEDULE_VERSION == jpa.RANDOM_SCHEDULE_VERSION == 2


def test_validate_plan_object_walk_and_fast_gap():
    job = plan.Job(job_id=0, failed_node=0, requestor=0, helpers=(1, 2))
    good = plan.RepairPlan(jobs=[job], rounds=[plan.Round(transfers=[
        plan.Transfer(1, 0, 0, frozenset({1})), plan.Transfer(2, 3, 0, frozenset({2}))]),
        plan.Round(transfers=[plan.Transfer(3, 0, 0, frozenset({2}))])])
    plan.validate_plan(good)
    plan.validate_plan(good, fast=False)
    # the gap is closed: fast=True takes the compiled PlanArrays path
    plan.validate_plan(good, fast=True)
    bad = plan.RepairPlan(jobs=[job], rounds=good.rounds[:1])
    for fast in (None, False, True):
        with pytest.raises(ValueError, match="does not complete"):
            plan.validate_plan(bad, fast=fast)
