"""repro_torch.core.engine.arrays held against repro.core.engine.arrays.

The same plans (every scheme, single and multiple failures, BMF-relayed
paths) are compiled by both packages and compared field for field, dtype
included; the transforms (`decompile`, `plan_arrays_from_schedule`,
`splice_path`, `relabel_plan_nodes`) and `validate_plan_arrays` must give
the same arrays, the same verdicts and the same error messages.
"""
import dataclasses
import types

import numpy as np
import pytest

from repro.core import bandwidth as jbw
from repro.core import bmf as jbmf
from repro.core import msrepair as jmsrepair
from repro.core import plan as jplan
from repro.core import ppr as jppr
from repro.core import ppt as jppt
from repro.core import simulator as jsim
from repro.core import topology as jtopo
from repro.core.engine import arrays as jarrays
from repro.core.engine import planner_arrays as jpa
from repro.ec.rs import RSCode as JRSCode
from repro_torch import convert
from repro_torch.core import bandwidth, bmf, msrepair, plan, ppr, ppt, simulator
from repro_torch.core.engine import arrays
from repro_torch.core.engine import planner_arrays as pa
from repro_torch.ec.rs import RSCode

PORT = types.SimpleNamespace(bw=bandwidth, bmf=bmf, msrepair=msrepair,
                             plan=plan, ppr=ppr, ppt=ppt, sim=simulator,
                             arrays=arrays, pa=pa, rs=RSCode)
REF = types.SimpleNamespace(bw=jbw, bmf=jbmf, msrepair=jmsrepair, plan=jplan,
                            ppr=jppr, ppt=jppt, sim=jsim, arrays=jarrays,
                            pa=jpa, rs=JRSCode)

SINGLE = ("traditional", "ppr", "bmf", "bmf_static", "ppt")
MULTI = ("mppr", "random", "msrepair")
CASES = ([(s, (2,)) for s in SINGLE]
         + [(s, f) for s in MULTI for f in ((1, 5), (0, 3, 6))])


def _scheme_plan(m, scheme, failed, seed=5, cluster=12):
    """The executed plan of `scheme` in package `m` (PPT through its
    store-and-forward lowering), on a churning heterogeneous cluster."""
    n, k = (6, 3) if len(failed) == 1 else (7, 4)
    base = jtopo.heterogeneous_matrix(cluster, low=3, high=30, seed=seed)
    bwp = m.bw.BandwidthProcess(base=base, change_interval=2.0, seed=seed,
                                mode="markov")
    sc = m.sim.Scenario(num_nodes=cluster, code=m.rs(n, k), failed=failed,
                        bw=bwp, ingress=m.bw.IngressModel(seed=seed),
                        chunk_mb=4.0)
    if scheme == "ppt":
        tree = m.ppt.build_ppt_tree(sc.make_jobs()[0], sc.bw.matrix_at(0.0))
        return m.ppt.ppt_round_plan(tree)
    return m.sim.run_scheme(sc, scheme, random_seed=seed).plan


def _relayed_plans(m):
    """PPR rounds rerouted by `bmf.optimize_round` through idle nodes:
    store-and-forward paths longer than one hop."""
    plans = []
    for seed in range(4):
        job = m.plan.Job(job_id=0, failed_node=0, requestor=0,
                         helpers=(1, 2, 3, 4))
        base = m.ppr.plan_ppr(job)
        bw = jtopo.heterogeneous_matrix(12, low=1, high=30, seed=seed)
        rounds = [m.bmf.optimize_round(r, bw, list(range(7, 12)), 16.0)[0]
                  for r in base.rounds]
        plans.append(m.plan.RepairPlan(jobs=base.jobs, rounds=rounds,
                                       meta={"scheme": "bmf", "seed": seed}))
    return plans


def _norm(p):
    jobs = tuple((j.job_id, j.failed_node, j.requestor, tuple(j.helpers))
                 for j in p.jobs)
    rounds = tuple(tuple((t.src, t.dst, t.job, tuple(sorted(t.terms)),
                          tuple(t.path)) for t in rnd.transfers)
                   for rnd in p.rounds)
    return jobs, rounds, dict(p.meta)


def assert_same_arrays(got, want):
    """Every `PlanArrays` field equal, numpy dtypes and shapes included."""
    assert type(got).__name__ == type(want).__name__ == "PlanArrays"
    for f in dataclasses.fields(arrays.PlanArrays):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert isinstance(a, np.ndarray), f.name
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            assert np.array_equal(a, b), f.name
        else:
            assert a == b, f.name


# ----------------------------------------------------------- compile_plan
@pytest.mark.parametrize("scheme,failed", CASES)
def test_compile_plan_fields_match_reference(scheme, failed):
    got_plan = _scheme_plan(PORT, scheme, failed)
    want_plan = _scheme_plan(REF, scheme, failed)
    assert _norm(got_plan) == _norm(want_plan)
    got = arrays.compile_plan(got_plan)
    want = jarrays.compile_plan(want_plan)
    assert_same_arrays(got, want)
    assert got.t_terms.dtype == np.uint64 and got.job_terms.dtype == np.uint64
    assert (got.num_jobs, got.num_rounds, got.num_transfers) == \
        (want.num_jobs, want.num_rounds, want.num_transfers)
    for r in range(got.num_rounds):
        for a, b in zip(got.round_hops(r), want.round_hops(r)):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("i", range(4))
def test_compile_relayed_bmf_paths_match_reference(i):
    got_plan, want_plan = _relayed_plans(PORT)[i], _relayed_plans(REF)[i]
    assert _norm(got_plan) == _norm(want_plan)
    got = arrays.compile_plan(got_plan)
    assert_same_arrays(got, jarrays.compile_plan(want_plan))
    assert arrays.decompile(got) == got_plan


def test_fixture_includes_relays_and_term_id_63():
    assert any(len(t.path) > 2 for p in _relayed_plans(PORT)
               for t in p.all_transfers())
    # bit 63 is the sign bit of an int64: the uint64 masks keep it exact
    job = plan.Job(job_id=0, failed_node=0, requestor=0, helpers=(63, 1))
    jjob = jplan.Job(job_id=0, failed_node=0, requestor=0, helpers=(63, 1))
    p = plan.RepairPlan(jobs=[job], rounds=[plan.Round(transfers=[
        plan.Transfer(63, 1, 0, frozenset({63}))]), plan.Round(transfers=[
            plan.Transfer(1, 0, 0, frozenset({63, 1}))])])
    jp = jplan.RepairPlan(jobs=[jjob], rounds=[jplan.Round(transfers=[
        jplan.Transfer(63, 1, 0, frozenset({63}))]), jplan.Round(transfers=[
            jplan.Transfer(1, 0, 0, frozenset({63, 1}))])])
    got = arrays.compile_plan(p)
    assert_same_arrays(got, jarrays.compile_plan(jp))
    assert int(got.job_terms[0]) == (1 << 63) | 2
    assert arrays.decompile(got) == p
    arrays.validate_plan_arrays(got)


@pytest.mark.parametrize("ids", [(1, 2, 64), (70, 1, 2)])
def test_compile_rejects_unmappable_term_ids_as_reference(ids):
    job = plan.Job(job_id=0, failed_node=0, requestor=0, helpers=ids)
    jjob = jplan.Job(job_id=0, failed_node=0, requestor=0, helpers=ids)
    with pytest.raises(arrays.UnsupportedPlanError) as ours:
        arrays.compile_plan(plan.RepairPlan(jobs=[job], rounds=[]))
    with pytest.raises(jarrays.UnsupportedPlanError) as theirs:
        jarrays.compile_plan(jplan.RepairPlan(jobs=[jjob], rounds=[]))
    assert str(ours.value) == str(theirs.value)


def test_compile_rejects_unknown_job_as_reference():
    job = plan.Job(job_id=0, failed_node=0, requestor=0, helpers=(1,))
    jjob = jplan.Job(job_id=0, failed_node=0, requestor=0, helpers=(1,))
    bad = plan.RepairPlan(jobs=[job], rounds=[plan.Round(transfers=[
        plan.Transfer(1, 0, 7, frozenset({1}))])])
    jbad = jplan.RepairPlan(jobs=[jjob], rounds=[jplan.Round(transfers=[
        jplan.Transfer(1, 0, 7, frozenset({1}))])])
    with pytest.raises(arrays.UnsupportedPlanError, match="unknown job"):
        arrays.compile_plan(bad)
    with pytest.raises(jarrays.UnsupportedPlanError, match="unknown job"):
        jarrays.compile_plan(jbad)


# ------------------------------------------------------------- decompile
@pytest.mark.parametrize("scheme,failed", CASES)
def test_decompile_roundtrip_and_carried_state(scheme, failed):
    got_plan = _scheme_plan(PORT, scheme, failed)
    want_pa = jarrays.compile_plan(_scheme_plan(REF, scheme, failed))
    assert arrays.decompile(arrays.compile_plan(got_plan)) == got_plan
    carried = convert.plan_arrays_from_reference(want_pa)
    assert_same_arrays(carried, want_pa)
    assert carried.t_path is not want_pa.t_path          # copies, not views
    assert _norm(arrays.decompile(carried)) == _norm(jarrays.decompile(want_pa))
    assert arrays.decompile(carried) == got_plan


def test_meta_and_helper_order_survive_roundtrip():
    jobs = [plan.Job(job_id=5, failed_node=1, requestor=1, helpers=(4, 2, 6))]
    p = plan.RepairPlan(jobs=jobs, rounds=[
        plan.Round(transfers=[plan.Transfer(4, 2, 5, frozenset({4}))]),
        plan.Round(transfers=[plan.Transfer(2, 6, 5, frozenset({4, 2}))]),
        plan.Round(transfers=[plan.Transfer(6, 1, 5, frozenset({4, 2, 6}))]),
    ], meta={"scheme": "custom", "note": [1, 2]})
    back = arrays.decompile(arrays.compile_plan(p))
    assert back == p and back.jobs[0].helpers == (4, 2, 6)
    assert back.meta == {"scheme": "custom", "note": [1, 2]}


# ------------------------------------------------ plan_arrays_from_schedule
def _schedules(m):
    jobs = [m.plan.Job(i, f, f, h) for i, (f, h) in enumerate(zip(
        (0, 3), m.msrepair.select_helpers_multi(7, 4, [0, 3])))]
    single = [m.plan.Job(0, 1, 1, (0, 2, 3, 5))]
    return [
        (single, m.pa.traditional_schedule(single[0])),
        (single, m.pa.ppr_schedule(single[0])),
        (jobs, m.pa.mppr_schedule(jobs)),
        (jobs, m.pa.msrepair_schedule(jobs)),
        (jobs, m.pa.random_schedule(jobs, seed=4)),
        ([m.plan.Job(3, 1, 1, (0, 2)), m.plan.Job(1, 4, 4, (5, 6))],
         [[(0, 1, 3, 1), (5, 4, 1, 32)], [(2, 1, 3, 4), (6, 4, 1, 64)]]),
    ]


@pytest.mark.parametrize("i", range(6))
def test_plan_arrays_from_schedule_matches_reference(i):
    jobs, rounds = _schedules(PORT)[i]
    jjobs, jrounds = _schedules(REF)[i]
    assert rounds == jrounds
    meta = {"scheme": f"sched{i}"}
    got = arrays.plan_arrays_from_schedule(jobs, rounds, meta)
    assert_same_arrays(got, jarrays.plan_arrays_from_schedule(jjobs, jrounds,
                                                              meta))
    arrays.validate_plan_arrays(got, max_recv_per_round=8)


@pytest.mark.parametrize("bad", [[[(1, 0, 9, 2)]], [[(1, 0, 0, 1 << 64)]]])
def test_plan_arrays_from_schedule_rejects_as_reference(bad):
    job = plan.Job(0, 0, 0, (1, 2))
    jjob = jplan.Job(0, 0, 0, (1, 2))
    with pytest.raises(arrays.UnsupportedPlanError) as ours:
        arrays.plan_arrays_from_schedule([job], bad, {})
    with pytest.raises(jarrays.UnsupportedPlanError) as theirs:
        jarrays.plan_arrays_from_schedule([jjob], bad, {})
    assert str(ours.value) == str(theirs.value)


# ----------------------------------------------------------- splice_path
def _splice_target(m):
    return m.arrays.compile_plan(_scheme_plan(m, "ppr", (2,)))


@pytest.mark.parametrize("extra", [(), (9,), (9, 11, 7)])
def test_splice_path_matches_reference(extra):
    got, want = _splice_target(PORT), _splice_target(REF)
    row = got.num_transfers - 1
    path = (int(got.t_src[row]), *extra, int(got.t_dst[row]))
    arrays.splice_path(got, row, path)
    jarrays.splice_path(want, row, path)
    assert_same_arrays(got, want)
    assert arrays.decompile(got).all_transfers()[row].path == path


@pytest.mark.parametrize("how", ["short", "endpoints", "cyclic"])
def test_splice_path_rejects_as_reference(how):
    got, want = _splice_target(PORT), _splice_target(REF)
    s, d = int(got.t_src[0]), int(got.t_dst[0])
    path = {"short": (s,), "endpoints": (s, 9, d + 20),
            "cyclic": (s, 9, 9, d)}[how]
    with pytest.raises(ValueError) as ours:
        arrays.splice_path(got, 0, path)
    with pytest.raises(ValueError) as theirs:
        jarrays.splice_path(want, 0, path)
    assert str(ours.value) == str(theirs.value)
    assert_same_arrays(got, want)                 # nothing was mutated


# ---------------------------------------------------- relabel_plan_nodes
@pytest.mark.parametrize("scheme,failed", [("bmf", (2,)), ("msrepair", (1, 5)),
                                           ("ppt", (2,))])
def test_relabel_plan_nodes_matches_reference(scheme, failed):
    got_pa = arrays.compile_plan(_scheme_plan(PORT, scheme, failed))
    want_pa = jarrays.compile_plan(_scheme_plan(REF, scheme, failed))
    perm = np.roll(np.arange(12), 5)
    got = arrays.relabel_plan_nodes(got_pa, perm)
    assert_same_arrays(got, jarrays.relabel_plan_nodes(want_pa, perm))
    plan.validate_plan(arrays.decompile(got),
                       max_recv_per_round=max(1, len(got_pa.job_helpers[0])))
    back = arrays.relabel_plan_nodes(got, np.argsort(perm))
    assert_same_arrays(back, got_pa)


@pytest.mark.parametrize("perm,err", [
    (np.array([0, 1]), ValueError),                 # does not cover node 2
    (np.array([0, 1, 1]), ValueError),              # not injective
    (np.array([0, 64, 2]), arrays.UnsupportedPlanError),   # term id 64
])
def test_relabel_rejects_as_reference(perm, err):
    def small(m):
        job = m.plan.Job(job_id=0, failed_node=0, requestor=0, helpers=(1, 2))
        return m.arrays.compile_plan(m.plan.RepairPlan(jobs=[job], rounds=[
            m.plan.Round(transfers=[m.plan.Transfer(1, 0, 0, frozenset({1})),
                                    m.plan.Transfer(2, 0, 0, frozenset({2}))])]))

    with pytest.raises(err) as ours:
        arrays.relabel_plan_nodes(small(PORT), perm)
    with pytest.raises(ValueError) as theirs:
        jarrays.relabel_plan_nodes(small(REF), perm)
    assert str(ours.value) == str(theirs.value)
    assert type(ours.value).__name__ == type(theirs.value).__name__


# ---------------------------------------------------- validate_plan_arrays
def _rejects(m):
    """The `tests/test_plan_arrays.py` rejection matrix, built in package
    `m`: name -> (plan, max_recv_per_round, message pattern)."""
    J, R, T, P = m.plan.Job, m.plan.Round, m.plan.Transfer, m.plan.RepairPlan
    two = [J(0, 0, 0, (2, 3)), J(1, 1, 1, (4, 5))]
    one = J(0, 0, 0, (1, 2, 3))
    pair = J(0, 0, 0, (1, 2))
    trad = m.ppr.plan_traditional(J(0, 0, 0, (1, 2, 3)))
    return {
        "relay_reused": (P(two, [R([T(2, 3, 0, frozenset({2}), (2, 6, 3)),
                                    T(4, 5, 1, frozenset({4}), (4, 6, 5))])]),
                         1, "relay node 6 used 2"),
        "stale_replay": (P([one], [R([T(1, 2, 0, frozenset({1}))]),
                                   R([T(1, 2, 0, frozenset({1}))])]),
                         1, "not matching src"),
        "redelivery": (P([pair], [R([T(1, 2, 0, frozenset({1}))]),
                                  R([T(2, 0, 0, frozenset({1, 2}))]),
                                  R([T(2, 0, 0, frozenset({1, 2}))])]),
                       1, "not matching src"),
        "fan_in_unrelaxed": (trad, 1, "receives"),
        "fan_in_short": (trad, 2, "receives"),
        "incomplete": (P([pair], [R([T(1, 0, 0, frozenset({1}))])]),
                       1, "does not complete"),
        "send_and_recv": (P(two, [R([T(2, 3, 0, frozenset({2})),
                                     T(4, 2, 1, frozenset({4}))])]),
                          1, "sends and receives"),
        "relay_and_send": (P(two, [R([T(2, 3, 0, frozenset({2})),
                                      T(4, 5, 1, frozenset({4}), (4, 2, 5))])]),
                           1, "relay"),
    }


REJECTS = sorted(_rejects(PORT))


@pytest.mark.parametrize("name", REJECTS)
def test_validate_plan_arrays_rejects_as_reference(name):
    p, max_recv, match = _rejects(PORT)[name]
    jp, _, _ = _rejects(REF)[name]
    with pytest.raises(ValueError, match=match) as ours:
        arrays.validate_plan_arrays(arrays.compile_plan(p),
                                    max_recv_per_round=max_recv)
    with pytest.raises(ValueError, match=match) as theirs:
        jarrays.validate_plan_arrays(jarrays.compile_plan(jp),
                                     max_recv_per_round=max_recv)
    assert str(ours.value) == str(theirs.value)
    for fast in (False, True):
        with pytest.raises(ValueError, match=match):
            plan.validate_plan(p, max_recv_per_round=max_recv, fast=fast)


@pytest.mark.parametrize("scheme,failed", CASES)
def test_valid_plans_pass_every_path(scheme, failed):
    p = _scheme_plan(PORT, scheme, failed)
    fan_in = max((sum(t.dst == d for t in r.transfers)
                  for r in p.rounds for d in {t.dst for t in r.transfers}),
                 default=1)
    for fast in (None, False, True):
        plan.validate_plan(p, max_recv_per_round=fan_in, fast=fast)
    arrays.validate_plan_arrays(arrays.compile_plan(p),
                                max_recv_per_round=fan_in)


def test_large_plan_takes_the_array_path(monkeypatch):
    """At >= 64 transfers `fast=None` compiles the plan (the bincount
    path), as the reference's threshold says; the verdict is the same."""
    assert plan._FAST_VALIDATE_MIN_TRANSFERS == jplan._FAST_VALIDATE_MIN_TRANSFERS
    jobs = [plan.Job(i, 2 * i, 2 * i, (2 * i + 1,)) for i in range(32)]
    big = plan.RepairPlan(jobs=jobs, rounds=[
        plan.Round(transfers=[plan.Transfer(2 * i + 1, 2 * i, i,
                                            frozenset({2 * i + 1}))
                              for i in range(32)])] * 2)
    small_ids = plan.RepairPlan(jobs=jobs[:30], rounds=[plan.Round(
        transfers=big.rounds[0].transfers[:30])])
    calls = []
    real = arrays.compile_plan
    monkeypatch.setattr(arrays, "compile_plan",
                        lambda p: calls.append(p) or real(p))
    with pytest.raises(ValueError, match="not matching src"):
        plan.validate_plan(big)                   # 64 transfers, replayed
    assert len(calls) == 1
    with pytest.raises(ValueError, match="not matching src"):
        plan.validate_plan(big, fast=False)
    plan.validate_plan(small_ids)                 # 30 transfers: object walk
    assert len(calls) == 1
