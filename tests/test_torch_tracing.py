"""repro_torch.tracing: the spans and counters of the repair path.

Off, nothing is recorded and `span` is one shared no-op; on, spans nest
with the right ids, the store stays bounded and, under torch.profiler,
each span is a `repro_torch.<name>` range as long as its record. Tracing
changes no plan or result of `run_sweep`; the search and replan spans add
up to `SimResult.planning_time`; `execute_plans_batch` records its spans
and byte counts, which equal a count made by hand here.
"""
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.core.engine import dataplane
from repro_torch.core.plan import Job, RepairPlan, Round, Transfer
from repro_torch.ec.rs import RSCode
from repro_torch.sim import suite, sweep


@pytest.fixture(autouse=True)
def fresh():
    tracing.disable()
    tracing.clear()
    yield
    tracing.disable()
    tracing.clear()


def _spans(name=None):
    spans, _ = tracing.snapshot()
    return [s for s in spans if name is None or s.name == name]


def test_off_records_nothing():
    a, b = tracing.span("x"), tracing.span("y")
    assert a is b
    with a:
        tracing.count("c", 5)
    assert tracing.snapshot() == ([], {})


def test_nesting_ids_and_counts():
    tracing.enable()
    with tracing.span("outer") as outer:
        with tracing.span("mid") as mid:
            with tracing.span("inner"):
                tracing.count("c", 2)
            tracing.count("c", 3)
    with tracing.span("other"):
        pass
    tracing.disable()
    with tracing.span("late"):
        tracing.count("c", 100)
    got = {s.name: s for s in _spans()}
    assert set(got) == {"outer", "mid", "inner", "other"}
    assert (got["outer"].id, got["mid"].id) == (outer.id, mid.id)
    assert got["outer"].parent == 0 and got["outer"].root == outer.id
    assert (got["mid"].parent, got["mid"].root) == (outer.id, outer.id)
    assert (got["inner"].parent, got["inner"].root) == (mid.id, outer.id)
    assert got["other"].parent == 0 and got["other"].root == got["other"].id
    assert len({s.id for s in got.values()}) == 4
    assert got["inner"].counts == {"c": 2} and got["mid"].counts == {"c": 3}
    assert got["outer"].counts is None
    assert tracing.snapshot()[1] == {"c": 5}
    s = got["outer"]
    assert s.start_ns <= got["mid"].start_ns <= got["mid"].end_ns <= s.end_ns


def test_the_store_is_bounded():
    tracing.enable()
    for i in range(tracing.CAPACITY + 10):
        with tracing.span(f"s{i}"):
            pass
    spans = _spans()
    assert len(spans) == tracing.CAPACITY
    assert spans[0].name == "s10" and spans[-1].name == f"s{tracing.CAPACITY + 9}"
    tracing.clear()
    assert tracing.snapshot() == ([], {})


def test_spans_are_profiler_ranges():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("a"):
            time.sleep(0.004)
            with tracing.span("a.b"):
                time.sleep(0.002)
    assert tracing.span("after") is tracing.span("the profiler")
    ranges = {ev.name: ev.time_range.elapsed_us() * 1e-6
              for ev in prof.events() if ev.name.startswith(tracing.PREFIX)}
    spans = {s.name: s.seconds for s in _spans()}
    assert set(ranges) == {tracing.PREFIX + n for n in spans} \
        == {"repro_torch.a", "repro_torch.a.b"}
    for name, seconds in spans.items():
        assert abs(ranges[tracing.PREFIX + name] - seconds) \
            <= max(0.05 * seconds, 50e-6), name


def _suite(scheme, num=6):
    failures = ("double", "rack") if scheme == "msrepair" else ("single",)
    space = suite.SampleSpace(codes=((6, 3), (7, 4)), cluster_sizes=(10,),
                              chunk_mb=(8.0,), regimes=("hot2s",),
                              failure_patterns=failures)
    return suite.MonteCarloSuite(f"t_{scheme}", num, space, base_seed=5)


def _sweep(scheme):
    return sweep.run_sweep(_suite(scheme), schemes=(scheme,),
                           executor="auto", keep_plans=True)


def _results(res, scheme):
    return [(r.total_time, r.round_times, r.relay_hops, r.log, r.plan)
            for r in (c.results[scheme] for c in res.cases)]


@pytest.mark.parametrize("scheme", ["bmf", "msrepair", "ppt"])
def test_sweep_results_do_not_change_with_tracing(scheme):
    off = _sweep(scheme)
    assert tracing.snapshot() == ([], {})
    tracing.enable()
    on = _sweep(scheme)
    assert _results(on, scheme) == _results(off, scheme)
    roots = _spans("plan")
    assert len(roots) == 1
    below = [s for s in _spans() if s.name != "plan"]
    assert below and all(s.root == roots[0].id for s in below)
    assert {s.name for s in below} >= {"plan.search", "plan.step"}
    if scheme != "ppt":
        assert "plan.convert" in {s.name for s in below}


@pytest.mark.parametrize("scheme", ["bmf", "msrepair", "ppt"])
def test_search_and_replan_spans_are_the_planning_time(scheme):
    tracing.enable()
    res = _sweep(scheme)
    planned = sum(c.results[scheme].planning_time for c in res.cases)
    spanned = sum(s.seconds for s in _spans()
                  if s.name in ("plan.search", "plan.replan"))
    assert abs(spanned - planned) <= 0.02 * planned + 50e-6


def test_replan_opens_once_a_round():
    tracing.enable()
    res = _sweep("bmf")
    # one cluster size: one execution batch, stepped for its longest plan
    rounds = max(len(c.results["bmf"].plan.rounds) for c in res.cases)
    assert len(_spans("plan.replan")) == rounds
    assert len(_spans("plan.step")) == rounds


def _two_case_batch(nbytes):
    """RS(6,3), node i holds block i; both cases lose node 0 and repair it
    at node 0 from nodes 1-3. Case 0 chains 1 -> 2 -> 3 -> 0; case 1 sends
    each helper to 0 in its own round, the first through relay node 4."""
    job = Job(job_id=0, failed_node=0, requestor=0, helpers=(1, 2, 3))
    chain = RepairPlan(jobs=[job], rounds=[
        Round([Transfer(1, 2, 0, frozenset({1}))]),
        Round([Transfer(2, 3, 0, frozenset({1, 2}))]),
        Round([Transfer(3, 0, 0, frozenset({1, 2, 3}))])])
    star = RepairPlan(jobs=[job], rounds=[
        Round([Transfer(1, 0, 0, frozenset({1}), path=(1, 4, 0))]),
        Round([Transfer(2, 0, 0, frozenset({2}))]),
        Round([Transfer(3, 0, 0, frozenset({3}))])])
    code = RSCode(6, 3)
    rng = np.random.default_rng(7)
    words = [code.encode(torch.from_numpy(
        rng.integers(0, 256, (3, nbytes), dtype=np.uint8))) for _ in range(2)]
    return [chain, star], code, words


def test_dataplane_spans_and_byte_counts():
    nbytes = 64
    plans, code, words = _two_case_batch(nbytes)
    tracing.enable()
    out = dataplane.execute_plans_batch(plans, code, words, device="cpu")
    assert out.all_verified
    spans = {s.name: s for s in _spans()
             if s.name.startswith("dataplane")}
    assert set(spans) == {"dataplane", "dataplane.prepare", "dataplane.wait"}
    root = spans["dataplane"]
    assert root.parent == 0
    for child in ("dataplane.prepare", "dataplane.wait"):
        assert (spans[child].parent, spans[child].root) == (root.id, root.id)
    # by hand: 3 + 3 helper rows gathered; the kernels write the buffer's
    # rows in place (not counted), so nothing fills or index-writes it; no
    # node sends and receives in one round, so no spare row; both
    # requestor rows end held
    gather = 2 * 6 * 64 + 2 * 6 * 64          # the per-case gathers, the cat
    verify = 2 * (2 * 64 + 3 * 64 + 64 + 1)   # copy, compare, reduce
    want = {"dataplane.bytes.gather": gather, "dataplane.bytes.verify": verify}
    assert tracing.snapshot()[1] == want
    assert root.counts == want
    assert out.rounds == 3
