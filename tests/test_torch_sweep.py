"""repro_torch.sim (suites + run_sweep) held against repro.sim.

Suites built from the same parameters and seeds give equal cases (the
numpy draws stay on the host). Sweeps of the same suite give equal
results across the port's executors (serial, thread, process, vectorized,
device on the CPU, auto) and equal to the reference's vectorized sweep:
simulated times within rtol=1e-6 (the reference's parity bar; in practice
they are equal to the last bit), identical rounds and relay hops, and
per-scheme `SchemeStats` and paired speedups equal (the wall-clock
planning fields excepted). Byte verification checks the same (case,
scheme) pairs as the reference's and verifies all of them on the CPU.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import bandwidth as jbw
from repro.core import simulator as jsim
from repro.core import topology as jtopo
from repro.ec.rs import RSCode as JRSCode
from repro.sim import suite as jsuite
from repro.sim import sweep as jsweep
from repro_torch.core import bandwidth, simulator
from repro_torch.core.engine import device_stepper
from repro_torch.ec.rs import RSCode
from repro_torch.sim import suite, sweep

RTOL = 1e-6
WALL_CLOCK = ("mean_planning", "planning_frac")


def _space(m, **kw):
    args = dict(codes=((4, 2), (6, 3)), cluster_sizes=(8,), chunk_mb=(8.0,),
                regimes=("hot2s",), failure_patterns=("single", "double",
                                                      "rack"))
    args.update(kw)
    return m.SampleSpace(**args)


def _mc(m, num=8, base_seed=3, **kw):
    return m.MonteCarloSuite("t", num, _space(m, **kw), base_seed=base_seed)


def assert_same_case(a, b):
    """Two `ScenarioCase`s (one per package) describe the same scenario."""
    assert (a.suite, a.index, a.seed, a.params, a.schemes) == \
        (b.suite, b.index, b.seed, b.params, b.schemes)
    sa, sb = a.scenario, b.scenario
    assert (sa.num_nodes, sa.failed, sa.chunk_mb, sa.helpers) == \
        (sb.num_nodes, sb.failed, sb.chunk_mb, sb.helpers)
    assert (sa.code.n, sa.code.k) == (sb.code.n, sb.code.k)
    assert dataclasses.asdict(sa.ingress) == dataclasses.asdict(sb.ingress)
    assert type(sa.bw).__name__ == type(sb.bw).__name__
    if type(sb.bw).__name__ == "BandwidthTrace":
        assert (sa.bw.change_interval, sa.bw.cycle) == \
            (sb.bw.change_interval, sb.bw.cycle)
        assert np.array_equal(sa.bw.epochs, sb.bw.epochs)
    else:
        assert np.array_equal(sa.bw.base, sb.bw.base)
        assert (sa.bw.change_interval, sa.bw.mode, sa.bw.seed) == \
            (sb.bw.change_interval, sb.bw.mode, sb.bw.seed)
        assert np.array_equal(sa.bw.matrix_at(7.0), sb.bw.matrix_at(7.0))


def assert_same_sweep(got, want, *, exact_stats=True):
    assert got.suite == want.suite and got.schemes == want.schemes
    assert len(got.cases) == len(want.cases)
    for cg, cw in zip(got.cases, want.cases):
        assert (cg.index, cg.seed, cg.params) == (cw.index, cw.seed,
                                                  cw.params)
        assert set(cg.results) == set(cw.results)
        for s, rw in cw.results.items():
            rg = cg.results[s]
            label = (cw.index, s)
            assert rg.num_rounds == rw.num_rounds, label
            assert rg.relay_hops == rw.relay_hops, label
            np.testing.assert_allclose(rg.total_time, rw.total_time,
                                       rtol=RTOL, err_msg=str(label))
            np.testing.assert_allclose(rg.round_times, rw.round_times,
                                       rtol=RTOL, atol=1e-9,
                                       err_msg=str(label))
    sg, sw = got.summary(), want.summary()
    assert list(sg) == list(sw)
    for s in sw:
        for f in dataclasses.fields(sweep.SchemeStats):
            if f.name in WALL_CLOCK:
                continue
            a, b = getattr(sg[s], f.name), getattr(sw[s], f.name)
            if exact_stats:
                assert a == b, (s, f.name)
            else:
                assert a == pytest.approx(b, rel=RTOL), (s, f.name)


# --------------------------------------------------------------- suites
@pytest.mark.parametrize("kw", [
    dict(),
    dict(codes=((7, 4), (14, 10)), cluster_sizes=(10, 14),
         chunk_mb=(8.0, 32.0), regimes=tuple(jsuite.VOLATILITY_REGIMES),
         failure_patterns=tuple(jsuite.FAILURE_PATTERNS)),
    dict(codes=((7, 4),), cluster_sizes=(14,), chunk_mb=(32.0,),
         regimes=("hot2s",), failure_patterns=("double",)),
])
def test_monte_carlo_cases_equal(kw):
    for a, b in zip(_mc(suite, num=20, base_seed=9, **kw).cases(),
                    _mc(jsuite, num=20, base_seed=9, **kw).cases()):
        assert_same_case(a, b)


def test_default_space_and_scheme_override_equal():
    got = suite.MonteCarloSuite("d", 12, schemes=("ppr", "bmf"), base_seed=4)
    want = jsuite.MonteCarloSuite("d", 12, schemes=("ppr", "bmf"),
                                  base_seed=4)
    assert len(got) == len(want) == 12 and got.schemes == want.schemes
    for a, b in zip(got.cases(), want.cases()):
        assert_same_case(a, b)


@pytest.mark.parametrize("cycle_epochs", [16, 64])
def test_trace_freeze_equal(cycle_epochs):
    got = suite.TraceSuite.freeze(_mc(suite, num=6), num_epochs=cycle_epochs)
    want = jsuite.TraceSuite.freeze(_mc(jsuite, num=6),
                                    num_epochs=cycle_epochs)
    assert (got.name, got.schemes, len(got)) == (want.name, want.schemes,
                                                 len(want))
    for a, b in zip(got.cases(), want.cases()):
        assert_same_case(a, b)


def _grid_build(m, rs):
    def build(params, seed):
        base = jtopo.heterogeneous_matrix(8, low=3, high=30, seed=seed)
        bwp = m.BandwidthProcess(base=base, change_interval=2.0, seed=seed,
                                 mode="markov")
        return (simulator if m is bandwidth else jsim).Scenario(
            num_nodes=8, code=rs(6, 3), failed=(0,), bw=bwp,
            ingress=m.IngressModel(seed=seed), chunk_mb=params["chunk_mb"])
    return build


def test_grid_suite_equal():
    axes = {"chunk_mb": [4.0, 8.0], "tag": ["x", "y"]}
    got = suite.GridSuite("g", axes, _grid_build(bandwidth, RSCode),
                          trials=2, schemes=("ppr", "bmf"), base_seed=5)
    want = jsuite.GridSuite("g", axes, _grid_build(jbw, JRSCode), trials=2,
                            schemes=("ppr", "bmf"), base_seed=5)
    assert len(got) == len(want) == 8 and got.combos() == want.combos()
    for a, b in zip(got.cases(), want.cases()):
        assert_same_case(a, b)


def test_sample_failures_and_case_seed_equal():
    r1, r2 = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(40):
        for n, k, pattern in ((7, 4, "single"), (7, 4, "double"),
                              (9, 5, "rack"), (14, 10, "rack")):
            assert suite.sample_failures(r1, n, k, pattern) == \
                jsuite.sample_failures(r2, n, k, pattern)
    assert [suite.case_seed(3, i) for i in range(50)] == \
        [jsuite.case_seed(3, i) for i in range(50)]
    for bad in ((4, 3, "double"), (4, 2, "nope"), (3, 3, "single")):
        with pytest.raises(ValueError) as e1:
            suite.sample_failures(r1, *bad)
        with pytest.raises(ValueError) as e2:
            jsuite.sample_failures(r2, *bad)
        assert str(e1.value) == str(e2.value)
    assert suite.VOLATILITY_REGIMES == jsuite.VOLATILITY_REGIMES
    assert suite.FAILURE_PATTERNS == jsuite.FAILURE_PATTERNS


# ------------------------------------------------------------ executors
@pytest.fixture(scope="module")
def reference_sweep():
    """The reference's vectorized sweep of the shared small suite."""
    return jsweep.run_sweep(_mc(jsuite, num=10), executor="vectorized")


@pytest.mark.parametrize("executor", ["serial", "thread", "vectorized",
                                      "device", "auto"])
def test_executors_match_reference_vectorized(executor, reference_sweep):
    got = sweep.run_sweep(_mc(suite, num=10), executor=executor,
                          max_workers=2, device="cpu")
    assert_same_sweep(got, reference_sweep)
    for base, s in (("traditional", "bmf"), ("ppr", "bmf"),
                    ("mppr", "msrepair"), ("random", "msrepair")):
        assert np.array_equal(got.speedups(base, s),
                              reference_sweep.speedups(base, s))
        assert got.reduction_pct(base, s) == \
            reference_sweep.reduction_pct(base, s)


def test_process_pool_matches_reference(monkeypatch, reference_sweep):
    """The real spawn pool (object engine in the workers)."""
    monkeypatch.setattr(sweep, "_MIN_CASES_PER_WORKER", 1)
    got = sweep.run_sweep(_mc(suite, num=10), executor="process",
                          max_workers=2)
    assert_same_sweep(got, reference_sweep)


def test_process_below_threshold_warns_and_runs_serial(reference_sweep):
    with pytest.warns(RuntimeWarning, match="spawn"):
        got = sweep.run_sweep(_mc(suite, num=10), executor="process",
                              max_workers=2)
    assert_same_sweep(got, reference_sweep)
    assert sweep._process_workers(6, None) == jsweep._process_workers(6, None)


def test_device_sweep_on_traces_counts_device_batches():
    device_stepper.COUNTS.reset()
    frozen = suite.TraceSuite.freeze(_mc(suite, num=12), num_epochs=64)
    got = sweep.run_sweep(frozen, executor="device", device="cpu")
    want = jsweep.run_sweep(
        jsuite.TraceSuite.freeze(_mc(jsuite, num=12), num_epochs=64),
        executor="vectorized")
    assert_same_sweep(got, want)
    counts = device_stepper.COUNTS.as_dict()
    device_stepper.COUNTS.reset()
    assert counts["device_batches"] > 0 and counts["host_batches"] == 0


def test_sweep_aggregation_helpers_equal(reference_sweep):
    got = sweep.run_sweep(_mc(suite, num=10), executor="vectorized")
    for key in ("pattern", "code"):
        g, w = got.group_by(key), reference_sweep.group_by(key)
        assert list(g) == list(w)
        for k in w:
            assert_same_sweep(g[k], w[k])
    s_got, cdf_got = got.speedup_cdf("ppr", "bmf")
    s_ref, cdf_ref = reference_sweep.speedup_cdf("ppr", "bmf")
    assert np.array_equal(s_got, s_ref) and np.array_equal(cdf_got, cdf_ref)
    assert got.speedup_percentile("ppr", "bmf", 90) == \
        reference_sweep.speedup_percentile("ppr", "bmf", 90)
    single = got.filter(lambda c: len(c.params["failed"]) == 1)
    assert all(len(c.params["failed"]) == 1 for c in single.cases)


# ------------------------------------------------------- auto and errors
def test_auto_resolution(monkeypatch):
    """auto is the vectorized engine wherever the reference's auto picks
    its jax stepper: the device stepper is an explicit opt-in."""
    big = list(suite.TraceSuite.freeze(
        _mc(suite, num=jsweep._JAX_AUTO_MIN_CASES)).cases())
    live = list(_mc(suite, num=jsweep._JAX_AUTO_MIN_CASES).cases())
    for available in (False, True):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: available)
        for cases in (big, big[:-1], live):
            assert sweep._resolve_executor("auto", cases) == "vectorized"
    assert sweep._resolve_executor("device", big) == "device"
    assert sweep._resolve_executor("serial", live) == "serial"


def test_jax_and_unknown_executors_raise():
    with pytest.raises(ValueError, match="device"):
        sweep.run_sweep(_mc(suite, num=2), executor="jax")
    with pytest.raises(ValueError, match="unknown executor"):
        sweep.run_sweep(_mc(suite, num=2), executor="tpu")


def test_no_card_and_device_none_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sweep.run_sweep(_mc(suite, num=2), executor="device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sweep.run_sweep(_mc(suite, num=2), executor="vectorized",
                        verify_bytes=1)


# ------------------------------------------------------- byte verification
@pytest.mark.parametrize("num,verify", [(6, 3), (4, 4), (10, 16)])
def test_byte_verification_same_pairs_all_verified(num, verify):
    got = sweep.run_sweep(_mc(suite, num=num), executor="vectorized",
                          verify_bytes=verify, device="cpu")
    want = jsweep.run_sweep(_mc(jsuite, num=num), executor="vectorized",
                            verify_bytes=verify)
    bv, bw = got.byte_verification, want.byte_verification
    assert bv.checked == bw.checked and bv.nbytes == bw.nbytes == 512
    assert bv.verified and not bv.failures and bv.rounds > 0
    assert bw.verified


def test_byte_verification_covers_ppt():
    space = dict(codes=((6, 3),), cluster_sizes=(9,), regimes=("hot2s",),
                 failure_patterns=("single",))
    got = sweep.run_sweep(_mc(suite, num=3, base_seed=11, **space),
                          executor="serial", verify_bytes=3, device="cpu")
    assert got.byte_verification.verified
    assert any(s == "ppt" for _, s in got.byte_verification.checked)
    assert sweep.run_sweep(_mc(suite, num=2),
                           executor="serial").byte_verification is None
