"""repro_torch.core.engine.device_stepper held against the reference engines.

The JAX package's own device stepper cannot be the yardstick on the CPU
here (its `jax.experimental.enable_x64` import fails on jax >= 0.9), so
the port's `backend="device"` is held against what the reference's
`tests/test_jax_engine.py` holds the JAX stepper against: the object
engine `repro.core.simulator.run_scheme` and the numpy
`repro.core.engine.vectorized.run_scheme_vectorized`. The stepper runs
with `device="cpu"` (the same torch ops as on the card). Bar: simulated
times within rtol=1e-6, identical round counts, relay hops, logs and
plans; the routing counts (device batches, host batches, horizon
doublings, host syncs) are checked where a case forces a route.
"""
import numpy as np
import pytest
import torch

from repro.core import bandwidth as jbw
from repro.core import simulator as jsim
from repro.core import topology as jtopo
from repro.core.engine import vectorized as jvec
from repro.ec.rs import RSCode as JRSCode
from repro_torch.core import bandwidth, simulator
from repro_torch.core import engine
from repro_torch.core.engine import device_stepper, vectorized
from repro_torch.ec.rs import RSCode

RTOL = 1e-6
MULTI = ("mppr", "random", "msrepair")


class _Pkg:
    def __init__(self, bw, sim, rs):
        self.bw, self.sim, self.rs = bw, sim, rs


PORT = _Pkg(bandwidth, simulator, RSCode)
REF = _Pkg(jbw, jsim, JRSCode)


def norm_plan(p):
    if p is None:
        return None
    return (tuple((j.job_id, j.failed_node, j.requestor, tuple(j.helpers))
                  for j in p.jobs),
            tuple(tuple((t.src, t.dst, t.job, tuple(sorted(t.terms)),
                         tuple(t.path)) for t in rnd.transfers)
                  for rnd in p.rounds),
            dict(p.meta))


def _scenario(m, n=7, k=4, failed=(0,), seed=0, cluster=10, chunk=8.0,
              interval=2.0, mode="markov", trace=None, persistent=True):
    base = jtopo.heterogeneous_matrix(cluster, low=3, high=30, seed=seed)
    bwp = m.bw.BandwidthProcess(base=base, change_interval=interval,
                                seed=seed, mode=mode)
    if trace is not None:
        bwp = m.bw.BandwidthTrace.record(bwp, 16, cycle=trace)
    return m.sim.Scenario(
        num_nodes=cluster, code=m.rs(n, k), failed=failed, bw=bwp,
        ingress=m.bw.IngressModel(seed=seed, persistent_shares=persistent),
        chunk_mb=chunk)


def assert_parity(want, got, label=""):
    assert got.num_rounds == want.num_rounds, label
    assert got.relay_hops == want.relay_hops, label
    np.testing.assert_allclose(got.total_time, want.total_time, rtol=RTOL,
                               err_msg=label)
    assert len(got.round_times) == len(want.round_times), label
    np.testing.assert_allclose(got.round_times, want.round_times, rtol=RTOL,
                               atol=1e-9, err_msg=label)
    assert got.log == want.log, label
    assert norm_plan(got.plan) == norm_plan(want.plan), label


def _device_vs_reference(make, scheme, seeds):
    """The port's device backend on the CPU against the reference's object
    and numpy batched engines; returns the port's results."""
    got = vectorized.run_scheme_vectorized(
        [make(PORT, s) for s in seeds], scheme, seeds=seeds,
        backend="device", device="cpu")
    obj = [jsim.run_scheme(make(REF, s), scheme, random_seed=s)
           for s in seeds]
    vec = jvec.run_scheme_vectorized([make(REF, s) for s in seeds], scheme,
                                     seeds=seeds)
    for s, (g, a, b) in enumerate(zip(got, obj, vec)):
        assert_parity(a, g, f"{scheme} seed={s} vs run_scheme")
        assert_parity(b, g, f"{scheme} seed={s} vs numpy vectorized")
    return got


@pytest.fixture
def counts():
    device_stepper.COUNTS.reset()
    yield device_stepper.COUNTS
    device_stepper.COUNTS.reset()


# ------------------------------------------------------------ parity matrix
@pytest.mark.parametrize("mode", ["jitter", "redraw", "markov"])
@pytest.mark.parametrize("scheme", jsim.ALL_SCHEMES)
def test_device_matches_reference_all_schemes_all_regimes(scheme, mode,
                                                          counts):
    failed = (0, 1) if scheme in MULTI else (0,)
    _device_vs_reference(
        lambda m, s: _scenario(m, failed=failed, seed=s, mode=mode),
        scheme, list(range(4)))
    assert counts.device_batches == 1 and counts.host_batches == 0
    assert counts.host_syncs > 0


@pytest.mark.parametrize("scheme", ["traditional", "ppr", "ppt", "bmf",
                                    "mppr", "msrepair"])
@pytest.mark.parametrize("net", ["static", "trace_cycle", "trace_hold"])
def test_device_static_network_and_traces(net, scheme, counts):
    failed = (0, 1) if scheme in MULTI else (0,)
    kw = dict(interval=None) if net == "static" else dict(
        trace=net == "trace_cycle")
    _device_vs_reference(
        lambda m, s: _scenario(m, failed=failed, seed=s, **kw),
        scheme, list(range(3)))
    assert counts.host_batches == 0 and counts.horizon_grows == 0


def test_device_bmf_optimize_all(counts):
    scs = [_scenario(PORT, seed=s) for s in range(3)]
    got = vectorized.run_scheme_vectorized(scs, "bmf", bmf_optimize_all=True,
                                           backend="device", device="cpu")
    for s, g in enumerate(got):
        want = jsim.run_scheme(_scenario(REF, seed=s), "bmf",
                               bmf_optimize_all=True)
        assert_parity(want, g, "optimize_all")


# ------------------------------------------------------- horizon growth
@pytest.mark.parametrize("scheme", ["bmf", "ppt", "msrepair", "traditional"])
def test_horizon_grows_and_restores_replans(scheme, counts, monkeypatch):
    """A live case outrunning the 2-epoch horizon re-runs with a doubled
    horizon, BMF splices of the aborted attempt rolled back, and still
    matches the reference engines."""
    monkeypatch.setattr(device_stepper, "_INITIAL_LIVE_EPOCHS", 2)
    failed = (0, 1) if scheme in MULTI else (0,)
    _device_vs_reference(
        lambda m, s: _scenario(m, n=4, k=2, failed=failed, seed=s,
                               cluster=6, chunk=64.0),
        scheme, [0, 1])
    assert counts.horizon_grows >= 1
    assert counts.device_batches == 1 and counts.host_batches == 0


# ------------------------------------------------------ host routes, counted
def test_non_persistent_shares_run_on_host_and_are_counted(counts):
    scs = [_scenario(PORT, seed=s, persistent=False) for s in range(2)]
    with pytest.warns(RuntimeWarning, match="non-persistent ingress shares"):
        assert device_stepper.make_round_engine(scs, 10, [],
                                                device="cpu") is None
    with pytest.warns(RuntimeWarning, match="2 case.*host steppers"):
        got = vectorized.run_scheme_vectorized(scs, "traditional",
                                               backend="device", device="cpu")
    for s, g in enumerate(got):
        want = jsim.run_scheme(_scenario(REF, seed=s, persistent=False),
                               "traditional")
        assert_parity(want, g, "non-persistent")
    assert counts.host_batches == 1 and counts.device_batches == 0


@pytest.mark.parametrize("scheme", ["ppr", "ppt"])
def test_memory_cap_runs_on_host_and_is_counted(scheme, counts, monkeypatch):
    """Past the epoch-stack budget the batch takes the numpy steppers."""
    monkeypatch.setattr(device_stepper, "_MEM_LIMIT_BYTES", 1024)
    with pytest.warns(RuntimeWarning, match="exceeds the device budget"):
        _device_vs_reference(lambda m, s: _scenario(m, seed=s), scheme,
                             [0, 1])
    assert counts.host_batches == 1 and counts.device_batches == 0


def test_capped_horizon_runs_on_host_and_is_counted(counts, monkeypatch):
    monkeypatch.setattr(device_stepper, "_INITIAL_LIVE_EPOCHS", 2)
    monkeypatch.setattr(device_stepper, "_MAX_LIVE_EPOCHS", 2)
    with pytest.warns(RuntimeWarning, match="horizon capped at 2 epochs"):
        _device_vs_reference(
            lambda m, s: _scenario(m, n=4, k=2, seed=s, cluster=6,
                                   chunk=64.0),
            "bmf", [0, 1])
    assert counts.host_batches == 1 and counts.device_batches == 0


def test_reference_memory_reckoning():
    """The budget check pads B and E to powers of two, as the reference's
    `Bp * pow2(E) * N * N * 8` does."""
    assert device_stepper._pow2(0) == device_stepper._pow2(1) == 1
    assert device_stepper._pow2(3) == 4 and device_stepper._pow2(8) == 8
    assert device_stepper._stack_bytes(512, 256, 14) == 205_520_896
    assert device_stepper._stack_bytes(1024, 64, 14) == 102_760_448
    assert device_stepper._stack_bytes(513, 256, 14) \
        > device_stepper._MEM_LIMIT_BYTES


# -------------------------------------------------------- the host loop
@pytest.mark.parametrize("every", [1, 3, 64])
def test_sync_interval_changes_no_result(every, counts, monkeypatch):
    """Steps run past a case's end leave it where it is."""
    monkeypatch.setattr(device_stepper, "_SYNC_EVERY", every)
    for scheme in ("traditional", "ppt", "msrepair"):
        failed = (0, 1) if scheme in MULTI else (0,)
        _device_vs_reference(
            lambda m, s: _scenario(m, failed=failed, seed=s), scheme,
            [0, 1, 2])
    assert counts.steps >= every * counts.host_syncs // 2


def test_guard_raises_instead_of_running_on(monkeypatch):
    monkeypatch.setattr(device_stepper, "_GUARD", 4)
    scs = [_scenario(PORT, seed=0)]
    with pytest.raises(RuntimeError, match="failed to converge"):
        vectorized.run_scheme_vectorized(scs, "traditional",
                                         backend="device", device="cpu")


def test_mixed_batch_with_object_engine_fallback(counts):
    """Helper ids >= 64 drop that case to the object engine; the rest of
    the batch runs on the device stepper."""
    def make(m, s):
        if s == 0:
            base = jtopo.heterogeneous_matrix(70, low=3, high=30, seed=1)
            bwp = m.bw.BandwidthProcess(base=base, change_interval=2.0,
                                        seed=1, mode="markov")
            return m.sim.Scenario(num_nodes=70, code=m.rs(6, 3), failed=(0,),
                                  bw=bwp, ingress=m.bw.IngressModel(seed=1),
                                  chunk_mb=4.0, helpers=((65, 66, 67),))
        return _scenario(m, n=6, k=3, seed=1, cluster=8, chunk=4.0)

    _device_vs_reference(make, "ppr", [0, 1])
    assert counts.device_batches == 1


# --------------------------------------------------- no silent CPU run
def test_no_card_and_device_none_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scs = [_scenario(PORT, seed=0)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vectorized.run_scheme_vectorized(scs, "ppr", backend="device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vectorized.run_work_vectorized([(scs[0], "ppt", 0)],
                                       backend="device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_stepper.make_round_engine(scs, 10, [])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_stepper.make_pipeline_engine(
            scs, 10, np.zeros((1, 1), np.int64), np.ones((1, 1), bool))
    assert not engine.device_available()


def test_engine_package_exports():
    assert engine.run_scheme_vectorized is vectorized.run_scheme_vectorized
    assert engine.execute_round_batch is vectorized.execute_round_batch
    assert engine.device_available() == torch.cuda.is_available()
    with pytest.raises(AttributeError):
        engine.jax_available  # noqa: B018
