"""repro_torch.core.engine.vectorized (numpy steppers) held against the
reference's `run_scheme` and its numpy `run_scheme_vectorized`.

The same scenarios (made from seeds with numpy) run through the port's
batched engine and the reference's object and batched engines: simulated
times within rtol=1e-6 (the reference's own parity bar), identical round
counts, relay hops, logs and executed plans, for all 8 schemes under
jitter, redraw and markov churn, static networks, recorded traces, mixed
cluster sizes and the per-case object-engine fallback. `planning_time` is
wall-clock and not compared.
"""
import types

import numpy as np
import pytest

from repro.core import bandwidth as jbw
from repro.core import simulator as jsim
from repro.core import topology as jtopo
from repro.core.engine import vectorized as jvec
from repro.ec.rs import RSCode as JRSCode
from repro_torch.core import bandwidth, simulator
from repro_torch.core.engine import vectorized
from repro_torch.ec.rs import RSCode

RTOL = 1e-6
PORT = types.SimpleNamespace(bw=bandwidth, sim=simulator, rs=RSCode)
REF = types.SimpleNamespace(bw=jbw, sim=jsim, rs=JRSCode)
MULTI = ("mppr", "random", "msrepair")


def norm_plan(p):
    """A RepairPlan (either package) as plain tuples, for equality."""
    if p is None:
        return None
    return (tuple((j.job_id, j.failed_node, j.requestor, tuple(j.helpers))
                  for j in p.jobs),
            tuple(tuple((t.src, t.dst, t.job, tuple(sorted(t.terms)),
                         tuple(t.path)) for t in rnd.transfers)
                  for rnd in p.rounds),
            dict(p.meta))


def _scenario(m, n=6, k=3, failed=(0,), seed=0, cluster=8, chunk=8.0,
              interval=2.0, mode="markov", trace=None, **kw):
    base = jtopo.heterogeneous_matrix(cluster, low=3, high=30, seed=seed)
    bwp = m.bw.BandwidthProcess(base=base, change_interval=interval,
                                seed=seed, mode=mode)
    if trace is not None:
        bwp = m.bw.BandwidthTrace.record(bwp, 16, cycle=trace)
    return m.sim.Scenario(num_nodes=cluster, code=m.rs(n, k), failed=failed,
                          bw=bwp, ingress=m.bw.IngressModel(seed=seed),
                          chunk_mb=chunk, **kw)


def assert_parity(want, got, label="", *, plans=True):
    assert got.num_rounds == want.num_rounds, label
    assert got.relay_hops == want.relay_hops, label
    np.testing.assert_allclose(got.total_time, want.total_time, rtol=RTOL,
                               err_msg=label)
    assert len(got.round_times) == len(want.round_times), label
    np.testing.assert_allclose(got.round_times, want.round_times, rtol=RTOL,
                               atol=1e-9, err_msg=label)
    assert got.log == want.log, label
    if plans:
        assert norm_plan(got.plan) == norm_plan(want.plan), label


def _three_way(make, scheme, seeds, **kw):
    """Port batched vs reference object engine vs reference batched."""
    got = vectorized.run_scheme_vectorized(
        [make(PORT, s) for s in seeds], scheme, seeds=seeds, **kw)
    ref_scs = [make(REF, s) for s in seeds]
    obj = [jsim.run_scheme(sc, scheme, random_seed=s,
                           bmf_optimize_all=kw.get("bmf_optimize_all", False))
           for s, sc in zip(seeds, ref_scs)]
    vec = jvec.run_scheme_vectorized([make(REF, s) for s in seeds], scheme,
                                     seeds=seeds, **kw)
    return got, obj, vec


# ------------------------------------------------------ per-scheme batches
@pytest.mark.parametrize("mode", ["jitter", "redraw", "markov"])
@pytest.mark.parametrize("scheme", jsim.ALL_SCHEMES)
def test_scheme_batch_matches_reference(scheme, mode):
    failed = (0, 1) if scheme in MULTI else (0,)
    got, obj, vec = _three_way(
        lambda m, s: _scenario(m, n=7, k=4, failed=failed, seed=s,
                               cluster=10, mode=mode),
        scheme, list(range(6)))
    for s, (g, a, b) in enumerate(zip(got, obj, vec)):
        assert_parity(a, g, f"{scheme}/{mode} seed={s} vs run_scheme")
        assert_parity(b, g, f"{scheme}/{mode} seed={s} vs vectorized")


def test_bmf_optimize_all_parity():
    got, obj, vec = _three_way(
        lambda m, s: _scenario(m, seed=s, cluster=10), "bmf", list(range(4)),
        bmf_optimize_all=True)
    for g, a, b in zip(got, obj, vec):
        assert_parity(a, g, "optimize_all vs run_scheme")
        assert_parity(b, g, "optimize_all vs vectorized")


@pytest.mark.parametrize("scheme", ["traditional", "ppr", "ppt", "bmf",
                                    "msrepair"])
@pytest.mark.parametrize("net", ["static", "trace_cycle", "trace_hold"])
def test_static_network_and_trace_parity(net, scheme):
    failed = (0, 1) if scheme in MULTI else (0,)
    kw = dict(interval=None) if net == "static" else dict(
        trace=net == "trace_cycle")
    got, obj, vec = _three_way(
        lambda m, s: _scenario(m, n=7, k=4, failed=failed, seed=s,
                               cluster=10, **kw), scheme, list(range(3)))
    for g, a, b in zip(got, obj, vec):
        assert_parity(a, g, f"{net} {scheme} vs run_scheme")
        assert_parity(b, g, f"{net} {scheme} vs vectorized")


def test_mixed_cluster_sizes_group_and_match():
    """Cases of different N split into batches but come back in order."""
    def make(m, s):
        if s < 3:
            return _scenario(m, n=4, k=2, seed=s, cluster=6)
        return _scenario(m, n=7, k=4, seed=s, cluster=12)

    got, obj, vec = _three_way(make, "bmf", list(range(6)))
    for g, a, b in zip(got, obj, vec):
        assert_parity(a, g, "mixed vs run_scheme")
        assert_parity(b, g, "mixed vs vectorized")


def test_integer_chunk_sizes_parity():
    """Integer `chunk_mb` must not make the batched state integer-typed."""
    for scheme in ("traditional", "ppr", "bmf", "ppt"):
        got, obj, _ = _three_way(lambda m, s: _scenario(m, seed=s, chunk=16),
                                 scheme, list(range(3)))
        for g, a in zip(got, obj):
            assert_parity(a, g, f"int-chunk {scheme}")


def test_unsupported_helper_ids_fall_back_per_case():
    """Helper ids >= 64 cannot be bitmask-compiled: that case runs on the
    object engine, the rest of the batch stays vectorized."""
    def make(m, s):
        if s == 0:
            base = jtopo.heterogeneous_matrix(70, low=3, high=30, seed=1)
            bwp = m.bw.BandwidthProcess(base=base, change_interval=2.0,
                                        seed=1, mode="markov")
            return m.sim.Scenario(num_nodes=70, code=m.rs(6, 3), failed=(0,),
                                  bw=bwp, ingress=m.bw.IngressModel(seed=1),
                                  chunk_mb=4.0, helpers=((65, 66, 67),))
        return _scenario(m, seed=1, chunk=4.0)

    got, obj, vec = _three_way(make, "ppr", [0, 1])
    for g, a, b in zip(got, obj, vec):
        assert_parity(a, g, "fallback vs run_scheme")
        assert_parity(b, g, "fallback vs vectorized")


def test_work_rows_mixing_schemes_keep_order():
    """`run_work_vectorized` rows of several schemes, in input order."""
    schemes = ("ppt", "traditional", "msrepair", "bmf", "random", "ppr")
    rows_p, rows_r = [], []
    for i, scheme in enumerate(schemes):
        failed = (0, 1) if scheme in MULTI else (0,)
        rows_p.append((_scenario(PORT, n=7, k=4, failed=failed, seed=i,
                                 cluster=10), scheme, i))
        rows_r.append((_scenario(REF, n=7, k=4, failed=failed, seed=i,
                                 cluster=10), scheme, i))
    got = vectorized.run_work_vectorized(rows_p, keep_plans=False)
    want = jvec.run_work_vectorized(rows_r, keep_plans=False)
    for g, w in zip(got, want):
        assert g.scheme == w.scheme and g.plan is None
        assert_parity(w, g, g.scheme, plans=False)


@pytest.mark.parametrize("bad", [dict(seeds=[0, 1]), dict(backend="jax"),
                                 dict(backend="tpu")])
def test_bad_arguments_raise(bad):
    with pytest.raises(ValueError) as exc:
        vectorized.run_scheme_vectorized([_scenario(PORT)], "ppr", **bad)
    if bad.get("backend") == "jax":
        assert "device" in str(exc.value)
