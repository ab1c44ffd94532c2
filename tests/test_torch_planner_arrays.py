"""repro_torch.core.engine.planner_arrays (batched half) held against
repro.core.engine.planner_arrays.

The same inputs, made from a seed with numpy, go through both packages'
batched BMF path search, `optimize_round_batch` (hop arrays, the in-place
avail mask, stats and splices), the lockstep MSRepair scheduler,
`schedule_for_scheme`, `plan_arrays_for_scheme` and
`lower_schedules_batch`. Everything is host numpy in both packages, so
the bar is exact equality: arrays equal with their dtypes, floats equal
to the last bit, the same error messages.
"""
import dataclasses
import types

import numpy as np
import pytest

from repro.core import msrepair as jmsrepair
from repro.core import plan as jplan
from repro.core import topology as jtopo
from repro.core.engine import arrays as jarrays
from repro.core.engine import planner_arrays as jpa
from repro_torch.core import msrepair, plan
from repro_torch.core.engine import arrays
from repro_torch.core.engine import planner_arrays as pa

PORT = types.SimpleNamespace(pa=pa, plan=plan, msrepair=msrepair,
                             arrays=arrays)
REF = types.SimpleNamespace(pa=jpa, plan=jplan, msrepair=jmsrepair,
                            arrays=jarrays)
ALL_SCHEMES = ("traditional", "ppr", "bmf", "bmf_static", "mppr", "random",
               "msrepair")


def assert_same(a, b, label=""):
    """numpy arrays equal with dtype and shape; anything else by ==."""
    if isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray), label
        assert a.dtype == b.dtype and a.shape == b.shape, label
        assert np.array_equal(a, b), label
    else:
        assert a == b, label


def assert_same_plan_arrays(got, want):
    assert type(got).__name__ == type(want).__name__ == "PlanArrays"
    for f in dataclasses.fields(arrays.PlanArrays):
        assert_same(getattr(got, f.name), getattr(want, f.name), f.name)


def _multi_jobs(m, seed):
    """Random multi-failure jobs (the reference tests' generator)."""
    rng = np.random.default_rng(seed)
    k = int(rng.integers(2, 6))
    n = int(rng.integers(k + 2, k + 7))
    nf = int(rng.integers(2, min(4, n - k) + 1))
    failed = sorted(rng.choice(n, size=nf, replace=False).tolist())
    helpers = m.msrepair.select_helpers_multi(n, k, failed)
    return [m.plan.Job(job_id=i, failed_node=f, requestor=f,
                       helpers=helpers[i]) for i, f in enumerate(failed)]


def _single_job(m, helpers=(1, 2, 3)):
    return [m.plan.Job(job_id=0, failed_node=0, requestor=0,
                       helpers=helpers)]


# ------------------------------------------------------- batched BMF search
def _search_inputs(seed):
    """A batch of path searches: clusters of 5-9 nodes, random endpoints
    and idle pools, finite and infinite bounds; every third seed rounds
    the bandwidths to force exact ties."""
    rng = np.random.default_rng(seed)
    B, N = 6, int(rng.integers(5, 10))
    bw = np.stack([jtopo.heterogeneous_matrix(N, low=1, high=30,
                                              seed=seed * 10 + b)
                   for b in range(B)])
    if seed % 3 == 0:
        bw = np.round(bw / 6) * 6
    src = rng.integers(0, N, size=B)
    dst = (src + rng.integers(1, N, size=B)) % N
    avail = rng.random((B, N)) < 0.7
    avail[np.arange(B), dst] = False
    chunk = rng.choice([8.0, 16.0, 32.0], size=B)
    bound = np.where(rng.random(B) < 0.5, np.inf, rng.uniform(0.2, 4.0, B))
    return src, dst, avail, bw, chunk, bound


@pytest.mark.parametrize("seed", range(12))
def test_find_min_time_paths_batch_equal(seed):
    src, dst, avail, bw, chunk, bound = _search_inputs(seed)
    out = {}
    for name, m in (("port", PORT), ("ref", REF)):
        w = m.pa.hop_time_stack(bw, chunk)
        out[name] = (w, m.pa.find_min_time_paths_batch(
            src, dst, avail.copy(), w, bound, bw_stack=bw, chunk_mb=chunk))
    (w_p, (paths_p, t_p, imp_p)), (w_r, (paths_r, t_r, imp_r)) = \
        out["port"], out["ref"]
    assert_same(w_p, w_r, "hop times")
    assert paths_p == paths_r
    assert_same(t_p, t_r, "times")
    assert_same(imp_p, imp_r, "improved")


@pytest.mark.parametrize("case", ["deep", "bound"])
def test_find_min_time_paths_batch_deep_and_bound(case):
    """The depth-bound fallback to the scalar DFS, and a bound the direct
    path already meets, give the same answers in both packages."""
    if case == "deep":
        n = 7
        bw = np.full((n, n), 0.1)
        np.fill_diagonal(bw, 0.0)
        for u, v in [(0, 2), (2, 3), (3, 4), (4, 5), (5, 1)]:
            bw[u, v] = 1000.0
        idle, bound = [2, 3, 4, 5, 6], np.inf
    else:
        n = 5
        bw = jtopo.uniform_matrix(n, 10.0)
        idle, bound = [2, 3, 4], 0.5
    avail = np.zeros((1, n), dtype=bool)
    avail[0, idle] = True
    res = []
    for m in (PORT, REF):
        w = m.pa.hop_time_stack(bw[None], np.array([16.0]))
        res.append(m.pa.find_min_time_paths_batch(
            np.array([0]), np.array([1]), avail.copy(), w,
            np.array([bound]), bw_stack=bw[None], chunk_mb=np.array([16.0])))
    (pp, tp, ip), (pr, tr, ir) = res
    assert pp == pr
    assert_same(tp, tr)
    assert_same(ip, ir)
    if case == "deep":
        assert pp[0] == (0, 2, 3, 4, 5, 1)


# ------------------------------------------------------ batched Algorithm 1
def _round_inputs(seed):
    """A batch of rounds of 1-4 direct or relayed transfers on 8-13 node
    clusters, with the idle pools the engine would pass."""
    rng = np.random.default_rng(100 + seed)
    B = 5
    N = int(rng.integers(8, 14))
    T, H = 4, 2
    bw = np.stack([jtopo.heterogeneous_matrix(N, low=1, high=40,
                                              seed=seed * 7 + b)
                   for b in range(B)])
    if seed % 4 == 0:
        bw = np.round(bw / 6) * 6              # force rate ties
    hop_u = np.zeros((B, T, H), dtype=np.int64)
    hop_v = np.zeros_like(hop_u)
    n_hops = np.zeros((B, T), dtype=np.int64)
    avail = np.zeros((B, N), dtype=bool)
    for b in range(B):
        nodes = rng.permutation(N)
        nt = int(rng.integers(1, T + 1))
        used = set()
        for t in range(nt):
            s, d = int(nodes[2 * t]), int(nodes[2 * t + 1])
            hop_u[b, t, 0], hop_v[b, t, 0] = s, d
            n_hops[b, t] = 1
            used.update((s, d))
        if nt > 1 and rng.random() < 0.5:      # one pre-relayed transfer
            r = int(nodes[2 * nt])
            s, d = int(hop_u[b, 0, 0]), int(hop_v[b, 0, 0])
            hop_u[b, 0, :2] = (s, r)
            hop_v[b, 0, :2] = (r, d)
            n_hops[b, 0] = 2
            used.add(r)
        avail[b] = [x not in used for x in range(N)]
    chunk = rng.choice([8.0, 16.0], size=B)
    return hop_u, hop_v, n_hops, bw, chunk, avail


@pytest.mark.parametrize("opt_all", [False, True])
@pytest.mark.parametrize("seed", range(8))
def test_optimize_round_batch_equal(seed, opt_all):
    res = []
    for m in (PORT, REF):
        hu, hv, nh, bw, chunk, avail = _round_inputs(seed)
        out = m.pa.optimize_round_batch(hu, hv, nh, bw, chunk, avail,
                                        optimize_all=opt_all)
        res.append((out, nh, avail))
    ((hu_p, hv_p, st_p, ch_p), nh_p, av_p), \
        ((hu_r, hv_r, st_r, ch_r), nh_r, av_r) = res
    assert_same(hu_p, hu_r, "hop_u")
    assert_same(hv_p, hv_r, "hop_v")
    assert_same(nh_p, nh_r, "n_hops (in place)")
    assert_same(av_p, av_r, "avail (in place)")
    assert ch_p == ch_r
    assert type(st_p).__name__ == type(st_r).__name__ == "BatchBMFStats"
    for f in dataclasses.fields(pa.BatchBMFStats):
        assert_same(getattr(st_p, f.name), getattr(st_r, f.name), f.name)


def test_optimize_round_batch_empty_round():
    for m in (PORT, REF):
        hu = np.zeros((2, 0, 1), dtype=np.int64)
        out = m.pa.optimize_round_batch(hu, hu.copy(),
                                        np.zeros((2, 0), np.int64),
                                        np.ones((2, 4, 4)), np.ones(2),
                                        np.ones((2, 4), bool))
        assert out[1].shape == (2, 0, 1) and out[3] == []


# --------------------------------------------------- lockstep MSRepair batch
@pytest.mark.parametrize("seed", range(25))
def test_msrepair_schedule_batch_equal(seed):
    got = pa.msrepair_schedule_batch([_multi_jobs(PORT, seed)])[0]
    want = jpa.msrepair_schedule_batch([_multi_jobs(REF, seed)])[0]
    assert got == want
    assert got == pa.msrepair_schedule(_multi_jobs(PORT, seed))


def test_msrepair_schedule_batch_mixed_and_fallback():
    """A batch of several cases, one with node ids >= 64 (tuple fallback)."""
    def batch(m):
        out = [_multi_jobs(m, s) for s in range(8)]
        out.append([m.plan.Job(job_id=0, failed_node=0, requestor=0,
                               helpers=(65, 66)),
                    m.plan.Job(job_id=1, failed_node=1, requestor=1,
                               helpers=(66, 67))])
        return out

    assert pa.msrepair_schedule_batch(batch(PORT)) == \
        jpa.msrepair_schedule_batch(batch(REF))


# ------------------------------------------------- schedules and lowering
def _scheme_jobs(m, scheme, seed):
    if scheme in ("mppr", "random", "msrepair"):
        return _multi_jobs(m, seed)
    return _single_job(m, helpers=(1, 2, 3, 4)[: 2 + seed % 3])


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("scheme", ALL_SCHEMES)
def test_schedule_and_plan_arrays_for_scheme_equal(scheme, seed):
    got = pa.schedule_for_scheme(scheme, _scheme_jobs(PORT, scheme, seed),
                                 random_seed=seed)
    want = jpa.schedule_for_scheme(scheme, _scheme_jobs(REF, scheme, seed),
                                   random_seed=seed)
    assert [(j.job_id, j.failed_node, j.requestor, tuple(j.helpers))
            for j in got[0]] == [(j.job_id, j.failed_node, j.requestor,
                                  tuple(j.helpers)) for j in want[0]]
    assert got[1:] == want[1:]
    assert_same_plan_arrays(
        pa.plan_arrays_for_scheme(scheme, _scheme_jobs(PORT, scheme, seed),
                                  random_seed=seed),
        jpa.plan_arrays_for_scheme(scheme, _scheme_jobs(REF, scheme, seed),
                                   random_seed=seed))


def _lowering_items(m):
    items = [m.pa.schedule_for_scheme("msrepair", _multi_jobs(m, s))
             for s in range(4)]
    items += [m.pa.schedule_for_scheme("random", _multi_jobs(m, s),
                                       random_seed=s) for s in range(2)]
    items.append(m.pa.schedule_for_scheme("traditional",
                                          _single_job(m, (1, 2, 3))))
    items.append(m.pa.schedule_for_scheme("ppr", _single_job(m, (70, 71))))
    return items


def test_lower_schedules_batch_equal():
    lims = [1] * 6 + [3, 1]          # traditional's fan-in of three
    got = pa.lower_schedules_batch(_lowering_items(PORT),
                                   max_recv_per_round=lims)
    want = jpa.lower_schedules_batch(_lowering_items(REF),
                                     max_recv_per_round=lims)
    assert got[-1] is None and want[-1] is None   # term ids >= 64
    for g, w in zip(got[:-1], want[:-1]):
        assert_same_plan_arrays(g, w)


@pytest.mark.parametrize("bad", [
    [[(1, 0, 0, 1 << 1), (1, 3, 0, 1 << 2)]],   # node 1 sends twice
    [[(1, 0, 0, 1 << 1), (2, 0, 0, 1 << 2)]],   # two arrivals at node 0
])
def test_lower_schedules_batch_rejects_alike(bad):
    errs = []
    for m in (PORT, REF):
        jobs = _single_job(m, (1, 2))
        with pytest.raises(ValueError) as exc:
            m.pa.lower_schedules_batch([(jobs, bad, {"scheme": "x"})])
        errs.append(str(exc.value))
    assert errs[0] == errs[1]


def test_plan_arrays_for_scheme_unsupported_alike():
    errs = []
    for m in (PORT, REF):
        with pytest.raises(m.arrays.UnsupportedPlanError) as exc:
            m.pa.plan_arrays_for_scheme("ppr", _single_job(m, (70, 71, 72)))
        errs.append(str(exc.value))
    assert errs[0] == errs[1]
