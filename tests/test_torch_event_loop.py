"""repro_torch.kernels.event_loop: the sweep's event loops, on the CPU.

The kernels in `csrc/event_loop.cu` run only on the card, where
`chip_smoke.py` phase 2 holds them to these plain versions. Here the
plain versions (the wrappers' CPU route) are held to what the kernels'
design relies on and to the reference's numpy engine:

* per-case independence: a case's end time in a batch equals the same
  case run alone (the kernels run one case a block, the plain version
  steps the batch in lockstep, a finished case standing still);
* `execute_rounds` (all rounds in one call) equals chained one-round
  calls, including rounds in which some or all cases have no transfer;
* PPT's pipeline at depth 0, 1 and deep, and with cases that have no
  edge, against the reference's numpy `execute_pipeline_batch`;
* the index checks, the flags, the shape limits, the launch counters.

Inputs come from numpy seeds. Comparisons are bit for bit unless a
tolerance is stated (the reference's 1e-6 rtol across packages).
"""
import dataclasses
import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import bandwidth as jbw
from repro.core.engine import vectorized as jvec
from repro_torch.core import bandwidth, simulator
from repro_torch.core import topology
from repro_torch.core.engine import device_stepper, vectorized
from repro_torch.ec.rs import RSCode
from repro_torch.kernels import event_loop

ROOT = Path(__file__).resolve().parents[1]

GUARD = 100_000
RTOL = 1e-6
MULTI = ("mppr", "random", "msrepair")


# ------------------------------------------------------------ inputs
def synthetic_ctx(rng, B, N, E, M, *, interval, cycle, can_ovf=False):
    """E epochs of random bandwidth a case, ingress parameters and
    Dirichlet fan-in shares (chip_smoke.py's generator)."""
    stack = rng.uniform(3.0, 30.0, (B, E, N, N))
    shares = np.zeros((B, N, M + 1, M))
    shares[:, :, :, 0] = 1.0
    for m in range(2, M + 1):
        shares[:, :, m, :m] = rng.dirichlet(np.ones(m), (B, N))
    f64 = dict(dtype=torch.float64)
    return event_loop.EventCtx(
        stack=torch.tensor(stack, **f64),
        interval=torch.tensor(np.broadcast_to(interval, (B,)), **f64),
        num_ep=torch.full((B,), E, dtype=torch.int64),
        cycle=torch.tensor(np.broadcast_to(cycle, (B,))),
        can_ovf=torch.tensor(np.broadcast_to(can_ovf, (B,))),
        chunk=torch.tensor(rng.uniform(16.0, 256.0, B), **f64),
        degrade=torch.tensor(rng.uniform(0.0, 0.3, B), **f64),
        floor=torch.tensor(rng.uniform(0.2, 0.6, B), **f64),
        duplex=torch.tensor(rng.uniform(0.5, 1.0, B), **f64),
        shares=torch.tensor(shares, **f64))


def synthetic_rounds(rng, B, R, T, H, N, idle=0.3):
    paths = np.argsort(rng.random((B, R, T, N)), axis=-1)[..., :H + 1]
    n_hops = rng.integers(0, H + 1, (B, R, T))
    n_hops[rng.random((B, R)) < idle] = 0
    return paths[..., :-1].copy(), paths[..., 1:].copy(), n_hops


def mixed_ctx(rng, B=12, N=9, E=8, M=5):
    """Cycled and clamped traces and static networks in one batch."""
    interval = rng.uniform(0.05, 2.0, B)
    interval[::3] = np.inf
    return synthetic_ctx(rng, B, N, E, M, interval=interval,
                         cycle=np.arange(B) % 2 == 0)


def case_ctx(ctx, b):
    """Case b of a batch context, alone."""
    return event_loop.EventCtx(**{f.name: getattr(ctx, f.name)[b:b + 1]
                                  .clone() for f in dataclasses.fields(ctx)})


def rounds_of(ctx, hu, hv, nh, t0, **kw):
    return event_loop.round_events(ctx, hu, hv, nh, t0, guard=GUARD,
                                   **kw).numpy()


# ------------------------------------------------ per-case independence
def _scenario(m, scheme, seed, chunk, mode):
    failed = (0, 1) if scheme in MULTI else (0,)
    base = topology.heterogeneous_matrix(10, low=3, high=30, seed=seed)
    bwp = m.BandwidthProcess(base=base, change_interval=2.0, seed=seed,
                             mode=mode)
    return simulator.Scenario(
        num_nodes=10, code=RSCode(7, 4), failed=failed, bw=bwp,
        ingress=m.IngressModel(seed=seed, duplex=0.5), chunk_mb=chunk)


@pytest.mark.parametrize("mode", ["jitter", "redraw", "markov"])
@pytest.mark.parametrize("scheme", simulator.ALL_SCHEMES)
def test_case_in_a_batch_equals_the_case_alone(scheme, mode):
    """Each case of a mixed batch (seeds, chunk sizes: other step counts,
    horizons and fan-in tables) ends as it does alone."""
    chunks = (8.0, 64.0, 16.0, 128.0)

    def make(i):
        return _scenario(bandwidth, scheme, i, chunks[i], mode)

    batch = vectorized.run_scheme_vectorized(
        [make(i) for i in range(4)], scheme, seeds=list(range(4)),
        backend="device", device="cpu")
    for i, got in enumerate(batch):
        alone = vectorized.run_scheme_vectorized(
            [make(i)], scheme, seeds=[i], backend="device", device="cpu")[0]
        assert got.total_time == alone.total_time, (scheme, mode, i)
        assert got.round_times == alone.round_times
        assert got.num_rounds == alone.num_rounds


def test_a_finished_case_stands_still():
    """Steps past a case's end change nothing: a batch padded with a
    case that needs many more steps gives the others' results."""
    rng = np.random.default_rng(3)
    ctx = mixed_ctx(rng)
    hu, hv, nh = synthetic_rounds(rng, 12, 1, 6, 3, 9, idle=0.0)
    t0 = rng.uniform(0.0, 3.0, 12)
    whole = rounds_of(ctx, hu, hv, nh, t0)
    for b in (0, 5, 11):
        one = case_ctx(ctx, b)
        alone = rounds_of(one, hu[b:b + 1], hv[b:b + 1], nh[b:b + 1],
                          t0[b:b + 1])
        assert np.array_equal(alone[:, :, 0], whole[:, :, b])


# --------------------------------------------- rounds: one call vs chain
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_execute_rounds_equals_chained_execute_round(seed):
    rng = np.random.default_rng(seed)
    B, R, T, H, N = 12, 5, 7, 3, 9
    ctx = mixed_ctx(rng, B, N)
    hu, hv, nh = synthetic_rounds(rng, B, R, T, H, N)
    nh[:, 2] = 0                           # a round no case has
    t0 = rng.uniform(0.0, 3.0, B)
    whole = rounds_of(ctx, hu, hv, nh, t0)
    assert not whole[event_loop.FLAGS].any()
    t = t0
    for r in range(R):
        one = rounds_of(ctx, hu[:, r:r + 1], hv[:, r:r + 1], nh[:, r:r + 1],
                        t)
        assert np.array_equal(one[event_loop.T_END, 0],
                              whole[event_loop.T_END, r])
        assert np.array_equal(one[event_loop.STEPS, 0],
                              whole[event_loop.STEPS, r])
        t = one[event_loop.T_END, 0]
    idle = nh.max(axis=2) == 0             # (B, R): no transfer that round
    before = np.concatenate([t0[None], whole[event_loop.T_END, :-1]])
    assert np.array_equal(whole[event_loop.T_END].T[idle], before.T[idle])
    assert (whole[event_loop.STEPS].T[idle] == 0).all()
    assert (whole[event_loop.STEPS, 2] == 0).all()


def test_engine_rounds_equal_chained_rounds(monkeypatch):
    """`DeviceRoundEngine.execute_rounds` against `execute_round` round by
    round on the sweep's own inputs (the engine's tables and epochs)."""
    calls = []
    original = event_loop.round_events

    def record(ctx, *args, **kwargs):
        out = original(ctx, *args, **kwargs)
        calls.append((ctx, [np.array(a) for a in args[:-1]],
                      np.array(args[-1]), out.numpy().copy()))
        return out

    monkeypatch.setattr(event_loop, "round_events", record)
    scs = [_scenario(bandwidth, "ppr", s, 32.0, "markov") for s in range(4)]
    vectorized.run_scheme_vectorized(scs, "ppr", seeds=list(range(4)),
                                     backend="device", device="cpu")
    ctx, (hu, hv, nh), t0, whole = next(c for c in calls
                                        if c[3].shape[1] > 1)
    t = t0
    for r in range(whole.shape[1]):
        one = rounds_of(ctx, hu[:, r:r + 1], hv[:, r:r + 1], nh[:, r:r + 1],
                        t)
        assert np.array_equal(one[0, 0], whole[0, r])
        t = one[0, 0]


# ----------------------------------------------------------- pipeline
def _trees(rng, B, N, shape):
    """(B, N - 1) edges of trees rooted at 0: "zero" (depth 0: no level
    scanned), "flat" (depth 1), "deep" (a chain), "mixed"; some edges
    missing, case 0 with none."""
    E = N - 1
    child = np.tile(np.arange(1, N), (B, 1))
    parent = np.zeros((B, E), dtype=np.int64)
    for b in range(B):
        for e, c in enumerate(range(1, N)):
            parent[b, e] = {"flat": 0, "zero": 0, "deep": c - 1}.get(
                shape, int(rng.integers(0, c)))
    depth = np.zeros((B, E), dtype=np.int64)
    for e in range(E):
        up = np.maximum(parent[:, e] - 1, 0)
        depth[:, e] = np.where(parent[:, e] == 0, 1,
                               depth[np.arange(B), up] + 1)
    if shape == "zero":
        depth[:] = 0
    valid = rng.random((B, E)) < 0.85
    valid[0] = False
    return child, parent, depth, valid


@pytest.mark.parametrize("shape", ["zero", "flat", "mixed", "deep"])
def test_pipeline_against_the_reference_numpy_engine(shape):
    """The pipeline's plain route (through `DevicePipelineEngine` on traces
    that cycle or clamp) against the reference's `execute_pipeline_batch`
    on the same traces and ingress models."""
    rng = np.random.default_rng(11)
    B, N = 6, 8
    epochs = rng.uniform(3.0, 30.0, (B, 6, N, N))
    child, parent, depth, valid = _trees(rng, B, N, shape)
    t0 = rng.uniform(0.0, 2.0, B)

    def make(m, b):
        trace = m.BandwidthTrace(epochs[b], change_interval=0.5 + 0.25 * b,
                                 cycle=b % 2 == 0)
        return simulator.Scenario(
            num_nodes=N, code=RSCode(6, 3), failed=(0,), bw=trace,
            ingress=m.IngressModel(seed=b, duplex=0.5 + 0.1 * b),
            chunk_mb=16.0 * (b + 1))

    scs = [make(bandwidth, b) for b in range(B)]
    engine = device_stepper.make_pipeline_engine(scs, N, parent, valid,
                                                 device="cpu")
    got = engine.execute(child, parent, depth, valid, t0)
    ref = [make(jbw, b) for b in range(B)]
    want = jvec.execute_pipeline_batch(
        child, parent, depth, valid, t0,
        jvec._BatchBandwidth([sc.bw for sc in ref], N),
        [sc.ingress for sc in ref], jvec._chunk_array(ref), {},
        *jvec._ingress_params(ref))
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert got[0] == t0[0]                 # no edge: no time passes


def test_pipeline_case_alone_equals_batch():
    rng = np.random.default_rng(5)
    B, N = 8, 10
    ctx = mixed_ctx(rng, B, N, M=N - 1)
    tables = _trees(rng, B, N, "mixed")
    t0 = rng.uniform(0.0, 2.0, B)
    whole = event_loop.pipeline_events(ctx, *tables, t0, guard=GUARD).numpy()
    assert not whole[event_loop.FLAGS].any()
    for b in range(B):
        one = case_ctx(ctx, b)
        alone = event_loop.pipeline_events(
            one, *(a[b:b + 1] for a in tables), t0[b:b + 1],
            guard=GUARD).numpy()
        assert np.array_equal(alone[:, 0, 0], whole[:, 0, b])


# ------------------------------------------------- flags and the guard
def test_overflow_and_guard_flags_raise():
    rng = np.random.default_rng(2)
    B, N = 6, 8
    ctx = synthetic_ctx(rng, B, N, 2, 4, interval=0.05, cycle=False,
                        can_ovf=True)
    tables = synthetic_rounds(rng, B, 2, 5, 2, N, idle=0.0)
    out = rounds_of(ctx, *tables, np.zeros(B))
    assert (out[event_loop.FLAGS, 0] == event_loop.OVERFLOW).any()
    with pytest.raises(event_loop.EpochHorizonError):
        event_loop.check_flags(out[event_loop.FLAGS])
    trees = _trees(rng, B, N, "mixed")
    out = event_loop.pipeline_events(ctx, *trees, np.zeros(B),
                                     guard=GUARD).numpy()
    with pytest.raises(event_loop.EpochHorizonError):
        event_loop.check_flags(out[event_loop.FLAGS])
    ctx.can_ovf[:] = False
    out = event_loop.round_events(ctx, *tables, np.zeros(B), guard=3).numpy()
    assert set(np.unique(out[event_loop.FLAGS, 0])) <= {0, event_loop.STALLED}
    with pytest.raises(RuntimeError, match="failed to converge"):
        event_loop.check_flags(out[event_loop.FLAGS])


def test_check_flags_takes_the_first_flagged_round():
    ok = np.zeros((3, 4))
    event_loop.check_flags(ok)
    flags = ok.copy()
    flags[1, 2] = event_loop.STALLED
    flags[2, 0] = event_loop.OVERFLOW
    with pytest.raises(RuntimeError, match="failed to converge") as info:
        event_loop.check_flags(flags)
    assert not isinstance(info.value, event_loop.EpochHorizonError)
    flags[1, 3] = event_loop.OVERFLOW
    with pytest.raises(event_loop.EpochHorizonError):
        event_loop.check_flags(flags)


# ----------------------------------------------------- index checks
def test_index_checks_raise():
    rng = np.random.default_rng(0)
    B, N = 4, 6
    ctx = synthetic_ctx(rng, B, N, 4, 3, interval=1.0, cycle=True)
    hu, hv, nh = synthetic_rounds(rng, B, 1, 3, 2, N)
    for bad in (N, -1):
        wrong = hu.copy()
        wrong[1, 0, 2, 1] = bad
        with pytest.raises(IndexError, match=r"hop_u .*\[0, 6\)"):
            event_loop.round_events(ctx, wrong, hv, nh, np.zeros(B),
                                    guard=GUARD)
        with pytest.raises(IndexError, match="hop_v"):
            event_loop.round_events(ctx, hu, wrong, nh, np.zeros(B),
                                    guard=GUARD)
    child, parent, depth, valid = _trees(rng, B, N, "mixed")
    bad_parent = parent.copy()
    bad_parent[2, 1] = N
    with pytest.raises(IndexError, match="parent"):
        event_loop.pipeline_events(ctx, child, bad_parent, depth, valid,
                                   np.zeros(B), guard=GUARD)
    bad_child = child.copy()
    bad_child[0, 0] = -3
    with pytest.raises(IndexError, match="child"):
        event_loop.pipeline_events(ctx, bad_child, parent, depth, valid,
                                   np.zeros(B), guard=GUARD)
    with pytest.raises(TypeError, match="integers"):
        event_loop.round_events(ctx, hu.astype(float), hv, nh, np.zeros(B),
                                guard=GUARD)
    with pytest.raises(ValueError, match="n_hops"):
        event_loop.round_events(ctx, hu, hv, nh[:, :, :2], np.zeros(B),
                                guard=GUARD)


def test_node_table_is_contiguous_int32():
    table = np.arange(24, dtype=np.int64).reshape(2, 3, 4)[:, :, ::2] % 5
    out = event_loop.node_table(table, 5, "t")
    assert out.dtype == np.int32 and out.flags.c_contiguous
    assert np.array_equal(out, table)


# ----------------------------------------------- routes and counters
def test_no_launch_on_the_cpu_or_without_the_kernel():
    rng = np.random.default_rng(1)
    B, N = 4, 6
    ctx = synthetic_ctx(rng, B, N, 4, N - 1, interval=1.0, cycle=True)
    rounds = synthetic_rounds(rng, B, 2, 3, 2, N)
    trees = _trees(rng, B, N, "mixed")
    before = (event_loop.round_events.launches,
              event_loop.pipeline_events.launches)
    for use_kernel in (True, False):
        a = event_loop.round_events(ctx, *rounds, np.zeros(B), guard=GUARD,
                                    use_kernel=use_kernel)
        b = event_loop.pipeline_events(ctx, *trees, np.zeros(B),
                                       guard=GUARD, use_kernel=use_kernel)
        assert a.device.type == b.device.type == "cpu"
        assert a.shape == (3, 2, B) and b.shape == (3, 1, B)
    assert (event_loop.round_events.launches,
            event_loop.pipeline_events.launches) == before


def test_forced_routes_run_the_plain_version_on_the_cpu():
    """`_route` picks a kernel; a CPU tensor still takes the plain version,
    whatever the route, and nothing is counted."""
    rng = np.random.default_rng(2)
    B, N = 3, 6
    ctx = synthetic_ctx(rng, B, N, 4, N - 1, interval=1.0, cycle=True)
    rounds = synthetic_rounds(rng, B, 2, 3, 2, N)
    trees = _trees(rng, B, N, "mixed")
    before = (dict(event_loop.round_events.routes),
              dict(event_loop.pipeline_events.routes))
    want = [event_loop.round_events(ctx, *rounds, np.zeros(B), guard=GUARD),
            event_loop.pipeline_events(ctx, *trees, np.zeros(B), guard=GUARD)]
    for route in event_loop.ROUTES:
        got = [event_loop.round_events(ctx, *rounds, np.zeros(B), guard=GUARD,
                                       _route=route),
               event_loop.pipeline_events(ctx, *trees, np.zeros(B),
                                          guard=GUARD, _route=route)]
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (event_loop.round_events.routes,
            event_loop.pipeline_events.routes) == before
    assert set(before[0]) == set(event_loop.ROUTES) == {"warp", "block"}


@pytest.mark.parametrize("lanes,nodes,forced,route", [
    (13, 14, None, "warp"), (32, 32, None, "warp"), (33, 14, None, "block"),
    (13, 33, None, "block"), (13, 14, "block", "block"),
    (32, 14, "warp", "warp"), (300, 70, "block", "block")])
def test_the_route_follows_the_shape(lanes, nodes, forced, route):
    assert event_loop.pick_route(lanes, nodes, forced) == route
    assert event_loop.warp_route_fits(lanes, nodes) == (lanes <= 32
                                                        and nodes <= 32)


def test_a_forced_route_that_cannot_run_raises():
    with pytest.raises(event_loop.DeviceUnsupported, match="warp route"):
        event_loop.pick_route(40, 48, "warp")
    with pytest.raises(event_loop.DeviceUnsupported, match="warp route"):
        event_loop.pick_route(13, 33, "warp")
    with pytest.raises(ValueError, match="route must be one of"):
        event_loop.pick_route(13, 14, "grid")
    # the block route's shared-memory limit holds where the warp's does not
    with pytest.raises(event_loop.DeviceUnsupported, match="shared memory"):
        event_loop._launch_route(10_000, 14, None,
                                 event_loop.check_round_shape)
    assert event_loop._launch_route(30, 14, None, None) == "warp"


def test_the_profiled_copy_is_the_kernel_source_with_stamps():
    """scripts/event_loop_profiled.cu, which the step breakdown builds, is
    the package's kernel source plus its clock64() stamps, line for line;
    the package's source has no stamp and one case-warps constant."""
    spec = importlib.util.spec_from_file_location(
        "event_loop_breakdown", ROOT / "scripts" / "event_loop_breakdown.py")
    breakdown = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(breakdown)
    src = (event_loop.build.CSRC / "event_loop.cu").read_text()
    profiled = breakdown.PROFILED.read_text()
    assert breakdown.without_stamps(profiled) == src
    stamps = [line.split("(")[0].strip() for line in profiled.splitlines()
              if breakdown.STAMP.match(line)]
    assert stamps.count("PROF_BEGIN;") == stamps.count("PROF_END") == 4
    assert "PROF" not in src and "clock64" not in src
    assert "EVENT_LOOP" not in src      # no build knob: one shipped build
    assert "kCaseWarps = 8;" in breakdown.with_case_warps(src, 8)


def test_other_devices_raise():
    rng = np.random.default_rng(1)
    ctx = synthetic_ctx(rng, 2, 4, 2, 2, interval=1.0, cycle=True)
    meta = event_loop.EventCtx(**{f.name: getattr(ctx, f.name).to("meta")
                                  for f in dataclasses.fields(ctx)})
    hu, hv, nh = synthetic_rounds(rng, 2, 1, 2, 1, 4)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        event_loop.round_events(meta, hu, hv, nh, np.zeros(2), guard=GUARD)


def test_plain_version_counts_steps_and_syncs():
    class Counts:
        steps = 0
        host_syncs = 0

    rng = np.random.default_rng(4)
    ctx = mixed_ctx(rng)
    rounds = synthetic_rounds(rng, 12, 3, 5, 2, 9)
    counts = Counts()
    out = event_loop.round_events(ctx, *rounds, np.zeros(12), guard=GUARD,
                                  sync_every=4, counts=counts)
    per_round = out[event_loop.STEPS].max(dim=1).values
    assert counts.steps % 4 == 0 and counts.steps >= per_round.sum()
    assert counts.host_syncs == counts.steps // 4


# ------------------------------------------------------- shape limits
def test_shape_limits_send_big_cases_to_the_host():
    assert event_loop.round_smem_bytes(13, 14) == 8 * (39 + 14 + 8) + 4 * 40
    assert event_loop.pipeline_smem_bytes(13, 14) == \
        8 * (52 + 28 + 8) + 4 * (52 + 28)
    event_loop.check_round_shape(14, 14)
    event_loop.check_pipeline_shape(13, 14)
    with pytest.raises(event_loop.DeviceUnsupported, match="shared memory"):
        event_loop.check_round_shape(10_000, 14)
    with pytest.raises(event_loop.DeviceUnsupported, match="tree edges"):
        event_loop.check_pipeline_shape(8_000, 14)
    assert device_stepper.DeviceUnsupported is event_loop.DeviceUnsupported
    assert device_stepper.EpochHorizonError is event_loop.EpochHorizonError


def test_engine_factories_take_use_kernel(monkeypatch):
    """On the CPU both settings run the plain version; every call is
    counted, and each reads the host once besides the loop's reads."""
    factory = device_stepper.make_pipeline_engine
    scs = [_scenario(bandwidth, "ppt", s, 16.0, "markov") for s in range(3)]
    seen = []
    for use_kernel in (True, False):
        made = []

        def make(*args, _flag=use_kernel, **kwargs):
            made.append(factory(*args, **kwargs, use_kernel=_flag))
            return made[-1]

        monkeypatch.setattr(device_stepper, "make_pipeline_engine", make)
        device_stepper.COUNTS.reset()
        seen.append([r.total_time for r in vectorized.run_scheme_vectorized(
            scs, "ppt", backend="device", device="cpu")])
        c = device_stepper.COUNTS
        assert c.pipeline_calls == 1 and c.round_calls == 0
        assert c.host_syncs > 1 and c.device_batches == 1
        assert made[0].use_kernel is use_kernel and not made[0].on_kernel
    assert seen[0] == seen[1]
    device_stepper.COUNTS.reset()


# ------------------------------------------------------------ imports
def test_imports_without_nvcc_triton_or_a_card():
    code = ("import sys; import repro_torch.kernels.event_loop as el; "
            "from repro_torch.kernels import build; "
            "assert build.load_library.cache_info().currsize == 0; "
            "assert 'triton' not in sys.modules; "
            "assert 'jax' not in sys.modules and 'repro' not in sys.modules; "
            "print('ok')")
    env = {"PATH": "/usr/bin:/bin", "CUDA_HOME": "/nonexistent",
           "PYTHONPATH": ":".join(p for p in sys.path if p)}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_source_matches_the_wrappers():
    """The constants and C entry points the wrappers rely on, as the
    kernel source states them (it is compiled only on the card)."""
    src = (event_loop.build.CSRC / "event_loop.cu").read_text()
    for name in ("round_events_launch", "pipeline_events_launch"):
        assert f'extern "C" int {name}(' in src, name
    for name in ("round_events_smem", "pipeline_events_smem"):
        assert f'extern "C" long long {name}(' in src, name
    assert f"kOverflow = {event_loop.OVERFLOW};" in src
    assert f"kStalled = {event_loop.STALLED};" in src
    assert f"kMaxThreads = {event_loop._THREADS_MAX};" in src
    assert "kEps = 1e-9;" in src and event_loop.EPS == 1e-9
    # the warp route: its size, the route codes, the launch functions'
    # `route` argument before the stream (always one of the two: the
    # wrapper picks the route, the launch function only refuses a warp
    # launch that does not fit)
    assert f"kWarpLanes = {event_loop.WARP_LANES};" in src
    assert (f"kRouteWarp = {event_loop.ROUTES['warp']}, "
            f"kRouteBlock = {event_loop.ROUTES['block']};") in src
    assert "kRouteAuto" not in src
    assert src.count("int route, void* stream) {") == 2
    for kernel in ("round_events_kernel", "round_events_warp_kernel",
                   "pipeline_events_kernel", "pipeline_events_warp_kernel"):
        assert f"{kernel}<<<" in src, kernel
    code = "\n".join(line.split("//")[0] for line in src.splitlines())
    for intrinsic in ("__ballot_sync", "__all_sync", "__any_sync",
                      "__reduce_max_sync", "__reduce_min_sync", "__shfl_sync",
                      "__shfl_xor_sync", "__syncwarp", "__popc",
                      "cp.async"):
        assert intrinsic in code, intrinsic
