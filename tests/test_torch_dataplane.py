"""The port's batched byte data plane held against repro's, and its own
serial walk.

`execute_plans_batch(device="cpu")` runs the kernels' plain versions on the
CPU (with `use_kernel=True` the plane-domain versions behind the kernel
wrappers, with `use_kernel=False` the byte-domain ones). Over the
`tests/test_dataplane.py` matrix — every scheme, single, double and rack
failures, mixed batches of codes, clusters and job counts, placed stripes —
the reconstructed bytes, `verified` and `bytes_moved` must equal the JAX
package's batched engine and the port's serial `execute_plan` exactly.
"""
import numpy as np
import pytest
import torch

from repro.core import executor as jexecutor
from repro.core import topology as jtopo
from repro.core.bandwidth import BandwidthProcess as JBandwidthProcess
from repro.core.bandwidth import IngressModel as JIngressModel
from repro.core.engine import dataplane as jdataplane
from repro.core.engine.arrays import compile_plan as jcompile_plan
from repro.core.engine.arrays import relabel_plan_nodes as jrelabel
from repro.core.plan import Job as JJob
from repro.core.plan import RepairPlan as JRepairPlan
from repro.core.plan import Round as JRound
from repro.core.plan import Transfer as JTransfer
from repro.core.simulator import Scenario as JScenario
from repro.ec.rs import RSCode as JRSCode
from repro.ec.stripe import place_stripes as jplace_stripes
from repro.sim.suite import sample_failures
from repro.sim.sweep import _verify_plan
from repro_torch import convert
from repro_torch.core import executor
from repro_torch.core.bandwidth import BandwidthProcess, IngressModel
from repro_torch.core.engine import dataplane
from repro_torch.core.engine.arrays import (compile_plan, decompile,
                                            relabel_plan_nodes)
from repro_torch.core.plan import (Job, RepairPlan, Round, Transfer,
                                   validate_plan)
from repro_torch.core.ppt import build_ppt_tree, ppt_round_plan
from repro_torch.core.simulator import Scenario, run_scheme
from repro_torch.ec.rs import RSCode
from repro_torch.ec.stripe import place_stripes

SINGLE = ("traditional", "ppr", "bmf", "bmf_static", "ppt")
MULTI = ("mppr", "random", "msrepair")


def _plans(n, k, failed, scheme, seed, cluster):
    """The same executed plan from both packages: (port PlanArrays,
    reference PlanArrays); asserts the two planners agree."""
    base = jtopo.heterogeneous_matrix(cluster, low=3, high=30, seed=seed)
    jsc = JScenario(num_nodes=cluster, code=JRSCode(n, k), failed=failed,
                    bw=JBandwidthProcess(base=base, change_interval=2.0,
                                         seed=seed, mode="markov"),
                    ingress=JIngressModel(seed=seed), chunk_mb=4.0)
    sc = Scenario(num_nodes=cluster, code=RSCode(n, k), failed=failed,
                  bw=BandwidthProcess(base=base, change_interval=2.0,
                                      seed=seed, mode="markov"),
                  ingress=IngressModel(seed=seed), chunk_mb=4.0)
    if scheme == "ppt":
        plan = ppt_round_plan(build_ppt_tree(sc.make_jobs()[0],
                                             sc.bw.matrix_at(0.0)))
    else:
        plan = run_scheme(sc, scheme, random_seed=seed).plan
    jpa = jcompile_plan(_verify_plan(jsc, scheme, seed,
                                     bmf_optimize_all=False))
    pa = compile_plan(plan)
    assert decompile(pa) == decompile(convert.plan_arrays_from_reference(jpa))
    return pa, jpa


def _codeword(rng, n, k, nbytes):
    return JRSCode(n, k).encode(
        rng.integers(0, 256, size=(k, nbytes), dtype=np.uint8))


def _assert_batch_equal(got, want):
    """Port batch result == reference batch result, exactly."""
    assert np.array_equal(got.verified, want.verified)
    assert got.bytes_moved.dtype == np.int64
    assert np.array_equal(got.bytes_moved, want.bytes_moved)
    assert len(got.reconstructed) == len(want.reconstructed)
    for g, w in zip(got.reconstructed, want.reconstructed):
        assert g.keys() == w.keys()
        for jid, blk in g.items():
            assert isinstance(blk, torch.Tensor) and blk.device.type == "cpu"
            assert np.array_equal(blk.numpy(), w[jid])


def _run_both(pas, jpas, n_or_codes, cws, block_of=None):
    codes = ([RSCode(c.n, c.k) for c in n_or_codes]
             if isinstance(n_or_codes, list) else RSCode(*n_or_codes))
    jcodes = ([JRSCode(c.n, c.k) for c in n_or_codes]
              if isinstance(n_or_codes, list) else JRSCode(*n_or_codes))
    want = jdataplane.execute_plans_batch(jpas, jcodes, cws,
                                          block_of=block_of, use_kernel=False)
    for use_kernel in (True, False):
        got = dataplane.execute_plans_batch(pas, codes, cws, block_of=block_of,
                                            use_kernel=use_kernel,
                                            device="cpu")
        _assert_batch_equal(got, want)
    return got, want


# ------------------------------------------------------- scheme-sweep parity
@pytest.mark.parametrize("scheme", SINGLE)
def test_single_failure_schemes_match_reference_and_serial(scheme, rng):
    pa, jpa = _plans(6, 3, (2,), scheme, seed=4, cluster=12)
    cw = _codeword(rng, 6, 3, 640)
    got, _ = _run_both([pa], [jpa], (6, 3), [cw])
    assert got.all_verified
    assert np.array_equal(got.reconstructed[0][0].numpy(), cw[2])
    ser = executor.execute_plan(decompile(pa), RSCode(6, 3), cw, device="cpu")
    assert ser.verified and ser.bytes_moved == int(got.bytes_moved[0])
    assert torch.equal(ser.reconstructed[0], got.reconstructed[0][0])


@pytest.mark.parametrize("scheme", MULTI)
@pytest.mark.parametrize("failed", [(1, 5), (0, 2, 6)])
def test_multi_failure_schemes_match_reference_and_serial(scheme, failed, rng):
    pa, jpa = _plans(7, 4, failed, scheme, seed=9, cluster=12)
    cw = _codeword(rng, 7, 4, 385)
    got, _ = _run_both([pa], [jpa], (7, 4), [cw])
    assert got.all_verified
    ser = executor.execute_plan(decompile(pa), RSCode(7, 4), cw, device="cpu")
    assert ser.verified and ser.bytes_moved == int(got.bytes_moved[0])
    for j, f in enumerate(failed):
        assert np.array_equal(got.reconstructed[0][j].numpy(), cw[f])
        assert torch.equal(ser.reconstructed[j], got.reconstructed[0][j])


MIXED = [
    ((4, 2), (0,), "traditional", 8), ((6, 3), (1,), "ppr", 10),
    ((7, 4), (3,), "bmf", 12), ((6, 3), (0, 2), "msrepair", 11),
    ((7, 4), (0, 1), "mppr", 13), ((6, 3), (1, 4), "random", 9),
    ((6, 3), (5,), "ppt", 12), ((7, 4), (2,), "bmf_static", 14),
]


@pytest.mark.parametrize("nbytes", [256, 257])
def test_mixed_batch_matches_reference_and_serial_case_by_case(nbytes, rng):
    """One heterogeneous batch (codes, clusters, schemes, job counts),
    with the reference's compiled plans carried across, equals the
    reference's batch and the port's serial walk per case."""
    pas, jpas, codes, cws = [], [], [], []
    for i, ((n, k), failed, scheme, cluster) in enumerate(MIXED):
        _, jpa = _plans(n, k, failed, scheme, seed=20 + i, cluster=cluster)
        pas.append(convert.plan_arrays_from_reference(jpa))
        jpas.append(jpa)
        codes.append(JRSCode(n, k))
        cws.append(_codeword(rng, n, k, nbytes))
    got, _ = _run_both(pas, jpas, codes, cws)
    assert got.all_verified
    for b, pa in enumerate(pas):
        ser = executor.execute_plan(decompile(pa), RSCode(codes[b].n, codes[b].k),
                                    cws[b], device="cpu")
        assert ser.verified and ser.bytes_moved == int(got.bytes_moved[b])
        for jid, blk in ser.reconstructed.items():
            assert torch.equal(blk, got.reconstructed[b][jid])


def test_batch_result_counts_its_segment_folds(rng, monkeypatch):
    """`rounds` is the number of segment folds the call ran: one per
    non-empty round of the batch."""
    pas, codes, cws = [], [], []
    for i, ((n, k), failed, scheme, cluster) in enumerate(MIXED):
        pa, _ = _plans(n, k, failed, scheme, seed=20 + i, cluster=cluster)
        pas.append(pa)
        codes.append(RSCode(n, k))
        cws.append(_codeword(rng, n, k, 64))
    folds = []
    plain = dataplane.ops.xor_reduce_segments

    def counted(*args, **kw):
        folds.append(1)
        return plain(*args, **kw)

    monkeypatch.setattr(dataplane.ops, "xor_reduce_segments", counted)
    got = dataplane.execute_plans_batch(pas, codes, cws, device="cpu")
    assert got.all_verified
    assert got.rounds == len(folds) == max(pa.num_rounds for pa in pas) > 1


def _matrix():
    """Deterministic stand-in for the reference's hypothesis sweep: codes x
    failure patterns x schemes x seeds."""
    cases = []
    for code_i, (n, k) in enumerate(((6, 3), (7, 4), (6, 4))):
        for pattern in ("single", "double", "rack"):
            for seed in (3, 1000 + 7 * code_i):
                cases.append((n, k, pattern, seed))
    return cases


@pytest.mark.parametrize("n,k,pattern,seed", _matrix())
def test_failure_pattern_matrix_matches_reference(n, k, pattern, seed):
    rng = np.random.default_rng(seed)
    failed = tuple(int(f) for f in sample_failures(rng, n, k, pattern))
    pool = SINGLE if len(failed) == 1 else MULTI
    scheme = pool[seed % len(pool)]
    pa, jpa = _plans(n, k, failed, scheme, seed=seed % 1024, cluster=n + 4)
    cw = _codeword(rng, n, k, 160)
    got, _ = _run_both([pa], [jpa], (n, k), [cw])
    assert got.all_verified
    for j, f in enumerate(failed):
        assert np.array_equal(got.reconstructed[0][j].numpy(), cw[f])


# ------------------------------------------------- stripe placement replay
def test_placed_stripes_relabeled_through_perm(rng):
    """Plans relabeled through rotated `place_stripes` placements still
    reconstruct each placed stripe's lost block, as in the reference."""
    cluster = 11
    pa, jpa = _plans(6, 3, (2,), "bmf", seed=5, cluster=cluster)
    stripes = place_stripes(5, RSCode(6, 3), cluster)
    jstripes = jplace_stripes(5, JRSCode(6, 3), cluster)
    pas, jpas, cws, bmaps = [], [], [], []
    for stripe, jstripe in zip(stripes, jstripes):
        assert np.array_equal(stripe.perm(cluster), jstripe.perm(cluster))
        pas.append(relabel_plan_nodes(pa, stripe.perm(cluster)))
        jpas.append(jrelabel(jpa, jstripe.perm(cluster)))
        cws.append(_codeword(rng, 6, 3, 333))
        bmaps.append(stripe.block_map(cluster))
    got, _ = _run_both(pas, jpas, (6, 3), cws, block_of=bmaps)
    assert got.all_verified
    for b in range(len(stripes)):
        assert np.array_equal(got.reconstructed[b][0].numpy(), cws[b][2])
        ser = executor.execute_plan(decompile(pas[b]), RSCode(6, 3), cws[b],
                                    block_of=bmaps[b], device="cpu")
        assert ser.verified and ser.bytes_moved == int(got.bytes_moved[b])


def test_tensor_codewords_and_plans_as_repair_plans(rng):
    """Codewords given as tensors and plans given as `RepairPlan`s (compiled
    on entry) run the same; results stay on the codewords' device."""
    pa, jpa = _plans(6, 3, (0,), "ppr", seed=2, cluster=9)
    cw = _codeword(rng, 6, 3, 100)
    want = jdataplane.execute_plans_batch([jpa], JRSCode(6, 3), [cw],
                                          use_kernel=False)
    got = dataplane.execute_plans_batch([decompile(pa)], RSCode(6, 3),
                                        [torch.from_numpy(cw)], device="cpu")
    _assert_batch_equal(got, want)
    empty = dataplane.execute_plans_batch([], RSCode(6, 3), [], device="cpu")
    assert empty.all_verified and empty.bytes_moved.shape == (0,)


# --------------------------------------------------- executable invariants
def _bad_plans(J, R, T, P):
    jobs = [J(job_id=0, failed_node=0, requestor=0, helpers=(1, 2))]
    consumed = P(jobs=jobs, rounds=[R(transfers=[T(1, 0, 0, frozenset({1}))]),
                                    R(transfers=[T(1, 0, 0, frozenset({1}))])])
    partial = P(jobs=jobs, rounds=[R(transfers=[T(1, 0, 0, frozenset({1}))])])
    sent_away = P(jobs=jobs, rounds=[R(transfers=[T(1, 2, 0, frozenset({1}))]),
                                     R(transfers=[T(2, 3, 0, frozenset({1, 2}))])])
    two_hop = P(jobs=jobs, rounds=[R(transfers=[T(1, 2, 0, frozenset({1}))]),
                                   R(transfers=[T(2, 0, 0, frozenset({1, 2}))])])
    return consumed, partial, sent_away, two_hop


def test_consumed_source_raises_as_reference(rng):
    consumed, *_ = _bad_plans(Job, Round, Transfer, RepairPlan)
    jconsumed, *_ = _bad_plans(JJob, JRound, JTransfer, JRepairPlan)
    cw = _codeword(rng, 4, 2, 64)
    with pytest.raises(ValueError, match="holds no buffer") as ours:
        dataplane.execute_plans_batch([consumed], [RSCode(4, 2)], [cw],
                                      device="cpu")
    with pytest.raises(ValueError, match="holds no buffer") as theirs:
        jdataplane.execute_plans_batch([jconsumed], [JRSCode(4, 2)], [cw],
                                       use_kernel=False)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("which", [1, 2])
def test_incomplete_plan_not_verified_as_reference(which, rng):
    """A plan whose requestor never gathers every term (or whose requestor
    slot ends empty) is reported unverified, with the same bytes."""
    plan = _bad_plans(Job, Round, Transfer, RepairPlan)[which]
    jplan = _bad_plans(JJob, JRound, JTransfer, JRepairPlan)[which]
    cw = _codeword(rng, 4, 2, 64)
    want = jdataplane.execute_plans_batch([jplan], [JRSCode(4, 2)], [cw],
                                          use_kernel=False)
    got = dataplane.execute_plans_batch([plan], [RSCode(4, 2)], [cw],
                                        device="cpu")
    assert not got.all_verified and not want.all_verified
    _assert_batch_equal(got, want)


def test_unplaced_block_raises_as_reference(rng):
    *_, two_hop = _bad_plans(Job, Round, Transfer, RepairPlan)
    *_, jtwo_hop = _bad_plans(JJob, JRound, JTransfer, JRepairPlan)
    cw = _codeword(rng, 4, 2, 64)
    bad_map = np.array([-1, 1, 2, 3])          # failed node 0 holds no block
    with pytest.raises(ValueError, match="holds no block") as ours:
        dataplane.execute_plans_batch([two_hop], [RSCode(4, 2)], [cw],
                                      block_of=[bad_map], device="cpu")
    with pytest.raises(ValueError, match="holds no block") as theirs:
        jdataplane.execute_plans_batch([jtwo_hop], [JRSCode(4, 2)], [cw],
                                       block_of=[bad_map], use_kernel=False)
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match="holds no block"):
        executor.execute_plan(two_hop, RSCode(4, 2), cw, block_of=bad_map,
                              device="cpu")
    with pytest.raises(ValueError, match="must align"):
        dataplane.execute_plans_batch([two_hop], [RSCode(4, 2)], [cw, cw],
                                      device="cpu")


def test_identity_block_map_moved_and_reexported():
    assert executor.identity_block_map is dataplane.identity_block_map
    assert executor.execute_plans_batch is dataplane.execute_plans_batch
    assert executor.BatchExecutionResult is dataplane.BatchExecutionResult
    for args in ((6, 4), (2, 4)):
        assert np.array_equal(dataplane.identity_block_map(*args),
                              jdataplane.identity_block_map(*args))
    assert jexecutor.identity_block_map(6, 4).tolist() == [0, 1, 2, 3, -1, -1]


def test_device_none_raises_without_a_card(monkeypatch, rng):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pa, _ = _plans(6, 3, (0,), "ppr", seed=2, cluster=9)
    cw = _codeword(rng, 6, 3, 64)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dataplane.execute_plans_batch([pa], RSCode(6, 3), [cw],
                                          device=device)


def test_schedule_keeps_sources_and_destinations_on_the_host():
    """The round tables name only rows that hold a buffer, each destination
    once per round, a held destination first in its group."""
    pa, _ = _plans(6, 3, (0,), "ppr", seed=2, cluster=9)
    N = pa.num_nodes
    pre_rows, steps, occupied = dataplane._schedule([pa], N, N)
    assert np.array_equal(pre_rows, pa.job_helpers[0])
    before = np.zeros(N, dtype=bool)
    before[pre_rows] = True
    assert len(steps) == pa.num_rounds
    for step in steps:
        assert np.unique(step.dst_rows).size == step.dst_rows.size
        assert step.groups.shape[0] == step.dst_rows.size
        live = step.groups[step.groups >= 0]
        assert np.unique(live).size == live.size
    first = steps[0]
    held_dst = before[first.dst_rows]
    assert np.array_equal(first.groups[held_dst, 0], first.dst_rows[held_dst])
    assert occupied[int(pa.job_requestor[0])]


# ------------------------------------------------ the buffer written in place
def _assert_in_place_safe(schedule):
    """Every row a round reads was written before (by the premultiply or an
    earlier round), each destination row is written once a round, and no
    row one group writes is read by another group of the same round."""
    pre_rows, steps, occupied = schedule
    written = set(pre_rows.tolist())
    assert len(written) == pre_rows.size
    for step in steps:
        assert np.unique(step.dst_rows).size == step.dst_rows.size
        for g, row in enumerate(step.dst_rows.tolist()):
            members = step.groups[g][step.groups[g] >= 0].tolist()
            assert set(members) <= written
            others = np.delete(step.groups, g, axis=0)
            assert row not in set(others[others >= 0].tolist())
            assert 0 <= row < occupied.size
        written.update(step.dst_rows.tolist())


def _send_and_receive_plans(J, R, T, P):
    """Node 2 sends its own buffer and receives 1's in the same round, so
    the row it receives into is read by another group: in `crossed` (four
    nodes) it sends to 3, in `tight` (RS(3,2), three nodes) to 0."""
    job = J(job_id=0, failed_node=0, requestor=0, helpers=(1, 2, 3))
    crossed = P(jobs=[job], rounds=[
        R(transfers=[T(1, 2, 0, frozenset({1})), T(2, 3, 0, frozenset({2}))]),
        R(transfers=[T(2, 0, 0, frozenset({1})), T(3, 0, 0, frozenset({2, 3}))])])
    job = J(job_id=0, failed_node=0, requestor=0, helpers=(1, 2))
    tight = P(jobs=[job], rounds=[
        R(transfers=[T(1, 2, 0, frozenset({1})), T(2, 0, 0, frozenset({2}))]),
        R(transfers=[T(2, 0, 0, frozenset({1}))])])
    return crossed, tight


# (n, k, cluster, failure pattern, scheme): the benchmark cells' traffic,
# RS(9,6) single losses under BMF and RS(14,10) rack pairs under MSRepair
CELL_TRAFFIC = {"node_loss": (9, 6, 14, "single", "bmf"),
                "two_node_loss": (14, 10, 16, "rack", "msrepair")}


@pytest.mark.parametrize("traffic", sorted(CELL_TRAFFIC))
def test_schedule_never_writes_a_row_another_group_reads(traffic, rng):
    """On the cells' draws, placed and relabeled as the benchmark does, at a
    small chunk size: the in-place invariant holds on every round, and the
    batch restores every lost block as the serial walk does."""
    n, k, cluster, pattern, scheme = CELL_TRAFFIC[traffic]
    code = RSCode(n, k)
    stripes = place_stripes(4, code, cluster)
    pas, cws, bmaps = [], [], []
    for seed in range(4):
        draw = np.random.default_rng(100 + seed)
        failed = tuple(int(f) for f in sample_failures(draw, n, k, pattern))
        sc = Scenario(num_nodes=cluster, code=code, failed=failed,
                      bw=BandwidthProcess(base=jtopo.heterogeneous_matrix(
                          cluster, low=3, high=30, seed=seed),
                          change_interval=2.0, seed=seed, mode="markov"),
                      ingress=IngressModel(seed=seed), chunk_mb=128.0)
        plan = run_scheme(sc, scheme, random_seed=seed).plan
        pas.append(relabel_plan_nodes(compile_plan(plan),
                                      stripes[seed].perm(cluster)))
        bmaps.append(stripes[seed].block_map(cluster))
        cws.append(_codeword(rng, n, k, 258))
    N = max(pa.num_nodes for pa in pas)
    S = max(pa.num_jobs for pa in pas) * N
    _assert_in_place_safe(dataplane._schedule(pas, N, S))
    for use_kernel in (True, False):
        got = dataplane.execute_plans_batch(pas, code, cws, block_of=bmaps,
                                            use_kernel=use_kernel,
                                            device="cpu")
        assert got.all_verified
        for b, pa in enumerate(pas):
            ser = executor.execute_plan(decompile(pa), code, cws[b],
                                        block_of=bmaps[b], device="cpu")
            assert ser.bytes_moved == int(got.bytes_moved[b])
            for jid, blk in ser.reconstructed.items():
                assert torch.equal(blk, got.reconstructed[b][jid])


@pytest.mark.parametrize("which", [0, 1])
def test_send_and_receive_in_one_round_is_refused(which):
    """The kernels fold a round in place, so a slot that sends and receives
    in one round would be written by one group while another reads it: the
    schedule refuses such a plan, as `validate_plan` does."""
    plan = _send_and_receive_plans(Job, Round, Transfer, RepairPlan)[which]
    with pytest.raises(ValueError, match="both sends and receives"):
        validate_plan(plan)
    n = (4, 3)[which]
    with pytest.raises(ValueError, match="validate_plan-clean"):
        dataplane._schedule([compile_plan(plan)], n, n)


@pytest.mark.parametrize("which", [0, 1])
def test_send_and_receive_in_one_round_raises_before_any_byte_moves(which,
                                                                     rng):
    from repro_torch import tracing

    plan = _send_and_receive_plans(Job, Round, Transfer, RepairPlan)[which]
    n, k = ((6, 3), (3, 2))[which]
    good, _ = _plans(6, 3, (0,), "ppr", seed=2, cluster=9)
    tracing.disable()
    tracing.clear()
    tracing.enable()
    try:
        with pytest.raises(ValueError, match="both sends and receives"):
            dataplane.execute_plans_batch(
                [good, plan], [RSCode(6, 3), RSCode(n, k)],
                [_codeword(rng, 6, 3, 64), _codeword(rng, n, k, 64)],
                block_of=[None, None], device="cpu")
        counts = tracing.snapshot()[1]
    finally:
        tracing.disable()
        tracing.clear()
    assert not any(name.startswith("dataplane.bytes.") for name in counts)
