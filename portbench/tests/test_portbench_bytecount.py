"""The kernels' byte counts, held to hand-counted plans and to the port's
own schedule of real plans."""
import json

import numpy as np
import pytest

from portbench import bytecount, spec
from repro_torch.core.engine import dataplane
from repro_torch.core.engine.arrays import compile_plan
from repro_torch.core.plan import Job, RepairPlan, Round, Transfer

NB = 1000
CELLS = [w["name"] for w in json.loads(
    (spec.HERE.parent / "BENCHMARK.json").read_text())["workloads"]]


def plan(jobs, rounds):
    return compile_plan(RepairPlan(
        jobs=[Job(job_id=i, failed_node=f, requestor=f, helpers=h)
              for i, (f, h) in enumerate(jobs)],
        rounds=[Round([Transfer(src=s, dst=d, job=j, terms=frozenset(t), path=p)
                       for s, d, j, t, p in rnd]) for rnd in rounds]))


def test_direct_plan():
    """RS(5,3), block 0 lost: helpers 1, 2, 3 each send to node 0."""
    pa = plan([(0, (1, 2, 3))],
              [[(1, 0, 0, {1}, ()), (2, 0, 0, {2}, ()), (3, 0, 0, {3}, ())]])
    assert bytecount.fold_rows(pa) == [(3, 1)]
    assert bytecount.scale_bytes([pa], NB) == 2 * 3 * NB
    assert bytecount.fold_bytes([pa], NB) == 4 * NB


def test_relayed_plan():
    """Helper 3 folds into 2 first (2 still holds its own row), helper 1's
    buffer goes to node 0 over relay 5, then 2's partial sum follows."""
    pa = plan([(0, (1, 2, 3))],
              [[(3, 2, 0, {3}, ()), (1, 0, 0, {1}, (1, 5, 0))],
               [(2, 0, 0, {2, 3}, ())]])
    # round 0: group at 2 reads 3's row and its own, group at 0 reads 1's
    # row: 3 read, 2 written; round 1: 0 holds 1's row, reads it and 2's
    assert bytecount.fold_rows(pa) == [(3, 2), (2, 1)]
    assert bytecount.fold_bytes([pa], NB) == 8 * NB
    assert bytecount.scale_bytes([pa], NB) == 6 * NB


def test_two_job_plan():
    """RS(6,3), blocks 0 and 1 lost, each job with its own helpers and
    its own slot on a node that both use."""
    pa = plan([(0, (2, 3, 4)), (1, (3, 4, 5))],
              [[(2, 3, 0, {2}, ()), (3, 4, 1, {3}, ()), (5, 1, 1, {5}, ())],
               [(3, 0, 0, {2, 3}, ()), (4, 0, 0, {4}, ()), (4, 1, 1, {3, 4}, ())]])
    # round 0: job 0 at 3 (2's row + own) 2 read; job 1 at 4 (3's row +
    # own) 2 read; job 1 at 1 (5's row) 1 read: 5 read, 3 written.
    # round 1: job 0 at 0 reads 3's and 4's rows; job 1 at 1 reads 4's
    # row and its own: 4 read, 2 written
    assert bytecount.fold_rows(pa) == [(5, 3), (4, 2)]
    assert bytecount.fold_bytes([pa], NB) == 14 * NB
    assert bytecount.scale_bytes([pa], NB) == 12 * NB


@pytest.mark.parametrize("cell", CELLS)
def test_counts_match_the_ports_schedule(cell):
    """On real plans, the rows the port's `_schedule` folds: each group's
    members read, each group's destination written."""
    from portbench import harness, traffic

    bench = harness.Bench(spec.load_cell(cell), 9, __import__("torch").device("cpu"), 64)
    cases = [traffic.draw_case(bench.cfg, bench.trf, 9, traffic.WINDOW, i) for i in range(8)]
    from repro_torch.sim import run_sweep

    res = run_sweep(traffic.BatchSuite("t", cases, bench.trf["scheme"]),
                    schemes=(bench.trf["scheme"],), keep_plans=True)
    plans = [compile_plan(c.results[bench.trf["scheme"]].plan) for c in res.cases]
    N = max(pa.num_nodes for pa in plans)
    _, steps, _ = dataplane._schedule(plans, N, max(pa.num_jobs for pa in plans) * N)
    rows = sum(int((s.groups >= 0).sum()) + len(s.dst_rows) for s in steps)
    assert bytecount.fold_bytes(plans, NB) == rows * NB
    assert np.all([r >= w for pa in plans for r, w in bytecount.fold_rows(pa)])
