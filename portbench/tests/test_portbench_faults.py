"""The control and each fault of the timed path make `correct` false,
and the faults break the data the way `portbench/faults.py` says."""
import numpy as np
import pytest
import torch

from portbench import faults, harness, spec, traffic
from _runs import cell_args, result


@pytest.mark.parametrize("fault", faults.NAMES)
def test_fault_is_caught(fault):
    res, err = result(cell_args("rs63_node_loss", seed=5) + ["--fault", fault])
    assert res["correct"] is False
    assert res["checks"]["restored_blocks_wrong"]["value"] > 0
    assert any(line.startswith("check restored_bytes_wrong") for line in err)


def test_one_flipped_byte_is_caught():
    """One byte of each restored block, and nothing else."""
    res, _ = result(cell_args("rs104_two_node_loss", seed=6) + ["--fault", "flip_byte"])
    assert res["correct"] is False
    assert res["checks"]["restored_bytes_wrong"]["value"] == 1
    assert res["checks"]["parity_bytes_wrong"]["value"] == 0


def _first_batch(cell, seed, fault):
    """Batch 0 of the window on the CPU with `fault` installed: the
    bench, its lowered plans and its restored blocks."""
    bench = harness.Bench(spec.load_cell(cell), seed, torch.device("cpu"), 256)
    bench.make_pool()
    undo = faults.install(fault)
    try:
        batch = bench.batch(traffic.WINDOW, 0, marked=True)
    finally:
        undo()
    return bench, batch.plans, bench.sample.jobs


@pytest.mark.parametrize("cell", ["rs63_node_loss", "rs104_two_node_loss"])
def test_scale_noop_restores_the_xor_of_the_helpers(cell):
    bench, plans, jobs = _first_batch(cell, 31, "scale_noop")
    nodes = bench.cfg["cluster_nodes"]
    assert len(jobs) == bench.sample.offered >= len(plans)
    for job in jobs:
        pa, bmap = plans[job.stripe], bench.placement[job.stripe].block_map(nodes)
        j = [int(bmap[f]) for f in pa.job_failed].index(job.lost)
        helpers = bmap[pa.job_helpers[j, :int(pa.job_helpers_len[j])]]
        cw = bench.pool[job.stripe]
        want = torch.zeros_like(cw[0])
        for h in helpers:
            want ^= cw[int(h)]
        assert torch.equal(job.restored, want)
        assert not torch.equal(job.restored, cw[job.lost])


def test_round_noop_writes_each_groups_first_row():
    from repro_torch.kernels import ops

    rows = torch.randint(0, 256, (8, 64), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(3))
    groups = np.array([[0, 3, -1], [4, 1, 5], [6, -1, -1]])
    out_rows = np.array([0, 2, 7])
    folded = ops.xor_reduce_segments(rows.clone(), groups, out_rows=out_rows)
    assert torch.equal(folded[0], rows[0] ^ rows[3])
    undo = faults.install("round_noop")
    try:
        got = ops.xor_reduce_segments(rows.clone(), groups, out_rows=out_rows)
    finally:
        undo()
    want = rows.clone()
    want[out_rows] = rows[groups[:, 0]]
    assert torch.equal(got, want)


@pytest.mark.parametrize("fault", faults.NAMES)
def test_install_and_undo_leave_the_port_as_it_was(fault):
    from repro_torch.core.engine import dataplane
    from repro_torch.kernels import ops

    before = (dataplane.execute_plans_batch, ops.xor_reduce_segments,
              ops.gf256_scale_batch)
    faults.install(fault)()
    assert (dataplane.execute_plans_batch, ops.xor_reduce_segments,
            ops.gf256_scale_batch) == before
