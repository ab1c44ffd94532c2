"""The harness draws and does the same work for a seed as the harness it
replaced: the draws of three streams, and the bytes the traced batches
move and count. The constants were read, for the same seed, from the
harness of the benchmark's previous version (the two older cells from
its own `BENCHMARK.json`; `rs104_node_loss` from it with this cell's
files added)."""
import hashlib
import json

import pytest

from portbench import spec, traffic
from _runs import cell_args, result

SEED = 2147483721

DRAWS = {
    ("hdfs_rs_6_3", "node_loss"): "6fbf57577942abca",
    ("hdfs_rs_10_4", "two_node_loss"): "7084ad135bee5e27",
    ("hdfs_rs_10_4", "node_loss"): "120c9d92946152c0",
    ("hdfs_rs_10_4_t8", "node_loss"): "120c9d92946152c0",
}

# (net_bytes_per_lost_byte, dataplane_bytes_per_lost_byte) at 4 KiB blocks
BYTES = {
    "rs63_node_loss": (8.5625, 30.000244140625),
    "rs104_two_node_loss": (13.875, 46.000244140625),
    "rs104_node_loss": (14.125, 46.000244140625),
}


@pytest.mark.parametrize("config,mix", list(DRAWS))
def test_draws_are_unchanged(config, mix):
    cfg = json.loads((spec.HERE / "configs" / f"{config}.json").read_text())
    trf = json.loads((spec.HERE / "traffic" / f"{mix}.json").read_text())
    h = hashlib.sha256()
    for stream in (traffic.WARM, traffic.WINDOW, traffic.TRACED):
        for i in range(32):
            case = traffic.draw_case(cfg, trf, SEED, stream, i)
            sc = case.scenario
            h.update(repr((case.seed, sc.failed,
                           sc.bw.base.round(9).tolist())).encode())
    assert h.hexdigest()[:16] == DRAWS[config, mix]


@pytest.mark.parametrize("cell", list(BYTES))
def test_bytes_counted_are_unchanged(cell):
    res, _ = result(cell_args(cell, seed=SEED, trace=1))
    metrics = res["metrics"]
    assert (metrics["net_bytes_per_lost_byte"]["value"],
            metrics["dataplane_bytes_per_lost_byte"]["value"]) == BYTES[cell]
