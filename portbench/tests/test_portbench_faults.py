"""The control and each fault of the timed path make `correct` false."""
import pytest

from portbench import faults
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
