"""On the card: a small run of each cell is correct and its control is
not.  Skipped without an NVIDIA GPU."""

import pytest

from conftest import small
from portbench import control, harness, judge

CELLS = ("h2o_1e8_k100.grid", "h2o_1e8_k100.sort")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_small_run_on_the_card(cuda_device, workload):
    cell = harness.Cell(workload)
    config = small(cell.config)
    result, summary = harness.run(workload, 2 ** 31 + 11, 0.5, True, cuda_device, config=config)
    assert result["correct"], (result["checks"], summary["errors"])
    assert result["device"]["platform"] == "gpu" and result["device"]["busy_s"] > 0
    assert 0 < result["metrics"]["scan_roofline"]["value"] <= 100
    numbers = control.control(cell, 2 ** 31 + 11, cuda_device, config)
    assert not judge.verdict(numbers, cell.limits)[1]
