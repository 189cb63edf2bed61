"""``correct`` comes out false when the timed path is broken underneath,
and the control (the reference in float32) fails every cell's limits; a
sound run is correct.  Each run skips the harness's look for a chip and
runs the rest on the CPU at a small size."""

import pytest
import torch

from conftest import small
from portbench import control, harness, judge

CELLS = ("h2o_1e8_k100.grid", "h2o_1e8_k100.sort")


def small_config(workload):
    return small(harness.Cell(workload).config)


def unchanged(monkeypatch):
    """Every pass's step returns its state unchanged."""
    from vaex_tpu_torch import tasks
    for cls in (tasks.TaskAggregations, tasks.TaskSetCreate, tasks.TaskMapIndex):
        monkeypatch.setattr(cls, "update", lambda self, state, ctx: state)


def half(monkeypatch):
    """Every second tile of a pass is left out; means are taken over the
    rest."""
    from vaex_tpu_torch import settings, tasks
    monkeypatch.setattr(settings, "TILE_ROWS", 2048)
    for cls in (tasks.TaskAggregations, tasks.TaskSetCreate, tasks.TaskMapIndex):
        update = cls.update

        def skipping(self, state, ctx, update=update):
            self._fault_tiles = getattr(self, "_fault_tiles", 0) + 1
            return state if self._fault_tiles % 2 == 0 else update(self, state, ctx)
        monkeypatch.setattr(cls, "update", skipping)


def altered(monkeypatch):
    """A groupby's answer has one aggregated value changed where the
    program hands it out."""
    from vaex_tpu_torch.dataframe import DataFrame
    groupby = DataFrame.groupby

    def altering(self, *args, **kwargs):
        out = groupby(self, *args, **kwargs)
        col = out.dataset[out.get_column_names()[-1]]
        col[0] += 1
        return out
    monkeypatch.setattr(DataFrame, "groupby", altering)


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(workload):
    result, summary = harness.run(workload, 2 ** 31 + 7, 0.2, False, "cpu",
                                  config=small_config(workload))
    assert result["correct"], (result["checks"], summary["errors"])
    assert result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("fault", [unchanged, half, altered], ids=lambda f: f.__name__)
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    config = small_config(workload)
    fault(monkeypatch)
    try:  # a window long enough that every question is asked at least once
        result, summary = harness.run(workload, 2 ** 31 + 7, 2.0, False, "cpu", config=config)
    except Exception:  # a fault that breaks the warm round fails the run outright
        return
    assert not result["correct"], (result["checks"], summary["questions"])


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails(workload):
    cell = harness.Cell(workload)
    for seed in (1, 2, 3):
        numbers = control.control(cell, seed, "cpu", small_config(workload))
        checks, within = judge.verdict(numbers, cell.limits)
        assert not within, checks


def test_the_limits_separate_rounding_from_float32():
    """Each float limit lies between float64's rounding and float32's."""
    for workload in CELLS:
        for name, limit in harness.Cell(workload).limits.items():
            if name != "mismatches":
                assert torch.finfo(torch.float64).eps < limit < torch.finfo(torch.float32).eps
