"""Per-cell percentiles, the port against vaex_tpu on the same seeded
arrays: ``median_approx`` / ``median`` / ``percentile_approx`` per group and
per cell of ``binby``, exact (one sort of the collected (cell, value) pairs,
over several tiles) and approximate (the [G, B] count grid through the
additive plan), with NaN and masked values, an empty group and
``selection=``.

Both packages interpolate between the two bracketing order statistics, so
the exact answers agree to the float contract (1e-6 relative, 1e-7
absolute; in fact they are equal), and the binned answers too, both
computed from the same counts.
"""

import numpy as np
import numpy.testing as npt
import pytest

import vaex_tpu
import vaex_tpu_torch
from torch_port_helpers import ATOL, RTOL, assert_same_frame, same_frames
from vaex_tpu_torch.ops import grid_plan


def _arrays(seed, n=6000, k=12):
    """A key k in 0..k-2 (the last category stays empty), a float v with
    NaN, a masked float vm, an int i, a float u for continuous bins."""
    rng = np.random.default_rng(seed)
    v = rng.normal(0, 10, n)
    v[::13] = np.nan
    return {"k": rng.integers(0, k - 1, n), "v": v,
            "vm": np.ma.MaskedArray(rng.normal(5, 2, n), rng.random(n) < 0.2),
            "i": rng.integers(-1000, 1000, n), "u": rng.uniform(-1, 1, n)}


@pytest.fixture(scope="module")
def frames():
    """Both packages' frames, categorized on k (12 labels, the last empty),
    in tiles of 1000 rows: an exact percentile collects six tiles."""
    return same_frames(_arrays(1), category="k", labels=list(range(12)), tile_rows=1000)


def _agg(pkg, kind, column, **kw):
    a = pkg.agg
    if kind == "median":
        return a.median_approx(column, **kw)
    if kind == "median_exact":
        return a.median(column, percentile_shape=None, **kw)
    return a.percentile_approx(column, kind, **kw)


@pytest.mark.parametrize("column", ["v", "vm", "i"])
@pytest.mark.parametrize("kind,exact", [("median", None), ("median_exact", None), (10.0, None),
                                        (90.0, None), ("median", False), (10.0, False),
                                        (90.0, False)])
def test_groupby_percentile_matches_vaex_tpu(frames, column, kind, exact):
    ref, port = frames
    kw = {} if exact is None else {"exact": exact}
    want = ref.groupby("k", agg={"p": _agg(vaex_tpu, kind, column, **kw)}, sort=True)
    got = port.groupby("k", agg={"p": _agg(vaex_tpu_torch, kind, column, **kw)}, sort=True)
    assert_same_frame(want, got)
    assert np.isnan(got["p"].tolist()[-1])  # the empty category
    strategy = port.executor.trace_log[-1]["strategies"][0]
    if exact is False:  # the [15 cells, 1024 bins] count grid through the additive plan
        assert strategy["percentile"] == grid_plan.strategy(1000, 15 * 1024, 0, 0, True)
    else:
        assert strategy["percentile_exact"] == "sort"


def test_the_exact_median_interpolates_between_order_statistics():
    """Two values in a group give their midpoint; one value itself; numpy's
    median in every group of a raw key."""
    rng = np.random.default_rng(2)
    n = 4000
    arrays = {"k": rng.integers(0, 50, n), "v": rng.normal(0, 1, n)}
    arrays["k"][:3] = [1000, 1000, 2000]
    arrays["v"][:3] = [1.0, 4.0, -7.5]
    ref, port = same_frames(arrays, tile_rows=700)
    got = port.groupby("k", agg={"m": vaex_tpu_torch.agg.median("v")}, sort=True)
    want = ref.groupby("k", agg={"m": vaex_tpu.agg.median("v")}, sort=True)
    assert_same_frame(want, got)
    keys, medians = np.asarray(got["k"].tolist()), np.asarray(got["m"].tolist())
    for key, m in zip(keys, medians):
        npt.assert_allclose(m, np.median(arrays["v"][arrays["k"] == key]), rtol=1e-12)
    assert medians[keys == 1000][0] == 2.5 and medians[keys == 2000][0] == -7.5


def test_several_percentages_and_a_selection(frames):
    ref, port = frames
    specs = {"q": ([25, 75], {}), "s": (50.0, {"selection": "u > 0"}),
             "a": ([5, 95], {"exact": False, "selection": "i > 0"})}
    want = ref.groupby("k", agg={name: vaex_tpu.agg.percentile_approx("v", p, **kw)
                                 for name, (p, kw) in specs.items()}, sort=True)
    got = port.groupby("k", agg={name: vaex_tpu_torch.agg.percentile_approx("v", p, **kw)
                                 for name, (p, kw) in specs.items()}, sort=True)
    for name in specs:
        npt.assert_allclose(np.asarray(got.evaluate(name), dtype=np.float64),
                            np.asarray(want.evaluate(name), dtype=np.float64),
                            rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("exact", [None, False])
def test_binby_median_per_cell(frames, exact):
    """The median of i per cell of a continuous axis and of the category,
    with a selection."""
    ref, port = frames
    kw = {} if exact is None else {"exact": exact}
    args = dict(by=["u", "k"], limits=[[-1, 1], None], shape=[5, 12])
    want = ref.binby(agg={"m": vaex_tpu.agg.median_approx("i", selection="v > 0", **kw)},
                     **args)
    got = port.binby(agg={"m": vaex_tpu_torch.agg.median_approx("i", selection="v > 0", **kw)},
                     **args)
    npt.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert np.asarray(got).shape == (5, 12)


def test_exact_true_past_the_row_limit_raises_and_the_approximation_runs(monkeypatch):
    """Past EXACT_MAX_ROWS the median takes the count grid (and its limits
    pre-pass); exact=True raises there, as in vaex_tpu."""
    ref, port = same_frames(_arrays(3, n=3000), category="k", labels=list(range(12)))
    for pkg in (vaex_tpu, vaex_tpu_torch):
        monkeypatch.setattr(pkg.agg.AggregatorDescriptorPercentile, "EXACT_MAX_ROWS", 1000)
    want = ref.groupby("k", agg={"m": vaex_tpu.agg.median_approx("v")}, sort=True)
    passes = port.executor.passes
    got = port.groupby("k", agg={"m": vaex_tpu_torch.agg.median_approx("v")}, sort=True)
    assert port.executor.passes == passes + 2  # the limits, then the count grid
    assert "percentile" in port.executor.trace_log[-1]["strategies"][0]
    assert_same_frame(want, got)
    for df, pkg in ((ref, vaex_tpu), (port, vaex_tpu_torch)):
        with pytest.raises(ValueError):
            df.groupby("k", agg={"m": pkg.agg.median_approx("v", exact=True)})


def test_the_count_grid_halves_its_bins_past_its_cells(monkeypatch):
    """A grid of G cells keeps G * B within APPROX_MAX_CELLS by halving B
    (not below 64), as vaex_tpu's 2^26 cap does."""
    cls = vaex_tpu_torch.agg.AggregatorDescriptorPercentile
    monkeypatch.setattr(cls, "APPROX_MAX_CELLS", 15 * 256)
    _, port = same_frames(_arrays(4, n=2000), category="k", labels=list(range(12)))
    binners = port._create_binners(["k"])  # G = 12 categories + 3 edges
    [promise] = vaex_tpu_torch.agg.median_approx("v", exact=False).add_tasks(port, binners)
    [op] = port.executor.tasks[-1].subtasks
    assert op.bins == 256
    port.execute()
    assert promise.get().shape == (15,)
