"""The route past B3's limits (``vaex_tpu_torch.ops.grid_sort``, ``"sort"``)
and the split of a batch into calls of B3's partition (``"b3×k"``).

* The route's two functions against the plain versions of the kernels whose
  contracts they keep, at grids where both run: ``grid_sort`` against
  ``grid_partition.grid_partition_reference`` (int64 exact mod 2^64, f64 and
  f32 with NaN and +-inf, the count, rows outside [0, G)),
  ``grid_sort_extreme`` against ``grid_partition_extreme_reference`` and
  numpy (int64 / f64 / f32, min and max, NaN, +-inf, validities, empty
  cells at the identity), both adding into given rows in place.
* The plan names a route for every (N, G, C).
* Every statistic past B3 through both packages: with B3's partition cut to
  a few buckets (``grid_partition.P_MAX``) and the resident routes' budget
  to 64 KiB, a 403 x 403 grid takes "sort" or the split at 20 000 rows, in
  tiles of 8000; ints exact, floats to rtol 1e-6 / atol 1e-7.
"""

import numpy as np
import numpy.testing as npt
import pytest
import torch

import vaex_tpu
import vaex_tpu_torch
from torch_port_helpers import ATOL, RTOL, binby_arrays, same_frames
from vaex_tpu_torch.ops import grid_moments as gm
from vaex_tpu_torch.ops import grid_partition as gp
from vaex_tpu_torch.ops import grid_plan, grid_sort

N = 20_000


def _idx(rng, G, n, kind):
    if kind == "uniform":  # drops on both sides of [0, G)
        return rng.integers(-3, G + G // 8 + 1, n).astype(np.int32)
    if kind == "clusters":  # most cells stay empty
        centers = rng.integers(0, G, 3)
        return (centers[rng.integers(0, 3, n)] + rng.integers(-20, 20, n)).astype(np.int32)
    return np.full(n, G // 2, dtype=np.int32)  # every row on one cell


def _columns(rng, n):
    """int64 past 2^53 (their sums wrap), f64 with NaN, +-inf and both
    zeros, f32 with NaN."""
    ints = rng.integers(-(2 ** 62), 2 ** 62, n, dtype=np.int64)
    f64 = rng.normal(0, 1e3, n)
    f64[::7] = np.nan
    f64[1::11] = np.inf
    f64[2::13] = -np.inf
    f64[3::5] = -0.0
    f32 = rng.normal(0, 1, n).astype(np.float32)
    f32[::9] = np.nan
    return ints, f64, f32


@pytest.mark.parametrize("kind", ["uniform", "clusters", "single"])
@pytest.mark.parametrize("G,n", [(1, 500), (1000, 0), (100_003, 30_000)])
def test_sums_match_b3s_plain_version(kind, G, n):
    rng = np.random.default_rng(G + n)
    idx = torch.from_numpy(_idx(rng, G, n, kind))
    ints, f64, f32 = (torch.from_numpy(c) for c in _columns(rng, n))
    for int_cols, float_cols, count in (([ints, ints * 3], [f64, f32], True), ([], [], True),
                                        ([ints], [], False), ([], [f32], False)):
        got = grid_sort.grid_sort(idx, int_cols, float_cols, G, count)
        want = gp.grid_partition_reference(idx, int_cols, float_cols, G, count)
        npt.assert_array_equal(got[0].numpy(), want[0].numpy())
        npt.assert_allclose(got[1].numpy(), want[1].numpy(), rtol=1e-12, atol=1e-9)
        assert got[0].dtype == torch.int64 and got[1].dtype == torch.float64


def test_sums_add_into_the_given_rows_in_place():
    """A pass hands the route its running state: the rows given take the
    tile's sums in place, a None row comes back fresh."""
    rng = np.random.default_rng(3)
    G, n = 5003, 4000
    idx = torch.from_numpy(_idx(rng, G, n, "uniform"))
    ints, f64, _ = (torch.from_numpy(c) for c in _columns(rng, n))
    count_row = torch.full((G,), 5, dtype=torch.int64)
    float_row = torch.full((G,), 0.25, dtype=torch.float64)
    int_rows, float_rows = grid_sort.grid_sort(idx, [ints], [f64], G, True,
                                               out=([count_row, None], [float_row]))
    assert int_rows[0] is count_row and float_rows[0] is float_row
    want = gp.grid_partition_reference(idx, [ints], [f64], G, True)
    npt.assert_array_equal(count_row.numpy(), want[0][0].numpy() + 5)
    npt.assert_array_equal(int_rows[1].numpy(), want[0][1].numpy())
    npt.assert_allclose(float_row.numpy(), want[1][0].numpy() + 0.25, rtol=1e-12, atol=1e-9)
    with pytest.raises(ValueError, match="a row to add into"):
        grid_sort.grid_sort(idx, [], [f64], G, False, out=([], [count_row]))


def _numpy_extreme(idx, col, mode, valid, G):
    keep = (idx >= 0) & (idx < G)
    if col.dtype.kind == "f":
        keep &= ~np.isnan(col)
        fill = np.inf if mode == "min" else -np.inf
    else:
        info = np.iinfo(col.dtype)
        fill = info.max if mode == "min" else info.min
    if valid is not None:
        keep &= valid
    out = np.full(G, fill, dtype=col.dtype)
    (np.minimum if mode == "min" else np.maximum).at(out, idx[keep], col[keep])
    return out


@pytest.mark.parametrize("kind", ["uniform", "clusters", "single"])
@pytest.mark.parametrize("G,n", [(1, 500), (1000, 0), (100_003, 30_000)])
def test_extremes_match_b3xs_plain_version_and_numpy(kind, G, n):
    rng = np.random.default_rng(G * 7 + n)
    idx_np = _idx(rng, G, n, kind)
    idx = torch.from_numpy(idx_np)
    arrays = _columns(rng, n)
    cols = [torch.from_numpy(c) for c in arrays] * 2
    modes = ["min", "max", "min", "max", "min", "max"]
    valid_np = [None, rng.random(n) < 0.7, None, None, rng.random(n) < 0.3, None]
    valids = [None if v is None else torch.from_numpy(v) for v in valid_np]
    got = grid_sort.grid_sort_extreme(idx, cols, modes, valids, G)
    want, _, _ = gp.grid_partition_extreme_reference(idx, cols, modes, valids, G)
    for g, w, c, m, v in zip(got, want, arrays * 2, modes, valid_np):
        assert g.dtype == w.dtype
        npt.assert_array_equal(g.numpy(), w.numpy())
        npt.assert_array_equal(g.numpy(), _numpy_extreme(idx_np, c, m, v, G))


def test_extremes_take_into_the_given_grids():
    rng = np.random.default_rng(5)
    G, n = 3001, 5000
    idx = torch.from_numpy(_idx(rng, G, n, "uniform"))
    _, f64, _ = _columns(rng, n)
    col = torch.from_numpy(f64)
    state = torch.full((G,), 100.0, dtype=torch.float64)
    (got,) = grid_sort.grid_sort_extreme(idx, [col], ["max"], [None], G, out=[state])
    assert got is state
    want = grid_sort.grid_sort_extreme(idx, [col], ["max"], [None], G)[0]
    npt.assert_array_equal(state.numpy(), np.maximum(want.numpy(), 100.0))


ROUTES = {"b1", "b2", "b3-l2", "b3", "sort"}


def _named(name):
    return name in ROUTES or (name.startswith("b3×") and int(name[3:]) >= 2)


def test_the_plan_names_a_route_for_every_call():
    """No (N, G, C) is left without a route: the additive, moment and
    extreme plans over rows from 0 to past 2^31 and grids to 2^31 - 1."""
    for n in (0, 1, 10 ** 8, 2 ** 31, 2 ** 40):
        for G in (1, 128, 129, 10_609, 1_000_003, 16_793_604, 33_554_433, 67_158_025,
                  135_796_744, 144_048_004, 2 ** 28 + 1, 2 ** 31 - 1):
            for C in range(1, 17):
                assert _named(grid_plan.strategy(n, G, C - 1, 0, True)), (n, G, C)
                assert _named(grid_plan.strategy(n, G, 0, C, False)), (n, G, C)
                name = grid_plan.moment_strategy(n, G, C)
                assert name in ("b4", "b5") or _named(name), (n, G, C)
            for E in range(1, gp.MAX_EXT + 1):
                assert grid_plan.extreme_strategy(n, G, E) in (
                    "b3x-direct", "b3x-l2", "b3x", "sort"), (n, G, E)
    # ROADMAP A4's limits: 1 channel to 134.2M cells, 2-3 to 67.1M, 4-6 to
    # 33.6M, 8-12 to 16.8M; past them split where fewer channels fit
    n = 10 ** 8
    assert grid_plan.strategy(n, 144_048_004, 0, 0, True) == "sort"
    assert grid_plan.strategy(n, 144_048_004, 0, 1, True) == "sort"
    assert grid_plan.moment_strategy(n, 144_048_004, 3) == "sort"
    assert grid_plan.strategy(n, 135_796_744, 0, 0, True) == "sort"
    assert grid_plan.extreme_strategy(n, 67_158_025, 1) == "sort"
    assert grid_plan.moment_strategy(n, 16_793_604, 12) == "b3×2"
    assert grid_plan.strategy(n, 67_108_865, 0, 1, True) == "b3×2"
    assert grid_plan.strategy(n, 33_554_433, 0, 3, True) == "b3×2"


# ---------------------------------------------- statistics through both packages
SHAPE, LIMITS = 400, [[-3, 3], [-3, 3]]  # 403 x 403 = 162 409 cells


@pytest.fixture(scope="module")
def frames():
    return same_frames(binby_arrays(11, N), tile_rows=8_000)


def _wide(df, call, pkg):
    return call(df, pkg.agg)


CALLS = {
    # name: (call, exact, P_MAX, what the port's last pass records)
    # the count alone takes B2 to about 226 000 cells: 703 x 703 is past it
    "count": (lambda df, a: df.count(binby=["x", "y"], limits=LIMITS, shape=700), True, 2,
              {"additive": "sort"}),
    "count_expr": (lambda df, a: df.count("vm", binby=["x", "y"], limits=LIMITS, shape=SHAPE),
                   True, 2, {"additive": "sort"}),
    "sum_int": (lambda df, a: df.sum("iv", binby=["x", "y"], limits=LIMITS, shape=SHAPE), True,
                2, {"additive": "sort"}),
    "sum_float": (lambda df, a: df.sum("v", binby=["x", "y"], limits=LIMITS, shape=SHAPE), False,
                  2, {"additive": "sort"}),
    "mean_split": (lambda df, a: df.mean("v", binby=["x", "y"], limits=LIMITS, shape=SHAPE),
                   False, 12, {"additive": "b3×2"}),
    "mean_selection": (lambda df, a: df.mean("w", binby=["x", "y"], limits=LIMITS, shape=SHAPE,
                                             selection="v > 50"), False, 2, {"additive": "sort"}),
    "std": (lambda df, a: df.std("v", binby=["x", "y"], limits=LIMITS, shape=SHAPE), False, 2,
            {"moments": "sort"}),
    "std_four_split": (lambda df, a: df.std(["v", "x", "w", "iv"], binby=["x", "y"],
                                            limits=LIMITS, shape=SHAPE), False, 64,
                       {"moments": "b3×2"}),
    "var_masked": (lambda df, a: df.var("vm", binby=["x", "y"], limits=LIMITS, shape=SHAPE),
                   False, 2, {"moments": "sort"}),
    "min": (lambda df, a: df.min("v", binby=["x", "y"], limits=LIMITS, shape=SHAPE), True, 12,
            {"extremes": "sort"}),
    "max_int": (lambda df, a: df.max("iv", binby=["x", "y"], limits=LIMITS, shape=SHAPE), True,
                12, {"extremes": "sort"}),
    "minmax_masked": (lambda df, a: df.minmax("vm", binby=["x", "y"], limits=LIMITS,
                                              shape=SHAPE), True, 12, {"extremes": "sort"}),
    "max_beside_sum": (lambda df, a: [df.max("v", binby=["x", "y"], limits=LIMITS, shape=SHAPE,
                                             delay=True),
                                      df.sum("iv", binby=["x", "y"], limits=LIMITS, shape=SHAPE,
                                             delay=True)], True, 12,
                       {"additive": "b3", "extremes": "sort"}),
    "max_beside_sum_sort": (lambda df, a: [
        df.max("v", binby=["x", "y"], limits=LIMITS, shape=SHAPE, delay=True),
        df.mean("iv", binby=["x", "y"], limits=LIMITS, shape=SHAPE, delay=True)], False, 2,
        {"additive": "sort", "extremes": "sort"}),
    "first": (lambda df, a: df.first("v", "t", binby=["x", "y"], limits=LIMITS, shape=SHAPE),
              True, 12, {"first": "sort"}),
    "datetime_max": (lambda df, a: df.max("d", binby=["x", "y"], limits=LIMITS, shape=SHAPE),
                     True, 12, {"extremes": "sort"}),
    "percentile_binned": (lambda df, a: df.percentile_approx(
        "v", 50.0, binby=["x", "y"], limits=LIMITS, shape=SHAPE, percentile_shape=8), False, 12,
        {"additive": "sort"}),
}


@pytest.mark.parametrize("name", CALLS)
def test_statistic_past_b3_matches_vaex_tpu(frames, monkeypatch, name):
    ref, port = frames
    call, exact, p_max, strategy = CALLS[name]
    monkeypatch.setattr(gp, "P_MAX", p_max)
    monkeypatch.setattr(gp, "RESIDENT_BYTES", 1 << 16)
    want = call(ref, vaex_tpu.agg)
    start = len(port.executor.trace_log)
    got = call(port, vaex_tpu_torch.agg)
    if isinstance(got, list):  # delayed calls share one pass
        port.execute()
        ref.execute()
        got, want = [g.get() for g in got], [w.get() for w in want]
    for g, w in zip(got if isinstance(got, list) else [got],
                    want if isinstance(want, list) else [want]):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape, g.dtype, w.dtype)
        if exact or w.dtype.kind != "f":
            npt.assert_array_equal(g, w)
        else:
            npt.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    # the call's last pass but a second pass less a shift a cell (a std of a
    # binby axis: its cells' means lie far from the frame's shift)
    recorded = [e["strategies"][0] for e in port.executor.trace_log[start:]
                if e.get("strategies") and e["strategies"][0].get("moment_shift") != "cell"][-1]
    assert {k: recorded.get(k) for k in strategy} == strategy, recorded


def test_a_pass_scatters_every_tile_into_one_grid(frames, monkeypatch):
    """The route adds each tile into the pass's running state: every call
    gets the same rows to add into, so the grid is allocated once a pass."""
    _, port = frames
    monkeypatch.setattr(gp, "P_MAX", 2)
    monkeypatch.setattr(gp, "RESIDENT_BYTES", 1 << 16)
    seen = []
    inner = grid_sort.grid_sort

    def spy(idx, int_cols, float_cols, G, count, out=None):
        seen.append([row.data_ptr() for row in out[0] + out[1]])
        return inner(idx, int_cols, float_cols, G, count, out)
    monkeypatch.setattr(grid_sort, "grid_sort", spy)
    port.mean("v", binby=["x", "y"], limits=LIMITS, shape=SHAPE)
    assert len(seen) == 3 and seen[0] == seen[1] == seen[2]  # 20 000 rows, tiles of 8000
    assert port.executor.trace_log[-1]["strategies"] == [{"additive": "sort"}]


def test_moment_terms_shared_by_two_statistics_stay_equal(frames, monkeypatch):
    """mean and std of one column share the count and sum terms: the first
    holder's rows take the tile, the other's copy them."""
    ref, port = frames
    monkeypatch.setattr(gp, "P_MAX", 2)
    monkeypatch.setattr(gp, "RESIDENT_BYTES", 1 << 16)
    kw = dict(binby=["x", "y"], limits=LIMITS, shape=SHAPE)
    got = [port.var("v", delay=True, **kw), port.std("v", delay=True, **kw)]
    port.execute()
    want = [ref.var("v", **kw), ref.std("v", **kw)]
    for g, w in zip(got, want):
        npt.assert_allclose(np.asarray(g.get()), np.asarray(w), rtol=RTOL, atol=ATOL)
    assert gm.MAX_TERMS >= 3


def test_a_pass_frees_its_grid_when_the_query_returns(frames, monkeypatch):
    """The running state the route scatters into is freed as soon as the
    query returns its host array, not when Python's cycle collector next
    runs: a settled promise drops its callbacks (a 144M-cell grid is 1-3.5
    GB on a card)."""
    import gc
    import weakref
    _, port = frames
    monkeypatch.setattr(gp, "P_MAX", 2)
    monkeypatch.setattr(gp, "RESIDENT_BYTES", 1 << 16)
    rows = []
    inner = grid_sort.grid_sort

    def spy(idx, int_cols, float_cols, G, count, out=None):
        rows.extend(weakref.ref(row) for row in out[0] + out[1])
        return inner(idx, int_cols, float_cols, G, count, out)
    monkeypatch.setattr(grid_sort, "grid_sort", spy)
    gc.disable()
    try:
        got = port.mean("v", binby=["x", "y"], limits=LIMITS, shape=SHAPE)
        assert rows and all(row() is None for row in rows)
    finally:
        gc.enable()
    assert got.shape == (SHAPE, SHAPE)
