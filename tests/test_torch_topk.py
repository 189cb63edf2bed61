"""Per-cell top-k, the port against vaex_tpu on the same seeded arrays:
``max_n``, ``min_n``, ``nth_largest`` and ``nth_smallest`` on float (with
NaN), masked, int and datetime columns, per group and per cell of
``binby``, over several tiles, with groups that hold fewer than k values
and ``selection=``.

Values are exact.  A slot no value fills holds NaN in a float column; an
int column keeps the identity the reference's ``get_result`` leaves there
(the int type's min for ``max_n``, its max for ``min_n``): the tests pin
it (ROADMAP, "Known problems of the reference itself").

The rounds route (``b3x-l2-topk``, ``ops/grid_topk.py``) runs its plain
version here: a plan that takes it for every grid (``rounds_on_cpu``) is held
to the sort route over the same frames, k = 1 .. K_MAX, both ends, float64,
float32, int64, uint64, datetime and masked columns with their missing and
extreme values, ties of a cell's best value, rows outside the limits, empty
cells, three tiles; then ``topk_strategy`` at its edges and the wrapper's
refusals.
"""

import numpy as np
import numpy.testing as npt
import pytest
import torch

import vaex_tpu
import vaex_tpu_torch
from torch_port_helpers import assert_same_frame, same_frames
from vaex_tpu_torch.ops import grid_partition, grid_plan, grid_topk


def _arrays(seed, n=5000, k=40):
    """A key k in 0..k-1 whose last keys hold one or two rows, v float with
    NaN, vm masked, i int64, u for continuous bins."""
    rng = np.random.default_rng(seed)
    key = rng.integers(0, k - 3, n)
    key[:5] = [k - 3, k - 2, k - 2, k - 1, k - 1]
    v = rng.normal(0, 10, n)
    v[::11] = np.nan
    v[3] = np.nan  # one of the two rows of the last key
    return {"k": key, "v": v, "vm": np.ma.MaskedArray(rng.normal(0, 1, n), rng.random(n) < 0.3),
            "i": rng.integers(-10 ** 12, 10 ** 12, n), "u": rng.uniform(0, 1, n)}


@pytest.fixture(scope="module")
def frames():
    return same_frames(_arrays(1), tile_rows=1200)


def _columns(df, names):
    return {name: np.asarray(df.evaluate(name)) for name in names}


@pytest.mark.parametrize("column", ["v", "vm", "i"])
@pytest.mark.parametrize("largest", [True, False])
def test_max_n_and_min_n_per_group(frames, column, largest):
    ref, port = frames
    name = "max_n" if largest else "min_n"
    want = ref.groupby("k", agg={"t": getattr(vaex_tpu.agg, name)(column, 3)}, sort=True)
    got = port.groupby("k", agg={"t": getattr(vaex_tpu_torch.agg, name)(column, 3)}, sort=True)
    g, w = np.asarray(got.evaluate("t")), np.asarray(want.evaluate("t"))
    assert g.shape == w.shape == (40, 3) and g.dtype == w.dtype
    npt.assert_array_equal(g, w)
    npt.assert_array_equal(np.asarray(got.evaluate("k")), np.asarray(want.evaluate("k")))
    if column == "i":  # the reference's identity fills an int column's empty slots
        fill = np.iinfo(np.int64).min if largest else np.iinfo(np.int64).max
        assert (g[-3, 1:] == fill).all()
    else:
        assert np.isnan(g[-3, 1:]).all()
    assert port.executor.trace_log[-1]["strategies"][0]["topk"] == "sort"


@pytest.mark.parametrize("n", [0, 1, 4])
def test_nth_largest_and_nth_smallest(frames, n):
    ref, port = frames

    def aggs(pkg):
        a = pkg.agg
        return {"l": a.nth_largest("v", n), "s": a.nth_smallest("i", n),
                "m": a.nth_largest("vm", n)}
    want = ref.groupby("k", agg=aggs(vaex_tpu), sort=True)
    got = port.groupby("k", agg=aggs(vaex_tpu_torch), sort=True)
    assert_same_frame(want, got)
    assert got.get_column_names() == want.get_column_names()


def test_the_names_of_the_top_k_columns(frames):
    ref, port = frames
    specs = lambda a: [a.nth_largest("v", 1), a.max_n("v", 2), a.min_n("i", 2)]  # noqa: E731
    want = ref.groupby("k", agg={"v": specs(vaex_tpu.agg)})
    got = port.groupby("k", agg={"v": specs(vaex_tpu_torch.agg)})
    assert got.get_column_names() == want.get_column_names()


def test_top_k_with_a_selection_and_on_a_raw_key(frames):
    """A selection per aggregator; a raw key (the dense grouper, its empty
    values dropped)."""
    ref, port = frames
    want = ref.groupby("k", agg={"a": vaex_tpu.agg.nth_largest("v", 0, selection="u > 0.5"),
                                 "b": vaex_tpu.agg.nth_smallest("i", 1, selection="v > 0")},
                       sort=True)
    got = port.groupby("k", agg={"a": vaex_tpu_torch.agg.nth_largest("v", 0, selection="u > 0.5"),
                                 "b": vaex_tpu_torch.agg.nth_smallest("i", 1, selection="v > 0")},
                       sort=True)
    assert_same_frame(want, got)


@pytest.mark.parametrize("largest", [True, False])
def test_top_k_per_cell_of_binby(frames, largest):
    ref, port = frames
    name = "max_n" if largest else "min_n"
    args = dict(by=["u"], limits=[0, 1], shape=7)
    want = ref.binby(agg={"t": getattr(vaex_tpu.agg, name)("v", 2, selection="i > 0")}, **args)
    got = port.binby(agg={"t": getattr(vaex_tpu_torch.agg, name)("v", 2, selection="i > 0")},
                     **args)
    npt.assert_array_equal(np.asarray(got), np.asarray(want))
    assert np.asarray(got).shape == (7, 2)


def test_top_k_of_a_datetime_skips_nat():
    rng = np.random.default_rng(3)
    n = 2000
    d = (np.datetime64("2020-01-01") + rng.integers(0, 10 ** 6, n).astype("m8[s]"))
    d[::7] = np.datetime64("NaT")
    ref, port = same_frames({"k": rng.integers(0, 9, n), "d": d})
    want = ref.groupby("k", agg={"a": vaex_tpu.agg.nth_largest("d", 1),
                                 "b": vaex_tpu.agg.nth_smallest("d", 0)}, sort=True)
    got = port.groupby("k", agg={"a": vaex_tpu_torch.agg.nth_largest("d", 1),
                                 "b": vaex_tpu_torch.agg.nth_smallest("d", 0)}, sort=True)
    for name in ("a", "b"):
        g, w = np.asarray(got.evaluate(name)), np.asarray(want.evaluate(name))
        assert g.dtype == w.dtype == d.dtype
        npt.assert_array_equal(g, w)


# The rounds route (``b3x-l2-topk``): on the CPU its wrapper takes the plain
# version, reached through ``OpTopK`` by a plan that takes the rounds for any
# grid; each case holds it to the sort route over the same frame, three tiles.

ROUNDS_CELLS = 40  # cells 35..39 empty, 30..34 one value each
KINDS = ["f64", "f32", "i64", "u64", "dt", "masked"]


def _kind_column(kind, small, rng, plain=None):
    """The small ints ``small`` in the column kind's domain, with its own
    missing and extreme values mixed in, except at the rows ``plain``."""
    n = small.shape[0]
    mixed = np.ones(n, dtype=bool) if plain is None else ~plain
    draw = np.where(mixed, rng.random(n), 1.0)
    if kind in ("f64", "f32", "masked"):
        v = small.astype(np.float64)
        v[draw < 0.05] = np.nan
        v[(draw >= 0.05) & (draw < 0.08)] = np.inf
        v[(draw >= 0.08) & (draw < 0.11)] = -np.inf
        v[(draw >= 0.11) & (draw < 0.15)] = -0.0
        v[(draw >= 0.15) & (draw < 0.19)] = 0.0
        if kind == "f32":
            return v.astype(np.float32)
        if kind == "masked":
            return np.ma.MaskedArray(v, mixed & (rng.random(n) < 0.2))
        return v
    if kind == "i64":
        v = small.astype(np.int64)
        v[draw < 0.02] = np.iinfo(np.int64).min
        v[(draw >= 0.02) & (draw < 0.04)] = np.iinfo(np.int64).max
        return v
    if kind == "u64":  # around 2^63, with both ends of the type
        v = small.astype(np.int64).view(np.uint64) ^ np.uint64(2 ** 63)
        v[draw < 0.02] = 0
        v[(draw >= 0.02) & (draw < 0.04)] = np.iinfo(np.uint64).max
        return v
    v = np.datetime64("2020-01-01") + small.astype("m8[s]")
    v[draw < 0.1] = np.datetime64("NaT")
    return v


def _rounds_frame(kind, k, seed=11, n=3000):
    """Rows over ROUNDS_CELLS bins of u in [0, 1) and some outside it, values
    1..5 (ties) with, for both ends, a best value that appears once (cell
    0), k times (cell 1) and k + 3 times (cell 2)."""
    rng = np.random.default_rng(seed)
    cell = rng.integers(3, 30, n)
    small = rng.integers(1, 6, n)
    cell[:5] = np.arange(30, 35)  # one value each
    at = 5
    for c, times in ((0, 1), (1, k), (2, k + 3)):
        for value in (100, -100):
            cell[at:at + times], small[at:at + times] = c, value
            at += times
    u = (cell + 0.5) / ROUNDS_CELLS
    u[at:][rng.random(n - at) < 0.05] = 1.5  # outside the limits
    order = rng.permutation(n)
    plain = (np.arange(n) < at)[order]
    port = vaex_tpu_torch.from_arrays(u=u[order], x=_kind_column(kind, small[order], rng, plain),
                                      s=rng.random(n)).to_device("cpu")
    port._tile_rows = n // 3
    return port


@pytest.fixture
def rounds_on_cpu(monkeypatch):
    """The plan of a card at a grid in the rounds' range, whatever the tile's
    device and G."""
    monkeypatch.setattr(vaex_tpu_torch.agg, "topk_strategy",
                        lambda G, k, dtype, device: grid_plan.topk_strategy(1 << 20, k, dtype,
                                                                            "cuda"))


def _top(port, k, largest, selection=None):
    name = "max_n" if largest else "min_n"
    grid = port.binby(by=["u"], limits=[0, 1], shape=ROUNDS_CELLS,
                      agg={"t": getattr(vaex_tpu_torch.agg, name)("x", k, selection=selection)})
    return np.asarray(grid), port.executor.trace_log[-1]["strategies"][0]["topk"]


def _same_values(got, want):
    if got.dtype.kind == "M":
        got, want = got.view("i8"), want.view("i8")
    assert got.dtype == want.dtype
    npt.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", range(1, 17))  # 1 .. grid_topk.K_MAX
@pytest.mark.parametrize("largest", [True, False])
def test_rounds_plain_version_matches_the_sort(rounds_on_cpu, monkeypatch, kind, k, largest):
    agg = vaex_tpu_torch.agg
    port = _rounds_frame(kind, k)
    before = dict(agg.OpTopK.routes)
    got, route = _top(port, k, largest)
    assert route == grid_plan.B3X_L2_TOPK
    assert agg.OpTopK.routes["rounds"] - before["rounds"] == 3  # a tile each
    monkeypatch.setattr(agg, "topk_strategy", grid_plan.topk_strategy)
    want, route = _top(port, k, largest)
    assert route == "sort"
    _same_values(got, want)
    assert got.shape == (ROUNDS_CELLS, k)
    # the best value once (cell 0, then the other end), k and k + 3 times
    best, other = _kind_column(kind, np.array([100, -100] if largest else [-100, 100]),
                               np.random.default_rng(0), plain=np.ones(2, dtype=bool))
    assert got[0, 0] == best and (k == 1 or got[0, 1] == other)
    assert (got[1] == best).all() and (got[2] == best).all()


def test_rounds_with_a_selection(rounds_on_cpu, monkeypatch):
    port = _rounds_frame("f64", 3)
    got, route = _top(port, 3, True, selection="s > 0.3")
    assert route == grid_plan.B3X_L2_TOPK
    monkeypatch.setattr(vaex_tpu_torch.agg, "topk_strategy", grid_plan.topk_strategy)
    want, route = _top(port, 3, True, selection="s > 0.3")
    assert route == "sort"
    _same_values(got, want)


def _strategy_cases():
    edge = grid_partition.SMEM_BUDGET // 8  # the last G of the direct route
    top = grid_partition.RESIDENT_BYTES // 20  # the last G whose round stays in L2
    f64 = torch.float64
    past = grid_topk.K_PAST_L2
    return [("direct edge", edge, 2, f64, "cuda", "sort"),
            ("past the direct edge", edge + 1, 2, f64, "cuda", "rounds"),
            ("resident edge", top, 2, f64, "cuda", "rounds"),
            ("resident edge, K_MAX", top, grid_topk.K_MAX, f64, "cuda", "rounds"),
            ("past the resident edge", top + 1, 2, f64, "cuda", "rounds"),
            ("past the resident edge, K_PAST_L2", top + 1, past, f64, "cuda", "rounds"),
            ("past the resident edge, K_PAST_L2 + 1", top + 1, past + 1, f64, "cuda", "sort"),
            ("1e8 cells, K_PAST_L2", 10 ** 8, past, f64, "cuda", "rounds"),
            ("K_MAX", 1 << 20, grid_topk.K_MAX, torch.int64, "cuda", "rounds"),
            ("K_MAX + 1", 1 << 20, grid_topk.K_MAX + 1, torch.int64, "cuda", "sort"),
            ("k = 1", 1 << 20, 1, torch.float32, "cuda", "rounds"),
            ("int32", 1 << 20, 2, torch.int32, "cuda", "sort"),
            ("float16", 1 << 20, 2, torch.float16, "cuda", "sort"),
            ("no dtype", 1 << 20, 2, None, "cuda", "sort"),
            ("cpu", 1 << 20, 2, f64, "cpu", "sort")]


@pytest.mark.parametrize("case", range(len(_strategy_cases())))
def test_topk_strategy_at_its_boundaries(case):
    _, G, k, dtype, device, want = _strategy_cases()[case]
    got = grid_plan.topk_strategy(G, k, dtype, device)
    assert got == (grid_plan.B3X_L2_TOPK if want == "rounds" else grid_plan.SORT)


@pytest.mark.parametrize("bad", ["idx", "values", "mask", "k", "state"])
def test_grid_topk_refuses_what_it_does_not_take(bad):
    f64 = torch.float64
    args = dict(idx=torch.zeros(4, dtype=torch.int32), values=torch.zeros(4, dtype=f64),
                mask=None, G=3, k=2, largest=True, state=torch.zeros(3, 2, dtype=f64))
    grid_topk.grid_topk(**args)  # takes these
    args.update({"idx": dict(idx=torch.zeros(4, dtype=torch.int64)),
                 "values": dict(values=torch.zeros(4, dtype=torch.int32)),
                 "mask": dict(mask=torch.zeros(4, dtype=torch.uint8)),
                 "k": dict(k=grid_topk.K_MAX + 1,
                           state=torch.zeros(3, grid_topk.K_MAX + 1, dtype=f64)),
                 "state": dict(state=torch.zeros(3, 2, dtype=torch.float32))}[bad])
    with pytest.raises((TypeError, ValueError)):
        grid_topk.grid_topk(**args)
