"""Special floats through every groupby route: C23 and C24 of ROADMAP queue C.

One frame of 5000 rows whose value column holds each special float at a
stride of its own: the dtype's largest finite value every 173rd row, -0.0
every 41st, NaN every 31st, -inf every 89th and +inf every 97th (where two
strides meet, the one named later wins), N(0, 10) elsewhere; in float64
(``x64``) and float32 (``x32``).  A key ``k`` in [0, 400) makes groups of
about 12 rows, so that some hold +inf, some -inf, some both, some the
largest value and most none of them.

Each route's per-group sum, mean, std, var, min, max and count is held to
numpy's nan-functions over the group's values cast to float64 (std and var
with ddof 0): NaN and infinities exactly, with their sign, other floats
within 1e-9 relative.  Not to pandas: pandas gives NaN for a mean whose sum
overflows, where numpy and the port give inf.

The routes: a categorized key, a dense raw key, the one-sort plan over one
wide key and over two keys packed in one word, the classic wide path (a
filtered frame: the set path), binby, ``df.<stat>`` (the frame, and one
selection per kind of group) and a mesh of three CPU shards (the fused
one-sort exchange, and the classic all-to-all).

* C23: the one-sort plan cleaned a float column with ``nan_to_num``, which
  also maps +-inf to the dtype's extremes, and shifted std / var by the
  first non-NaN value, an infinity where the column starts with one.
* C24: the classic paths take var from shifted sums, (sum u^2 - (sum u)^2 /
  n) / n; where u^2 overflows float64 that is inf - inf, NaN where numpy
  gives inf.  Such a cell's moments are taken again over x * 2^-540.

The reference's own faults with these values are pinned at the end.
"""

import functools

import numpy as np
import pandas as pd
import pytest

import vaex_tpu
import vaex_tpu_torch
from torch_port_helpers import assert_special, numpy_stat, special_floats
from vaex_tpu_torch import agg, cache, groupby
from vaex_tpu_torch.parallel import distributed_executor

N = 5000
G = 400
WIDE = 10_000_019  # a key step whose span passes the dense plan's range
STATS = ["sum", "mean", "std", "var", "min", "max", "count"]
COLUMNS = {"float64": "x64", "float32": "x32"}
ROUTES = ["categorized", "dense", "one-sort", "one-sort two keys", "classic wide", "binby",
          "df.stat", "mesh one-sort", "mesh classic"]
# the trace each route's passes must leave: ("groupby", "one-sort") on the
# one-sort plan, ("shuffle", True) on the all-to-all, None where no pass
# records either
TRACE = {"one-sort": ("groupby", "one-sort"), "one-sort two keys": ("groupby", "one-sort"),
         "mesh one-sort": ("fused_mesh_groupby", True), "mesh classic": ("shuffle", True)}


def _arrays():
    k = np.random.default_rng(1).integers(0, G, N).astype(np.int64)
    return {"k": k, "w": k * WIDE, "a": k // 20 * 1000, "b": k % 20 * 100,
            "x64": special_floats(N, np.float64), "x32": special_floats(N, np.float32)}


ARRAYS = _arrays()


@functools.lru_cache(maxsize=None)
def _want(column, stat):
    x, k = ARRAYS[column], ARRAYS["k"]
    return np.array([numpy_stat(x[k == g], stat) for g in range(G)])


def _frame(route):
    df = vaex_tpu_torch.from_arrays(**ARRAYS).to_device("cpu")
    if route == "categorized":
        df = df.categorize("k", min_value=0, labels=list(range(G)))
    elif route == "classic wide":
        df = df[df.k >= 0]  # a filtered frame leaves the one-sort plan: the set path
    elif route.startswith("mesh"):
        df.executor = distributed_executor(3, devices=["cpu"] * 3)
    return df


def _aggregations():
    return {f"{stat}_{c}": getattr(agg, stat)(c) for stat in STATS for c in COLUMNS.values()}


@functools.lru_cache(maxsize=None)
def _grouped(route):
    """{name: per-group answer in k's order} of every aggregation on
    ``route``, and the trace entries of its passes."""
    df = _frame(route)
    key = {"one-sort two keys": ["a", "b"], "one-sort": "w", "classic wide": "w",
           "mesh one-sort": "w"}.get(route, "k")
    shuffle_min_g = groupby.SHUFFLE_MIN_G
    if route == "mesh classic":
        groupby.SHUFFLE_MIN_G = 1  # the all-to-all, not the replicated grids
    try:
        with cache.off():
            passes = len(df.executor.trace_log)
            out = df.groupby(key, agg=_aggregations(), sort=True)
    finally:
        groupby.SHUFFLE_MIN_G = shuffle_min_g
    if route == "one-sort two keys":
        keys = np.asarray(out["a"].values) // 1000 * 20 + np.asarray(out["b"].values) // 100
    else:
        keys = np.asarray(out[key].values) // (WIDE if key == "w" else 1)
    assert keys.tolist() == list(range(G)), route
    return ({name: np.asarray(out[name].values) for name in _aggregations()},
            df.executor.trace_log[passes:])


def _kinds(x, k):
    """One group of each kind, by its values: the first that holds both
    infinities, +inf alone, -inf alone, the largest value and no infinity,
    none of these."""
    big = np.finfo(x.dtype).max
    first = {}
    for g in range(G):
        v = x[k == g]
        pos, neg = bool((v == np.inf).any()), bool((v == -np.inf).any())
        kind = ("both" if pos and neg else "+inf" if pos else "-inf" if neg
                else "largest" if (v == big).any() else "finite")
        first.setdefault(kind, g)
    return first


@pytest.mark.parametrize("stat", STATS)
@pytest.mark.parametrize("dtype", list(COLUMNS))
@pytest.mark.parametrize("route", ROUTES)
def test_special_floats_per_group_match_numpy(route, dtype, stat):
    column = COLUMNS[dtype]
    want = _want(column, stat)
    what = f"{route} {stat}({column})"
    if route == "binby":
        df = _frame(route)
        with cache.off():
            got = getattr(df, stat)(column, binby="k", shape=G, limits=[0, G])
        assert_special(got, want, what)
        return
    if route == "df.stat":  # the frame, then one selection per kind of group
        df = _frame(route)
        x = ARRAYS[column]
        with cache.off():
            assert_special(getattr(df, stat)(column), numpy_stat(x, stat), what)
            groups = _kinds(x, ARRAYS["k"])
            assert set(groups) == {"both", "+inf", "-inf", "largest", "finite"}
            for kind, g in groups.items():
                got = getattr(df, stat)(column, selection=f"k == {g}")
                assert_special(got, want[g], f"{what} of a group with {kind}")
        return
    got, log = _grouped(route)
    assert_special(got[f"{stat}_{column}"], want, what)
    if route in TRACE:
        name, value = TRACE[route]
        assert any(e.get(name) == value for e in log), (route, log)
    else:
        assert not any("groupby" in e or "shuffle" in e for e in log), (route, log)


def test_the_sweep_holds_each_kind_of_group():
    """Groups with both infinities, one of them, the largest value alone and
    none: each kind is there in both dtypes, and no float64 group holds two
    largest values (a sum whose finite terms overflow next to an infinity
    depends on the order of the adds: the next test takes those)."""
    for column in COLUMNS.values():
        assert set(_kinds(ARRAYS[column], ARRAYS["k"])) == {
            "both", "+inf", "-inf", "largest", "finite"}
    assert np.isinf(_want("x64", "std")).any() and np.isinf(_want("x64", "sum")).any()
    assert np.isnan(_want("x32", "sum")).any() and np.isneginf(_want("x32", "mean")).any()


# groups of float64 values past what u^2 holds: one largest value (its
# square overflows, the sum does not), two (the sum overflows too), the
# largest value beside -inf, and two plain values, whose first row is the
# frame's first (the classic paths' shift: a shift far from a group loses
# that group's digits, C25)
BIG = np.finfo(np.float64).max
OVERFLOW = {"values": [2.0, BIG, 1.0, 2.0, BIG, BIG, 1.0, BIG, -np.inf, 3.0],
            "k": [3, 0, 0, 0, 1, 1, 1, 2, 2, 3]}


@pytest.mark.parametrize("route", ["dense", "one-sort", "classic wide", "binby", "df.stat",
                                   "mesh classic"])
def test_a_variance_past_float64_is_inf(route, monkeypatch):
    """C24: numpy's nanvar is inf where the deviations' squares overflow
    float64 and NaN where the group holds an infinity; the shifted sums gave
    NaN for both."""
    x, k = np.array(OVERFLOW["values"]), np.array(OVERFLOW["k"], dtype=np.int64)
    want = {stat: np.array([numpy_stat(x[k == g], stat) for g in range(4)])
            for stat in ("var", "std")}
    assert np.isinf(want["var"][:2]).all() and np.isnan(want["var"][2])
    df = vaex_tpu_torch.from_arrays(k=k, w=k * WIDE, x=x).to_device("cpu")
    if route == "classic wide":
        df = df[df.k >= 0]
    if route == "mesh classic":
        monkeypatch.setattr(groupby, "SHUFFLE_MIN_G", 1)
        df.executor = distributed_executor(3, devices=["cpu"] * 3)
    for stat in ("var", "std"):
        with cache.off():
            if route == "binby":
                got = getattr(df, stat)("x", binby="k", shape=4, limits=[0, 4])
            elif route == "df.stat":
                got = [getattr(df, stat)("x", selection=f"k == {g}") for g in range(4)]
            else:
                out = df.groupby("w" if route in ("one-sort", "classic wide") else "k",
                                 agg={"v": getattr(agg, stat)("x")}, sort=True)
                got = out["v"].values
        assert_special(got, want[stat], f"{route} {stat}")


@pytest.mark.parametrize("dtype", list(COLUMNS))
def test_the_one_sort_reproducer(dtype):
    """C23's reproducer: w = [0, 0, 0, 5e9, 5e9] on the one-sort route."""
    w = np.array([0, 0, 0, 5_000_000_000, 5_000_000_000])
    cases = {"inf -inf": [np.inf, -np.inf, 1, 2, 3], "inf": [np.inf, 1, 1, 2, 3],
             "two inf": [np.inf, np.inf, 1, 2, 3]}
    for name, values in cases.items():
        f = np.array(values, dtype=dtype)
        df = vaex_tpu_torch.from_arrays(w=w, f=f).to_device("cpu")
        with cache.off():
            out = df.groupby("w", agg={s: getattr(agg, s)("f") for s in STATS}, sort=True)
        assert df.executor.trace_log[-1]["groupby"] == "one-sort"
        for stat in STATS:
            want = [numpy_stat(f[:3], stat), numpy_stat(f[3:], stat)]
            assert_special(out[stat].values, want, f"{name} {stat}")
    assert out["std"].values[1] == 0.5 and out["var"].values[1] == 0.25


# --------------------------------------------------- the reference's faults

def test_the_reference_sums_one_sort_groups_by_prefix_differences():
    """vaex_tpu/fused_groupby.py:28, 636, pinned: its one-sort float sums are
    differences of one f64 cumsum, so every group after one that holds an
    infinity comes out NaN (the second group's sum is 5)."""
    w = np.array([0, 0, 0, 5_000_000_000, 5_000_000_000])
    f = np.array([np.inf, 1, 1, 2, 3])
    aggs = lambda pkg: {"s": pkg.agg.sum("f"), "m": pkg.agg.mean("f")}  # noqa: E731
    ref = vaex_tpu.from_arrays(w=w, f=f).groupby("w", agg=aggs(vaex_tpu), sort=True)
    assert ref["s"].tolist()[0] == np.inf and np.isnan(ref["s"].tolist()[1])
    assert np.isnan(ref["m"].tolist()[1])
    port = vaex_tpu_torch.from_arrays(w=w, f=f).to_device("cpu")
    got = port.groupby("w", agg=aggs(vaex_tpu_torch), sort=True)
    assert got["s"].tolist() == [np.inf, 5.0] and got["m"].tolist() == [np.inf, 2.5]


def test_the_reference_sums_a_dense_group_with_an_infinity_to_nan():
    """vaex_tpu's dense raw-key groupby, pinned: {inf, 1} and {-inf, 2} sum
    to NaN and NaN, where numpy gives inf and -inf."""
    k, f = np.array([0, 0, 1, 1]), np.array([np.inf, 1, -np.inf, 2])
    ref = vaex_tpu.from_arrays(k=k, f=f).groupby("k", agg={"s": vaex_tpu.agg.sum("f")},
                                                  sort=True)
    assert np.isnan(ref["s"].tolist()).all()
    port = vaex_tpu_torch.from_arrays(k=k, f=f).to_device("cpu")
    got = port.groupby("k", agg={"s": agg.sum("f")}, sort=True)
    assert got["s"].tolist() == [np.inf, -np.inf]


def test_the_reference_std_binby_with_an_infinity_in_row_0():
    """vaex_tpu's binned std, pinned: an infinity in row 0 (its raw moments'
    first row) makes every bin NaN; numpy gives NaN for the bin that holds
    it alone."""
    f = np.arange(10.0)
    f[0] = np.inf
    k = np.arange(10) % 2
    want = [numpy_stat(f[k == b], "std") for b in range(2)]
    ref = vaex_tpu.from_arrays(k=k, f=f).std("f", binby="k", shape=2, limits=[0, 2])
    assert np.isnan(np.asarray(ref)).all()
    port = vaex_tpu_torch.from_arrays(k=k, f=f).to_device("cpu")
    assert_special(port.std("f", binby="k", shape=2, limits=[0, 2]), want, "std binby")


def _datetimes(n=5000, seed=0):
    rng = np.random.default_rng(seed)
    d = (np.datetime64("2020-01-01T00:00:00", "ns")
         + rng.integers(0, 950, n).astype("m8[D]"))
    d[::67] = np.datetime64("NaT")
    return d


def test_the_reference_lists_nat_once_per_tile_in_value_counts():
    """vaex_tpu's ``value_counts(dropna=False)`` of a datetime64 column with
    NaT, pinned: over tiles of 512 rows it lists NaT once per tile (ten
    entries of 7 or 8); pandas and the port list it once, with all 75."""
    d = _datetimes()
    want = pd.Series(d).value_counts(dropna=False)
    ref = vaex_tpu.from_arrays(d=d)
    ref._tile_rows = 512
    ref_nat = [c for v, c in ref.d.value_counts(dropna=False).items() if pd.isna(v)]
    assert len(ref_nat) == 10 and sum(ref_nat) == 75
    port = vaex_tpu_torch.from_arrays(d=d).to_device("cpu")
    port._tile_rows = 512
    got = port.d.value_counts(dropna=False)
    assert len(got) == len(want)
    assert [c for v, c in got.items() if pd.isna(v)] == [int(want[pd.NaT])] == [75]
    assert sorted(got.tolist()) == sorted(want.tolist())
    assert port.d.nunique(dropna=False) == pd.Series(d).nunique(dropna=False)
