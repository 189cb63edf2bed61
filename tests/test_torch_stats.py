"""The port's per-cell statistics against vaex_tpu on the same frames: var,
std, min, max, minmax, covar and correlation on the DataFrame, and std,
var, corr, covar, min and max as groupby aggregators, on one key (G = 103),
two keys (G = 10 609) and one key wide enough for B3 (the port on
device="cpu", where each kernel wrapper runs its plain version; the plan
picks the same kernel as on a GPU, so the strategies are asserted too).

Ints exact; floats to 1e-6 relative and 1e-7 absolute.  A constant cell's
variance is a rounding residue whose size differs between the two packages
(both clamp it at 0): it is held to 1e-9 * c^2 on var, and its std is not
compared.
"""

import numpy as np
import numpy.testing as npt
import pytest

import torch

import vaex_tpu
import vaex_tpu_torch
import vaex_tpu_torch.tasks
from torch_port_helpers import ATOL, RTOL, assert_same_frame, same_frames, seeded_arrays


def _h2o(seed, n=200_000, k=100, k6=None, empty_above=None):
    """H2O-groupby-shaped columns: id4, id5 in 1..k (below empty_above only,
    so the categories above it stay empty), id6 in 1..k6, v1, v2 in 1..5,
    v3 uniform in [0, 100) with NaN in every 17th row."""
    rng = np.random.default_rng(seed)
    top = empty_above or k
    d = {"id4": rng.integers(1, top + 1, n), "id5": rng.integers(1, k + 1, n),
         "v1": rng.integers(1, 6, n), "v2": rng.integers(1, 6, n),
         "v3": rng.uniform(0, 100, n)}
    if k6:
        d["id6"] = rng.integers(1, k6 + 1, n)
    d["v3"][::17] = np.nan
    return d


def _frames(arrays, keys):
    """Both packages' frames with each key categorized on 1..K."""
    ref, port = same_frames(arrays)
    for name, k in keys.items():
        labels = list(range(1, k + 1))
        ref = ref.categorize(name, min_value=1, labels=labels)
        port = port.categorize(name, min_value=1, labels=labels)
    return ref, port


def _strategies(df):
    return df.executor.trace_log[-1]["strategies"]


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if want.dtype.kind == "f" or got.dtype.kind == "f":
        npt.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    else:
        assert got.dtype == want.dtype
        npt.assert_array_equal(got, want)


@pytest.mark.parametrize("stat,kw", [("var", {}), ("var", {"ddof": 1}), ("std", {}),
                                     ("std", {"ddof": 1}), ("min", {}), ("max", {}),
                                     ("minmax", {})])
def test_df_statistics_match_vaex_tpu(stat, kw):
    """x f64 with NaN, iv int64 near 2^40, y f32; with no binby and by k."""
    ref, port = same_frames(seeded_arrays(3, 20_000, k=100, nan_every=13), "k",
                            labels=list(range(100)))
    columns = ("x", "iv", "y")
    results = {}
    for name, df in (("ref", ref), ("port", port)):
        promises = [getattr(df, stat)(c, binby=binby, delay=True, **kw)
                    for c in columns for binby in ([], ["k"])]
        df.execute()
        results[name] = [p.get() for p in promises]
    for got, want in zip(results["port"], results["ref"]):
        _close(got, want)
    if stat in ("min", "max"):  # the input dtype, f32 included
        assert [np.asarray(r).dtype for r in results["port"]] == [
            np.asarray(r).dtype for r in results["ref"]]


def test_covar_and_correlation_match_vaex_tpu():
    ref, port = same_frames(seeded_arrays(4, 20_000, k=100, nan_every=11), "k",
                            labels=list(range(100)))
    for x, y in (("x", "y"), ("iv", "y")):
        _close(port.covar(x, y), ref.covar(x, y))
        _close(port.correlation(x, y), ref.correlation(x, y))
        _close(port.correlation(x, y, binby=["k"]), ref.correlation(x, y, binby=["k"]))
    _close(port.covar("x", "y", binby=["k"]), ref.covar("x", "y", binby=["k"]))
    _close(port.correlation(["x", "y", "iv"]), ref.correlation(["x", "y", "iv"]))


def _aggs(pkg, kind):
    a = pkg.agg
    return {
        "var": {"sd_v3": a.std("v3", ddof=1), "var_v3": a.var("v3")},
        "corr": {"r2": a.corr("v1", "v2"), "cov": a.covar("v3", "v1"),
                 "cov1": a.covar("v1", "v2", ddof=1)},
        "extremes": {"max_v1": a.max("v1"), "min_v2": a.min("v2"), "max_v3": a.max("v3"),
                     "min_v3": a.min("v3")},
    }[kind]


@pytest.mark.parametrize("kind,strategy", [
    ("var", {"moments": "b4"}),  # C = 3 at G = 103
    ("corr", {"moments": "b5"}),  # past B4's grid at C = 6
    ("extremes", {"extremes": "b3x-direct"}),  # the min/max kernel, no partition
])
def test_groupby_one_key(kind, strategy):
    """G = 103; categories 98..100 have no row: NaN moments, min/max
    identities (+-inf, int64 max / min)."""
    ref, port = _frames(_h2o(5, empty_above=97), {"id4": 100})
    want = ref.groupby("id4", agg=_aggs(vaex_tpu, kind))
    got = port.groupby("id4", agg=_aggs(vaex_tpu_torch, kind))
    assert _strategies(port) == [strategy]
    assert len(got) == 100  # one key keeps every category
    assert_same_frame(want, got)


def test_groupby_two_keys_q6_sd_and_q9():
    """H2O q6 (sd part) and q9 on the cartesian grid of two keys
    (G = 10 609, sort=True): the window kernel B5."""
    ref, port = _frames(_h2o(6), {"id4": 100, "id5": 100})
    for aggs in ({"sd_v3": "std"}, {"r2": "corr"}):
        name, = aggs
        spec = (lambda pkg: {name: pkg.agg.std("v3", ddof=1)} if name == "sd_v3"
                else {name: pkg.agg.corr("v1", "v2")})
        want = ref.groupby(["id4", "id5"], agg=spec(vaex_tpu), sort=True)
        got = port.groupby(["id4", "id5"], agg=spec(vaex_tpu_torch), sort=True)
        assert _strategies(port) == [{"additive": "b2", "moments": "b5"}]
        assert_same_frame(want, got)


def test_groupby_wide_key_takes_b3_q7():
    """One key past B5's windows (K = 250 000): the moments ride B3 (its
    resident route: the grid stays in L2) over the formed term columns; H2O
    q7's max/min keep int64 through the min/max kernel's resident route."""
    K = 250_000
    ref, port = _frames(_h2o(7, n=100_000, k6=K), {"id6": K})
    aggs = lambda pkg: {"sd": pkg.agg.std("v3"), "r2": pkg.agg.corr("v1", "v2"),  # noqa: E731
                        "max_v1": pkg.agg.max("v1"), "min_v2": pkg.agg.min("v2")}
    want = ref.groupby("id6", agg=aggs(vaex_tpu))
    got = port.groupby("id6", agg=aggs(vaex_tpu_torch))
    assert _strategies(port) == [{"moments": "b3-l2", "extremes": "b3x-l2"}]
    assert got.evaluate("max_v1").dtype == want.evaluate("max_v1").dtype == np.int64
    assert_same_frame(want, got)


def _edge_cases():
    """k = 0: one row; 1: a constant 1e3; 2: only NaN; 3..9: random;
    10, 11: no row."""
    rng = np.random.default_rng(8)
    k = np.concatenate([[0], np.full(50, 1), np.full(20, 2), rng.integers(3, 10, 2000)])
    x = rng.normal(10, 3, len(k))
    x[k == 1] = 1e3
    x[k == 2] = np.nan
    y = rng.normal(-2, 1, len(k))
    return same_frames({"k": k, "x": x, "y": y}, "k", labels=list(range(12)))


@pytest.mark.parametrize("ddof", [0, 1, 2])
def test_var_std_edge_cells(ddof):
    ref, port = _edge_cases()
    var = port.var("x", binby=["k"], ddof=ddof)
    want = ref.var("x", binby=["k"], ddof=ddof)
    assert not np.isnan(var[1]) and abs(var[1]) <= 1e-9 * 1e3 ** 2  # the constant cell
    other = np.arange(12) != 1
    _close(var[other], want[other])
    # n <= ddof (cell 0 has one row), only NaN (2), no row (10, 11): NaN
    nan_cells = [2, 10, 11] + ([0] if ddof >= 1 else [])
    assert np.isnan(var[nan_cells]).all()
    std = port.std("x", binby=["k"], ddof=ddof)
    _close(std[other], ref.std("x", binby=["k"], ddof=ddof)[other])
    out = port.groupby("k", agg={"v": vaex_tpu_torch.agg.var("x", ddof=ddof),
                                 "r": vaex_tpu_torch.agg.corr("x", "y")})
    ref_out = ref.groupby("k", agg={"v": vaex_tpu.agg.var("x", ddof=ddof),
                                    "r": vaex_tpu.agg.corr("x", "y")})
    _close(np.asarray(out["v"].tolist())[other], np.asarray(ref_out["v"].tolist())[other])
    # the constant operand gives no correlation: NaN, in both
    _close(out["r"].tolist(), ref_out["r"].tolist())
    assert np.isnan(out["r"].tolist()[1])


def test_min_max_edge_cells():
    ref, port = _edge_cases()
    for stat in ("min", "max", "minmax"):
        got = getattr(port, stat)("x", binby=["k"])
        _close(got, getattr(ref, stat)("x", binby=["k"]))
    mm = port.minmax("x", binby=["k"])
    assert np.isposinf(mm[[2, 10, 11], 0]).all() and np.isneginf(mm[[2, 10, 11], 1]).all()


def test_masked_base_is_its_nan_form():
    """A masked column's masked rows are missing, as NaN rows are."""
    arrays = seeded_arrays(9, 5000, k=20)
    mask = np.random.default_rng(9).random(5000) < 0.2
    arrays["xm"] = np.ma.MaskedArray(arrays["x"], mask)
    arrays["xn"] = np.where(mask, np.nan, arrays["x"])
    ref, port = same_frames(arrays, "k", labels=list(range(20)))
    for pkg, df in ((vaex_tpu, ref), (vaex_tpu_torch, port)):
        out = df.groupby("k", agg={"sm": pkg.agg.std("xm"), "sn": pkg.agg.std("xn"),
                                   "rm": pkg.agg.corr("xm", "y"), "rn": pkg.agg.corr("xn", "y"),
                                   "mm": pkg.agg.min("xm"), "mn": pkg.agg.min("xn")})
        for a, b in (("sm", "sn"), ("rm", "rn"), ("mm", "mn")):
            npt.assert_allclose(out[a].tolist(), out[b].tolist(), rtol=1e-12, atol=0)
        if pkg is vaex_tpu:
            want = out
    assert_same_frame(want, out)


def test_moment_ops_past_max_bases_split_into_calls(monkeypatch):
    """Five std's read five bases: two kernel calls, at most four bases
    each; the terms of std and var of one column are shared."""
    arrays = seeded_arrays(10, 3000, k=30)
    rng = np.random.default_rng(10)
    for c in "abcde":
        arrays[c] = rng.normal(0, 1, 3000)
    ref, port = same_frames(arrays, "k", labels=list(range(30)))
    calls = []
    moment_sums = vaex_tpu_torch.tasks.moment_sums

    def counted(idx, bases, terms, G):
        calls.append((len(bases), len(terms)))
        return moment_sums(idx, bases, terms, G)
    monkeypatch.setattr(vaex_tpu_torch.tasks, "moment_sums", counted)
    aggs = lambda pkg: {"a": pkg.agg.std("a"), "va": pkg.agg.var("a", ddof=1),  # noqa: E731
                        **{c: pkg.agg.std(c) for c in "bcde"}}
    got = port.groupby("k", agg=aggs(vaex_tpu_torch))
    assert calls == [(4, 12), (1, 3)]
    assert_same_frame(ref.groupby("k", agg=aggs(vaex_tpu)), got)


@pytest.mark.parametrize("mode", ["min", "max"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.int64, np.int32])
def test_grid_extreme_matches_numpy(mode, dtype):
    """Rows outside [0, G), NaN rows and invalid rows drop; empty bins hold
    the identity; the dtype is kept, int64 beyond 2^53 exactly."""
    from vaex_tpu_torch.ops import grid_extreme as ge
    rng = np.random.default_rng(12)
    n, G = 5000, 300
    idx = rng.integers(-3, G + 5, n).astype(np.int32)
    if np.dtype(dtype).kind == "f":
        col = rng.normal(0, 1e3, n).astype(dtype)
        col[::7] = np.nan
    else:
        info = np.iinfo(dtype)
        col = rng.integers(info.min // 2, info.max // 2, n, dtype=dtype)
        col[::5] += np.iinfo(dtype).max // 2  # past 2^53 for int64
    valid = rng.random(n) < 0.9
    got = ge.grid_extreme(ge.extreme_bins(torch.from_numpy(idx), G), torch.from_numpy(col), G,
                          mode, torch.from_numpy(valid))
    assert got.dtype == torch.from_numpy(col).dtype
    keep = (idx >= 0) & (idx < G) & valid & ~np.isnan(col.astype(np.float64))
    fill = torch.tensor(ge.identity(got.dtype, mode), dtype=got.dtype).item()
    want = np.full(G, fill, dtype)
    (np.minimum if mode == "min" else np.maximum).at(want, idx[keep], col[keep])
    npt.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["float64", "float32", "int64", "int32"])
@pytest.mark.parametrize("mode", ["min", "max"])
def test_extreme_of_rows_matches_grid_extreme(mode, dtype):
    """The one-cell reduction of a statistic without binby equals the grid
    version at G = 1: NaN and invalid rows drop, no row gives the identity."""
    from vaex_tpu_torch.ops import grid_extreme as ge
    rng = np.random.default_rng(13)
    n = 3000
    col = torch.from_numpy((rng.normal(0, 1e3, n)).astype(dtype))
    if col.is_floating_point():
        col[::7] = float("nan")
    zeros = torch.zeros(n, dtype=torch.int64)
    for valid in (None, torch.from_numpy(rng.random(n) < 0.5), torch.zeros(n, dtype=torch.bool)):
        got = ge.extreme_of_rows(col, mode, valid)
        assert got.dtype == col.dtype and got.shape == (1,)
        assert torch.equal(got, ge.grid_extreme(zeros, col, 1, mode, valid))
    empty = ge.extreme_of_rows(col[:0], mode)
    assert empty.tolist() == [ge.identity(col.dtype, mode)]


def test_aggregator_names_match_vaex_tpu():
    ref, port = _frames(_h2o(11, n=2000), {"id4": 100})
    for spec in ({"v3": ["std", "var", "min", "max"]}, ["std", "max"]):
        want = ref.groupby("id4", agg=spec)
        got = port.groupby("id4", agg=spec)
        assert_same_frame(want, got)
    named = lambda pkg: [pkg.agg.corr("v1", "v2"), pkg.agg.covar("v3", "v1")]  # noqa: E731
    assert_same_frame(ref.groupby("id4", agg=named(vaex_tpu)),
                      port.groupby("id4", agg=named(vaex_tpu_torch)))



@pytest.mark.parametrize("how,indexed", [("alone", False), ("selection", True),
                                         ("binby", True), ("beside a sum", True)])
def test_statistic_without_binby_passes_b4_no_index(monkeypatch, how, indexed):
    """A moment statistic without binby or selection hands B4 no index (every
    row in bin 0), so no all-zero index is made or read; a selection, a
    binby or an additive statistic in the same pass still gets one.  The
    results match vaex_tpu's either way."""
    from vaex_tpu_torch.ops import grid_plan
    b4, seen = grid_plan.MOMENT_KERNELS["b4"], []

    def spy(idx, bases, terms, G):
        seen.append(idx is not None)
        return b4(idx, bases, terms, G)
    monkeypatch.setitem(grid_plan.MOMENT_KERNELS, "b4", spy)
    ref, port = _frames(_h2o(23, n=20_000), {"id4": 100})
    kw = {"selection": "v1 > 2"} if how == "selection" else {}
    kw.update(binby=["id4"] if how == "binby" else [])
    results = {}
    for name, df in (("ref", ref), ("port", port)):
        promises = [df.std("v3", delay=True, **kw)]
        if how == "beside a sum":
            promises.append(df.sum("v1", delay=True))
        df.execute()
        results[name] = [p.get() for p in promises]
    for got, want in zip(results["port"], results["ref"]):
        _close(got, want)
    assert seen and all(s == indexed for s in seen)
    if how == "beside a sum":  # one pass: the sum rides B4's pass
        assert {"additive", "moments"} <= _strategies(port)[0].keys()
