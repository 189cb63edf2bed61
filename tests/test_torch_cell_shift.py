"""C25 of ROADMAP queue C: a shift a cell for the classic moments, and C24's
leftover (``dataframe.cov``'s diagonal, ``covar`` and ``corr`` where a
float64 cell's products overflow).

The classic std, var, covar and corr take the sums of u = x - a.  With one
shift a frame (the first valid value of its first rows) a group far from it
cancels its sums down to rounding noise: std 0.0, a covar of 1e10, a corr
of inf, where numpy gives about 1, 2 and 0.9.  A statistic now flags such a
cell from its first pass (``agg.cancelled``) and takes it again in one
second pass, less a shift a cell: the cell's mean, a [G] table that B4 and
B5 (and the wide routes, through ``grid_moments.form_terms``) read at each
row's bin.

The frames: 20 000 rows from seed 1, x = offset[k] + N(0, 1) over four
groups, y = 2 x + N(0, 1), row 0 in the farthest group; the same in
float32, in int64 (offsets up to 2^50, noise N(0, 100) rounded) and as a
masked int64 column (every 7th row masked).  Each answer is held to numpy's
two-pass answer per group (``np.var``, ``np.std``, the mean of the centred
products, ``np.corrcoef``) within 1e-6 relative and 1e-7 absolute, through
binby and ``groupby(agg=...)`` on every classic route: B4's lane and warp
routes, B5, ``b3-l2``, ``b3`` and ``sort`` (forced by lowering the plan's
limits), a 3-shard CPU mesh, the all-to-all groupby and ``df.cov`` /
``describe``.  Where the reference takes part (``vaex_tpu``, its plain
path) the frame is well conditioned: the reference takes raw moments
(vaex_tpu/agg.py:1114), which lose these groups too.
"""

import hypothesis
import hypothesis.strategies as st
import numpy as np
import numpy.testing as npt
import pytest
import torch

import vaex_tpu
import vaex_tpu_torch
from torch_port_helpers import assert_special, numpy_stat
from vaex_tpu_torch import agg, cache, groupby, tasks
from vaex_tpu_torch.ops import grid_moments as gm
from vaex_tpu_torch.ops import grid_partition as gp
from vaex_tpu_torch.ops import grid_plan
from vaex_tpu_torch.ops.nullable import NA
from vaex_tpu_torch.parallel import distributed_executor

RTOL, ATOL = 1e-6, 1e-7
N = 20_000
G = 4
LIMITS = {"binby": "k", "shape": G, "limits": [-0.5, G - 0.5]}
OFFSETS = {"float64": (0.0, 1e4, 1e8, 1e12), "float32": (0.0, 1e2, 1e4, 1e6),
           "int64": (0, 2 ** 20, 2 ** 35, 2 ** 50), "masked": (0, 2 ** 20, 2 ** 35, 2 ** 50)}
DTYPES = list(OFFSETS)
STATS = ["std", "var", "covar", "corr"]
GRID_ROUTES = ["b4 lane", "b4 warp", "b5", "b3-l2", "b3", "sort"]


def _columns(dtype="float64", seed=1, outlier=False):
    """(k, x, y, valid): x = offset[k] + noise in ``dtype`` (numpy arrays;
    ``masked``: x an int64 MaskedArray), row 0 in the last group; with
    ``outlier`` three groups at (0, 1e4, 1e8) and row 0 = 1e10 alone in the
    fourth."""
    rng = np.random.default_rng(seed)
    offsets = np.array(OFFSETS[dtype] if not outlier else (0.0, 1e4, 1e8, 0.0))
    k = rng.integers(0, 3 if outlier else G, N)
    k[0] = G - 1
    if dtype in ("int64", "masked"):
        x = offsets.astype(np.int64)[k] + np.rint(rng.normal(0, 100, N)).astype(np.int64)
        y = 2 * x + np.rint(rng.normal(0, 100, N)).astype(np.int64)
    else:
        x = offsets[k] + rng.normal(0, 1, N)
        if outlier:
            x[0] = 1e10
        y = 2 * x + rng.normal(0, 1, N)
        if dtype == "float32":
            x, y = x.astype(np.float32), y.astype(np.float32)
    valid = np.ones(N, dtype=bool)
    if dtype == "masked":
        valid[::7] = False
        x = np.ma.MaskedArray(x, ~valid)
    return k, x, y, valid


def _frame(k, x, y):
    return vaex_tpu_torch.from_arrays(k=k, x=x, y=y).to_device("cpu")


def _numpy(stat, k, x, y, valid, groups=G):
    """numpy's two-pass answer per group, over the rows where x is valid; an
    int column's group less its first value first, in int64 (exact; numpy
    would cast values near 2^50 to float64 and round its own mean)."""
    x = np.ma.getdata(x)
    out = []
    for g in range(groups):
        keep = (k == g) & valid
        xs, ys = x[keep], y[keep]
        if xs.dtype.kind == "i":
            xs, ys = xs - xs[0], ys - ys[0]
        xs, ys = xs.astype(np.float64), ys.astype(np.float64)
        if stat in ("std", "var"):
            out.append(getattr(np, stat)(xs))
        elif stat == "covar":
            out.append(np.mean((xs - xs.mean()) * (ys - ys.mean())))
        else:
            out.append(np.corrcoef(xs, ys)[0, 1])
    return np.array(out)


def _close(got, want, what, atol=ATOL):
    npt.assert_allclose(np.asarray(got, dtype=np.float64), want, rtol=RTOL, atol=atol,
                        err_msg=what)


def _aggregator(stat):
    return (getattr(agg, stat)("x") if stat in ("std", "var")
            else getattr(agg, stat)("x", "y"))


def _check_binned(df, stat, dtype, want, what):
    """The binned statistic through ``df.<stat>``; ``df.covar`` and
    ``df.correlation`` take each mean over its own rows (vaex_tpu's cov), so
    a masked column's are held to that in
    test_a_masked_cov_follows_the_reference_s_definition instead."""
    if stat in ("std", "var"):
        _close(getattr(df, stat)("x", **LIMITS), want, what)
    elif dtype != "masked":
        _close((df.covar if stat == "covar" else df.correlation)("x", "y", **LIMITS), want, what)


def _force(route, monkeypatch):
    """Lower the plan's limits so that a grid of a few cells takes ``route``."""
    if route != "b4 lane":  # no lane route: B4's warp route up to b4_max_g
        monkeypatch.setattr(gm, "LANE_MIN_WARPS", {s: 1 << 30 for s in gm.LANE_MIN_WARPS})
    if route not in ("b4 lane", "b4 warp"):  # past B4
        monkeypatch.setattr(grid_plan, "B4_MAX_GC", 0)
    if route in ("b3-l2", "b3", "sort"):  # past B5
        monkeypatch.setattr(grid_plan, "B5_MAX_PARTS", 0)
    if route == "b3-l2":
        monkeypatch.setattr(gp, "RESIDENT_MIN_G", 1)
    if route == "sort":
        monkeypatch.setattr(gp, "P_MAX", 0)


def _moment_routes(df, start):
    return {s.get("moments") for e in df.executor.trace_log[start:]
            for s in e.get("strategies") or [] if s.get("moments")}


# ------------------------------------------------------- the issue's table

def test_the_motivation_table():
    """20 000 rows, offsets (0, 1e4, 1e8, 1e12), row 0 in the 1e12 group:
    std, covar and corr by k as numpy gives them, binned and per group, in
    one second pass each; PR 24's tree gave std 0, covar 7.8e9 and corr inf
    for the first three groups."""
    k, x, y, valid = _columns()
    df = _frame(k, x, y)
    before = agg.cell_shifted.second_passes
    with cache.off():
        for stat in ("std", "covar", "corr"):
            want = _numpy(stat, k, x, y, valid)
            _check_binned(df, stat, "float64", want, f"binned {stat}")
            out = df.groupby("k", agg={"v": _aggregator(stat)}, sort=True)
            _close(out["v"].values, want, f"groupby {stat}")
    assert agg.cell_shifted.second_passes > before


def test_the_outlier_variant():
    """Offsets (0, 1e4, 1e8) and an outlier of 1e10 in row 0, a group of its
    own: the three groups' std of about 1 came out 0.0 on PR 24's tree."""
    k, x, y, valid = _columns(outlier=True)
    df = _frame(k, x, y)
    want = _numpy("std", k, x, y, valid)
    assert (want[:3] > 0.9).all()
    with cache.off():
        _close(df.std("x", **LIMITS), want, "binned std")
        out = df.groupby("k", agg={"s": agg.std("x"), "v": agg.var("x")}, sort=True)
    _close(out["s"].values, want, "groupby std")
    _close(out["v"].values, want ** 2, "groupby var")


# --------------------------------------------------- every classic route

@pytest.mark.parametrize("stat", STATS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("route", GRID_ROUTES)
def test_every_grid_route_keeps_far_groups(route, dtype, stat, monkeypatch):
    """std / var / covar / corr by k on each grid route, binned and per
    group, in float64, float32, int64 and a masked int64, each group held
    to numpy; the route is asserted on the passes."""
    _force(route, monkeypatch)
    k, x, y, valid = _columns(dtype)
    df = _frame(k, x, y)
    want = _numpy(stat, k, x, y, valid)
    start = len(df.executor.trace_log)
    with cache.off():
        _check_binned(df, stat, dtype, want, f"{route} {dtype} binned {stat}")
        out = df.groupby("k", agg={"v": _aggregator(stat)}, sort=True)
    _close(out["v"].values, want, f"{route} {dtype} groupby {stat}")
    assert route.split()[0] in _moment_routes(df, start)


@pytest.mark.parametrize("stat", STATS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_the_row_sharded_mesh_keeps_far_groups(dtype, stat):
    """The same statistics over a mesh of three CPU shards: every shard
    subtracts the same table, and the merged sums give numpy's answer."""
    k, x, y, valid = _columns(dtype)
    df = _frame(k, x, y)
    df.executor = distributed_executor(3, devices=["cpu"] * 3)
    want = _numpy(stat, k, x, y, valid)
    with cache.off():
        _check_binned(df, stat, dtype, want, f"mesh {dtype} binned {stat}")
        out = df.groupby("k", agg={"v": _aggregator(stat)}, sort=True)
    _close(out["v"].values, want, f"mesh {dtype} groupby {stat}")
    assert df.executor.trace_log[-1]["mesh"]["shards"] == ["cpu"] * 3


@pytest.mark.parametrize("stat", ["std", "var"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_the_all_to_all_keeps_far_groups(dtype, stat, monkeypatch):
    """std / var per group through the all-to-all groupby of three CPU
    shards: each owner takes its own flagged cells again less their means."""
    monkeypatch.setattr(groupby, "SHUFFLE_MIN_G", 1)
    k, x, y, valid = _columns(dtype)
    df = _frame(k, x, y)
    df.executor = distributed_executor(3, devices=["cpu"] * 3)
    with cache.off():
        out = df.groupby("k", agg={"v": getattr(agg, stat)("x")}, sort=True)
    assert any(e.get("shuffle") is True for e in df.executor.trace_log)
    _close(out["v"].values, _numpy(stat, k, x, y, valid), f"all-to-all {dtype} {stat}")


@pytest.mark.parametrize("dtype", DTYPES)
def test_cov_and_describe_keep_far_groups(dtype):
    """``df.cov([x, y], binby=k)``: its diagonal is numpy's var, its
    off-diagonal the covar (over the rows where both are valid), and the
    corr it gives numpy's; ``describe``'s std of one far group (a
    selection) numpy's."""
    k, x, y, valid = _columns(dtype)
    df = _frame(k, x, y)
    with cache.off():
        c = df.cov(["x", "y"], **LIMITS)
        d = df.describe(selection="k == 0")
    want_var = _numpy("var", k, x, y, valid)
    _close(c[:, 0, 0], want_var, f"{dtype} cov diagonal")
    if dtype != "masked":  # vaex_tpu's cov takes each mean over its own rows
        _close(c[:, 0, 1], _numpy("covar", k, x, y, valid), f"{dtype} cov")
        _close(c[:, 0, 1] / np.sqrt(c[:, 0, 0] * c[:, 1, 1]), _numpy("corr", k, x, y, valid),
               f"{dtype} corr of cov")
    _close(d["x"]["std"], np.sqrt(want_var[0]), f"{dtype} describe std")


def test_a_masked_cov_follows_the_reference_s_definition():
    """With missing values an off-diagonal entry is E_xy[x y] - E_x[x]
    E_y[y], each mean over its own rows (vaex_tpu/dataframe.py:1060-1081):
    held to that entry taken exactly over the int64 values (fractions)."""
    from fractions import Fraction
    k, x, y, valid = _columns("masked")
    df = _frame(k, x, y)
    with cache.off():
        c = df.cov(["x", "y"], **LIMITS)
    xd = np.ma.getdata(x)
    for g in range(G):
        both, own = (k == g) & valid, k == g
        xy = sum(int(a) * int(b) for a, b in zip(xd[both], y[both]))
        want = (Fraction(xy, int(both.sum()))
                - Fraction(sum(map(int, xd[both])), int(both.sum()))
                * Fraction(sum(map(int, y[own])), int(own.sum())))
        npt.assert_allclose(c[g, 0, 1], float(want), rtol=RTOL, err_msg=f"group {g}")


# ------------------------------------------- the kernels' plain versions

@pytest.mark.parametrize("kernel", ["b4", "b5"])
@pytest.mark.parametrize("dtype", ["float64", "float32", "int64"])
def test_the_plain_versions_take_a_table(kernel, dtype):
    """B4's and B5's plain versions with a [G] shift table (a base less its
    bin's shift, rows outside [0, G) dropped) against numpy's sums of the
    shifted terms, exact for int64; a table of the wrong dtype or shape
    raises."""
    rng = np.random.default_rng(5)
    Gk, n = (37, 5000) if kernel == "b4" else (3001, 20_000)
    idx = rng.integers(-3, Gk + 3, n).astype(np.int32)
    cell = np.clip(idx, 0, Gk - 1)
    table = rng.integers(-2 ** 40, 2 ** 40, Gk)
    if dtype == "int64":
        x, t = table[cell] + rng.integers(-50, 50, n), torch.as_tensor(table)
        u = (x - table[cell]).astype(np.float64)
    else:
        x = (table[cell] + rng.normal(0, 1, n)).astype(dtype)
        t = torch.as_tensor(table.astype(np.float64))
        u = x.astype(np.float64) - table[cell].astype(np.float64)
    fn = gm.grid_moments if kernel == "b4" else gm.grid_moments_window
    counts, sums = fn(torch.as_tensor(idx), [torch.as_tensor(x)], agg.VAR_TERMS, Gk, [t])
    inside = (idx >= 0) & (idx < Gk)
    want = [np.bincount(idx[inside], u[inside] ** p, minlength=Gk) for p in (1, 2)]
    npt.assert_array_equal(counts[0].numpy(), np.bincount(idx[inside], minlength=Gk))
    npt.assert_allclose(sums.numpy(), np.stack(want), rtol=1e-12, atol=1e-9)
    with pytest.raises(ValueError, match="shift table"):
        fn(torch.as_tensor(idx), [torch.as_tensor(x)], agg.VAR_TERMS, Gk, [t[:-1]])
    wrong = t.to(torch.float64 if dtype == "int64" else torch.int64)
    with pytest.raises(ValueError, match="shift table"):
        fn(torch.as_tensor(idx), [torch.as_tensor(x)], agg.VAR_TERMS, Gk, [wrong])


def test_a_table_counts_in_the_kernels_shared_memory():
    """The plan counts a table's 8 bytes a base and bin: var's lane route
    ends below G = 181 with one, B5's corr at H2O's G = 10 609 takes more
    parts, and no part passes 227 KiB."""
    assert gm.route(181, 1, 2, 1) == gm.LANE and gm.route(181, 1, 2, 1, 1) == gm.WARP
    assert gm.n_parts(10_609, 6, 1, 2) > gm.n_parts(10_609, 6, 1)
    for G, C, nb in ((10_609, 3, 1), (10_609, 6, 2), (200_000, 16, 4)):
        W, _, bounds = gm.part_plan(G, C, 1, nb)
        for lo, hi in zip(bounds, bounds[1:]):
            assert W * gm.bin_bytes(hi - lo, max(0, min(hi, 1) - lo), nb) <= gm.CLUSTER_SMEM


# ------------------------------------------- when the second pass runs

def test_a_well_conditioned_frame_takes_no_second_pass():
    """Groups near the frame's shift (H2O-like: v3 in [0, 100), v1 and v2
    in 1..5, groups of one or two rows among them): std, var, covar and corr
    in one pass each, binned and per group, and ``df.cov`` in one."""
    rng = np.random.default_rng(2)
    k = rng.integers(0, 3000, 5000)
    v1, v2, v3 = rng.integers(1, 6, 5000), rng.integers(1, 6, 5000), rng.uniform(0, 100, 5000)
    df = vaex_tpu_torch.from_arrays(k=k, v1=v1, v2=v2, v3=v3).to_device("cpu")
    before, passes = agg.cell_shifted.second_passes, df.executor.passes
    with cache.off():
        df.groupby("k", agg={"s": agg.std("v3"), "v": agg.var("v1"), "c": agg.covar("v1", "v3"),
                             "r": agg.corr("v1", "v2")})
        df.std("v3", binby="k", shape=3000, limits=[-0.5, 2999.5])
        df.cov(["v1", "v3"], binby="k", shape=300, limits=[-0.5, 2999.5])
    assert agg.cell_shifted.second_passes == before
    assert df.executor.passes - passes <= 4  # the groupby's pre-pass and three passes


def test_a_constant_int_cell_is_not_flagged():
    """Cells of equal ints far from the shift: exact sums tell them from a
    lost cell, so they take no second pass and give 0."""
    k = np.repeat(np.arange(50), 4)
    x = (k * 1003).astype(np.int64)
    df = vaex_tpu_torch.from_arrays(k=k, x=x).to_device("cpu")
    before = agg.cell_shifted.second_passes
    with cache.off():
        got = df.groupby("k", agg={"s": agg.std("x")}, sort=True)["s"].values
    assert agg.cell_shifted.second_passes == before
    npt.assert_array_equal(np.asarray(got), np.zeros(50))


def test_a_second_pass_op_never_shares_a_base_with_a_first_pass_op():
    """The moment batch keys a base by its expression and, for a table, the
    table itself: a first-pass op (the frame's constant) and a second-pass op
    (a [G] table) of one expression take two bases; two constants of one
    expression share one."""
    from vaex_tpu_torch.tasks import _moment_batches
    frame = torch.tensor(3.0, dtype=torch.float64)
    table = torch.arange(4, dtype=torch.float64)
    ops = [agg.OpMoments(["x"], agg.VAR_TERMS, [frame]),
           agg.OpMoments(["x"], agg.VAR_TERMS, [table]),
           agg.OpMoments(["x"], agg.VAR_TERMS, [frame.clone()]),
           agg.OpMoments(["x"], agg.VAR_TERMS, [table.clone()])]
    [batch] = _moment_batches(ops, range(4))
    assert batch.bases == ["x"] * 3
    assert [s is table for s in batch.shifts] == [False, True, False]
    assert batch.shifts[0] is frame and batch.shifts[2] is not table
    assert [slots for _, slots in batch.members][0] == [slots for _, slots in
                                                        batch.members][2]


# ---------------------------------------- C25's reproducer, C24's leftover

BIG = np.finfo(np.float64).max
# OVERFLOW of tests/test_torch_special_floats.py, its first two rows in the
# other order (the largest float in row 0, as ROADMAP's C25 names it), and
# reversed
OVERFLOW = {"values": [2.0, BIG, 1.0, 2.0, BIG, BIG, 1.0, BIG, -np.inf, 3.0],
            "k": [3, 0, 0, 0, 1, 1, 1, 2, 2, 3]}
ORDERS = {"largest first": [1, 0, 2, 3, 4, 5, 6, 7, 8, 9], "reversed": list(range(9, -1, -1))}


@pytest.mark.parametrize("order", list(ORDERS))
@pytest.mark.parametrize("route", ["binby", "groupby", "mesh classic"])
def test_the_c25_reproducer(order, route, monkeypatch):
    """With the largest float in row 0 (the frame's shift) the std of the
    group [2, 3] was 0.0 where numpy gives 0.5; its u^2 overflowed, so C24's
    rescue ran over x * 2^-540 less the same far shift.  Now the second
    pass takes that cell less its own mean (0 where that mean is not
    finite), infinities and NaN as numpy gives them."""
    x = np.array(OVERFLOW["values"])[ORDERS[order]]
    k = np.array(OVERFLOW["k"], dtype=np.int64)[ORDERS[order]]
    df = vaex_tpu_torch.from_arrays(k=k, x=x).to_device("cpu")
    if route == "mesh classic":
        monkeypatch.setattr(groupby, "SHUFFLE_MIN_G", 1)
        df.executor = distributed_executor(3, devices=["cpu"] * 3)
    for stat in ("std", "var"):
        want = [numpy_stat(x[k == g], stat) for g in range(4)]
        with cache.off():
            if route == "binby":
                got = getattr(df, stat)("x", binby="k", shape=4, limits=[-0.5, 3.5])
            else:
                got = df.groupby("k", agg={"v": getattr(agg, stat)("x")}, sort=True)["v"].values
        assert_special(got, want, f"{route} {order} {stat}")
    assert want[3] == 0.25


def _overflowing():
    """A float64 frame whose first group's products pass float64 (|x| near
    1e155, spread 1e150: np.cov finite), a second group whose variance
    itself passes it (np.cov inf), and a plain third group."""
    rng = np.random.default_rng(9)
    k = np.repeat(np.arange(3), 40)
    x = np.concatenate([1e155 + rng.normal(0, 1e150, 40), rng.normal(0, 1e160, 40),
                        rng.normal(5, 1, 40)])
    y = np.concatenate([-2e155 + 3 * (x[:40] - 1e155) + rng.normal(0, 1e149, 40),
                        rng.normal(0, 1, 40), rng.normal(0, 1, 40) + x[80:]])
    return k, x, y


def test_cov_of_an_overflowing_cell_matches_numpy():
    """C24's leftover: ``df.cov``'s diagonal and off-diagonal, ``covar`` and
    ``corr`` of a float64 cell whose products overflow gave NaN (inf - inf);
    now numpy's np.cov / np.corrcoef answer: finite where numpy's is, inf
    where the variance itself passes float64."""
    k, x, y = _overflowing()
    df = vaex_tpu_torch.from_arrays(k=k, x=x, y=y).to_device("cpu")
    limits = {"binby": "k", "shape": 3, "limits": [-0.5, 2.5]}
    with cache.off():
        c = df.cov(["x", "y"], **limits)
        covar = df.groupby("k", agg={"c": agg.covar("x", "y"), "r": agg.corr("x", "y")},
                           sort=True)
        binned = df.covar("x", "y", **limits)
    for g in range(3):
        xs, ys = x[k == g], y[k == g]
        with np.errstate(over="ignore", invalid="ignore"):
            want = np.cov(xs, ys, ddof=0)
        if g == 1:  # the variance of x passes float64: numpy's inf, the rest finite
            assert np.isinf(want[0, 0]) and np.isinf(c[g, 0, 0]) and c[g, 0, 0] > 0
            npt.assert_allclose([c[g, 0, 1], c[g, 1, 1], covar["c"].values[g], binned[g]],
                                [want[0, 1], want[1, 1], want[0, 1], want[0, 1]], rtol=RTOL)
            continue
        npt.assert_allclose(c[g], want, rtol=RTOL, err_msg=f"cov of group {g}")
        npt.assert_allclose(covar["c"].values[g], want[0, 1], rtol=RTOL)
        npt.assert_allclose(binned[g], want[0, 1], rtol=RTOL)
        npt.assert_allclose(covar["r"].values[g], np.corrcoef(xs, ys)[0, 1], rtol=RTOL)
    assert np.isfinite(c[0]).all()


# ----------------------------------------- the reference, well conditioned

def test_the_port_agrees_with_the_reference_where_it_is_well_conditioned():
    """Groups near zero, where the reference's raw moments keep their digits:
    the port's std, var, covar and corr by k equal vaex_tpu's (its plain
    path) within 1e-6 relative."""
    rng = np.random.default_rng(4)
    data = {"k": rng.integers(0, 8, 4000), "x": rng.normal(0, 3, 4000),
            "y": rng.normal(1, 2, 4000)}
    aggs = lambda pkg: {"s": pkg.agg.std("x"), "v": pkg.agg.var("y"),  # noqa: E731
                        "c": pkg.agg.covar("x", "y"), "r": pkg.agg.corr("x", "y")}
    ref = vaex_tpu.from_arrays(**data).groupby("k", agg=aggs(vaex_tpu), sort=True)
    port = vaex_tpu_torch.from_arrays(**data).to_device("cpu")
    with cache.off():
        got = port.groupby("k", agg=aggs(vaex_tpu_torch), sort=True)
    for name in ("s", "v", "c", "r"):
        npt.assert_allclose(np.asarray(got[name].values), np.asarray(ref[name].tolist()),
                            rtol=RTOL, atol=ATOL, err_msg=name)


# ------------------------------------ C26-C28: the last silent zeros

def _c26():
    """C26: 20 000 rows, seed 0; k in {0, 1, 2} with x = (0, 10, 1e3)[k] +
    N(0, 1e-7), row 0 alone in group 3 at 1e17 (the frame's shift): one
    table from the first pass's means (0 for groups 0-2) leaves groups 1
    and 2 cancelling."""
    rng = np.random.default_rng(0)
    k = rng.integers(0, 3, N)
    x = np.array([0.0, 10.0, 1e3])[k] + rng.normal(0, 1e-7, N)
    k[0], x[0] = 3, 1e17
    return k, x


def _c27_int64():
    """C27: 4000 rows, seed 2; x = (-2^62, 2^62 - 10 000)[k] + an int in
    [-100, 100), row 0 in group 0: group 1's mean lies past 2^62 from the
    frame's shift."""
    rng = np.random.default_rng(2)
    k = rng.integers(0, 2, 4000)
    k[0] = 0
    x = np.array([-2 ** 62, 2 ** 62 - 10_000], dtype=np.int64)[k] + rng.integers(-100, 100, 4000)
    return k, x


def _c27_datetime():
    """C27's datetime64[ns] form: 4000 rows, seed 3; t = (1700-01-01,
    2100-01-01)[k] + up to 1e12 ns, row 0 in the 1700 group: 400 years
    apart, more than 2^62 ns."""
    rng = np.random.default_rng(3)
    k = rng.integers(0, 2, 4000)
    k[0] = 0
    t = (np.array(["1700-01-01", "2100-01-01"], dtype="datetime64[ns]")[k]
         + rng.integers(0, 10 ** 12, 4000).astype("timedelta64[ns]"))
    return k, t


def _c28():
    """C28: a nanosecond clock as uint64, 4000 values 1.7e18 + an int in
    [0, 100) (seed 1), in two groups: its spread lies below float64's
    spacing of 256 there."""
    rng = np.random.default_rng(1)
    x = np.uint64(1_700_000_000_000_000_000) + rng.integers(0, 100, 4000).astype(np.uint64)
    return rng.integers(0, 2, 4000), x


REPRODUCERS = {"c26": _c26, "c27 int64": _c27_int64, "c27 datetime": _c27_datetime,
               "c28 uint64": _c28}
ROUTES = GRID_ROUTES + ["mesh", "all-to-all", "cov"]


def _exact_var(values):
    """The variance of integer values (ints, datetime64's nanoseconds,
    uint64) in exact arithmetic: (n sum x^2 - (sum x)^2) / n^2."""
    from fractions import Fraction
    v = [int(a) for a in np.asarray(values).view(np.int64 if values.dtype.kind in "mM"
                                                    else values.dtype)]
    n = len(v)
    return float(Fraction(n * sum(a * a for a in v) - sum(v) ** 2, n * n)) if n else np.nan


def _want(stat, k, x, groups):
    """Per group numpy's two-pass var or std of a float column, the exact
    one of an integer, temporal or uint64 column."""
    out = []
    for g in range(groups):
        xs = x[k == g]
        var = np.var(xs.astype(np.float64)) if xs.dtype.kind == "f" else _exact_var(xs)
        out.append(var if stat == "var" else np.sqrt(var))
    return np.array(out)


def _limits(groups):
    return {"binby": "k", "shape": groups, "limits": [-0.5, groups - 0.5]}


def _by_route(df, route, groups, monkeypatch):
    """{(query, stat): the answer} of std and var by k on ``route``: binned
    and per group on a forced grid route or the 3-shard mesh, per group
    on the all-to-all, ``df.cov``'s diagonal (var) and its root (std)."""
    if route in ("mesh", "all-to-all"):
        df.executor = distributed_executor(3, devices=["cpu"] * 3)
    if route == "all-to-all":
        monkeypatch.setattr(groupby, "SHUFFLE_MIN_G", 1)
    elif route in GRID_ROUTES:
        _force(route, monkeypatch)
    got = {}
    with cache.off():
        if route == "cov":
            var = np.asarray(df.cov(["x"], **_limits(groups)))[:, 0, 0]
            return {("cov", "var"): var, ("cov", "std"): np.sqrt(var)}
        out = df.groupby("k", agg={"std": agg.std("x"), "var": agg.var("x")}, sort=True)
        for stat in ("std", "var"):
            got[("groupby", stat)] = out[stat].values
            if route != "all-to-all":
                got[("binby", stat)] = getattr(df, stat)("x", **_limits(groups))
    return got


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("case", list(REPRODUCERS))
def test_the_c26_to_c28_reproducers(case, route, monkeypatch):
    """Each of C26's, C27's (int64 and datetime64[ns]) and C28's frames on
    every classic route, binned and per group: numpy's two-pass std and var,
    or exact integer arithmetic, within 1e-6 relative and no absolute slack
    (C26's spread of 1e-7 lies within 1e-7 of 0.0).  One table from the
    first pass's means, an int table clamped to 2^62 from the frame's
    shift and a uint64 base rounded before its shift gave 0.0 for the
    groups far from the frame's shift (C26, C27) or every group (C28)."""
    k, x = REPRODUCERS[case]()
    groups = int(k.max()) + 1
    df = vaex_tpu_torch.from_arrays(k=k, x=x).to_device("cpu")
    start = len(df.executor.trace_log)
    got = _by_route(df, route, groups, monkeypatch)
    for (query, stat), value in got.items():
        _close(value, _want(stat, k, x, groups), f"{case} {route} {query} {stat}", atol=0)
    if route == "all-to-all":
        assert any(e.get("shuffle") is True for e in df.executor.trace_log)
    elif route == "mesh":
        assert df.executor.trace_log[-1]["mesh"]["shards"] == ["cpu"] * 3
    elif route in GRID_ROUTES:
        assert route.split()[0] in _moment_routes(df, start)


@pytest.mark.parametrize("route", ["one device", "mesh"])
def test_a_one_sort_int_segment_far_from_row_0_keeps_its_digits(route):
    """C29: the one-sort groupby (a raw key spanning past 2^22) took an int
    column less its row 0, whose float64 rounds away the low bits of a
    segment 2^53 or more from it: C27's group at 2^62 - 10 000 gave a std
    of 9216, not 58.85.  Each segment is now less its own first row, exact
    in int64, on one device and on the fused mesh exchange (eight groups,
    at C27's two places in turn, so that an owner holds both): exact
    answers."""
    rng = np.random.default_rng(29)
    k = rng.integers(0, 8, 4000)
    k[0] = 0
    x = (np.array([-2 ** 62, 2 ** 62 - 10_000], dtype=np.int64)[k % 2]
         + rng.integers(-100, 100, 4000))
    df = vaex_tpu_torch.from_arrays(k=k * 10_000_000, x=x).to_device("cpu")
    if route == "mesh":
        df.executor = distributed_executor(3, devices=["cpu"] * 3)
    with cache.off():
        out = df.groupby("k", agg={"std": agg.std("x"), "var": agg.var("x")}, sort=True)
    log = df.executor.trace_log
    assert any(e.get("groupby") == "one-sort" or e.get("fused_mesh_groupby") is True
               for e in log)
    for stat in ("std", "var"):
        _close(out[stat].values, _want(stat, k, x, 8), f"one-sort {route} {stat}", atol=0)


def test_c26_takes_a_third_pass_and_no_more():
    """C26's groups at 10 and 1e3 take the frame's shift (1e17), then a
    table of 0 (their means lie within the first pass's rounding of 0),
    then their own means: one second pass and one further pass a
    statistic, and nothing left unsettled."""
    k, x = _c26()
    df = vaex_tpu_torch.from_arrays(k=k, x=x).to_device("cpu")
    second, further, unsettled = (agg.cell_shifted.second_passes, agg.settle.further,
                                  agg.settle.unsettled)
    with cache.off():
        got = df.std("x", **_limits(4))
    _close(got, _want("std", k, x, 4), "c26 std", atol=0)
    assert agg.cell_shifted.second_passes == second + 1
    assert agg.settle.further == further + 1
    assert agg.settle.unsettled == unsettled


def test_the_c25_cases_still_take_one_second_pass():
    """The motivation table's std, covar and corr (binned and per group)
    and the C25 reproducer's std and var (both orders): each query takes a
    second pass and no statistic a further one: one table settles them."""
    k, x, y, valid = _columns()
    df = _frame(k, x, y)
    queries = []
    for stat in ("std", "covar", "corr"):
        queries.append(lambda s=stat: _check_binned(df, s, "float64", _numpy(s, k, x, y, valid),
                                                    s))
        queries.append(lambda s=stat: df.groupby("k", agg={"v": _aggregator(s)}, sort=True))
    for order in ORDERS.values():
        xs = np.array(OVERFLOW["values"])[order]
        ks = np.array(OVERFLOW["k"], dtype=np.int64)[order]
        frame = vaex_tpu_torch.from_arrays(k=ks, x=xs).to_device("cpu")
        for stat in ("std", "var"):
            queries.append(lambda f=frame, s=stat: getattr(f, s)("x", binby="k", shape=4,
                                                                 limits=[-0.5, 3.5]))
            queries.append(lambda f=frame, s=stat: f.groupby(
                "k", agg={"v": getattr(agg, s)("x")}, sort=True))
    further = agg.settle.further
    for query in queries:
        second = agg.cell_shifted.second_passes
        with cache.off():
            query()
        assert agg.cell_shifted.second_passes > second
    assert agg.settle.further == further


@pytest.mark.parametrize("route", ["binby", "all-to-all"])
def test_a_cell_unsettled_at_the_bound_is_nan(route, monkeypatch):
    """With the bound at one pass past the first, C26's groups at 10 and
    1e3 are still flagged after it and their tables still move: NaN, and
    counted, never the cancelled 0.0; the groups that settled keep numpy's
    answer.  At the bound of the code they settle (the reproducer test)."""
    monkeypatch.setattr(agg, "MAX_CELL_PASSES", 1)
    k, x = _c26()
    df = vaex_tpu_torch.from_arrays(k=k, x=x).to_device("cpu")
    before = agg.settle.unsettled
    with cache.off():
        if route == "binby":
            got = np.asarray(df.std("x", **_limits(4)))
        else:
            monkeypatch.setattr(groupby, "SHUFFLE_MIN_G", 1)
            df.executor = distributed_executor(3, devices=["cpu"] * 3)
            got = np.asarray(df.groupby("k", agg={"s": agg.std("x")}, sort=True)["s"].values)
    assert np.isnan(got[1:3]).all()
    want = _want("std", k, x, 4)
    _close(got[[0, 3]], want[[0, 3]], f"{route} settled groups", atol=0)
    assert agg.settle.unsettled == before + 2


def test_a_uint64_clock_equals_its_int64_copy():
    """C28: std and var of the uint64 clock, with and without binby, equal
    those of its int64 copy and the exact answer; a uint64 base rounded to
    float64 before its shift gave 0.0 (the int64 copy subtracts exactly)."""
    k, x = _c28()
    df = vaex_tpu_torch.from_arrays(k=k, x=x, xi=x.astype(np.int64)).to_device("cpu")
    with cache.off():
        for stat in ("std", "var"):
            exact = _exact_var(x) if stat == "var" else np.sqrt(_exact_var(x))
            whole = [getattr(df, stat)(c) for c in ("x", "xi")]
            binned = [getattr(df, stat)(c, **_limits(2)) for c in ("x", "xi")]
            _close(whole, [exact, exact], f"{stat} of the clock")
            _close(binned[0], _want(stat, k, x, 2), f"binned {stat}")
            npt.assert_array_equal(binned[0], binned[1])
    assert df.std("x") > 28


@pytest.mark.parametrize("route", ["binby", "groupby", "mesh", "all-to-all", "cov"])
def test_a_uint64_base_past_2_63_keeps_its_digits(route, monkeypatch):
    """uint64 groups at 1.7e18, straddling 2^63 and at 2^64 - 10^4, each a
    spread of 100, row 0 in the first: the shift and the tables subtract
    in the order image of the bits (the value less 2^63); exact answers."""
    rng = np.random.default_rng(11)
    k = rng.integers(0, 3, 3000)
    k[0] = 0
    base = np.array([1_700_000_000_000_000_000, 2 ** 63 - 50, 2 ** 64 - 10_000], dtype=np.uint64)
    x = base[k] + rng.integers(0, 100, 3000).astype(np.uint64)
    df = vaex_tpu_torch.from_arrays(k=k, x=x).to_device("cpu")
    got = _by_route(df, route if route not in ("binby", "groupby") else "b4 lane", 3,
                    monkeypatch)
    for (query, stat), value in got.items():
        if route in ("binby", "groupby") and query != route:
            continue
        _close(value, _want(stat, k, x, 3), f"{route} {query} {stat}")


def test_the_order_image_subtracts_uint64_bits_exactly():
    """A uint64 base's moment data is the order image of its bits (the
    value less 2^63): ``grid_moments.shifted`` of it less a shift's image
    is the exact difference, one rounding, on either side of 2^63 and
    across it; less ``agg.ORDER_ZERO``, the unsigned float value."""
    vals = [0, 5, 2 ** 63 - 1, 2 ** 63, 2 ** 63 + 7, 2 ** 64 - 1]
    bits = torch.as_tensor(np.array(vals, dtype=np.uint64).view(np.int64))
    image, missing = tasks.moment_data(NA(bits, None, np.uint64))
    assert missing is None and image.dtype == torch.int64
    npt.assert_array_equal(image.numpy(), [v - 2 ** 63 for v in vals])
    for s in vals:
        got = gm.shifted(image, torch.tensor(s - 2 ** 63, dtype=torch.int64))
        npt.assert_array_equal(got.numpy(), [float(v - s) for v in vals])
    npt.assert_array_equal(gm.shifted(image, agg.ORDER_ZERO).numpy(), [float(v) for v in vals])


def test_an_int_table_is_the_rounded_mean_clamped_to_int64():
    """``agg.cell_shift`` of an int base: a + m1 / n rounded, past 2^62
    from a as near it, clamped into int64's range (float64's 2^63 is no
    int64); a uint64 base's table is the order image of its bits."""
    a = torch.tensor(-2 ** 62, dtype=torch.int64)
    n = torch.ones(3, dtype=torch.float64)
    m1 = torch.tensor([2.0 ** 63 - 10_000.0, 2.0 ** 64, -5.0], dtype=torch.float64)
    got = agg.cell_shift(a, m1, n, True)
    assert abs(int(got[0]) - (2 ** 62 - 10_000)) <= 1024
    assert int(got[1]) == 2 ** 63 - 1024  # float64's largest value below 2^63
    assert abs(int(got[2]) - (-2 ** 62 - 5)) <= 512  # float64's spacing there is 1024
    top = torch.tensor(8, dtype=torch.int64)  # the image of 2^63 + 8
    got = agg.cell_shift(top, torch.tensor([-16.0, 2.0 ** 70], dtype=torch.float64),
                         torch.ones(2, dtype=torch.float64), True)
    assert [int(v) + 2 ** 63 for v in got] == [2 ** 63 - 8, 2 ** 64 - 1024]


# -------------------------------------------------- a hypothesis sweep

SWEEP_DTYPES = ["float64", "float32", "int64", "uint64", "datetime64[ns]"]
SWEEP_ROWS, SWEEP_G = 800, 4


@st.composite
def _sweep_frames(draw, dtype):
    """(k, x): SWEEP_G groups whose means are drawn from 0 and the powers
    of ten to 1e17, each with a spread of its own (a float64 group down to
    1e-12 of its mean, a float32 one to 1e-4; an int group a width from 1,
    a constant cell, to 1e6), and row 0, the frame's shift, in a drawn
    group or alone in one more at a drawn power of ten to 1e17."""
    seed = draw(st.integers(0, 2 ** 32 - 1))
    exps = draw(st.lists(st.one_of(st.none(), st.integers(0, 17)), min_size=SWEEP_G,
                         max_size=SWEEP_G))
    means = np.array([0.0 if e is None else 10.0 ** e for e in exps])
    alone = draw(st.booleans())
    at = draw(st.integers(0, 17) if alone else st.integers(0, SWEEP_G - 1))
    rng = np.random.default_rng(seed)
    k = rng.integers(0, SWEEP_G, SWEEP_ROWS)
    if dtype in ("float64", "float32"):
        low = 12 if dtype == "float64" else 4
        spread = [max(m, 1.0) * 10.0 ** -draw(st.integers(0, low)) for m in means]
        x = means[k] + np.array(spread)[k] * rng.normal(0, 1, SWEEP_ROWS)
    else:
        width = [10 ** draw(st.integers(0, 6)) for _ in means]
        x = (means.astype(np.int64)[k]
             + rng.integers(0, np.array(width)[k]).astype(np.int64))
    if alone:
        k[0], x[0] = SWEEP_G, 10 ** at
    else:
        k[0] = at
    if dtype == "float32":
        x = x.astype(np.float32)
    elif dtype == "uint64":
        x = x.astype(np.uint64)
    elif dtype == "datetime64[ns]":
        x = x.view("datetime64[ns]")
    return k, x


@pytest.mark.parametrize("route", ["one device", "all-to-all"])
@pytest.mark.parametrize("dtype", SWEEP_DTYPES)
def test_the_sweep_of_far_groups(dtype, route, monkeypatch):
    """Hypothesis-drawn frames (:func:`_sweep_frames`): std and var per
    group (and binned on one device) against numpy's two-pass answer on
    float data, exact arithmetic on int64, uint64 and datetime64[ns],
    within 1e-6 relative and no absolute slack (a spread may be 1e-12)."""
    if route == "all-to-all":
        monkeypatch.setattr(groupby, "SHUFFLE_MIN_G", 1)

    @hypothesis.settings(max_examples=60, deadline=None, derandomize=True, database=None,
                         suppress_health_check=list(hypothesis.HealthCheck))
    @hypothesis.given(frame=_sweep_frames(dtype))
    def check(frame):
        k, x = frame
        groups = int(k.max()) + 1
        df = vaex_tpu_torch.from_arrays(k=k, x=x).to_device("cpu")
        if route == "all-to-all":
            df.executor = distributed_executor(3, devices=["cpu"] * 3)
        with cache.off():
            out = df.groupby("k", agg={"std": agg.std("x"), "var": agg.var("x")}, sort=True)
            binned = {} if route == "all-to-all" else {
                stat: getattr(df, stat)("x", **_limits(groups)) for stat in ("std", "var")}
        for stat in ("std", "var"):
            want = _want(stat, k, x, groups)
            _close(out[stat].values, want, f"{dtype} {route} groupby {stat}", atol=0)
            if stat in binned:
                _close(binned[stat], want, f"{dtype} binned {stat}", atol=0)
    check()


# ------------------------------------ known problems of the reference

def test_the_reference_gives_a_nanosecond_clock_no_variance():
    """vaex_tpu's std and var of C28's clock are 0.0 as uint64 and as int64
    (its raw moments cancel; exact: 28.92 and 836.6): the port is held to
    exact arithmetic instead (test_a_uint64_clock_equals_its_int64_copy)."""
    _, x = _c28()
    ref = vaex_tpu.from_arrays(x=x, xi=x.astype(np.int64))
    for c in ("x", "xi"):
        assert float(ref.std(c)) == 0.0 and float(ref.var(c)) == 0.0
    assert abs(np.sqrt(_exact_var(x)) - 28.924) < 1e-3
