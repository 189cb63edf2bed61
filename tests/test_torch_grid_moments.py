"""The port's moment kernel module (``vaex_tpu_torch.ops.grid_moments``)
against the TPU kernels it replaces, against numpy, and the plan that picks
among the moment kernels.

* B4, ``grid_moments``, against ``vaex_tpu.ops.pallas_gridagg._agg_kernel``
  (``fused_additive_pallas``), G <= 2048;
* B5, ``grid_moments_window``, against ``pallas_gridagg._agg2_kernel``
  (``fused_additive_two_level``), G > 2048.

The Pallas kernels run here in interpret mode, through a test-local
monkeypatch of the ``pl`` of ``vaex_tpu.ops.pallas_gridagg``, on the term
columns formed by numpy as vaex_tpu forms them (x, x^2, x*y, y, y^2, and a
count column of ones where the row is valid).  Counts must match exactly;
floats to rtol 1e-6: the TPU kernels add the f32 hi and lo halves of each
block in f32 (a relative error near 1.2e-7 here).  The plain versions hold
against numpy in float64 to 1e-12.
"""

import functools
import os
import shutil
import types

import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch
from jax.experimental import pallas as pl

from vaex_tpu.ops import pallas_gridagg
from vaex_tpu_torch import agg
from vaex_tpu_torch.ops import grid_moments as gm
from vaex_tpu_torch.ops import grid_additive as ga
from vaex_tpu_torch.ops import grid_partition as gp
from vaex_tpu_torch.ops import grid_plan, kernel_build
from vaex_tpu_torch.ops import grid_window as gw
from vaex_tpu_torch.ops.nullable import NA
from vaex_tpu_torch.tasks import moment_input


@pytest.fixture
def interpret_pallas(monkeypatch):
    shim = types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        program_id=pl.program_id, when=pl.when, BlockSpec=pl.BlockSpec)
    monkeypatch.setattr(pallas_gridagg, "pl", shim)


def _inputs(seed, n, G, nan_every=13):
    """idx with ~1/8 of the rows at idx >= G (they drop), x uniform in
    [0, 100) with some NaN, y an integer in 1..5."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, G + max(1, G // 8) + 1, n).astype(np.int32)
    x = rng.uniform(0, 100, n)
    x[::nan_every] = np.nan
    y = rng.integers(1, 6, n).astype(np.int64)
    return idx, x, y


# the term sets of var(x) and corr(x, y), and the columns vaex_tpu forms for
# them (valid: the rows where every base the statistic reads is not NaN)
TERMS = {"var": agg.VAR_TERMS, "corr": agg.CORR_TERMS}


def _columns(kind, x, y):
    """(count column, float columns) in the order of the port's terms."""
    if kind == "var":
        valid = ~np.isnan(x)
        xv = np.where(valid, x, 0.0)
        return valid, [xv, xv * xv]
    valid = ~np.isnan(x)  # y is an integer column
    xv, yv = np.where(valid, x, 0.0), np.where(valid, y, 0)
    return valid, [xv * yv, xv, yv, xv * xv, yv * yv]


def _bases(kind, x, y):
    return [torch.from_numpy(x)] if kind == "var" else [torch.from_numpy(x),
                                                        torch.from_numpy(y)]


@pytest.mark.parametrize("kind", ["var", "corr"])
@pytest.mark.parametrize("kernel,G", [("b4", 1), ("b4", 103), ("b4", 2048),
                                      ("b5", 2049), ("b5", 10_609)])
def test_reference_matches_pallas_kernel(interpret_pallas, kind, kernel, G):
    n = 20_000
    idx, x, y = _inputs(G + len(kind), n, G)
    valid, floats = _columns(kind, x, y)
    cols = jnp.asarray(np.stack([*floats, valid.astype(np.float64)], axis=1))
    fused = (pallas_gridagg.fused_additive_pallas if kernel == "b4"
             else pallas_gridagg.fused_additive_two_level)
    want = np.asarray(fused(jnp.asarray(idx), cols, G))  # [G, A]
    counts, sums = grid_plan.MOMENT_PLAIN[kernel](torch.from_numpy(idx), _bases(kind, x, y),
                                                  TERMS[kind], G)
    assert np.array_equal(want[:, -1], np.round(want[:, -1]))  # an exact f32 count
    npt.assert_array_equal(counts[0].numpy(), want[:, -1].astype(np.int64))
    npt.assert_allclose(sums.numpy(), want[:, :-1].T, rtol=1e-6, atol=1e-9)


def _numpy_sums(idx, count_cols, float_cols, G):
    keep = (idx >= 0) & (idx < G)
    counts = [np.bincount(idx[keep], c[keep], minlength=G).astype(np.int64)
              for c in count_cols]
    sums = [np.bincount(idx[keep], f[keep], minlength=G) for f in float_cols]
    return counts, sums


@pytest.mark.parametrize("plain", ["b4", "b5"])
@pytest.mark.parametrize("G", [1, 300, 10_609])
def test_reference_matches_numpy(plain, G):
    """Rows outside [0, G) drop; NaN in any base a term names drops the row
    from that term only; f32 and int64 bases are read as float64; a masked
    base arrives as NaN."""
    rng = np.random.default_rng(G)
    n = 6000
    idx = rng.integers(-3, G + 5, n).astype(np.int32)
    a = rng.normal(0, 1, n) + np.where(rng.random(n) < 0.5, 1e3, -1e3)
    a[::11] = np.nan
    b = rng.normal(0, 10, n).astype(np.float32)
    b[::7] = np.nan
    c = rng.integers(-(2 ** 20), 2 ** 20, n)
    mask = rng.random(n) < 0.1
    d = np.ma.MaskedArray(rng.normal(5, 1, n), mask)
    bases = [torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c),
             moment_input(NA(torch.from_numpy(d.data), torch.from_numpy(mask)))[0]]
    assert bases[3].dtype == torch.float64 and torch.isnan(bases[3][torch.from_numpy(mask)]).all()
    terms = [(0, -1, -1, -1), (0, 1, -1, -1), (-1, -1, 0, 1), (2, 2, 3, -1), (-1, -1, -1, -1),
             (3, -1, 2, 0), (1, 3, -1, -1), (-1, -1, 3, -1)]
    counts, sums = grid_plan.MOMENT_PLAIN[plain](torch.from_numpy(idx), bases, terms, G)
    f = [a, b.astype(np.float64), c.astype(np.float64), np.where(mask, np.nan, d.data)]
    ok = [~np.isnan(v) for v in f]
    want_counts, want_sums = _numpy_sums(
        idx, [ok[0] & ok[1], np.ones(n, bool), ok[3]],
        [np.where(ok[0], f[0], 0), np.where(ok[0] & ok[1], f[0] * f[1], 0),
         np.where(ok[3], f[2] * f[2], 0), np.where(ok[0] & ok[3], f[3], 0),
         np.where(ok[1] & ok[3], f[1] * f[3], 0)], G)
    npt.assert_array_equal(counts.numpy(), np.stack(want_counts))
    npt.assert_allclose(sums.numpy(), np.stack(want_sums), rtol=1e-12, atol=1e-6)


def test_window_reference_cuts_the_kernels_windows():
    """B5's plain version adds window by window.  A part is one CTA's
    227 KiB: a float term's plane of 29 056 bins fits, so G = 10 609 is one
    window; corr's bins take 44 bytes (a 32-bit count and five doubles), so
    its window is three groups of two terms, var's (20 bytes) one part; past
    29 056 bins the grid takes two windows, the last one narrower."""
    assert gm.window_width(6) == 29_056 and gm.window_width(1) == 58_112  # counts alone
    assert gm.part_plan(10_609, 6) == (10_610, 1, [0, 2, 4, 6])  # q9
    assert gm.part_plan(10_609, 3) == (10_610, 1, [0, 3])  # q6-sd: one walk
    assert gm.part_plan(60_000, 6)[:2] == (20_000, 3)
    idx, x, y = _inputs(5, 30_000, 60_000)
    bases = _bases("corr", x, y)
    args = (torch.from_numpy(idx), bases, agg.CORR_TERMS, 60_000)
    for got, want in zip(gm.grid_moments_window_reference(*args),
                         gm.grid_moments_reference(*args)):
        npt.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=1e-9)


# (kind, G, parts) where B5's parts change: a group of terms one bin past
# what fits splits, one window one bin past a float plane of 227 KiB
PART_EDGES = [("var", 11_622, 1), ("var", 11_623, 2), ("var", 29_056, 3), ("var", 29_057, 4),
              ("corr", 5_282, 1), ("corr", 5_283, 2), ("corr", 8_302, 2), ("corr", 9_686, 3),
              ("corr", 19_370, 5), ("corr", 19_371, 6), ("corr", 29_056, 6),
              ("corr", 29_057, 10)]


@pytest.mark.parametrize("kind,G,parts", PART_EDGES)
def test_window_edges_match_pallas_kernel(interpret_pallas, kind, G, parts):
    """The plain B5 against ``_agg2_kernel`` in interpret mode where its
    parts change (one window or group exactly full, one bin past it), and
    the part plan there: every group's planes fit 227 KiB, the windows are
    the fewest of equal even width that hold a float plane."""
    C = len(TERMS[kind])
    W, n_win, bounds = gm.part_plan(G, C)
    assert gm.n_parts(G, C) == parts == n_win * (len(bounds) - 1)
    assert W % 2 == 0 and (n_win - 1) * W < G <= n_win * W
    assert n_win == -(-G // gm.window_width(C))
    assert bounds[0] == 0 and bounds[-1] == C and all(a < b for a, b in zip(bounds, bounds[1:]))
    for lo, hi in zip(bounds, bounds[1:]):
        assert W * gm.bin_bytes(hi - lo, int(lo == 0)) <= ga.CLUSTER_SMEM
    n = 20_000
    idx, x, y = _inputs(G % 1000 + len(kind), n, G)
    idx[:4] = [0, G - 1, min(W, G - 1), W - 1]
    valid, floats = _columns(kind, x, y)
    cols = jnp.asarray(np.stack([*floats, valid.astype(np.float64)], axis=1))
    want = np.asarray(pallas_gridagg.fused_additive_two_level(jnp.asarray(idx), cols, G))
    counts, sums = gm.grid_moments_window_reference(torch.from_numpy(idx), _bases(kind, x, y),
                                                    TERMS[kind], G)
    npt.assert_array_equal(counts[0].numpy(), want[:, -1].astype(np.int64))
    npt.assert_allclose(sums.numpy(), want[:, :-1].T, rtol=1e-6, atol=1e-9)


def test_b5_orders_the_float_terms_by_base():
    """B5 takes the float terms of two bases first, then those of one base,
    base by base: corr's parts at G = 10 609 are [count, x*y], [x, x*x] and
    [y, y*y], so a part of one int64 base loads no other column."""
    order = gm.float_order(agg.CORR_TERMS)
    floats = [t[:2] for t in agg.CORR_TERMS if t[0] >= 0]
    assert [floats[k] for k in order] == [(0, 1), (0, -1), (0, 0), (1, -1), (1, 1)]
    assert gm.part_plan(10_609, 6)[2] == [0, 2, 4, 6]
    assert gm.float_order(agg.VAR_TERMS) == [0, 1]
    assert gm.float_order(agg.COVAR_TERMS) == [0, 1, 2]


@pytest.mark.parametrize("C", [3, 6])
def test_moment_plan_boundaries(C):
    n = 10 ** 8
    g4 = grid_plan.b4_max_g(C)
    assert g4 == {3: 128, 6: 64}[C]  # the warp route while G * C <= 384
    assert grid_plan.moment_strategy(n, 1, C) == "b4"  # df.std
    assert grid_plan.moment_strategy(n, g4, C) == "b4"
    assert grid_plan.moment_strategy(n, g4 + 1, C) == "b5"
    assert grid_plan.moment_strategy(n, 10_609, C) == "b5"  # q6-sd, q9
    last = max(G for G in range(g4 + 1, 400_000, 97) if gm.n_parts(G, C) <= grid_plan.B5_MAX_PARTS)
    assert grid_plan.moment_strategy(n, last, C) == "b5"
    past = next(G for G in range(last, 400_000) if gm.n_parts(G, C) > grid_plan.B5_MAX_PARTS)
    assert grid_plan.moment_strategy(n, past, C) == ("b3-l2" if gp.resident_fits(past, C)
                                                     else "b3")
    S = gp.shape(n, 10 ** 6, C).S
    assert grid_plan.moment_strategy(n, gp.P_MAX * S, C) == "b3"
    # past B3 in one call: calls of fewer terms where they fit, else sort
    width = max([c for c in range(1, C) if gp.shape(n, gp.P_MAX * S + 1, c)] or [0])
    assert grid_plan.moment_strategy(n, gp.P_MAX * S + 1, C) == (
        f"b3×{-(-C // width)}" if width else "sort")
    assert grid_plan.moment_strategy(2 ** 31, gp.P_MAX * S, C) == "sort"
    assert gm.fits(g4, C)
    assert grid_plan.moment_strategy(n, 1, gm.MAX_TERMS) == "b4"  # never B5 at G = 1


def test_b4_lane_route_boundaries():
    """B4's lane route while a CTA of 227 KiB holds two warps of var's lane
    grids (its compiled set: 20 bytes a bin and lane, so G <= 181), three of
    corr's (44 bytes: G <= 55) or eight of any other batch's (corr's 44
    bytes through the tables: G <= 20); the warp route past that.  The plan
    takes B4 wherever its lane route does, on its warp route to b4_max_g,
    then B5."""
    assert gm.lane_warp_bytes(103, 1, 2) == 32 * 103 * 20
    assert gm.compiled(1, agg.VAR_TERMS) == 1 and gm.compiled(2, agg.CORR_TERMS) == 2
    assert not gm.compiled(2, agg.COVAR_TERMS)
    assert not gm.compiled(1, [(0, -1, -1, -1), (-1, -1, 0, -1)])  # mean's terms
    assert not gm.compiled(1, [(0, 0, -1, -1), (0, -1, -1, -1), (-1, -1, 0, -1)])  # x*x, x
    assert not gm.compiled(1, [(0, -1, -1, -1), (0, 0, -1, -1), (-1, -1, -1, -1)])  # any row
    assert gm.route(1, 1, 2) == gm.route(181, 1, 2) == gm.LANE
    assert gm.route(182, 1, 2) == gm.WARP
    assert gm.route(55, 1, 5, 2) == gm.LANE and gm.route(56, 1, 5, 2) == gm.WARP
    assert gm.route(20, 1, 5, 0) == gm.LANE and gm.route(21, 1, 5, 0) == gm.WARP
    assert gm.route(103, 1, 2, 0) == gm.WARP  # var's grid through the tables
    n = 10 ** 8
    assert grid_plan.moment_strategy(n, 181, 3, 1, 1) == "b4"  # var, compiled
    assert grid_plan.moment_strategy(n, 182, 3, 1, 1) == "b5"
    assert grid_plan.moment_strategy(n, 129, 3) == "b5"  # through the tables
    assert grid_plan.moment_strategy(n, 64, 6) == "b4"  # covar-like batch: the warp route
    assert grid_plan.moment_strategy(n, 55, 6, 1, 2) == "b4"  # corr, compiled: lane
    assert gm.route(64, 1, 5, 2) == gm.WARP  # then B4's warp route to G * C = 384
    assert grid_plan.moment_strategy(n, 64, 6, 1, 2) == "b4"
    assert grid_plan.moment_strategy(n, 65, 6, 1, 2) == "b5"
    for G, want_warps in ((1, gm.MAX_WARPS), (64, 5), (103, 3), (121, 3), (181, 2), (363, 1)):
        n_ctas, warps = gm.lane_plan(10 ** 8, G, 1, 2, 1, 132)
        assert warps == want_warps and 1 <= n_ctas <= 132 * 8
        assert warps * gm.lane_warp_bytes(G, 1, 2) <= gm.CLUSTER_SMEM
    # few rows: a warp still walks its share of steps, at least one CTA
    assert gm.lane_plan(1000, 103, 1, 2, 1, 132)[0] == 1
    assert [gm.lane_rows(nb) for nb in range(gm.MAX_BASES + 1)] == [32, 32, 16, 8, 8]


def test_b4_fits_its_shared_memory():
    """One warp's [C, G] grid and its staged float terms; at C = 6 that is
    G <= 196 608 / 48 - 128 = 3968."""
    assert gm.fits(3968, 6) and not gm.fits(3969, 6)
    assert not gm.fits(10, gm.MAX_TERMS + 1) and not gm.fits(10, 0)


@pytest.mark.parametrize("G", [50, 10_609, 200_003])
def test_moment_sums_through_the_plan(G):
    """grid_plan.moment_sums on the CPU: B4, B5 or B3 (its resident route
    while the grid stays in L2) over the formed term columns, each equal to
    the plain version."""
    idx, x, y = _inputs(G, 20_000, G)
    bases = _bases("corr", x, y)
    name, counts, sums = grid_plan.moment_sums(torch.from_numpy(idx), bases, agg.CORR_TERMS, G)
    assert name == grid_plan.moment_strategy(20_000, G, 6)
    want = gm.grid_moments_reference(torch.from_numpy(idx), bases, agg.CORR_TERMS, G)
    npt.assert_array_equal(counts.numpy(), want[0].numpy())
    npt.assert_allclose(sums.numpy(), want[1].numpy(), rtol=1e-12, atol=1e-9)
    if G == 200_003:
        assert name == "b3-l2"


@pytest.mark.parametrize("P_MAX,route", [(8, "b3×3"), (4, "sort")])
def test_moment_sums_raise_past_b3_naming_a6(monkeypatch, P_MAX, route):
    """Named for the raise this replaced (ROADMAP A4): var's three terms at
    G = 120 000 (past B5's parts, below ``b3-l2``) with B3's partition cut to
    P_MAX buckets: in three calls of one term where one fits (16 384 bins a
    bucket), through "sort" where none does; equal to the plain moment
    version, counts exact."""
    monkeypatch.setattr(gp, "P_MAX", P_MAX)
    G = 120_000
    idx, x, y = _inputs(7, 20_000, G)
    bases = _bases("var", x, y)
    name, counts, sums = grid_plan.moment_sums(torch.from_numpy(idx), bases, agg.VAR_TERMS, G)
    assert name == route == grid_plan.moment_strategy(20_000, G, 3)
    want = gm.grid_moments_reference(torch.from_numpy(idx), bases, agg.VAR_TERMS, G)
    npt.assert_array_equal(counts.numpy(), want[0].numpy())
    npt.assert_allclose(sums.numpy(), want[1].numpy(), rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("name", ["b4", "b5"])
def test_wrappers_take_the_plain_version_for_cpu_tensors(name):
    kernel = grid_plan.MOMENT_KERNELS[name]
    idx = torch.tensor([0, 2, 2, 5, -1], dtype=torch.int32)
    x = torch.tensor([1.0, 2.0, float("nan"), 4.0, 5.0])
    before = kernel.launches
    counts, sums = kernel(idx, [x], agg.VAR_TERMS, 3)
    assert kernel.launches == before  # no kernel launched
    npt.assert_array_equal(counts.numpy(), [[1, 0, 1]])  # the NaN row and idx 5, -1 drop
    npt.assert_array_equal(sums.numpy(), [[1, 0, 2], [1, 0, 4]])


@pytest.mark.parametrize("name", ["b4", "b5"])
@pytest.mark.parametrize("bad", [
    dict(idx=torch.zeros(4, dtype=torch.int64)),
    dict(bases=[torch.zeros(4, dtype=torch.int32)]),
    dict(bases=[torch.zeros(5)]),
    dict(bases=[torch.zeros(4)] * (gm.MAX_BASES + 1)),
    dict(terms=[]),
    dict(terms=[(0, -1, -1, -1)] * (gm.MAX_TERMS + 1)),
    dict(terms=[(1, -1, -1, -1)]),  # no base 1
    dict(terms=[(-1, 0, -1, -1)]),  # a count with a factor
    dict(G=0),
    dict(idx=None),  # no index at G = 3
])
def test_wrapper_rejects_what_the_kernel_does_not_take(name, bad):
    args = dict(idx=torch.zeros(4, dtype=torch.int32), bases=[torch.zeros(4)],
                terms=agg.VAR_TERMS, G=3)
    args.update(bad)
    with pytest.raises((TypeError, ValueError)):
        grid_plan.MOMENT_KERNELS[name](**args)


@pytest.mark.parametrize("kind", ["var", "corr"])
def test_b4_without_an_index_puts_every_row_in_one_bin(kind):
    """idx None at G = 1 (a statistic without binby or selection): every row
    in bin 0, as an all-zero index gives; B5 and a call without a base refuse
    it."""
    idx, x, y = _inputs(11, 5000, 1)
    bases = _bases(kind, x, y)
    terms = agg.VAR_TERMS if kind == "var" else agg.CORR_TERMS
    got = gm.grid_moments(None, bases, terms, 1)
    want = gm.grid_moments_reference(torch.zeros(5000, dtype=torch.int32), bases, terms, 1)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    valid, cols = _columns(kind, x, y)
    npt.assert_array_equal(got[0].numpy(), [[valid.sum()]])
    npt.assert_allclose(got[1].numpy()[:, 0], [c.sum() for c in cols], rtol=1e-12)
    assert grid_plan.moment_sums(None, bases, terms, 1)[0] == "b4"
    with pytest.raises(TypeError, match="None"):
        gm.grid_moments_window(None, bases, terms, 1)
    with pytest.raises(TypeError, match="None"):
        gm.grid_moments(None, [], [(-1, -1, -1, -1)], 1)


@pytest.mark.parametrize("header", ["moments_common.cuh", "grid_common.cuh"])
def test_build_key_covers_every_header(tmp_path, monkeypatch, header):
    """An edited header must not load a library built from the old one."""
    csrc = tmp_path / "csrc"
    shutil.copytree(kernel_build.CSRC, csrc)
    monkeypatch.setattr(kernel_build, "CSRC", str(csrc))
    before = {name: kernel_build._target(name) for name in ("grid_moments", "grid_additive")}
    assert os.path.join(str(csrc), "moments_common.cuh") in kernel_build.headers()
    with open(csrc / header, "a") as f:
        f.write("\n// edited\n")
    for name, path in before.items():
        assert kernel_build._target(name) != path
