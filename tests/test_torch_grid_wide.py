"""The port's wide-grid kernel modules against the TPU kernels they replace
and against numpy, and the strategy plan that picks among the kernels.

* B2, ``vaex_tpu_torch.ops.grid_window``, against
  ``vaex_tpu.ops.pallas_gridagg._channels2_kernel``
  (``fused_additive_two_level_channels``);
* B3, ``vaex_tpu_torch.ops.grid_partition``, both its partition route
  (``b3``) and its resident route (``b3-l2``), against
  ``vaex_tpu.ops.pallas_partition._phase1_kernel`` + ``_phase2_kernel``
  (``partitioned_additive_channels``).

The Pallas kernels run here in interpret mode, through a test-local
monkeypatch of the ``pl`` of both modules.  Counts and int64 sums must match
exactly; float sums to rtol 1e-9 and atol 1e-9 (both sides add f64 sums of
the same values in different orders; the TPU kernels quantise each block
to 2^-40 of its largest value).
"""

import functools
import types

import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch
from jax.experimental import pallas as pl

from vaex_tpu.ops import pallas_gridagg, pallas_partition
from vaex_tpu_torch.ops import grid_additive as ga
from vaex_tpu_torch.ops import grid_moments as gm
from vaex_tpu_torch.ops import grid_partition as gp
from vaex_tpu_torch.ops import grid_plan
from vaex_tpu_torch.ops import grid_window as gw


@pytest.fixture
def interpret_pallas(monkeypatch):
    shim = types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        program_id=pl.program_id, when=pl.when, BlockSpec=pl.BlockSpec)
    monkeypatch.setattr(pallas_gridagg, "pl", shim)
    monkeypatch.setattr(pallas_partition, "pl", shim)


def _inputs(seed, n, G):
    rng = np.random.default_rng(seed)
    # ~1/8 of the rows carry idx >= G and must drop
    idx = rng.integers(0, G + G // 8 + 1, n).astype(np.int32)
    ints = rng.integers(-(2 ** 62), 2 ** 62, n, dtype=np.int64)  # sums wrap
    floats = rng.normal(0, 100, n)
    return idx, ints, floats


def _limbs(ints):
    """Signed 8-bit limbs, as vaex_tpu's OpSum.kernel_channels makes them."""
    r = ints.copy()
    limbs = []
    for _ in range(8):
        s = ((r + 128) & 255) - 128
        limbs.append(jnp.asarray(s.astype(np.float32)))
        r = (r - s) >> 8
    return limbs


def _from_limbs(static):
    """As OpSum.apply_kernel: the int64 sum mod 2^64 from the limb sums."""
    total = static[0].astype(np.int64)
    for k in range(1, 8):
        total = total + (static[k].astype(np.int64) << np.int64(8 * k))
    return total


def _pallas_sums(kernel, idx, ints, floats, G):
    """(count, int64 sum, f64 sum) through vaex_tpu's TPU kernel ``kernel``."""
    hi = floats.astype(np.float32)
    lo = (floats - hi.astype(np.float64)).astype(np.float32)
    pair = (jnp.asarray(hi), jnp.asarray(lo))
    if kernel == "b2":
        static, float_sums = pallas_gridagg.fused_additive_two_level_channels(
            jnp.asarray(idx), [None] + _limbs(ints), [pair], G)
    else:
        # the partition kernel has no implicit count: a ones channel instead
        ones = jnp.ones(len(idx), jnp.float32)
        static, float_sums, _, overflow = pallas_partition.partitioned_additive_channels(
            jnp.asarray(idx), [ones] + _limbs(ints), [pair], G)
        assert int(overflow) == 0
    static = np.asarray(static)
    return static[0].astype(np.int64), _from_limbs(static[1:]), np.asarray(float_sums)[0]


PLAIN = {"b2": gw.grid_window_reference, "b3": gp.grid_partition_reference,
         "b3-l2": gp.grid_resident_reference}


@pytest.mark.parametrize("kernel,G", [("b2", 8182), ("b2", 10609),
                                      ("b3", 40003), ("b3", 100003),
                                      ("b3-l2", 40003), ("b3-l2", 140003)])
@pytest.mark.parametrize("n", [1, 20_000])
def test_reference_matches_pallas_kernel(interpret_pallas, kernel, G, n):
    idx, ints, floats = _inputs(G + n, n, G)
    want_count, want_int, want_float = _pallas_sums(kernel, idx, ints, floats, G)
    int_sums, float_sums = PLAIN[kernel](
        torch.from_numpy(idx), [torch.from_numpy(ints)], [torch.from_numpy(floats)], G,
        count=True)
    npt.assert_array_equal(int_sums[0].numpy(), want_count)
    npt.assert_array_equal(int_sums[1].numpy(), want_int)
    npt.assert_allclose(float_sums[0].numpy(), want_float, rtol=1e-9, atol=1e-9)


def _numpy_sums(idx, ints, f64, f32, G):
    keep = (idx >= 0) & (idx < G)
    count = np.bincount(idx[keep], minlength=G)
    total = np.zeros(G, np.int64)
    np.add.at(total, idx[keep], ints[keep])
    s64 = np.bincount(idx[keep], np.nan_to_num(f64[keep]), minlength=G)
    s32 = np.bincount(idx[keep], f32[keep].astype(np.float64), minlength=G)
    return count, total, s64, s32


CASES = {
    # G % S != 0 and drops on both sides of [0, G)
    "uniform": dict(G=100_003, n=30_000),
    # pre-sorted keys: every row of a run lands in one bucket (the TPU
    # kernel's run capacity overflowed on these and the pass was rerun)
    "sorted": dict(G=100_003, n=30_000, sort=True),
    # keys in a few narrow ranges: most buckets and windows stay empty
    "empty_buckets": dict(G=1_000_003, n=20_000, clusters=3),
    # one window / one bucket narrower than G
    "narrow": dict(G=300, n=5_000),
    # every row on one key: one bucket holds all the rows
    "single_key": dict(G=1_000_003, n=20_000, single=True),
    # a Zipf(1.1) draw: a few keys hold most rows, in no order
    "skewed": dict(G=1_000_003, n=30_000, zipf=1.1),
}


@pytest.mark.parametrize("kernel", ["b2", "b3", "b3-l2"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_matches_numpy(kernel, case):
    """Drops outside [0, G), NaN adds nothing, f32 widens, int64 wraps."""
    spec = CASES[case]
    G, n = spec["G"], spec["n"]
    rng = np.random.default_rng(len(case))
    idx = rng.integers(-3, G + 5, n)
    if "clusters" in spec:
        starts = rng.integers(0, G - 100, spec["clusters"])
        idx = starts[rng.integers(0, len(starts), n)] + rng.integers(0, 100, n)
    if spec.get("single"):
        idx = np.full(n, G // 3)
        idx[::7] = -1
    if "zipf" in spec:
        idx = rng.permutation(G)[np.minimum(rng.zipf(spec["zipf"], n), G) - 1]
    if spec.get("sort"):
        idx = np.sort(idx)
    idx = idx.astype(np.int32)
    ints = rng.integers(-(2 ** 63), 2 ** 63 - 1, n, dtype=np.int64)
    f64 = rng.normal(0, 1, n) + np.where(rng.random(n) < 0.5, 1e6, -1e6)
    f64[::11] = np.nan
    f32 = rng.normal(0, 1, n).astype(np.float32)
    int_sums, float_sums = PLAIN[kernel](
        torch.from_numpy(idx), [torch.from_numpy(ints)],
        [torch.from_numpy(f64), torch.from_numpy(f32)], G, count=True)
    count, total, s64, s32 = _numpy_sums(idx, ints, f64, f32, G)
    npt.assert_array_equal(int_sums[0].numpy(), count)
    npt.assert_array_equal(int_sums[1].numpy(), total)
    npt.assert_allclose(float_sums[0].numpy(), s64, rtol=1e-12, atol=1e-6)
    npt.assert_allclose(float_sums[1].numpy(), s32, rtol=1e-12, atol=1e-12)


def test_bucket_offsets_are_bucket_major():
    counts = torch.tensor([[2, 0, 1], [0, 0, 0], [3, 1, 0]], dtype=torch.int32)
    offsets, bucket_start = gp.bucket_offsets(counts)
    npt.assert_array_equal(offsets.numpy(), [[0, 2, 2], [3, 3, 3], [3, 6, 7]])
    npt.assert_array_equal(bucket_start.numpy(), [0, 3, 3, 7])


@pytest.mark.parametrize("G", [1, 100, 1024, 1025, 100_003, 1_000_003, 10_000_000])
@pytest.mark.parametrize("C", [1, 2, 3, 4, 8, 33])
def test_partition_shape_fits_its_kernels(G, C):
    n = 3 * 10 ** 7
    sh = gp.shape(n, G, C)
    if sh is None:
        assert G > gp.P_MAX  # more buckets than phase 1 keeps offsets for
        return
    assert sh.S == 1 << sh.shift and sh.shift <= gp.MAX_SHIFT
    assert sh.P * sh.S >= G > (sh.P - 1) * sh.S  # the last bucket holds the tail
    assert 1 <= sh.P <= gp.P_MAX
    assert C * sh.S * 8 <= gp.SUB_GRID_BYTES <= ga.SMEM_BUDGET  # the CTA-wide sub-grid
    assert sh.S == 1 << gp.MAX_SHIFT or sh.S >= G or C * 2 * sh.S * 8 > gp.SUB_GRID_BYTES
    assert sh.threads == gp.SCATTER_THREADS and sh.threads % 32 == 0
    assert gp.scatter_bytes(sh.threads, sh.P) <= ga.SMEM_BUDGET  # phase-1 counters and stage
    assert gp.scatter_bytes(gp.SCATTER_THREADS, gp.P_MAX) <= ga.SMEM_BUDGET
    tile = sh.threads * gp.SCATTER_ROWS
    assert tile <= 1 << 16 and sh.P <= 1 << 15  # a bucket and a rank share one 32-bit word
    assert sh.seg_rows % tile == 0 and sh.n_seg * sh.seg_rows >= n
    assert (sh.n_seg - 1) * sh.seg_rows < n  # no empty segment
    per_sm = min(ga.SM_THREADS // sh.threads,
                 ga.SM_SMEM // gp.scatter_bytes(sh.threads, sh.P))
    assert sh.n_seg <= 132 * max(1, per_sm)  # one wave of the card's CTAs
    ctas = gp.sums_ctas(n, C, sh, sm_count=132)
    assert 1 <= ctas <= gp.SUMS_WAVES * 132 * ga.SM_THREADS // gp.SUMS_THREADS
    assert gp.sums_ctas(0, C, sh, sm_count=132) == 1
    assert gp.shape(n, G, C, sm_count=66).n_seg <= sh.n_seg  # follows the card


@pytest.mark.parametrize("G,C,fits", [
    (gp.RESIDENT_MIN_G - 1, 1, False), (gp.RESIDENT_MIN_G, 1, True),
    (1_000_003, 2, True), (1_000_003, 3, True), (1_000_003, 4, False),
    (gp.RESIDENT_BYTES // 8, 1, True), (gp.RESIDENT_BYTES // 8 + 1, 1, False),
    (4_000_037, 1, False),
])
def test_resident_route_takes_the_grids_that_stay_in_l2(G, C, fits):
    assert gp.resident_fits(G, C) is fits
    assert gp.RESIDENT_BYTES < 50 << 20  # the card's L2


def test_resident_reference_returns_views_of_one_buffer():
    """The route adds into one zeroed [C, G] buffer of 8-byte words; the
    plain version mirrors the layout."""
    idx = torch.tensor([0, 2, 2, 5, -1], dtype=torch.int32)
    ints = torch.tensor([1, 2, 3, 4, 5], dtype=torch.int64)
    floats = torch.tensor([0.5, float("nan"), 1.5, 2.0, 3.0], dtype=torch.float32)
    int_sums, float_sums = gp.grid_resident_reference(idx, [ints], [floats], 3, True)
    assert int_sums.dtype == torch.int64 and float_sums.dtype == torch.float64
    npt.assert_array_equal(int_sums.numpy(), [[1, 0, 2], [1, 0, 5]])
    npt.assert_array_equal(float_sums.numpy(), [[0.5, 0.0, 1.5]])
    assert float_sums.untyped_storage().data_ptr() == int_sums.untyped_storage().data_ptr()


@pytest.mark.parametrize("C", [1, 2, 3, 4, 8])
def test_window_plan_fits_its_kernel(C):
    """B2's cluster: the fewest windows of at most ``cluster_width`` bins (a
    32-bit count and 8-byte sums a bin; even), of equal even width, at most
    ``MAX_CLUSTER`` of them; as many clusters as the occupancy query allows,
    fewer for few rows."""
    for count in (True, False):
        W = gw.cluster_width(C, count)
        per_bin = 4 * count + 8 * (C - count)
        assert W % 2 == 0 and W * per_bin <= gw.CLUSTER_SMEM < (W + 2) * per_bin
        assert gw.window_bytes(W, C, count) == W * per_bin
        for G in (1, 257, W, W + 1, 2 * W + 1, gw.MAX_CLUSTER * W):
            W2, n_win, n_clusters = gw.plan(10 ** 8, G, C, count, max_clusters=16)
            assert W2 <= W and W2 % 2 == 0 and (n_win - 1) * W2 < G <= n_win * W2
            assert n_win == gw.cluster_windows(G, C, count) <= gw.MAX_CLUSTER
            assert gw.fits(G, C, count) and n_clusters == 16
            assert gw.plan(1, G, C, count, max_clusters=16)[2] == 1
            rows_per_cta = gw.WARPS * ga.STAGE_ROWS * ga.MIN_STEPS_PER_WARP
            assert gw.plan(3 * n_win * rows_per_cta, G, C, count, max_clusters=16)[2] == 3
        assert not gw.fits(gw.MAX_CLUSTER * W + 1, C, count)
    # B5's windows hold one term's plane (8 bytes a bin for a float term, 4
    # for counts alone) within CLUSTER_SMEM; even, as B2's; a bin of all its
    # terms takes a 32-bit word per count and 8 bytes per float term
    W5, plane = gm.window_width(C), 8 if C > 1 else 4
    assert gm.bin_bytes(C) == 4 + 8 * (C - 1)
    assert W5 % 2 == 0 and W5 * plane <= ga.CLUSTER_SMEM < (W5 + 2) * plane


@pytest.mark.parametrize("G,C,n_win,W", [
    (10_609, 2, 1, 10_610),  # q2: count + v1, one window, a cluster of one CTA
    (10_609, 3, 1, 10_610),  # count + int64 + f64: 20 bytes a bin fit one CTA
    (32_768, 3, 3, 10_924),
    (67_081, 1, 2, 33_542),  # count(binby=[x, y], shape=256)
    (1_027, 1, 1, 1_028),  # limits(x, "99.7%"): the percentile's histogram
])
def test_window_plan_at_the_query_shapes(G, C, n_win, W):
    assert gw.cluster_window(G, C, True) == (W, n_win)
    assert gw.plan(10 ** 8, G, C, True, max_clusters=132 // n_win) == (W, n_win, 132 // n_win)
    # 2^26 rows (one tile) still give every CTA of 33 clusters its share
    assert gw.plan(2 ** 26, G, C, True, max_clusters=33)[2] == \
        min(33, -(-2 ** 26 // (2 ** 17 * n_win)))


def test_window_reference_cuts_the_clusters_windows():
    """B2's plain version adds the kernel's windows one after the other:
    their edges (k * W and k * W + 1) keep every row once."""
    rng = np.random.default_rng(7)
    C, W = 2, gw.cluster_width(2, True)
    for G in (W - 1, W, W + 1, 3 * W + 1):
        idx = torch.from_numpy(rng.integers(-2, G + 3, 20_000).astype(np.int32))
        idx[:4] = torch.tensor([0, W - 1, min(W, G - 1), G - 1], dtype=torch.int32)
        vals = torch.from_numpy(rng.integers(-2 ** 62, 2 ** 62, 20_000))
        got = gw.grid_window_reference(idx, [vals], [], G, True)
        want = ga.grid_additive_reference(idx, [vals], [], G, True)
        npt.assert_array_equal(got[0].numpy(), want[0].numpy())
        assert gw.cluster_windows(G, C, True) == -(-G // W)


def _numpy_channel_sums(idx, ints, floats, G):
    """The count, the int64 sums (mod 2^64) and the NaN-skipping f64 sums
    per bin in numpy, as [C, G] arrays; rows outside [0, G) drop."""
    keep = (idx >= 0) & (idx < G)
    b = idx[keep]
    int_sums = [np.bincount(b, minlength=G).astype(np.int64)]
    for c in ints:
        out = np.zeros(G, dtype=np.int64)
        np.add.at(out, b, c[keep])
        int_sums.append(out)
    float_sums = [np.bincount(b, weights=np.nan_to_num(c[keep], nan=0.0), minlength=G)
                  for c in floats]
    return np.stack(int_sums), np.stack(float_sums)


def _strategy(G, C, n=10 ** 8):
    return grid_plan.strategy(n, G, C - 1, 0, True)


@pytest.mark.parametrize("C", [1, 2, 3, 4])
def test_plan_boundaries(C):
    W = gw.cluster_width(C, True)
    for G in (1, grid_plan.B1_MAX_G):  # df.sum; B1's last bin: its route by the columns
        lane = ga.route(G, C - 1, 0, True) == ga.LANE
        assert lane == (ga.LANE_MIN_WARPS * ga.lane_warp_bytes(G, C - 1, 0, True) <=
                        ga.CLUSTER_SMEM)
        assert _strategy(G, C) == ("b1" if lane else "b2")
    assert _strategy(grid_plan.B1_MAX_G + 1, C) == "b2"
    assert grid_plan.b2_max_windows(C) == (4 if C <= 2 else 2)
    assert _strategy(grid_plan.b2_max_windows(C) * W, C) == "b2"
    past_b2 = grid_plan.b2_max_windows(C) * W + 1
    assert _strategy(past_b2, C) == ("b3-l2" if past_b2 >= gp.RESIDENT_MIN_G else "b3")
    assert _strategy(gp.RESIDENT_MIN_G - 1, C) in ("b2", "b3")
    assert _strategy(max(past_b2, gp.RESIDENT_MIN_G), C) == "b3-l2"
    in_l2 = gp.RESIDENT_BYTES // (8 * C)  # the widest grid that stays in L2
    assert _strategy(in_l2, C) == "b3-l2"
    assert _strategy(in_l2 + 1, C) == "b3"
    S = gp.shape(10 ** 8, 10 ** 7, C).S  # as wide as the sub-grids get
    assert C * S * 8 <= ga.SMEM_BUDGET
    assert _strategy(gp.P_MAX * S, C) == "b3"
    # past B3 in one call: calls of fewer channels where they fit, else sort
    width = max([c for c in range(1, C) if gp.shape(10 ** 8, gp.P_MAX * S + 1, c)] or [0])
    assert _strategy(gp.P_MAX * S + 1, C) == (f"b3×{-(-C // width)}" if width else "sort")
    assert _strategy(gp.P_MAX * S, C, n=2 ** 31) == "sort"  # int32 offsets
    assert _strategy(in_l2, C, n=2 ** 31) == "b3-l2"  # one pass, no offsets


@pytest.mark.parametrize("n_int", [4, 7, 11, 15, 30])
def test_plan_gives_b2_the_grids_past_b1s_lane_route(n_int):
    """Where B1's lane route stops fitting (count + n_int int64 + one f64),
    the plan takes B2, not B1's warp route, up to ``B1_MAX_G`` and past it."""
    first = next(G for G in range(1, grid_plan.B1_MAX_G + 1)
                 if ga.route(G, n_int, 1, True) == ga.WARP)
    assert ga.fits(first, n_int, 1, True)  # the wrapper's warp route would take it
    assert grid_plan.strategy(10 ** 8, first - 1, n_int, 1, True) == "b1"
    for G in (first, grid_plan.B1_MAX_G, grid_plan.B1_MAX_G + 1):
        assert grid_plan.strategy(10 ** 8, G, n_int, 1, True) == "b2"


def test_plan_keeps_b1_for_many_columns_only_where_it_fits():
    assert not ga.fits(grid_plan.B1_MAX_G, ga.MAX_COLS + 1, 0, True)
    # no kernel takes more than MAX_COLS columns a call (B2's wrapper refused
    # the "b2" this plan gave before): the count and 32 columns on B2, whose
    # lane grids B1 cannot hold, the 33rd column alone on B1's lane route
    assert grid_plan.strategy(10, grid_plan.B1_MAX_G, ga.MAX_COLS + 1, 0, True) == "b2+b1"


@pytest.mark.parametrize("G,route", [(20_000, "b3×2"), (40_000, "b3×4"), (70_000, "sort")])
def test_grid_sums_raises_past_b3_naming_a6(monkeypatch, G, route):
    """Named for the raise this replaced (ROADMAP A4): with B3's partition cut
    to 4 buckets, count + two int64 + one f64 (four channels) past it in one
    call split into calls of as many channels as fit (S = 8192 bins at three
    channels, 16 384 at one), or take the route "sort" where not one channel
    fits; ints exact, floats to 1e-9 against the plain resident version and
    numpy; with ``out`` the sums land in the given rows."""
    monkeypatch.setattr(gp, "P_MAX", 4)
    rng = np.random.default_rng(G)
    n = 20_000
    idx = torch.from_numpy(rng.integers(-3, G + 5, n).astype(np.int32))
    ints = [torch.from_numpy(rng.integers(-2 ** 62, 2 ** 62, n)) for _ in range(2)]
    f = rng.normal(0, 100, n)
    f[::11] = np.nan
    floats = [torch.from_numpy(f)]
    assert grid_plan.strategy(n, G, 2, 1, True) == route
    name, int_sums, float_sums = grid_plan.grid_sums(idx, ints, floats, G, True)
    want_i, want_f = gp.grid_resident_reference(idx, ints, floats, G, True)
    assert name == route
    npt.assert_array_equal(int_sums.numpy(), want_i.numpy())
    npt.assert_allclose(float_sums.numpy(), want_f.numpy(), rtol=1e-9, atol=1e-9)
    np_i, np_f = _numpy_channel_sums(idx.numpy(), [c.numpy() for c in ints], [f], G)
    npt.assert_array_equal(int_sums.numpy(), np_i)
    npt.assert_allclose(float_sums.numpy(), np_f, rtol=1e-9, atol=1e-9)
    rows = ([torch.ones(G, dtype=torch.int64) for _ in range(3)],
            [torch.full((G,), 0.5, dtype=torch.float64)])
    _, got_i, got_f = grid_plan.grid_sums(idx, ints, floats, G, True, out=rows)
    assert all(a is b for a, b in zip(got_i + got_f, rows[0] + rows[1]))
    npt.assert_array_equal(torch.stack(got_i).numpy(), want_i.numpy() + 1)
    npt.assert_allclose(torch.stack(got_f).numpy(), want_f.numpy() + 0.5, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("name", ["b1", "b2", "b3", "b3-l2"])
def test_wrappers_take_the_plain_version_for_cpu_tensors(name):
    idx = torch.tensor([0, 2, 2, 5, -1], dtype=torch.int32)
    vals = torch.tensor([1, 2, 3, 4, 5], dtype=torch.int64)
    kernel = grid_plan.KERNELS[name]
    before = kernel.launches
    int_sums, float_sums = kernel(idx, [vals], [], 3, count=True)
    assert kernel.launches == before  # no kernel launched
    npt.assert_array_equal(int_sums.numpy(), [[1, 0, 2], [1, 0, 5]])
    assert float_sums.shape == (0, 3) and float_sums.dtype == torch.float64


@pytest.mark.parametrize("name", ["b2", "b3", "b3-l2"])
@pytest.mark.parametrize("bad", [
    dict(idx=torch.zeros(4, dtype=torch.int64)),
    dict(int_cols=[torch.zeros(4, dtype=torch.int32)]),
    dict(float_cols=[torch.zeros(4, dtype=torch.float16)]),
    dict(float_cols=[torch.zeros(5, dtype=torch.float64)]),
    dict(G=0),
    dict(count=False, int_cols=[], float_cols=[]),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(name, bad):
    args = dict(idx=torch.zeros(4, dtype=torch.int32), int_cols=[], float_cols=[],
                G=3, count=True)
    args.update(bad)
    with pytest.raises((TypeError, ValueError)):
        grid_plan.KERNELS[name](**args)
