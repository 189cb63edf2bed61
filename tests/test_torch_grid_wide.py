"""The port's wide-grid kernel modules against the TPU kernels they replace
and against numpy, and the strategy plan that picks among the kernels.

* B2, ``vaex_tpu_torch.ops.grid_window``, against
  ``vaex_tpu.ops.pallas_gridagg._channels2_kernel``
  (``fused_additive_two_level_channels``);
* B3, ``vaex_tpu_torch.ops.grid_partition``, against
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


PLAIN = {"b2": gw.grid_window_reference, "b3": gp.grid_partition_reference}


@pytest.mark.parametrize("kernel,G", [("b2", 8182), ("b2", 10609),
                                      ("b3", 40003), ("b3", 100003)])
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
}


@pytest.mark.parametrize("kernel", ["b2", "b3"])
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
    assert gp.MIN_WARPS1 <= sh.warps1 <= gp.WARPS1
    assert gp.scatter_bytes(sh.warps1, sh.P) <= ga.SMEM_BUDGET  # phase-1 offsets and counts
    assert gp.scatter_bytes(gp.MIN_WARPS1, gp.P_MAX) <= ga.SMEM_BUDGET
    frontiers = sh.n_seg * sh.P * (C + 1) * 32  # the scatter's partly written sectors
    assert frontiers <= max(gp.FRONTIER_BYTES, sh.P * (C + 1) * 32) or (
        sh.seg_rows == gp.MIN_SEG_ROWS)
    assert 1 <= sh.warps2 <= ga.MAX_WARPS
    assert sh.warps2 * ga.warp_bytes(C, sh.S) <= ga.SMEM_BUDGET  # phase-2 sub-grids
    assert sh.seg_rows % 32 == 0 and sh.n_seg * sh.seg_rows >= n
    chunks = gp.chunks(n, C, sh, sm_count=132)
    assert 1 <= chunks <= 65535
    assert gp.chunks(n, C, sh, sm_count=132) == chunks  # reproducible


@pytest.mark.parametrize("C", [1, 2, 3, 4, 8])
def test_window_plan_fits_its_kernel(C):
    W = gw.window_width(C)
    assert C * W * 8 <= ga.SMEM_BUDGET < C * (W + 1) * 8
    for G in (257, W, W + 1, 64 * W):
        W2, n_win, n_slices = gw.plan(10 ** 8, G, C, sm_count=132)
        assert W2 == W and (n_win - 1) * W < G <= n_win * W
        assert 1 <= n_slices <= 65535


def _strategy(G, C, n=10 ** 8):
    return grid_plan.strategy(n, G, C - 1, 0, True)


@pytest.mark.parametrize("C", [1, 2, 3, 4])
def test_plan_boundaries(C):
    W = gw.window_width(C)
    assert _strategy(1, C) == "b1"  # df.sum
    assert _strategy(grid_plan.B1_MAX_G, C) == "b1"
    assert _strategy(grid_plan.B1_MAX_G + 1, C) == "b2"
    assert _strategy(grid_plan.B2_MAX_WINDOWS * W, C) == "b2"
    assert _strategy(grid_plan.B2_MAX_WINDOWS * W + 1, C) == "b3"
    S = gp.shape(10 ** 8, 10 ** 6, C).S  # as wide as the sub-grids get
    assert _strategy(gp.P_MAX * S, C) == "b3"
    assert _strategy(gp.P_MAX * S + 1, C) is None  # past B3: the sort strategies (A6)
    assert _strategy(gp.P_MAX * S, C, n=2 ** 31) is None  # int32 offsets


def test_plan_keeps_b1_for_many_columns_only_where_it_fits():
    assert not ga.fits(grid_plan.B1_MAX_G, ga.MAX_COLS + 1, 0, True)
    assert grid_plan.strategy(10, grid_plan.B1_MAX_G, ga.MAX_COLS + 1, 0, True) == "b2"


def test_grid_sums_raises_past_b3_naming_a6():
    idx = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="ROADMAP queue A6"):
        grid_plan.grid_sums(idx, [], [], 10 ** 9, True)


@pytest.mark.parametrize("name", ["b1", "b2", "b3"])
def test_wrappers_take_the_plain_version_for_cpu_tensors(name):
    idx = torch.tensor([0, 2, 2, 5, -1], dtype=torch.int32)
    vals = torch.tensor([1, 2, 3, 4, 5], dtype=torch.int64)
    kernel = grid_plan.KERNELS[name]
    before = kernel.launches
    int_sums, float_sums = kernel(idx, [vals], [], 3, count=True)
    assert kernel.launches == before  # no kernel launched
    npt.assert_array_equal(int_sums.numpy(), [[1, 0, 2], [1, 0, 5]])
    assert float_sums.shape == (0, 3) and float_sums.dtype == torch.float64


@pytest.mark.parametrize("name", ["b2", "b3"])
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
