"""The port's grid kernel module (vaex_tpu_torch.ops.grid_additive) against
the TPU kernel it replaces, vaex_tpu.ops.pallas_gridagg._channels_kernel.

The Pallas kernel runs here in interpret mode: a test-local monkeypatch
gives the module a ``pl`` whose ``pallas_call`` interprets the kernel body
on the CPU.  Counts and int64 sums must match exactly; float sums to
rtol 1e-9 and atol 1e-9 (both sides accumulate f64 sums of the same values
in different orders; the TPU kernel's block quantisation adds up to 2^-40
of each block's largest value per row).
"""

import functools
import types

import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch
from jax.experimental import pallas as pl

from vaex_tpu.ops import pallas_gridagg
from vaex_tpu_torch.ops import grid_additive as ga

BLOCK = 4096


@pytest.fixture
def interpret_pallas(monkeypatch):
    shim = types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        program_id=pl.program_id, when=pl.when, BlockSpec=pl.BlockSpec)
    monkeypatch.setattr(pallas_gridagg, "pl", shim)


def _inputs(seed, n, G):
    rng = np.random.default_rng(seed)
    # ~1/8 of the rows carry idx >= G and must drop
    idx = rng.integers(0, G + max(1, G // 8) + 1, n).astype(np.int32)
    ints = rng.integers(-(2 ** 62), 2 ** 62, n, dtype=np.int64)  # sums wrap
    # zero-mean values: per-bin sums cancel to ~sqrt(rows) of the values.
    # Larger offsets would not test the port: the TPU kernel quantises each
    # block to 2^-40 of its largest value, which bounds its error by the
    # values, not by the sum (test_reference_matches_numpy cancels harder)
    floats = rng.normal(0, 100, n)
    return idx, ints, floats


def _pallas_sums(idx, ints, floats, G):
    """vaex_tpu's route: signed 8-bit limbs as OpSum.kernel_channels makes
    them, the implicit count, an exact (hi, lo) f32 pair for the f64."""
    r = ints.copy()
    limbs = []
    for _ in range(8):
        s = ((r + 128) & 255) - 128
        limbs.append(jnp.asarray(s.astype(np.float32)))
        r = (r - s) >> 8
    hi = floats.astype(np.float32)
    lo = (floats - hi.astype(np.float64)).astype(np.float32)
    static, float_sums = pallas_gridagg.fused_additive_channels(
        jnp.asarray(idx), [None] + limbs, [(jnp.asarray(hi), jnp.asarray(lo))], G,
        block=BLOCK)
    static = np.asarray(static)
    count = static[0].astype(np.int64)
    # as OpSum.apply_kernel: reconstruct mod 2^64 from the limb sums
    total = static[1].astype(np.int64)
    for k in range(1, 8):
        total = total + (static[1 + k].astype(np.int64) << np.int64(8 * k))
    return count, total, np.asarray(float_sums)[0]


@pytest.mark.parametrize("G", [1, 103, 128, 512])
@pytest.mark.parametrize("n", [0, 1, 2 * BLOCK + 17, 20_000])
def test_reference_matches_pallas_kernel(interpret_pallas, G, n):
    idx, ints, floats = _inputs(G * 7 + n, n, G)
    want_count, want_int, want_float = _pallas_sums(idx, ints, floats, G)
    int_sums, float_sums = ga.grid_additive_reference(
        torch.from_numpy(idx), [torch.from_numpy(ints)], [torch.from_numpy(floats)], G,
        count=True)
    npt.assert_array_equal(int_sums[0].numpy(), want_count)
    npt.assert_array_equal(int_sums[1].numpy(), want_int)
    npt.assert_allclose(float_sums[0].numpy(), want_float, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("G", [1, 103, 512])
def test_reference_matches_numpy(G):
    """Drops outside [0, G), NaN adds nothing, f32 widens, int64 wraps."""
    rng = np.random.default_rng(G)
    n = 5000
    idx = rng.integers(-3, G + 5, n).astype(np.int32)
    ints = rng.integers(-(2 ** 63), 2 ** 63 - 1, n, dtype=np.int64)
    # heavy cancellation: +-1e6 offsets around a sum of order 1e2
    f64 = rng.normal(0, 1, n) + np.where(rng.random(n) < 0.5, 1e6, -1e6)
    f64[::11] = np.nan
    f32 = rng.normal(0, 1, n).astype(np.float32)
    int_sums, float_sums = ga.grid_additive_reference(
        torch.from_numpy(idx), [torch.from_numpy(ints)],
        [torch.from_numpy(f64), torch.from_numpy(f32)], G, count=True)
    keep = (idx >= 0) & (idx < G)
    want_int = np.zeros(G, np.int64)
    np.add.at(want_int, idx[keep], ints[keep])
    npt.assert_array_equal(int_sums[0].numpy(), np.bincount(idx[keep], minlength=G))
    npt.assert_array_equal(int_sums[1].numpy(), want_int)
    npt.assert_allclose(float_sums[0].numpy(),
                        np.bincount(idx[keep], np.nan_to_num(f64[keep]), minlength=G),
                        rtol=1e-12, atol=1e-6)
    npt.assert_allclose(float_sums[1].numpy(),
                        np.bincount(idx[keep], f32[keep].astype(np.float64), minlength=G),
                        rtol=1e-12, atol=1e-12)


def test_wrapper_takes_the_plain_version_for_cpu_tensors():
    idx = torch.tensor([0, 2, 2, 5], dtype=torch.int32)
    vals = torch.tensor([1, 2, 3, 4], dtype=torch.int64)
    before = ga.grid_additive.launches
    int_sums, float_sums = ga.grid_additive(idx, [vals], [], 3, count=True)
    assert ga.grid_additive.launches == before  # no kernel launched
    npt.assert_array_equal(int_sums.numpy(), [[1, 0, 2], [1, 0, 5]])
    assert float_sums.shape == (0, 3) and float_sums.dtype == torch.float64


@pytest.mark.parametrize("bad", [
    dict(idx=torch.zeros(4, dtype=torch.int64)),
    dict(int_cols=[torch.zeros(4, dtype=torch.int32)]),
    dict(float_cols=[torch.zeros(4, dtype=torch.float16)]),
    dict(float_cols=[torch.zeros(5, dtype=torch.float64)]),
    dict(G=0),
    dict(count=False, int_cols=[], float_cols=[]),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    args = dict(idx=torch.zeros(4, dtype=torch.int32), int_cols=[], float_cols=[],
                G=3, count=True)
    args.update(bad)
    with pytest.raises((TypeError, ValueError)):
        ga.grid_additive(**args)


@pytest.mark.parametrize("G", [1, 103, 512, 2000])
@pytest.mark.parametrize("C", [1, 2, 3, 8])
def test_plan_fits_the_shared_memory_budget(G, C):
    assert ga.fits(G, C - 1, 0, True)
    for n in (0, 1, 10 ** 6, 4 * 10 ** 8):
        n_ctas, warps = ga.plan(n, G, C, sm_count=132)
        assert 1 <= warps <= ga.MAX_WARPS and n_ctas >= 1
        assert warps * ga.warp_bytes(C, G) <= ga.SMEM_BUDGET
        assert ga.plan(n, G, C, sm_count=132) == (n_ctas, warps)  # reproducible


def test_fits_bounds():
    G_max = ga.SMEM_BUDGET // (8 * 3) - ga.STAGE_ROWS
    assert ga.fits(G_max, 1, 1, True)
    assert not ga.fits(G_max + 1, 1, 1, True)
    assert not ga.fits(10, ga.MAX_COLS, 1, False)
    assert not ga.fits(10, 0, 0, False)


@pytest.mark.parametrize("G", [1, 2, 103, 128])
@pytest.mark.parametrize("n_int,n_float", [(0, 0), (0, 1), (1, 1), (2, 1)])
def test_lane_plan_fits_its_shared_memory(G, n_int, n_float):
    """The lane route's CTAs: as many warps as their lane grids (a 32-bit
    count and an 8-byte word per column for each lane and bin) fit in
    227 KiB, at most ``MAX_WARPS``; the route while a CTA keeps
    ``LANE_MIN_WARPS`` warps; one CTA for a small call, the card's resident
    CTAs for 4e8 rows."""
    wb = ga.lane_warp_bytes(G, n_int, n_float, True)
    assert wb == 32 * G * (4 + 8 * (n_int + n_float))
    lane = ga.LANE_MIN_WARPS * wb <= ga.CLUSTER_SMEM
    assert ga.route(G, n_int, n_float, True) == (ga.LANE if lane else ga.WARP)
    n_ctas, warps = ga.lane_plan(4 * 10 ** 8, G, n_int, n_float, True, sm_count=132)
    assert 1 <= warps <= ga.MAX_WARPS and warps * wb <= ga.CLUSTER_SMEM
    assert warps == ga.MAX_WARPS or (warps + 1) * wb > ga.CLUSTER_SMEM
    per_sm = min(ga.SM_THREADS // (warps * 32), ga.SM_SMEM // (warps * wb))
    assert n_ctas == 132 * per_sm
    assert ga.lane_plan(1, G, n_int, n_float, True, sm_count=132) == (1, warps)


def test_main_path_and_isin_count_take_the_lane_route():
    """count + f64 at G = 103 (the main path: five warps of 39.5 KB), the
    count alone at G = 1 (the isin count) and count + int64 + f64 at G = 1
    take the lane route; count + int64 + f64 at G = 103 leaves a CTA three
    warps of lane grids and takes the warp route."""
    assert ga.route(103, 0, 1, True) == ga.LANE
    assert ga.lane_plan(10 ** 8, 103, 0, 1, True, sm_count=132) == (132, 5)
    assert ga.route(1, 0, 0, True) == ga.LANE
    assert ga.route(1, 1, 1, True) == ga.LANE
    assert ga.route(103, 1, 1, True) == ga.WARP
    assert ga.route(64, 2, 1, True) == ga.LANE  # four warps
