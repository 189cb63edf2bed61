"""The port's min/max kernel module (B3x, ``grid_partition_extreme``) against
the TPU kernel mode it replaces and against numpy, and the plan that routes
a pass's extremes.

* the plain version of B3x against the ``extreme_cols`` mode of
  ``vaex_tpu.ops.pallas_partition.partitioned_additive_channels`` (the
  masked min/max reduce of ``_phase2_kernel``), run in interpret mode through
  a test-local monkeypatch of the module's ``pl``: float32 values, exact;
* against numpy for int64 and float64 columns with NaN, +-inf, -0.0,
  validity masks, empty cells, pre-sorted keys and the G % S tail: exact by
  value, in the column's dtype;
* the sums that ride the same call against B3's plain version;
* the resident route's wrapper (``grid_resident_extreme``, its plain version
  on the CPU) against numpy on the same cases;
* ``extreme_strategy`` / ``grid_extremes`` / ``grid_sums_and_extremes``: the
  routes at their boundaries (the direct route's budget, the resident
  route's, B3's limits), the batching past ``MAX_EXT`` and by the resident
  budget, and the choice between a shared scatter and the resident route
  apart from the sums.
"""

import functools
import types

import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch
from jax.experimental import pallas as pl

from vaex_tpu.ops import pallas_partition
from vaex_tpu_torch.ops import grid_extreme as ge
from vaex_tpu_torch.ops import grid_partition as gp
from vaex_tpu_torch.ops import grid_plan


@pytest.fixture
def interpret_pallas(monkeypatch):
    shim = types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        program_id=pl.program_id, when=pl.when, BlockSpec=pl.BlockSpec)
    monkeypatch.setattr(pallas_partition, "pl", shim)


@pytest.mark.parametrize("G", [40_003, 100_003])
@pytest.mark.parametrize("n", [1, 20_000])
def test_plain_version_matches_the_pallas_extreme_mode(interpret_pallas, G, n):
    """f32 values (what the TPU mode takes), a validity channel, a min and a
    max column; rows with idx >= G drop; empty cells +-inf on both sides."""
    rng = np.random.default_rng(G + n)
    idx = rng.integers(0, G + G // 8 + 1, n).astype(np.int32)
    a = rng.normal(0, 1e3, n).astype(np.float32)
    b = rng.normal(0, 1, n).astype(np.float32)
    valid = rng.random(n) < 0.8
    ones = jnp.ones(n, jnp.float32)
    _, _, grids, overflow = pallas_partition.partitioned_additive_channels(
        jnp.asarray(idx), [ones], [], G,
        extreme_cols=[(jnp.asarray(a), "min"), (jnp.asarray(b), "max")],
        validity=jnp.asarray(valid.astype(np.float32)))
    assert int(overflow) == 0
    # the TPU mode takes one validity for all its columns: the same rows
    # dropped through idx
    masked = np.where(valid, idx, -1).astype(np.int32)
    got = ge.grid_extreme_batch(torch.from_numpy(masked),
                                [torch.from_numpy(a), torch.from_numpy(b)],
                                ["min", "max"], [None, None], G)
    for g, want in zip(got, grids):
        assert g.dtype == torch.float32
        npt.assert_array_equal(g.numpy(), np.asarray(want))
    # and as the port's contract takes it, a validity per column
    got = ge.grid_extreme_batch(torch.from_numpy(idx),
                                [torch.from_numpy(a), torch.from_numpy(b)], ["min", "max"],
                                [torch.from_numpy(valid)] * 2, G)
    for g, want in zip(got, grids):
        npt.assert_array_equal(g.numpy(), np.asarray(want))


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
    out = np.full(G, fill, col.dtype)
    (np.minimum if mode == "min" else np.maximum).at(out, idx[keep], col[keep])
    return out


def _columns(rng, n):
    """int64 past 2^53, f64 with NaN, +-inf and both zeros, f32."""
    ints = rng.integers(-(2 ** 62), 2 ** 62, n, dtype=np.int64)
    f64 = rng.normal(0, 1e3, n)
    f64[::7] = np.nan
    f64[1::11] = np.inf
    f64[2::11] = -np.inf
    f64[3::5] = 0.0
    f64[4::5] = -0.0
    f32 = rng.normal(0, 1, n).astype(np.float32)
    return ints, f64, f32


CASES = {
    # G % S != 0, drops on both sides of [0, G)
    "uniform": dict(G=100_003, n=30_000),
    # pre-sorted keys: every run of rows lands in one bucket
    "sorted": dict(G=100_003, n=30_000, sort=True),
    # keys in a few narrow ranges: most cells stay empty
    "empty_cells": dict(G=1_000_003, n=20_000, clusters=3),
    # the grid fits one CTA's shared memory: no partition
    "direct": dict(G=300, n=5_000),
    "one_cell": dict(G=1, n=3_000),
    "no_rows": dict(G=1000, n=0),
    # every row on one key of a wide grid: one bucket holds all the rows
    "single_key": dict(G=1_000_003, n=20_000, single=True),
    # a Zipf(1.1) draw: a few keys hold most rows, in no order
    "skewed": dict(G=1_000_003, n=30_000, zipf=1.1),
}


def _case_idx(rng, G, n, sort=False, clusters=0, single=False, zipf=0):
    if single:
        idx = np.full(n, G // 3)
        idx[::7] = -1
    elif zipf:
        idx = rng.permutation(G)[np.minimum(rng.zipf(zipf, n), G) - 1]
    elif clusters:
        centers = rng.integers(0, G, clusters)
        idx = (centers[rng.integers(0, clusters, n)] + rng.integers(-50, 50, n))
    else:
        idx = rng.integers(-3, G + G // 8 + 1, n)
    idx = idx.astype(np.int32)
    return np.sort(idx) if sort else idx


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("beside_sums", [False, True])
def test_wrapper_matches_numpy(case, beside_sums):
    """Through the wrapper on CPU tensors (its plain version): five columns,
    two of them under validity masks, alone and with count + int64 + f64
    sums riding the call."""
    spec = CASES[case]
    G, n = spec["G"], spec["n"]
    rng = np.random.default_rng(len(case) + G)
    idx = _case_idx(rng, **spec)
    ints, f64, f32 = _columns(rng, n)
    valid = rng.random(n) < 0.8
    cols = [ints, f64, f32, f64, ints]
    modes = ["min", "max", "min", "min", "max"]
    valids = [None, None, None, valid, valid]
    tensors = [torch.from_numpy(c) for c in cols]
    masks = [None if v is None else torch.from_numpy(v) for v in valids]
    summed = rng.normal(0, 100, n)
    extra = ([torch.from_numpy(ints)], [torch.from_numpy(summed)], True) if beside_sums else ()
    grids, int_sums, float_sums = gp.grid_partition_extreme(torch.from_numpy(idx), tensors, modes,
                                                            masks, G, *extra)
    for got, col, mode, v in zip(grids, cols, modes, valids):
        assert got.dtype == torch.from_numpy(col).dtype and got.shape == (G,)
        npt.assert_array_equal(got.numpy(), _numpy_extreme(idx, col, mode, v, G))
    if not beside_sums:
        assert int_sums is None and float_sums is None
        return
    want_i, want_f = gp.grid_partition_reference(torch.from_numpy(idx), *extra[:2], G, True)
    npt.assert_array_equal(int_sums.numpy(), want_i.numpy())
    npt.assert_allclose(float_sums.numpy(), want_f.numpy(), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("case", CASES)
def test_resident_wrapper_matches_numpy(case):
    """The resident route's wrapper on CPU tensors (its plain version): the
    five columns of ``test_wrapper_matches_numpy``, exact by value and
    dtype; no kernel launched."""
    spec = CASES[case]
    G, n = spec["G"], spec["n"]
    rng = np.random.default_rng(len(case) + G + 1)
    idx = _case_idx(rng, **spec)
    ints, f64, f32 = _columns(rng, n)
    valid = rng.random(n) < 0.8
    cols = [ints, f64, f32, f64, ints]
    modes = ["max", "min", "max", "max", "min"]
    valids = [None, valid, None, None, valid]
    before = gp.grid_resident_extreme.launches
    grids = gp.grid_resident_extreme(torch.from_numpy(idx), [torch.from_numpy(c) for c in cols],
                                     modes, [None if v is None else torch.from_numpy(v)
                                             for v in valids], G)
    assert gp.grid_resident_extreme.launches == before
    for got, col, mode, v in zip(grids, cols, modes, valids):
        assert got.dtype == torch.from_numpy(col).dtype and got.shape == (G,)
        npt.assert_array_equal(got.numpy(), _numpy_extreme(idx, col, mode, v, G))


def test_resident_stride_keeps_a_cells_keys_together():
    """A cell's E keys lie together, E rounded up to even past one column, so
    two keys are one 16-byte load; the budget counts the padding."""
    assert [gp.resident_stride(E) for E in range(1, gp.MAX_EXT + 1)] == [1, 2, 4, 4, 6, 6, 8, 8]
    for E in range(1, gp.MAX_EXT + 1):
        G = gp.RESIDENT_BYTES // (8 * gp.resident_stride(E))
        assert gp.extreme_resident_fits(G, E) and not gp.extreme_resident_fits(G + 1, E)
    assert not gp.extreme_resident_fits(100, gp.MAX_EXT + 1)


def test_zeros_of_both_signs_are_equal_by_value():
    """A cell that holds -0.0 and 0.0 returns a zero; which sign is the
    kernel's business (it keeps -0.0 as min, 0.0 as max) and equal by value."""
    idx = torch.zeros(4, dtype=torch.int32)
    col = torch.tensor([0.0, -0.0, 0.0, -0.0], dtype=torch.float64)
    for mode in ("min", "max"):
        [got] = ge.grid_extreme_batch(idx, [col], [mode], [None], 1)
        assert got.item() == 0.0


def test_empty_cells_hold_the_identity_of_each_dtype():
    idx = torch.tensor([5, -1, 7], dtype=torch.int32)  # nothing lands in [0, 3)
    cols = [torch.tensor([1, 2, 3], dtype=torch.int64), torch.tensor([1.0, 2.0, 3.0]),
            torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64)]
    for mode, ints, floats in (("min", np.iinfo(np.int64).max, np.inf),
                               ("max", np.iinfo(np.int64).min, -np.inf)):
        got = ge.grid_extreme_batch(idx, cols, [mode] * 3, [None] * 3, 3)
        assert [g.dtype for g in got] == [torch.int64, torch.float32, torch.float64]
        npt.assert_array_equal(got[0].numpy(), [ints] * 3)
        npt.assert_array_equal(got[1].numpy(), [floats] * 3)
        npt.assert_array_equal(got[2].numpy(), [floats] * 3)
        assert ge.identity(torch.int64, mode) == ints and ge.identity(torch.float64, mode) == floats


def test_fold_validity_reaches_no_cell():
    col = torch.tensor([5, -7, 9], dtype=torch.int64)
    valid = torch.tensor([True, False, True])
    assert ge.fold_validity(col, "min", None) is col
    assert ge.fold_validity(col, "min", valid).tolist() == [5, np.iinfo(np.int64).max, 9]
    assert ge.fold_validity(col, "max", valid).tolist() == [5, np.iinfo(np.int64).min, 9]
    f = ge.fold_validity(col.to(torch.float32), "max", valid)
    assert f.dtype == torch.float32 and torch.isnan(f[1]) and f[0] == 5


@pytest.mark.parametrize("bad,match", [
    (dict(idx=torch.zeros(3, dtype=torch.int64)), "int32"),
    (dict(cols=[torch.zeros(3, dtype=torch.int32)]), "int64, float64 or float32"),
    (dict(modes=["median"]), "'min' or 'max'"),
    (dict(valids=[torch.zeros(3, dtype=torch.uint8)]), "bool"),
    (dict(cols=[torch.zeros(4)]), "does not match"),
    (dict(cols=[]), "one mode and one validity"),
    (dict(G=0), "G >= 1"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad, match):
    args = dict(idx=torch.zeros(3, dtype=torch.int32), cols=[torch.zeros(3)], modes=["min"],
                valids=[None], G=5)
    args.update(bad)
    with pytest.raises((TypeError, ValueError), match=match):
        gp.grid_partition_extreme(args["idx"], args["cols"], args["modes"], args["valids"],
                                  args["G"])


def test_extreme_strategy_boundaries():
    """b3x-direct while E * G * 8 bytes of keys fit one CTA's shared memory,
    b3x-l2 while the grid of keys stays in L2 (both when nothing additive
    rides along), b3x over a partition up to B3's limits."""
    n = 100_000_000
    direct_max = gp.SMEM_BUDGET // 8  # E = 1
    assert grid_plan.extreme_strategy(n, 1, 1) == "b3x-direct"
    assert grid_plan.extreme_strategy(n, direct_max, 1) == "b3x-direct"
    assert grid_plan.extreme_strategy(n, direct_max + 1, 1) == "b3x-l2"
    assert grid_plan.extreme_strategy(n, direct_max // 4, 4) == "b3x-direct"
    assert grid_plan.extreme_strategy(n, direct_max // 4 + 1, 4) == "b3x-l2"
    # the resident route while [G, stride] keys take at most RESIDENT_BYTES
    for E in (1, 2, 3, gp.MAX_EXT):
        edge = gp.RESIDENT_BYTES // (8 * gp.resident_stride(E))
        assert grid_plan.extreme_strategy(n, edge, E) == "b3x-l2"
        assert grid_plan.extreme_strategy(n, edge + 1, E) == "b3x"
    # sums riding along always take the partition, whatever G
    assert grid_plan.extreme_strategy(n, 103, 2, 1, 1, True) == "b3x"
    assert grid_plan.extreme_strategy(n, 1_000_003, 1, 0, 0, True) == "b3x"
    # 2-D shape 256 and 1024, q7's G; the 2-D max of shape 2000 (32 MB of keys)
    for G in (259 ** 2, 1027 ** 2, 1_000_003):
        for E in (1, 2):
            assert grid_plan.extreme_strategy(n, G, E) == "b3x-l2"
    assert grid_plan.extreme_strategy(n, 1_000_003, 4) == "b3x"  # 32 MB
    assert grid_plan.extreme_strategy(n, 2003 ** 2, 1) == "b3x"
    # past B3's limits: too many buckets, too many rows (the resident route
    # has no row limit)
    assert grid_plan.extreme_strategy(n, 2 ** 30, 1) is None
    assert grid_plan.extreme_strategy(2 ** 31, 2003 ** 2, 1) is None
    assert grid_plan.extreme_strategy(2 ** 31, 1_000_003, 1) == "b3x-l2"
    assert grid_plan.extreme_strategy(2 ** 31, 103, 1) == "b3x-direct"
    with pytest.raises(ValueError, match="a call takes 1 to"):
        grid_plan.extreme_strategy(n, 103, gp.MAX_EXT + 1)


def test_partition_shape_counts_the_extreme_columns():
    """The low bits travel as uint16 and a CTA's [E, S] keys must fit shared
    memory: S shrinks as columns are added, sums or extremes."""
    n, G = 100_000_000, 1_000_003
    shapes = [gp.shape(n, G, C) for C in (1, 3, 3 + gp.MAX_EXT)]
    assert [s.S for s in shapes] == sorted((s.S for s in shapes), reverse=True)
    for C, s in zip((1, 3, 3 + gp.MAX_EXT), shapes):
        assert s.S <= 1 << gp.MAX_SHIFT and s.P * s.S >= G
        assert gp.MAX_EXT * s.S * 8 <= gp.SMEM_BUDGET or C < gp.MAX_EXT
    # alone, the extremes take the widest sub-grid within EXT_GRID_BYTES
    for E in (1, 2, 3, 4, gp.MAX_EXT):
        s = gp.extreme_shape(n, G, E)
        assert E * s.S * 8 <= gp.EXT_GRID_BYTES < E * 2 * s.S * 8 and s.P * s.S >= G
    assert gp.extreme_shape(n, G, 2, 3) == gp.shape(n, G, 5)
    assert gp.extreme_shape(n, G, 2, 3, sm_count=66) == gp.shape(n, G, 5, sm_count=66)
    assert gp.extreme_shape(n, 300, 1).P == 1  # one bucket as wide as the grid needs
    assert gp.extreme_call_fits(n, G, gp.MAX_EXT, 2, 2, True)
    assert not gp.extreme_call_fits(n, G, gp.MAX_EXT, gp.MAX_COLS, 0, True)  # MAX_COLS
    assert not gp.extreme_call_fits(n, G, gp.MAX_EXT + 1)
    assert gp.extreme_ctas(0, 8, 132) == 1
    assert 1 <= gp.extreme_ctas(n, 8 * 103, 132) <= 65535
    # equal chunks of the rows, whatever the buckets hold: two waves of the card
    assert gp.extreme_ctas(n, gp.EXT_GRID_BYTES, 132) == 2 * 132 * 3


def _batched(monkeypatch):
    """Records (extreme columns, additive channels) per call of the partition
    and direct routes' wrapper, (extreme columns, "l2") per call of the
    resident route's."""
    calls = []
    real, resident = gp.grid_partition_extreme, gp.grid_resident_extreme

    def counted(idx, cols, modes, valids, G, int_cols=(), float_cols=(), count=False):
        calls.append((len(cols), len(int_cols) + len(float_cols) + bool(count)))
        return real(idx, cols, modes, valids, G, int_cols, float_cols, count)

    def counted_resident(idx, cols, modes, valids, G):
        calls.append((len(cols), "l2"))
        return resident(idx, cols, modes, valids, G)
    monkeypatch.setattr(grid_plan.grid_partition, "grid_partition_extreme", counted)
    monkeypatch.setattr(grid_plan.grid_partition, "grid_resident_extreme", counted_resident)
    return calls


def test_grid_extremes_batches_past_max_ext(monkeypatch):
    calls = _batched(monkeypatch)
    rng = np.random.default_rng(5)
    n, G, E = 4000, 500, 2 * gp.MAX_EXT + 3
    idx = rng.integers(0, G, n).astype(np.int32)
    cols = [rng.normal(0, 1, n) for _ in range(E)]
    modes = ["min" if e % 2 else "max" for e in range(E)]
    name, grids = grid_plan.grid_extremes(torch.from_numpy(idx),
                                          [torch.from_numpy(c) for c in cols], modes,
                                          [None] * E, G)
    assert calls == [(gp.MAX_EXT, 0), (gp.MAX_EXT, 0), (3, 0)]
    assert name == "b3x-direct" and len(grids) == E
    for got, col, mode in zip(grids, cols, modes):
        npt.assert_array_equal(got.numpy(), _numpy_extreme(idx, col, mode, None, G))
    # a grid that the direct route takes only with fewer columns: the
    # resident route takes MAX_EXT columns a call past the direct budget
    del calls[:]
    G = gp.SMEM_BUDGET // 8 // 2  # two columns fit one CTA, three do not
    idx = rng.integers(0, G, n).astype(np.int32)
    name, grids = grid_plan.grid_extremes(torch.from_numpy(idx),
                                          [torch.from_numpy(c) for c in cols[:11]], modes[:11],
                                          [None] * 11, G)
    assert calls == [(gp.MAX_EXT, "l2"), (3, "l2")] and name == "b3x-l2"
    for got, col, mode in zip(grids, cols, modes):
        npt.assert_array_equal(got.numpy(), _numpy_extreme(idx, col, mode, None, G))
    del calls[:]
    name, grids = grid_plan.grid_extremes(torch.from_numpy(idx),
                                          [torch.from_numpy(c) for c in cols[:10]], modes[:10],
                                          [None] * 10, G)
    assert calls == [(gp.MAX_EXT, "l2"), (2, 0)] and name == "b3x-l2+b3x-direct"


def test_grid_extremes_batches_by_the_resident_budget(monkeypatch):
    """On the resident route a call takes as many columns as keep the grid of
    keys (their stride padded) within RESIDENT_BYTES; past the budget for
    one column, the partition takes B3X_BATCH a call."""
    calls = _batched(monkeypatch)
    rng = np.random.default_rng(6)
    n = 3000
    for G, E, want in ((1_000_003, 5, [(2, "l2"), (2, "l2"), (1, "l2")]),
                       (2_500_000, 3, [(1, "l2")] * 3),
                       (4_000_037, 5, [(grid_plan.B3X_BATCH, 0), (1, 0)])):
        del calls[:]
        idx = rng.integers(-1, G + 1, n).astype(np.int32)
        cols = [rng.normal(0, 1, n) for _ in range(E)]
        modes = ["min" if e % 2 else "max" for e in range(E)]
        name, grids = grid_plan.grid_extremes(torch.from_numpy(idx),
                                              [torch.from_numpy(c) for c in cols], modes,
                                              [None] * E, G)
        assert calls == want
        assert name == ("b3x-l2" if want[0][1] == "l2" else "b3x")
        for got, col, mode in zip(grids, cols, modes):
            npt.assert_array_equal(got.numpy(), _numpy_extreme(idx, col, mode, None, G))


@pytest.mark.parametrize("G,E,shared", [(1_000_003, 1, True), (1_000_003, 2, False),
                                        (1_000_003, 11, False), (4_000_037, 1, True),
                                        (4_000_037, 11, True), (30_011, 1, True),
                                        (32_768, 1, True), (67_081, 2, True),
                                        (30_011, 2, True), (13_001, 2, False),
                                        (10_609, 2, False), (103, 1, False)])
def test_sums_and_extremes_share_one_partition_on_b3(monkeypatch, G, E, shared):
    """Where the extremes alone take b3x, or b3x-l2 beside sums whose own
    call is dear, and the sums are past b1, the first B3X_BATCH extreme
    columns and the sums share one partition and the sums are b3's,
    whichever kernel they would take alone (b3 for count + int64 + f64 at
    30 011, 32 768, 67 081 and 4 000 037, b3-l2 at 1 000 003 beside one
    extreme column); beside sums on b2 in at most B3X_APART_B2_WINDOWS
    windows (13 001) or on b3-l2 beside B3X_APART_MIN_COLS extreme columns
    or more the extremes take b3x-l2 apart; where they take the direct route
    (10 609, 103), each takes its own call."""
    calls = _batched(monkeypatch)
    rng = np.random.default_rng(G + E)
    n = 6000
    idx = torch.from_numpy(rng.integers(-1, G + 2, n).astype(np.int32))
    ints = torch.from_numpy(rng.integers(-9, 9, n))
    floats = torch.from_numpy(rng.normal(0, 1, n))
    cols = [torch.from_numpy(rng.normal(0, 1, n)) for _ in range(E)]
    modes = ["max" if e % 2 else "min" for e in range(E)]
    add_name, ext_name, was_shared, int_sums, float_sums, grids = (
        grid_plan.grid_sums_and_extremes(idx, [ints], [floats], G, True, cols, modes, [None] * E))
    assert was_shared == shared
    assert add_name == ("b3" if shared else grid_plan.strategy(n, G, 1, 1, True))
    assert sum(size for size, _ in calls) == E
    if shared:
        # the first call shares the scatter, the rest as grid_extremes batches them
        assert calls[0] == (min(E, grid_plan.B3X_BATCH), 3)
        assert all(channels in (0, "l2") for _, channels in calls[1:])
        assert ext_name.split("+")[0] == "b3x"
    elif gp.extreme_direct_fits(G, E):
        assert calls == [(E, 0)] and ext_name == "b3x-direct"
    else:
        assert add_name in ("b2", "b3-l2")
        assert all(route == "l2" for _, route in calls) and ext_name == "b3x-l2"
    want_i, want_f = grid_plan.PLAIN[add_name](idx, [ints], [floats], G, True)
    npt.assert_array_equal(int_sums.numpy(), want_i.numpy())
    npt.assert_allclose(float_sums.numpy(), want_f.numpy(), rtol=1e-9, atol=1e-9)
    for got, col, mode in zip(grids, cols, modes):
        npt.assert_array_equal(got.numpy(),
                               _numpy_extreme(idx.numpy(), col.numpy(), mode, None, G))


def test_extremes_past_b3_raise_naming_a6():
    idx = torch.zeros(10, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="ROADMAP queue A6"):
        grid_plan.grid_extremes(idx, [torch.zeros(10)], ["min"], [None], 10 ** 9)
