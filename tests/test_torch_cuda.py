"""The port's CUDA kernels on the card, against their plain versions.

Imports neither JAX nor vaex_tpu, so that it runs where only the port is
installed.  Every test is marked ``cuda`` and skips without a GPU; on a
machine with one, from the root of the repository:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import numpy.testing as npt
import pytest
import torch

import vaex_tpu_torch
from vaex_tpu_torch import agg
from vaex_tpu_torch.ops import grid_additive as ga
from vaex_tpu_torch.ops import grid_extreme as ge
from vaex_tpu_torch.ops import grid_moments as gm
from vaex_tpu_torch.ops import grid_partition as gp
from vaex_tpu_torch.ops import grid_plan
from vaex_tpu_torch.ops import grid_window as gw
from vaex_tpu_torch.ops import probe

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _inputs(n, G, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    idx = torch.randint(0, G + G // 8 + 1, (n,), generator=g, device=device,
                        dtype=torch.int32)
    ints = torch.randint(-(2 ** 62), 2 ** 62, (n,), generator=g, device=device,
                         dtype=torch.int64)
    floats = torch.randn(n, generator=g, device=device, dtype=torch.float64) * 100
    return idx, ints, floats


@pytest.mark.parametrize("G", [1, 103, 512, 5000])
@pytest.mark.parametrize("n", [0, 1, 100_003])
def test_kernel_matches_plain(cuda, G, n):
    idx, ints, floats = _inputs(n, G, cuda)
    floats[::17] = float("nan")
    f32 = floats.to(torch.float32)
    before = ga.grid_additive.launches
    got = ga.grid_additive(idx, [ints], [floats, f32], G, count=True)
    assert ga.grid_additive.launches == before + 1
    want = ga.grid_additive_reference(idx, [ints], [floats, f32], G, count=True)
    torch.cuda.synchronize()
    npt.assert_array_equal(got[0].cpu().numpy(), want[0].cpu().numpy())
    npt.assert_allclose(got[1].cpu().numpy(), want[1].cpu().numpy(), rtol=1e-9, atol=1e-9)


def test_kernel_is_reproducible(cuda):
    idx, ints, floats = _inputs(1_000_000, 103, cuda, seed=1)
    a = ga.grid_additive(idx, [], [floats], 103, count=True)[1]
    b = ga.grid_additive(idx, [], [floats], 103, count=True)[1]
    assert torch.equal(a, b)


def test_wrapper_raises_on_a_grid_that_does_not_fit(cuda):
    idx = torch.zeros(10, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="does not fit"):
        ga.grid_additive(idx, [], [], 10 ** 6, count=True)


def test_groupby_past_b1_runs_on_the_wide_kernels(cuda):
    K = 20_000  # G = K + 3 is past B1's range: B2 or B3 takes it
    rng = np.random.default_rng(3)
    keys = rng.integers(0, K, 50_000)
    x = rng.normal(0, 1, 50_000)
    df = vaex_tpu_torch.from_arrays(k=keys, x=x).to_device(cuda)
    df = df.categorize("k", labels=list(range(K)))
    launches = {name: k.launches for name, k in grid_plan.KERNELS.items()}
    out = df.groupby("k", agg={"s": vaex_tpu_torch.agg.sum("x"), "c": "count"})
    [strategy] = [s["additive"] for s in df.executor.trace_log[-1]["strategies"]]
    assert strategy in ("b2", "b3")
    assert grid_plan.KERNELS[strategy].launches > launches[strategy]
    npt.assert_array_equal(out["c"].tolist(), np.bincount(keys, minlength=K))
    npt.assert_allclose(out["s"].tolist(), np.bincount(keys, x, minlength=K),
                        rtol=1e-9, atol=1e-9)


WIDE = {"b2": (gw.grid_window, gw.grid_window_reference),
        "b3": (gp.grid_partition, gp.grid_partition_reference)}


@pytest.mark.parametrize("name", ["b2", "b3"])
@pytest.mark.parametrize("G", [257, 10_609, 100_003, 1_000_003])
@pytest.mark.parametrize("n", [0, 1, 300_007])
def test_wide_kernel_matches_plain(cuda, name, G, n):
    kernel, plain = WIDE[name]
    idx, ints, floats = _inputs(n, G, cuda)
    floats[::17] = float("nan")
    f32 = floats.to(torch.float32)
    before = kernel.launches
    got = kernel(idx, [ints], [floats, f32], G, count=True)
    assert kernel.launches == before + 1
    want = plain(idx, [ints], [floats, f32], G, count=True)
    torch.cuda.synchronize()
    npt.assert_array_equal(got[0].cpu().numpy(), want[0].cpu().numpy())
    npt.assert_allclose(got[1].cpu().numpy(), want[1].cpu().numpy(), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("G", [103, 1_000_003])
def test_ordered_kernels_are_reproducible(cuda, G):
    """B1 and B3 add in an order fixed by their launch; B2's shared-memory
    atomics promise exact ints only, so it is not held to this."""
    kernel = ga.grid_additive if G == 103 else gp.grid_partition
    idx, ints, floats = _inputs(1_000_000, G, cuda, seed=1)
    a = kernel(idx, [ints], [floats], G, count=True)
    b = kernel(idx, [ints], [floats], G, count=True)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_partition_takes_sorted_keys(cuda):
    """Pre-sorted keys: every row of a long run lands in one bucket; the
    counts size the buckets, so nothing overflows or demotes."""
    G = 1_000_003
    idx, ints, floats = _inputs(2_000_000, G, cuda, seed=2)
    idx = torch.sort(idx).values
    got = gp.grid_partition(idx, [ints], [floats], G, count=True)
    want = gp.grid_partition_reference(idx, [ints], [floats], G, count=True)
    torch.cuda.synchronize()
    npt.assert_array_equal(got[0].cpu().numpy(), want[0].cpu().numpy())
    npt.assert_allclose(got[1].cpu().numpy(), want[1].cpu().numpy(), rtol=1e-9, atol=1e-9)


def test_plan_routes_each_grid_to_its_kernel_on_the_card(cuda):
    idx = torch.zeros(1000, dtype=torch.int32, device=cuda)
    for G, name in ((103, "b1"), (10_609, "b2"), (3_000_003, "b3")):
        before = grid_plan.KERNELS[name].launches
        strategy, _, _ = grid_plan.grid_sums(idx, [], [], G, True)
        assert strategy == name and grid_plan.KERNELS[name].launches == before + 1


def test_groupby_on_the_card(cuda):
    rng = np.random.default_rng(2)
    keys = rng.integers(0, 100, 200_000)
    x = rng.normal(0, 1, 200_000)
    df = vaex_tpu_torch.from_arrays(k=keys, x=x).to_device(cuda)
    df = df.categorize("k", labels=list(range(100)))
    before = ga.grid_additive.launches
    out = df.groupby("k", agg={"s": vaex_tpu_torch.agg.sum("x"), "c": "count"}, sort=True)
    assert ga.grid_additive.launches > before
    npt.assert_array_equal(out["c"].tolist(), np.bincount(keys, minlength=100))
    npt.assert_allclose(out["s"].tolist(), np.bincount(keys, x, minlength=100),
                        rtol=1e-9, atol=1e-9)


def _moment_inputs(n, G, kind, device, seed=0):
    """idx with ~1/8 of the rows dropping; var of an f64 column with NaN, or
    corr of that column and an int64 one."""
    g = torch.Generator(device=device).manual_seed(seed)
    idx = torch.randint(0, G + G // 8 + 1, (n,), generator=g, device=device,
                        dtype=torch.int32)
    x = torch.randn(n, generator=g, device=device, dtype=torch.float64) * 100
    x[::17] = float("nan")
    if kind == "var":
        return idx, [x], agg.VAR_TERMS
    y = torch.randint(1, 6, (n,), generator=g, device=device, dtype=torch.int64)
    return idx, [x, y], agg.CORR_TERMS


@pytest.mark.parametrize("name,G", [("b4", 1), ("b4", 42), ("b4", 213), ("b5", 300),
                                    ("b5", 10_609), ("b5", 100_003)])
@pytest.mark.parametrize("kind", ["var", "corr"])
@pytest.mark.parametrize("n", [0, 1, 300_007])
def test_moment_kernel_matches_plain(cuda, name, G, kind, n):
    kernel, plain = grid_plan.MOMENT_KERNELS[name], grid_plan.MOMENT_PLAIN[name]
    idx, bases, terms = _moment_inputs(n, G, kind, cuda)
    before = kernel.launches
    got = kernel(idx, bases, terms, G)
    assert kernel.launches == before + 1
    want = plain(idx, bases, terms, G)
    torch.cuda.synchronize()
    npt.assert_array_equal(got[0].cpu().numpy(), want[0].cpu().numpy())
    npt.assert_allclose(got[1].cpu().numpy(), want[1].cpu().numpy(), rtol=1e-9, atol=1e-9)


def test_b4_is_reproducible(cuda):
    idx, bases, terms = _moment_inputs(1_000_000, 103, "corr", cuda, seed=1)
    a = gm.grid_moments(idx, bases, terms, 103)
    b = gm.grid_moments(idx, bases, terms, 103)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_moments_past_the_windows_take_b3(cuda):
    """Past B5's windows the terms are formed as columns and B3 adds them."""
    G = 200_003  # 49 windows at 6 terms
    idx, bases, terms = _moment_inputs(300_007, G, "corr", cuda, seed=3)
    before = gp.grid_partition.launches
    name, counts, sums = grid_plan.moment_sums(idx, bases, terms, G)
    assert name == "b3" and gp.grid_partition.launches == before + 1
    want = gm.grid_moments_reference(idx, bases, terms, G)
    torch.cuda.synchronize()
    npt.assert_array_equal(counts.cpu().numpy(), want[0].cpu().numpy())
    npt.assert_allclose(sums.cpu().numpy(), want[1].cpu().numpy(), rtol=1e-9, atol=1e-9)


def test_moments_past_b3_raise_naming_a6(cuda):
    idx = torch.zeros(10, dtype=torch.int32, device=cuda)
    x = torch.zeros(10, dtype=torch.float64, device=cuda)
    with pytest.raises(NotImplementedError, match="ROADMAP queue A6"):
        grid_plan.moment_sums(idx, [x], agg.VAR_TERMS, 10 ** 9)


def test_moment_wrappers_raise_where_their_kernel_does_not_fit(cuda):
    idx = torch.zeros(10, dtype=torch.int32, device=cuda)
    x = torch.zeros(10, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="does not fit"):
        gm.grid_moments(idx, [x], agg.VAR_TERMS, 10 ** 5)
    with pytest.raises(ValueError, match="does not fit"):
        gm.grid_moments_window(idx, [x], agg.VAR_TERMS, 2 ** 30)


def test_statistics_on_the_card(cuda):
    """groupby std / corr / min / max on a card-resident frame, with a masked
    column (host-side, copied tile by tile): the masked form equals the NaN
    form, and the kernels the plan picks were launched."""
    rng = np.random.default_rng(4)
    n, K = 200_000, 100
    keys = rng.integers(0, K, n)
    x = rng.normal(0, 1, n)
    mask = rng.random(n) < 0.1
    v = rng.integers(1, 6, n)
    df = vaex_tpu_torch.from_arrays(k=keys, x=x, v=v, xn=np.where(mask, np.nan, x),
                                    xm=np.ma.MaskedArray(x, mask)).to_device(cuda)
    df = df.categorize("k", labels=list(range(K)))
    launches = {name: k.launches for name, k in grid_plan.MOMENT_KERNELS.items()}
    a = vaex_tpu_torch.agg
    out = df.groupby("k", agg={"sm": a.std("xm"), "sn": a.std("xn"), "rm": a.corr("xm", "v"),
                               "rn": a.corr("xn", "v"), "mm": a.max("xm"), "mn": a.max("xn")})
    [strategy] = df.executor.trace_log[-1]["strategies"]
    assert strategy["extremes"] == "b3x-direct"
    for name in strategy["moments"].split("+"):
        assert grid_plan.MOMENT_KERNELS[name].launches > launches[name]
    for m, nan in (("sm", "sn"), ("rm", "rn"), ("mm", "mn")):
        npt.assert_allclose(out[m].tolist(), out[nan].tolist(), rtol=1e-12, atol=1e-12)
    valid = ~mask
    want = [np.std(x[valid & (keys == k)]) for k in range(K)]
    npt.assert_allclose(out["sm"].tolist(), want, rtol=1e-9)
    npt.assert_allclose(df.std("x"), np.std(x), rtol=1e-9)
    npt.assert_array_equal(df.minmax("v"), [1, 5])


def test_extremes_on_the_card_keep_int64(cuda):
    idx = torch.tensor([0, 1, 1, 3, -1], dtype=torch.int32, device=cuda)
    col = torch.tensor([2 ** 62 + 1, 5, -(2 ** 62) - 3, 7, 0], dtype=torch.int64, device=cuda)
    got = ge.grid_extreme(ge.extreme_bins(idx, 3), col, 3, "min")
    assert got.dtype == torch.int64
    npt.assert_array_equal(got.cpu().numpy(),
                           [2 ** 62 + 1, -(2 ** 62) - 3, np.iinfo(np.int64).max])


def _extreme_inputs(n, G, device, seed=0):
    """idx with drops on both sides of [0, G); an int64 column past 2^53, an
    f64 one with NaN, +-inf and both zeros, an f32 one, a validity."""
    g = torch.Generator(device=device).manual_seed(seed)
    idx = torch.randint(-2, G + G // 8 + 1, (n,), generator=g, device=device, dtype=torch.int32)
    ints = torch.randint(-(2 ** 62), 2 ** 62, (n,), generator=g, device=device,
                         dtype=torch.int64)
    f64 = torch.randn(n, generator=g, device=device, dtype=torch.float64) * 100
    f64[::7] = float("nan")
    f64[1::11] = float("inf")
    f64[2::11] = float("-inf")
    f64[3::5] = 0.0
    f64[4::5] = -0.0
    f32 = torch.randn(n, generator=g, device=device, dtype=torch.float32)
    valid = torch.rand(n, generator=g, device=device) < 0.8
    return idx, [ints, f64, f32, f64, ints], ["min", "max", "min", "min", "max"], [
        None, None, None, valid, valid]


@pytest.mark.parametrize("G", [1, 103, 4_915, 4_916, 67_081, 1_000_003])
@pytest.mark.parametrize("n", [0, 1, 300_007])
def test_extreme_kernel_matches_plain(cuda, G, n):
    """B3x over the raw rows (five columns fit up to G = 4915) and over a
    partition, alone and with sums riding the partition: exact by value."""
    idx, cols, modes, valids = _extreme_inputs(n, G, cuda, seed=G)
    assert gp.extreme_direct_fits(G, len(cols)) == (G <= 4_915)
    before = gp.grid_partition_extreme.launches
    got, none_i, none_f = gp.grid_partition_extreme(idx, cols, modes, valids, G)
    summed = torch.randn(n, device=cuda, dtype=torch.float64)
    both, int_sums, float_sums = gp.grid_partition_extreme(idx, cols, modes, valids, G,
                                                           [cols[0]], [summed], True)
    assert gp.grid_partition_extreme.launches == before + 2
    assert none_i is None and none_f is None
    want = ge.grid_extreme_batch(idx, cols, modes, valids, G)
    want_i, want_f = gp.grid_partition_reference(idx, [cols[0]], [summed], G, True)
    torch.cuda.synchronize()
    for a, b, w in zip(got, both, want):
        assert a.dtype == b.dtype == w.dtype
        assert torch.equal(a, w) and torch.equal(b, w)
    assert torch.equal(int_sums, want_i)
    npt.assert_allclose(float_sums.cpu().numpy(), want_f.cpu().numpy(), rtol=1e-9, atol=1e-9)


def test_extreme_kernel_on_sorted_keys_and_one_hot_cell(cuda):
    """Pre-sorted keys (whole runs in one bucket) and every row in one cell
    of a wide grid."""
    G = 1_000_003
    idx, cols, modes, valids = _extreme_inputs(500_009, G, cuda, seed=5)
    for keys in (torch.sort(idx).values, torch.full_like(idx, 777_777)):
        got = gp.grid_partition_extreme(keys, cols, modes, valids, G)[0]
        want = ge.grid_extreme_batch(keys, cols, modes, valids, G)
        assert all(torch.equal(a, w) for a, w in zip(got, want))


def test_extreme_wrapper_raises_where_its_kernel_does_not_fit(cuda):
    idx = torch.zeros(10, dtype=torch.int32, device=cuda)
    x = torch.zeros(10, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="does not fit"):
        gp.grid_partition_extreme(idx, [x], ["min"], [None], 2 ** 30)
    with pytest.raises(ValueError, match="does not fit"):
        gp.grid_partition_extreme(idx, [x] * (gp.MAX_EXT + 1), ["min"] * (gp.MAX_EXT + 1),
                                  [None] * (gp.MAX_EXT + 1), 100)
    with pytest.raises(ValueError, match="contiguous"):
        gp.grid_partition_extreme(idx[::2], [x[::2]], ["min"], [None], 100)
    with pytest.raises(NotImplementedError, match="ROADMAP queue A6"):
        grid_plan.grid_extremes(idx, [x], ["min"], [None], 10 ** 9)


def test_binned_statistics_on_the_card(cuda):
    """The continuous-axis path on a card-resident frame against the same
    frame on the CPU device: limits, a 2-D count, the wide 2-D max on B3x,
    minmax over one axis, sums and extremes from one scatter, first, a
    datetime min."""
    rng = np.random.default_rng(6)
    n, K = 300_000, 250_000
    v = rng.uniform(0, 100, n)
    v[::97] = np.nan
    arrays = dict(x=rng.normal(0, 1, n), y=rng.normal(0, 1, n), v=v,
                  iv=rng.integers(-(2 ** 40), 2 ** 40, n), t=rng.permutation(n),
                  id6=rng.integers(0, K, n), k=rng.integers(0, 20, n),
                  d=(np.datetime64("2020-01-01") + rng.integers(0, 999, n).astype("m8[D]")))
    a = vaex_tpu_torch.agg
    frames = []
    for device in ("cpu", cuda):
        df = vaex_tpu_torch.from_arrays(**arrays).to_device(device)
        df = df.categorize("id6", labels=np.arange(K)).categorize("k", labels=list(range(20)))
        df._tile_rows = 120_000
        frames.append(df)
    cpu, card = frames
    calls = {
        "limits": (lambda df: df.limits(["x", "y"], "minmax"), None),
        "count": (lambda df: df.count(binby=["x", "y"], shape=64), {"additive": "b2"}),
        "max": (lambda df: df.max("v", binby=["x", "y"], shape=300), {"extremes": "b3x"}),
        "minmax": (lambda df: df.minmax(["v", "iv"], binby="x", shape=128),
                   {"extremes": "b3x-direct"}),
        "first": (lambda df: df.first("iv", "t", binby="k"), {"first": "b3x-direct"}),
        "datetime": (lambda df: df.minmax("d", binby="k"), {"extremes": "b3x-direct"}),
    }
    for name, (call, strategy) in calls.items():
        before = gp.grid_partition_extreme.launches
        got, want = call(card), call(cpu)
        assert np.asarray(got).dtype == np.asarray(want).dtype, name
        npt.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=name)
        if strategy is not None:
            assert card.executor.trace_log[-1]["strategies"] == [strategy], name
            assert card.executor.trace_log[-1]["device"].startswith("cuda")
            if "extremes" in strategy or "first" in strategy:
                assert gp.grid_partition_extreme.launches > before, name
    aggs = {"s": a.sum("iv"), "hi": a.max("iv"), "lo": a.min("v"), "n": "count"}
    before = gp.grid_partition_extreme.launches, gp.grid_partition.launches
    got, want = card.groupby("id6", agg=aggs), cpu.groupby("id6", agg=aggs)
    assert card.executor.trace_log[-1]["strategies"] == [
        {"additive": "b3", "extremes": "b3x", "scatter": "shared"}]
    # one call a tile computes both: B3's own wrapper is not called
    assert gp.grid_partition_extreme.launches == before[0] + 3
    assert gp.grid_partition.launches == before[1]
    for name in ("s", "hi", "lo", "n"):
        npt.assert_array_equal(got.evaluate(name), want.evaluate(name), err_msg=name)


def _probe_inputs(n, M, float_keys, device, seed=0):
    """M sorted unique keys and n rows with hits, misses, rows below the
    first and above the last key and, for floats, -0.0 and NaN."""
    g = torch.Generator(device=device).manual_seed(seed)
    keys = torch.unique(torch.randint(-3 * M, 3 * M + 1, (2 * M,), generator=g, device=device))
    keys = keys[torch.randperm(keys.numel(), generator=g, device=device)[:M]].sort().values
    x = torch.randint(-3 * M - 5, 3 * M + 6, (n,), generator=g, device=device)
    if float_keys:
        keys, x = keys.to(torch.float64) * 0.5, x.to(torch.float64) * 0.5
        x[::7] = -0.0
        x[3::11] = float("nan")
    if n:
        x[::5] = keys[torch.randint(0, keys.numel(), (len(x[::5]),), generator=g, device=device)]
    return keys, x


@pytest.mark.parametrize("float_keys", [False, True])
@pytest.mark.parametrize("M", [1, 64, 500, 2048, 16_384, probe.MAX_KEYS])
@pytest.mark.parametrize("n", [0, 1, 300_007])
def test_probe_kernel_matches_plain(cuda, float_keys, M, n):
    keys, x = _probe_inputs(n, M, float_keys, cuda)
    assert 1 <= keys.numel() <= M
    narrow = torch.float32 if float_keys else torch.int32
    for rows in (x, x.to(narrow), x.to(torch.float16 if float_keys else torch.int8)):
        before = probe.probe.launches
        got = probe.probe(keys, rows)
        assert probe.probe.launches == before + 1
        want = probe.probe_reference(keys, rows)
        torch.cuda.synchronize()
        assert got.dtype == torch.int32
        npt.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
        if float_keys and n:
            assert (got[torch.isnan(rows)] == -1).all()  # NaN finds nothing


def test_probe_finds_zero_for_negative_zero(cuda):
    keys = torch.tensor([-1.5, 0.0, 2.0], dtype=torch.float64, device=cuda)
    x = torch.tensor([-0.0, 0.0, float("nan"), 2.0, -2.0, 9.0], dtype=torch.float64, device=cuda)
    assert probe.probe(keys, x).tolist() == [1, 1, -1, 2, -1, -1]


@pytest.mark.parametrize("float_keys", [False, True])
@pytest.mark.parametrize("M", [probe.MAX_KEYS + 1, 50_000, 1_000_003])
@pytest.mark.parametrize("n", [0, 1, 300_007])
def test_wide_probe_kernel_matches_plain(cuda, float_keys, M, n):
    keys, x = _probe_inputs(n, M, float_keys, cuda)
    assert keys.numel() > probe.MAX_KEYS
    narrow = torch.float32 if float_keys else torch.int32
    for rows in (x, x.to(narrow)):
        before = probe.probe.wide_launches
        got = probe.probe(keys, rows)
        assert probe.probe.wide_launches == before + 1
        want = probe.probe_reference(keys, rows)
        torch.cuda.synchronize()
        npt.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.parametrize("top", [1, 2, 3, 8, 50])
@pytest.mark.parametrize("M", [1, 2, 3, 5, 17, 64, 129, 1000])
def test_wide_probe_kernel_at_every_sample_distance(cuda, monkeypatch, M, top):
    """The two-level kernel on small sets (the shared-memory kernel switched
    off), so that few samples, a last stretch shorter than the others and a
    lone key are all searched."""
    monkeypatch.setattr(probe, "MAX_KEYS", 0)
    monkeypatch.setattr(probe, "TOP_KEYS", top)
    for float_keys in (False, True):
        keys, x = _probe_inputs(10_007, M, float_keys, cuda, seed=M + top)
        before = probe.probe.wide_launches
        got = probe.probe(keys, x)
        assert probe.probe.wide_launches == before + 1
        npt.assert_array_equal(got.cpu().numpy(), probe.probe_reference(keys, x).cpu().numpy())


def test_probe_wrapper_raises_past_the_kernel(cuda):
    keys = torch.arange(4, device=cuda)
    with pytest.raises(ValueError, match="does not fit"):
        probe.probe(keys[:0], keys)


def test_isin_of_a_wide_set_on_the_card(cuda):
    """isin of 50 000 ids, a set past the shared-memory kernel: the pass
    records the two-level route and launches it."""
    rng = np.random.default_rng(9)
    k = rng.integers(0, 400_000, 300_000)
    values = rng.choice(400_000, 50_000, replace=False)
    df = vaex_tpu_torch.from_arrays(k=k).to_device(cuda)
    before = probe.probe.wide_launches
    assert int(df.count(selection=df.k.isin(values))) == int(np.isin(k, values).sum())
    assert df.executor.trace_log[-1]["probe"] == "b6-wide"
    assert probe.probe.wide_launches > before


def test_set_paths_on_the_card(cuda):
    """isin as a selection and a filter, a raw-key groupby through the set
    grouper and through the dense one, unique and nunique, on a card-resident
    frame: the probe kernel is launched and the answers are numpy's."""
    rng = np.random.default_rng(6)
    n = 200_000
    k = rng.integers(0, 300, n)
    wide = k * 1_000_003
    x = rng.normal(0, 1, n)
    df = vaex_tpu_torch.from_arrays(k=k, wide=wide, x=x).to_device(cuda)
    values = rng.choice(300, 40, replace=False)
    before = probe.probe.launches
    assert int(df.count(selection=df.k.isin(values))) == int(np.isin(k, values).sum())
    assert df.executor.trace_log[-1]["probe"] == "b6" and probe.probe.launches > before
    out = df[df.k.isin(values)].groupby(
        "wide", agg={"c": "count", "s": vaex_tpu_torch.agg.sum("x")})
    keep = np.isin(k, values)
    want_keys, want_counts = np.unique(wide[keep], return_counts=True)
    npt.assert_array_equal(out["wide"].tolist(), want_keys)
    npt.assert_array_equal(out["c"].tolist(), want_counts)
    npt.assert_allclose(out["s"].tolist(), [x[keep & (wide == w)].sum() for w in want_keys],
                        rtol=1e-9, atol=1e-9)
    dense = df.groupby("k", agg={"c": "count"})
    assert df.executor.trace_log[-1]["probe"] is None
    npt.assert_array_equal(dense["c"].tolist(), np.bincount(k, minlength=300))
    assert df.wide.nunique() == 300 and df.unique("k") == list(range(300))


def test_float_and_masked_keys_on_the_card(cuda):
    """Set groupers over a float key with NaN, -0.0 and infinities and over
    a masked int key (tiled from the host into the pass), and a combined
    grouper over both, on the card: the groups and counts are numpy's."""
    rng = np.random.default_rng(8)
    n = 100_000
    f = rng.choice([1.5, -0.0, 0.0, np.nan, np.inf, -np.inf, 7.25], n)
    m = np.ma.MaskedArray(rng.integers(0, 9, n), rng.random(n) < 0.1)
    df = vaex_tpu_torch.from_arrays(f=f, m=m, x=rng.normal(0, 1, n)).to_device(cuda)
    out = df.groupby("f", agg={"c": "count"}, sort=True)
    assert df.executor.trace_log[-1]["probe"] == "b6"
    finite = f[~np.isnan(f)]
    keys, counts = np.unique(finite, return_counts=True)
    npt.assert_array_equal(out["f"].tolist()[:-1], keys)
    assert np.isnan(out["f"].tolist()[-1])
    npt.assert_array_equal(out["c"].tolist(), [*counts, int(np.isnan(f).sum())])
    out = df.groupby("m", agg={"c": "count"}, sort=True)
    keys, counts = np.unique(m.compressed(), return_counts=True)
    assert out["m"].tolist() == [*keys.tolist(), None]
    npt.assert_array_equal(out["c"].tolist(), [*counts, int(m.mask.sum())])
    both = df.groupby(["f", "m"], agg={"c": "count"}, assume_sparse=True)
    assert int(np.sum(both["c"].tolist())) == n
    assert len(both) == len(df.groupby(["f", "m"], agg={"c": "count"}, assume_sparse=False))
