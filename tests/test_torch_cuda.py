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
    assert strategy in ("b2", "b3", "b3-l2")
    assert grid_plan.KERNELS[strategy].launches > launches[strategy]
    npt.assert_array_equal(out["c"].tolist(), np.bincount(keys, minlength=K))
    npt.assert_allclose(out["s"].tolist(), np.bincount(keys, x, minlength=K),
                        rtol=1e-9, atol=1e-9)


WIDE = {"b2": (gw.grid_window, gw.grid_window_reference),
        "b3": (gp.grid_partition, gp.grid_partition_reference),
        "b3-l2": (gp.grid_resident, gp.grid_resident_reference)}


@pytest.mark.parametrize("name", ["b2", "b3", "b3-l2"])
@pytest.mark.parametrize("G", [257, 10_609, 100_003, 1_000_003])
@pytest.mark.parametrize("n", [0, 1, 300_007])
def test_wide_kernel_matches_plain(cuda, name, G, n):
    kernel, plain = WIDE[name]
    idx, ints, floats = _inputs(n, G, cuda)
    floats[::17] = float("nan")
    f32 = floats.to(torch.float32)
    if name == "b2" and not gw.fits(G, 4, True):  # past B2's cluster of 8 windows
        with pytest.raises(ValueError, match="does not fit"):
            kernel(idx, [ints], [floats, f32], G, count=True)
        return
    before = kernel.launches
    got = kernel(idx, [ints], [floats, f32], G, count=True)
    assert kernel.launches == before + 1
    want = plain(idx, [ints], [floats, f32], G, count=True)
    torch.cuda.synchronize()
    npt.assert_array_equal(got[0].cpu().numpy(), want[0].cpu().numpy())
    npt.assert_allclose(got[1].cpu().numpy(), want[1].cpu().numpy(), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("C", [1, 2, 3, 4])
def test_window_cluster_edges_match_plain(cuda, C):
    """B2 at G = k * W and k * W + 1 for every cluster size k: C = 1
    (count), 2 (+ int64), 3 (+ f64 with NaN), 4 (+ f32); one launch per
    call; past the cluster it raises."""
    W = gw.cluster_width(C, True)
    n = 200_003
    for k in range(1, gw.MAX_CLUSTER + 1):
        for G in (k * W, k * W + 1):
            idx, ints, floats = _inputs(n, G, cuda, seed=k)
            floats[::17] = float("nan")
            int_cols = [ints] if C >= 2 else []
            float_cols = ([floats] if C >= 3 else []) + ([floats.float()] if C == 4 else [])
            if not gw.fits(G, C, True):
                with pytest.raises(ValueError, match="does not fit"):
                    gw.grid_window(idx, int_cols, float_cols, G, True)
                continue
            before = gw.grid_window.launches
            got = gw.grid_window(idx, int_cols, float_cols, G, True)
            assert gw.grid_window.launches == before + 1
            want = gw.grid_window_reference(idx, int_cols, float_cols, G, True)
            torch.cuda.synchronize()
            npt.assert_array_equal(got[0].cpu().numpy(), want[0].cpu().numpy())
            npt.assert_allclose(got[1].cpu().numpy(), want[1].cpu().numpy(), rtol=1e-9,
                                atol=1e-9)


def test_window_sums_carry_into_the_high_word(cuda):
    """The local int64 adds, two 32-bit adds, carry into the high word,
    beside the native 64-bit adds other CTAs of the cluster make into the
    same word."""
    n, W = 300_007, gw.cluster_width(2, True)
    G = 3 * W
    g = torch.Generator(device=cuda).manual_seed(5)
    idx = torch.randint(0, 4, (n,), generator=g, device=cuda, dtype=torch.int32) * W
    for v in (torch.full((n,), 2 ** 32 - 1, device=cuda), torch.full((n,), -1, device=cuda),
              torch.randint(-(2 ** 63), 2 ** 63 - 1, (n,), generator=g, device=cuda)):
        got = gw.grid_window(idx, [v], [], G, True)[0]
        want = gw.grid_window_reference(idx, [v], [], G, True)[0]
        assert torch.equal(got, want)


@pytest.mark.parametrize("G", [103, 1_000_003])
def test_ordered_kernels_are_reproducible(cuda, G):
    """B1 adds in an order fixed by its launch: ints and floats equal run to
    run.  B3 (both routes, G = 1 000 003) adds with shared-memory and global
    atomics, as B2 does: its ints are equal run to run, its floats within
    rtol 1e-12 (the order in which warps and CTAs reach a word varies)."""
    idx, ints, floats = _inputs(1_000_000, G, cuda, seed=1)
    for kernel in (ga.grid_additive,) if G == 103 else (gp.grid_partition, gp.grid_resident):
        a = kernel(idx, [ints], [floats], G, count=True)
        b = kernel(idx, [ints], [floats], G, count=True)
        assert torch.equal(a[0], b[0])
        if G == 103:
            assert torch.equal(a[1], b[1])
        else:
            npt.assert_allclose(a[1].cpu().numpy(), b[1].cpu().numpy(), rtol=1e-12, atol=1e-9)


def _skewed(kind, n, G, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    if kind == "single":
        idx = torch.full((n,), G // 3, device=device, dtype=torch.int32)
    elif kind == "zipf":
        cdf = torch.cumsum(torch.arange(1, G + 1, device=device, dtype=torch.float64) ** -1.1, 0)
        u = torch.rand(n, generator=g, device=device, dtype=torch.float64) * cdf[-1]
        rank = torch.searchsorted(cdf, u).clamp_(max=G - 1)
        idx = torch.randperm(G, generator=g, device=device)[rank].to(torch.int32)
    else:
        idx = torch.sort(torch.randint(0, G + G // 8, (n,), generator=g, device=device,
                                       dtype=torch.int32)).values
    idx[::17] = -1
    return idx


@pytest.mark.parametrize("kind", ["sorted", "single", "zipf"])
@pytest.mark.parametrize("route", ["b3", "b3-l2"])
def test_partition_takes_sorted_keys(cuda, route, kind):
    """Pre-sorted keys, one key and a Zipf(1.1) draw on both routes of B3:
    every row of a long run lands in one bucket; the counts size the
    buckets, so nothing overflows or demotes, and the lanes of a warp that
    share a bin are combined before the atomics."""
    G = 1_000_003
    kernel, plain = WIDE[route]
    _, ints, floats = _inputs(2_000_000, G, cuda, seed=2)
    idx = _skewed(kind, 2_000_000, G, cuda, seed=3)
    got = kernel(idx, [ints], [floats], G, count=True)
    want = plain(idx, [ints], [floats], G, count=True)
    torch.cuda.synchronize()
    npt.assert_array_equal(got[0].cpu().numpy(), want[0].cpu().numpy())
    npt.assert_allclose(got[1].cpu().numpy(), want[1].cpu().numpy(), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("kind", ["sorted", "single", "zipf"])
def test_extremes_over_a_partition_take_skewed_keys(cuda, kind):
    G, n = 1_000_003, 2_000_000
    _, ints, floats = _inputs(n, G, cuda, seed=4)
    floats[::13] = float("nan")
    idx = _skewed(kind, n, G, cuda, seed=5)
    cols, modes, valids = [ints, floats], ["min", "max"], [None, None]
    before = gp.grid_partition.launches
    got, int_sums, float_sums = gp.grid_partition_extreme(idx, cols, modes, valids, G, [ints],
                                                          [floats], True)
    assert gp.grid_partition.launches == before + 1  # B3's kernels ran for the sums
    want = ge.grid_extreme_batch(idx, cols, modes, valids, G)
    want_i, want_f = gp.grid_partition_reference(idx, [ints], [floats], G, True)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(int_sums, want_i)
    npt.assert_allclose(float_sums.cpu().numpy(), want_f.cpu().numpy(), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("target", ["int8", "int32", "int64", "uint8"])
def test_astype_float_to_int_agrees_between_cpu_and_card(cuda, target):
    x = np.array([np.nan, np.inf, -np.inf, 1e30, -1e30, 300.7, -300.7, 2147483648.0, 9.3e18,
                  -9.3e18, 0.0, 1.5, -1.5])
    frames = [vaex_tpu_torch.from_arrays(x=x).to_device(device) for device in ("cpu", cuda)]
    host, card = (df.evaluate(f"astype(x, '{target}')") for df in frames)
    npt.assert_array_equal(card, host)
    info = np.iinfo(target)
    assert card[0] == 0 and card[1] == info.max and card[2] == info.min


def test_plan_routes_each_grid_to_its_kernel_on_the_card(cuda):
    idx = torch.zeros(1000, dtype=torch.int32, device=cuda)
    for G, name in ((103, "b1"), (10_609, "b2"), (1_000_003, "b3-l2"), (30_000_003, "b3")):
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
    """Bit-equal floats run to run on both routes of B4: var on the lane
    route at G = 1 and 103, corr on the warp route at G = 103."""
    for kind, G, route in (("var", 1, gm.LANE), ("var", 103, gm.LANE), ("corr", 103, gm.WARP)):
        idx, bases, terms = _moment_inputs(1_000_000, G, kind, cuda, seed=1)
        a = gm.grid_moments(idx, bases, terms, G)
        assert gm.grid_moments.last_route == route
        b = gm.grid_moments(idx, bases, terms, G)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def _lane_edge(compiled_set, n_float):
    """The widest grid on which B4 takes its lane route."""
    warps = gm.LANE_MIN_WARPS[compiled_set]
    return gm.CLUSTER_SMEM // (warps * gm.lane_warp_bytes(1, 1, n_float))


@pytest.mark.parametrize("kind", ["var", "corr", "covar"])
@pytest.mark.parametrize("at", ["g1", "g1 no idx", "103", "edge", "past"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.int64])
def test_b4_lane_route_matches_plain(cuda, kind, at, dtype):
    """B4's lane route at G = 1 (a compiled set's terms held in registers;
    with and without an index), 103 and the last G it takes, and the warp
    route one bin past it, for var's and corr's compiled sets and covar's
    run-time tables, on f64, f32 and int64 bases starting at an odd row,
    NaN among the floats: counts exact, floats to rtol 1e-9 and bit-equal
    run to run."""
    terms = {"var": agg.VAR_TERMS, "corr": agg.CORR_TERMS, "covar": agg.COVAR_TERMS}[kind]
    n_bases = 1 if kind == "var" else 2
    edge = _lane_edge(gm.compiled(n_bases, terms), sum(t[0] >= 0 for t in terms))
    G = {"g1": 1, "g1 no idx": 1, "103": 103, "edge": edge, "past": edge + 1}[at]
    n = 300_007
    g = torch.Generator(device=cuda).manual_seed(G)
    idx = torch.randint(-2, G + G // 8 + 1, (n + 1,), generator=g, device=cuda,
                        dtype=torch.int32)[1:]
    bases = []
    for j in range(n_bases):
        if dtype == torch.int64:
            b = torch.randint(-1000, 1000, (n + 1,), generator=g, device=cuda)
        else:
            b = torch.randn(n + 1, generator=g, device=cuda, dtype=dtype) * 100
            b[j::37 + j] = float("nan")
        bases.append(b[1:])
    if at == "g1 no idx":
        idx = None
    got = gm.grid_moments(idx, bases, terms, G)
    assert gm.grid_moments.last_route == (gm.LANE if G <= edge else gm.WARP)
    again = gm.grid_moments(idx, bases, terms, G)
    want = gm.grid_moments_reference(idx, bases, terms, G)
    torch.cuda.synchronize()
    npt.assert_array_equal(got[0].cpu().numpy(), want[0].cpu().numpy())
    npt.assert_allclose(got[1].cpu().numpy(), want[1].cpu().numpy(), rtol=1e-9, atol=1e-9)
    assert torch.equal(got[1], again[1])


def test_std_without_binby_takes_b4s_lane_route(cuda):
    rng = np.random.default_rng(9)
    x = rng.normal(0, 1, 500_000)
    x[::101] = np.nan
    df = vaex_tpu_torch.from_arrays(x=x).to_device(cuda)
    before = gm.grid_moments.launches
    got = df.std("x")
    assert gm.grid_moments.launches == before + 1 and gm.grid_moments.last_route == gm.LANE
    assert df.executor.trace_log[-1]["strategies"] == [{"moments": "b4"}]
    npt.assert_allclose(got, np.nanstd(x), rtol=1e-9)


@pytest.mark.parametrize("G,route", [(200_003, "b3-l2"), (1_000_003, "b3")])
def test_moments_past_the_windows_take_b3(cuda, G, route):
    """Past B5's windows the terms are formed as columns and B3 adds them: its
    resident route while six channels of G bins stay in L2, its partition
    past that."""
    idx, bases, terms = _moment_inputs(300_007, G, "corr", cuda, seed=3)
    before = grid_plan.KERNELS[route].launches
    name, counts, sums = grid_plan.moment_sums(idx, bases, terms, G)
    assert name == route and grid_plan.KERNELS[route].launches == before + 1
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
    partition, alone and with sums riding the partition, and on its resident
    route: exact by value."""
    idx, cols, modes, valids = _extreme_inputs(n, G, cuda, seed=G)
    assert gp.extreme_direct_fits(G, len(cols)) == (G <= 4_915)
    before = gp.grid_partition_extreme.launches, gp.grid_resident_extreme.launches
    got, none_i, none_f = gp.grid_partition_extreme(idx, cols, modes, valids, G)
    summed = torch.randn(n, device=cuda, dtype=torch.float64)
    both, int_sums, float_sums = gp.grid_partition_extreme(idx, cols, modes, valids, G,
                                                           [cols[0]], [summed], True)
    resident = gp.grid_resident_extreme(idx, cols, modes, valids, G)
    assert gp.grid_partition_extreme.launches == before[0] + 2
    assert gp.grid_resident_extreme.launches == before[1] + 1
    assert none_i is None and none_f is None
    want = ge.grid_extreme_batch(idx, cols, modes, valids, G)
    want_i, want_f = gp.grid_partition_reference(idx, [cols[0]], [summed], G, True)
    torch.cuda.synchronize()
    for a, b, r, w in zip(got, both, resident, want):
        assert a.dtype == b.dtype == r.dtype == w.dtype
        assert torch.equal(a, w) and torch.equal(b, w) and torch.equal(r, w)
    assert torch.equal(int_sums, want_i)
    npt.assert_allclose(float_sums.cpu().numpy(), want_f.cpu().numpy(), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("keys", ["uniform", "zipf", "sorted", "single"])
@pytest.mark.parametrize("valid", [False, True])
def test_resident_extreme_matches_plain(cuda, keys, valid):
    """b3x-l2 on uniform, Zipf(1.1), sorted and one-key draws: int64, f64
    and f32 columns, min and max, with and without a validity, NaN rows, -0.0
    beside 0.0, empty cells holding the identity: exact by value and dtype."""
    G, n = 200_003, 400_009
    idx, cols, modes, valids = _extreme_inputs(n, G, cuda, seed=11)
    if keys != "uniform":
        idx = _skewed(keys, n, G, cuda, seed=12)
    cols, modes = cols[:3] + cols[:3], modes[:3] + ["max", "min", "max"]
    mask = valids[3] if valid else None
    valids = [mask] * len(cols)
    got = gp.grid_resident_extreme(idx, cols, modes, valids, G)
    want = ge.grid_extreme_batch(idx, cols, modes, valids, G)
    torch.cuda.synchronize()
    for g, w, c, m in zip(got, want, cols, modes):
        assert g.dtype == w.dtype and torch.equal(g, w)
    empty = torch.bincount(idx[(idx >= 0) & (idx < G)].to(torch.int64), minlength=G) == 0
    assert empty.any()  # the draws leave cells empty: each holds the identity
    for g, c, m in zip(got, cols, modes):
        assert (g[empty] == ge.identity(c.dtype, m)).all()
    # both signs of zero in one cell: by value the min and max are 0
    zeros = torch.tensor([0.0, -0.0, -0.0, 0.0], dtype=torch.float64, device=cuda)
    at = torch.tensor([1, 1, 2, 2], dtype=torch.int32, device=cuda)
    lo, hi = gp.grid_resident_extreme(at, [zeros, zeros], ["min", "max"], [None, None], 3)
    assert lo.tolist()[1:] == [0.0, 0.0] and hi.tolist()[1:] == [0.0, 0.0]


@pytest.mark.parametrize("E", [1, 2, 3, 8])
def test_resident_extreme_at_the_budgets_edge(cuda, E):
    """The widest grid of keys the plan keeps on b3x-l2 for E columns, and
    one bin past it (the plan's partition), both exact; the cell's E keys lie
    together (gp.resident_stride)."""
    G = gp.RESIDENT_BYTES // (8 * gp.resident_stride(E))
    assert grid_plan.extreme_strategy(10 ** 8, G, E) == "b3x-l2"
    assert grid_plan.extreme_strategy(10 ** 8, G + 1, E) == "b3x"
    n = 1_000_003
    g = torch.Generator(device=cuda).manual_seed(E)
    idx = torch.randint(-1, G + 2, (n,), generator=g, device=cuda, dtype=torch.int32)
    cols = [torch.randn(n, generator=g, device=cuda, dtype=torch.float64) for _ in range(E)]
    modes = ["min" if e % 2 else "max" for e in range(E)]
    for width in (G, G + 1):
        got = gp.grid_resident_extreme(idx, cols, modes, [None] * E, width)
        want = ge.grid_extreme_batch(idx, cols, modes, [None] * E, width)
        assert all(torch.equal(a, w) for a, w in zip(got, want))


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
        "max": (lambda df: df.max("v", binby=["x", "y"], shape=300), {"extremes": "b3x-l2"}),
        "max past L2": (lambda df: df.max("v", binby=["x", "y"], shape=2000),
                        {"extremes": "b3x"}),
        "minmax": (lambda df: df.minmax(["v", "iv"], binby="x", shape=128),
                   {"extremes": "b3x-direct"}),
        "first": (lambda df: df.first("iv", "t", binby="k"), {"first": "b3x-direct"}),
        "datetime": (lambda df: df.minmax("d", binby="k"), {"extremes": "b3x-direct"}),
    }
    kernels = {"b3x": gp.grid_partition_extreme, "b3x-direct": gp.grid_partition_extreme,
               "b3x-l2": gp.grid_resident_extreme}
    for name, (call, strategy) in calls.items():
        before = {route: kernel.launches for route, kernel in kernels.items()}
        got, want = call(card), call(cpu)
        assert np.asarray(got).dtype == np.asarray(want).dtype, name
        npt.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=name)
        if strategy is not None:
            assert card.executor.trace_log[-1]["strategies"] == [strategy], name
            assert card.executor.trace_log[-1]["device"].startswith("cuda")
            route = strategy.get("extremes", strategy.get("first"))
            if route is not None:
                assert kernels[route].launches > before[route], name
    # one extreme column beside sums on b3-l2 shares the sums' scatter: one
    # call a tile computes both, B3's kernels running inside B3x's call
    aggs = {"s": a.sum("iv"), "hi": a.max("iv"), "n": "count"}
    before = gp.grid_partition_extreme.launches, gp.grid_partition.launches
    got, want = card.groupby("id6", agg=aggs), cpu.groupby("id6", agg=aggs)
    assert card.executor.trace_log[-1]["strategies"] == [
        {"additive": "b3", "extremes": "b3x", "scatter": "shared"}]
    assert gp.grid_partition_extreme.launches == before[0] + 3
    assert gp.grid_partition.launches == before[1] + 3
    for name in ("s", "hi", "n"):
        npt.assert_array_equal(got.evaluate(name), want.evaluate(name), err_msg=name)
    # two take b3x-l2 apart from the sums on b3-l2
    aggs["lo"] = a.min("v")
    before = gp.grid_resident_extreme.launches, gp.grid_resident.launches
    got, want = card.groupby("id6", agg=aggs), cpu.groupby("id6", agg=aggs)
    assert card.executor.trace_log[-1]["strategies"] == [
        {"additive": "b3-l2", "extremes": "b3x-l2"}]
    assert gp.grid_resident_extreme.launches == before[0] + 3
    assert gp.grid_resident.launches == before[1] + 3
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
    """Sets past ``MAX_KEYS``: an int set whose range is below 2^32 on
    4-byte keys (``b6`` to twice the keys), spread past 2^32 on 8-byte keys,
    and float sets, each on the route of its size."""
    for spread in ((1, 1_000_003) if not float_keys else (1,)):
        keys, x = _probe_inputs(n, M, float_keys, cuda)
        keys, x = keys * spread, x * spread
        assert keys.numel() > probe.MAX_KEYS
        tree = probe.build_tree(keys)
        assert (tree.kind == probe.KIND_NARROW) == (not float_keys and spread == 1)
        assert tree.route == probe.probe_route(keys.numel(), tree.key_bytes)
        narrow = torch.float32 if float_keys else torch.int32
        for rows in (x, x.to(narrow)) if spread == 1 else (x,):
            before = probe.probe.launches, probe.probe.wide_launches
            got = probe.probe(keys, rows, tree)
            assert probe.probe.launches == before[0] + 1
            assert probe.probe.wide_launches == before[1] + (tree.route == probe.B6_WIDE)
            want = probe.probe_reference(keys, rows)
            torch.cuda.synchronize()
            npt.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.parametrize("top", [0, 1, 2, 10])
@pytest.mark.parametrize("M", [1, 2, 3, 7, 8, 9, 17, 64, 81, 1000, 30_000])
def test_wide_probe_kernel_at_every_sample_distance(cuda, monkeypatch, M, top):
    """The b6-wide route on small sets (``MAX_KEYS`` switched off), with
    ``top`` nodes' worth of shared memory, so that levels in shared memory,
    levels in global memory, a padded last node and a lone key are all
    searched, for int, 4-byte and float keys."""
    for name in ("MAX_KEYS", "NARROW_MAX_KEYS"):
        monkeypatch.setattr(probe, name, 0)
    monkeypatch.setattr(probe, "WIDE_SMEM", top * probe.LINE_BYTES)
    for float_keys, narrow in ((False, False), (False, True), (True, False)):
        keys, x = _probe_inputs(10_007, M, float_keys, cuda, seed=M + top)
        tree = probe.build_tree(keys, narrow=narrow)
        assert tree.route == probe.B6_WIDE and tree.smem <= top * probe.LINE_BYTES
        before = probe.probe.wide_launches
        got = probe.probe(keys, x, tree)
        assert probe.probe.wide_launches == before + 1
        npt.assert_array_equal(got.cpu().numpy(), probe.probe_reference(keys, x).cpu().numpy())


@pytest.mark.parametrize("narrow", [False, True])
@pytest.mark.parametrize("M", [1, 3, 4, 5, 15, 16, 17, 500, 50_000])
def test_probe_layouts_match_plain(cuda, narrow, M):
    """Both key widths (4-byte keys forced on or off) on the route of the
    set's size give the plain ordinals, for 8- and 4-byte rows."""
    keys, x = _probe_inputs(100_003, M, False, cuda, seed=M)
    tree = probe.build_tree(keys, narrow=narrow)
    assert (tree.kind == probe.KIND_NARROW) == narrow
    for rows in (x, x.to(torch.int32)):
        npt.assert_array_equal(probe.probe(keys, rows, tree).cpu().numpy(),
                               probe.probe_reference(keys, rows).cpu().numpy())


@pytest.mark.parametrize("float_keys", [False, True])
def test_probe_at_the_sentinel_edge_keys(cuda, float_keys):
    """INT64_MIN / INT64_MAX and -inf / +inf are keys the pad never
    matches; -0.0 finds 0.0; NaN finds nothing; on both routes."""
    if float_keys:
        keys = torch.tensor([-np.inf, -1.5, 0.0, 2.0, np.finfo(np.float64).max, np.inf],
                            dtype=torch.float64, device=cuda)
        x = torch.tensor([np.inf, -np.inf, -0.0, np.nan, 2.0, 1.0, np.finfo(np.float64).max],
                         dtype=torch.float64, device=cuda)
    else:
        i64 = np.iinfo(np.int64)
        keys = torch.tensor([i64.min, -5, 0, 7, i64.max - 1, i64.max], device=cuda)
        x = torch.tensor([i64.max, i64.min, i64.max - 1, 3, 7, 0, i64.min + 1], device=cuda)
    for M in (keys.numel(), 3, 2, 1):
        k = keys[-M:]
        want = probe.probe_reference(k, x).cpu().numpy()
        npt.assert_array_equal(probe.probe(k, x).cpu().numpy(), want)
        with pytest.MonkeyPatch.context() as mp:  # the b6-wide route
            mp.setattr(probe, "MAX_KEYS", 0)
            npt.assert_array_equal(probe.probe(k, x).cpu().numpy(), want)


@pytest.mark.parametrize("span", [2 ** 32 - 1, 2 ** 32])
def test_probe_of_an_int_set_at_the_4_byte_range(cuda, span):
    lo = -(2 ** 40)
    g = torch.Generator(device=cuda).manual_seed(span % 97)
    inner = torch.randperm(2 ** 20, generator=g, device=cuda)[:40_000] * 4093 + 1
    keys = torch.cat([torch.tensor([0, span], device=cuda), inner]).unique() + lo
    x = torch.cat([keys, keys + 1, keys - 1,
                   torch.tensor([lo + 2 ** 32, lo - 2 ** 32, lo + 2 ** 33], device=cuda)])
    tree = probe.build_tree(keys)
    assert (tree.kind == probe.KIND_NARROW) == (span < 2 ** 32)
    assert tree.route == probe.probe_route(keys.numel(), tree.key_bytes)
    npt.assert_array_equal(probe.probe(keys, x, tree).cpu().numpy(),
                           probe.probe_reference(keys, x).cpu().numpy())


def test_probe_wrapper_raises_past_the_kernel(cuda):
    keys = torch.arange(4, device=cuda)
    with pytest.raises(ValueError, match="does not fit"):
        probe.probe(keys[:0], keys)


def test_isin_of_a_wide_set_on_the_card(cuda):
    """isin of 50 000 ids: over a range below 2^32 the set takes b6 on
    4-byte keys; spread past 2^32 it takes b6-wide, and the pass records
    the route it launched."""
    rng = np.random.default_rng(9)
    k = rng.integers(0, 400_000, 300_000)
    values = rng.choice(400_000, 50_000, replace=False)
    for spread, route in ((1, "b6"), (1_000_003, "b6-wide")):
        df = vaex_tpu_torch.from_arrays(k=k * spread).to_device(cuda)
        before = probe.probe.launches, probe.probe.wide_launches
        assert int(df.count(selection=df.k.isin(values * spread))) == \
            int(np.isin(k, values).sum())
        assert df.executor.trace_log[-1]["probe"] == route
        assert probe.probe.launches > before[0]
        assert (probe.probe.wide_launches > before[1]) == (route == "b6-wide")


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


def test_host_frame_runs_on_the_card(cuda, monkeypatch):
    """A frame of host arrays that no one staged runs its passes on the
    card (``settings.DEVICE``), its tiles copied there; staged on the CPU it
    stays there."""
    from vaex_tpu_torch import settings
    monkeypatch.setattr(settings, "DEVICE", "cuda")
    rng = np.random.default_rng(12)
    x = rng.normal(0, 1, 100_000)
    df = vaex_tpu_torch.from_arrays(x=x)
    npt.assert_allclose(df.sum("x"), x.sum(), rtol=1e-9)
    assert df.executor.trace_log[-1]["device"].startswith("cuda")
    cpu = df.to_device("cpu")
    npt.assert_allclose(cpu.sum("x"), x.sum(), rtol=1e-9)
    assert cpu.executor.trace_log[-1]["device"] == "cpu"


def test_first_on_the_card_keeps_int64_orders(cuda):
    """first with int64 orders past 2^53 that differ by 1, and a cell whose
    only order is INT64_MAX (B3x's image of it is its empty-cell mark):
    numpy's argmin-based answer, on the direct route of B3x."""
    k = np.array([0, 0, 1, 1, 2, 3, 3], np.int64)
    i64 = np.iinfo(np.int64)
    o = np.array([2 ** 60 + 1, 2 ** 60, 5, 4, i64.max, i64.max, i64.max - 1], np.int64)
    v = np.arange(1.0, 8.0)
    for order in (o, o.view("M8[ns]")):
        df = vaex_tpu_torch.from_arrays(k=k, o=order, v=v).to_device(cuda)
        df = df.categorize("k", labels=list(range(5)))
        npt.assert_array_equal(df.first("v", "o", binby="k"), [2.0, 4.0, 5.0, 7.0, 0.0])
        assert df.executor.trace_log[-1]["strategies"] == [{"first": "b3x-direct"}]


# (kind, G) where B5's parts change: a group of terms one bin past what
# fits splits, one window one bin past a float plane of 227 KiB
B5_EDGES = [("var", 11_622), ("var", 11_623), ("var", 29_056), ("var", 29_057),
            ("corr", 5_282), ("corr", 5_283), ("corr", 9_686), ("corr", 19_370),
            ("corr", 19_371), ("corr", 29_056), ("corr", 29_057), ("corr", 60_000)]


def _b5_bases(kind, n, device, seed, dtypes=(torch.float64, torch.int64)):
    """var of one base or corr of two, of the given dtypes, with NaN in
    every float base."""
    g = torch.Generator(device=device).manual_seed(seed)
    bases = []
    for j, dtype in enumerate(dtypes[:1] if kind == "var" else dtypes):
        if dtype == torch.int64:
            bases.append(torch.randint(-1000, 1000, (n,), generator=g, device=device))
        else:
            b = torch.randn(n, generator=g, device=device, dtype=dtype) * 100
            b[j::13 + j] = float("nan")
            bases.append(b)
    return bases, agg.VAR_TERMS if kind == "var" else agg.CORR_TERMS


def _same_moments(got, want):
    torch.cuda.synchronize()
    npt.assert_array_equal(got[0].cpu().numpy(), want[0].cpu().numpy())
    npt.assert_allclose(got[1].cpu().numpy(), want[1].cpu().numpy(), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("kind,G", B5_EDGES)
@pytest.mark.parametrize("offset", [0, 1])
def test_window_kernel_at_its_edges(cuda, kind, G, offset):
    """B5 against its plain version where its parts change, on columns that
    start at row 0 or at an odd row of their storage (a slice)."""
    n = 300_007
    g = torch.Generator(device=cuda).manual_seed(G)
    idx = torch.randint(-2, G + G // 8 + 1, (n + offset,), generator=g, device=cuda,
                        dtype=torch.int32)[offset:]
    W = gm.part_plan(G, 3 if kind == "var" else 6)[0]
    idx[:4] = torch.tensor([0, G - 1, min(W, G - 1), W - 1], dtype=torch.int32)
    bases, terms = _b5_bases(kind, n + offset, cuda, G)
    bases = [b[offset:] for b in bases]
    before = gm.grid_moments_window.launches
    got = gm.grid_moments_window(idx, bases, terms, G)
    assert gm.grid_moments_window.launches == before + 1
    assert gm.grid_moments_window.last_parts == gm.n_parts(G, len(terms))
    _same_moments(got, gm.grid_moments_window_reference(idx, bases, terms, G))


@pytest.mark.parametrize("kind", ["var", "corr"])
@pytest.mark.parametrize("keys", ["single", "zipf"])
@pytest.mark.parametrize("G", [10_609, 31_063])
def test_window_kernel_on_skewed_keys(cuda, kind, keys, G):
    """One key and a Zipf(1.1) draw: the lanes that share a bin are combined
    before the atomics, in one window and over a cluster of windows."""
    idx = _skewed(keys, 1_000_003, G, cuda, seed=4)
    bases, terms = _b5_bases(kind, 1_000_003, cuda, 4)
    got = gm.grid_moments_window(idx, bases, terms, G)
    _same_moments(got, gm.grid_moments_window_reference(idx, bases, terms, G))


@pytest.mark.parametrize("dtypes", [(torch.float32, torch.int64), (torch.int64, torch.float32),
                                    (torch.float32, torch.float32)])
@pytest.mark.parametrize("G", [10_609, 20_011])
def test_window_kernel_widens_f32_and_int64_bases(cuda, dtypes, G):
    """f32 and int64 bases are read as float64; NaN in each base drops the
    row from every corr term."""
    idx = torch.randint(0, G, (500_003,), device=cuda, dtype=torch.int32)
    for kind in ("var", "corr"):
        bases, terms = _b5_bases(kind, 500_003, cuda, 5, dtypes)
        got = gm.grid_moments_window(idx, bases, terms, G)
        _same_moments(got, gm.grid_moments_window_reference(idx, bases, terms, G))


def test_window_kernel_takes_any_term_batch(cuda):
    """A batch that is no compiled set (covar's terms, and var's with a
    count that needs no base) reads the run-time tables, in one part and in
    several."""
    for G in (10_609, 40_009):
        idx = torch.randint(-1, G, (400_009,), device=cuda, dtype=torch.int32)
        bases, _ = _b5_bases("corr", 400_009, cuda, 6)
        for terms in (agg.COVAR_TERMS, [(0, -1, -1, -1), (0, 0, -1, -1), (-1, -1, -1, -1)]):
            got = gm.grid_moments_window(idx, bases, terms, G)
            _same_moments(got, gm.grid_moments_window_reference(idx, bases, terms, G))


def _b1_edges():
    """(G, int columns, float columns) at the edges of B1's routes: G = 1
    (sums in registers), 2, the narrowest and widest grids of the lane
    route by its columns, and B1's last bin."""
    return [(1, 0, 0), (1, 0, 1), (2, 0, 1), (103, 0, 1), (103, 1, 1), (128, 0, 1),
            (128, 1, 1), (1, 2, 1), (103, 2, 1), (128, 0, 0)]


@pytest.mark.parametrize("G,n_int,n_float", _b1_edges())
@pytest.mark.parametrize("offset", [0, 1])
def test_b1_routes_match_plain(cuda, G, n_int, n_float, offset):
    """Both routes of B1 at their edges against the plain version: int64
    sums wrap, f32 columns widen, NaN adds nothing, rows outside [0, G)
    drop, columns may start at an odd row; floats bit-equal run to run."""
    n = 500_003
    g = torch.Generator(device=cuda).manual_seed(G + n_int)
    idx = torch.randint(-2, G + 2, (n + 1,), generator=g, device=cuda,
                        dtype=torch.int32)[offset:offset + n]
    ints = [torch.randint(-(2 ** 63), 2 ** 63 - 1, (n + 1,), generator=g,
                          device=cuda)[offset:offset + n] for _ in range(n_int)]
    floats = []
    for k in range(n_float):
        f = torch.randn(n + 1, generator=g, device=cuda,
                        dtype=(torch.float64, torch.float32)[(k + offset) % 2]) * 100
        f[::11] = float("nan")
        floats.append(f[offset:offset + n])
    for route in (ga.LANE, ga.WARP):
        if route == ga.LANE and ga.lane_warp_bytes(G, n_int, n_float, True) > ga.CLUSTER_SMEM:
            continue
        planned = ga.route
        ga.route = lambda *a: route
        try:
            got = ga.grid_additive(idx, ints, floats, G, count=True)
            again = ga.grid_additive(idx, ints, floats, G, count=True)
        finally:
            ga.route = planned
        want = ga.grid_additive_reference(idx, ints, floats, G, count=True)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[0], again[0])
        assert torch.equal(got[1], again[1])
        npt.assert_allclose(got[1].cpu().numpy(), want[1].cpu().numpy(), rtol=1e-9, atol=1e-9)


def test_b1_plan_names_its_route_on_the_card(cuda):
    """The main path (count + f64 at G = 103) and the isin count (G = 1)
    take the lane route; the trace names it."""
    rng = np.random.default_rng(8)
    keys = rng.integers(0, 100, 300_000)
    x = rng.normal(0, 1, 300_000)
    df = vaex_tpu_torch.from_arrays(k=keys, x=x).to_device(cuda)
    df = df.categorize("k", labels=list(range(100)))
    df.groupby("k", agg={"s": vaex_tpu_torch.agg.sum("x"), "c": "count"})
    assert df.executor.trace_log[-1]["strategies"] == [{"additive": "b1"}]
    assert ga.grid_additive.last_route == ga.LANE
    assert df.count(selection=df.k.isin([3, 5, 7])) == int(np.isin(keys, [3, 5, 7]).sum())
    assert ga.grid_additive.last_route == ga.LANE
