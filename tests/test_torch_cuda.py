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
from vaex_tpu_torch.ops import grid_topk as gt
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


# shifted moments: (base dtype, offset); the int64 "span" puts half the
# values near -2^62 and half near 2^62, a span past 2^63 (shift 2^62)
SHIFTED = [(torch.float64, 1e6), (torch.float64, 1e8), (torch.float32, 1e6),
           (torch.float32, 1e8), (torch.int64, 2 ** 62), (torch.int64, "span")]


def _shifted_bases(nb, dtype, offset, n, g):
    bases, shift = [], []
    for j in range(nb):
        if dtype == torch.int64:
            b = torch.randint(-1000, 1000, (n,), generator=g, device="cuda")
            if offset == "span":
                b = b + (torch.randint(0, 2, (n,), generator=g, device="cuda") * 2 - 1) * 2 ** 62
            else:
                b = b + offset
            shift.append(2 ** 62)
        else:
            b = (torch.randn(n, generator=g, device="cuda", dtype=torch.float64) * (j + 1)
                 + offset).to(dtype)
            b[j::97] = float("nan")
            shift.append(offset)
        bases.append(b)
    return bases, shift


@pytest.mark.parametrize("name,G", [("b4", 1), ("b4", 103), ("b5", 10_609)])
@pytest.mark.parametrize("kind", ["var", "corr"])
@pytest.mark.parametrize("case", range(len(SHIFTED)))
def test_shifted_moment_kernel_matches_plain(cuda, name, G, kind, case):
    """B4 and B5 with a shift per base (in device memory) against their
    plain versions with the same shift: the kernel subtracts it in the
    base's own type before the cast."""
    kernel, plain = grid_plan.MOMENT_KERNELS[name], grid_plan.MOMENT_PLAIN[name]
    dtype, offset = SHIFTED[case]
    g = torch.Generator(device=cuda).manual_seed(case)
    n = 300_007
    idx = torch.randint(-1, G + 2, (n,), generator=g, device=cuda, dtype=torch.int32)
    bases, shift = _shifted_bases(1 if kind == "var" else 2, dtype, offset, n, g)
    terms = agg.VAR_TERMS if kind == "var" else agg.CORR_TERMS
    before = kernel.launches
    got = kernel(None if G == 1 else idx, bases, terms, G, shift)
    assert kernel.launches == before + 1
    want = plain(None if G == 1 else idx, bases, terms, G, shift)
    torch.cuda.synchronize()
    npt.assert_array_equal(got[0].cpu().numpy(), want[0].cpu().numpy())
    npt.assert_allclose(got[1].cpu().numpy(), want[1].cpu().numpy(), rtol=1e-9, atol=1e-9)


def test_the_frame_on_the_card_repairs_the_silent_faults(cuda):
    """The std of 2^62 and 2^62 + 7 is 3.5 and their mean numpy's; a unique
    sees a write through ``.data`` to a card tensor (no exact key: no cache
    hit)."""
    x = (torch.tensor([0, 7], device=cuda).repeat(50_000) + 2 ** 62)
    df = vaex_tpu_torch.from_dataset(vaex_tpu_torch.DatasetArrays({"x": x}))
    assert float(df.std("x")) == 3.5
    assert float(df.mean("x")) == float(np.mean(x.cpu().numpy()))
    k = torch.arange(1000, device=cuda) % 7
    df = vaex_tpu_torch.from_dataset(vaex_tpu_torch.DatasetArrays({"k": k}))
    assert df.unique("k") == list(range(7))
    k.data[3] = 100
    assert df.unique("k") == [*range(7), 100]


@pytest.mark.parametrize("route", ["b1", "b2", "b3", "b3-l2"])
def test_an_int64_float_channel_matches_plain(cuda, route):
    """An int64 column as a float channel (an int mean's sum in float64),
    converted on load by B1, B2 and both routes of B3, beside an f64 and an
    f32 column: the sums of ints below 2^53 are exact in any order."""
    G = {"b1": 103, "b2": 10_609, "b3": 1_000_003, "b3-l2": 500_003}[route]
    g = torch.Generator(device=cuda).manual_seed(7)
    n = 300_007
    idx = torch.randint(-1, G + 2, (n,), generator=g, device=cuda, dtype=torch.int32)
    ints = torch.randint(-10 ** 6, 10 ** 6, (n,), generator=g, device=cuda)
    halves = (torch.randint(-8, 8, (n,), generator=g, device=cuda) / 2).to(torch.float64)
    floats = [ints, halves, halves.to(torch.float32)]
    kernel = {"b1": ga.grid_additive, "b2": gw.grid_window, "b3": gp.grid_partition,
              "b3-l2": gp.grid_resident}[route]
    got = kernel(idx, [], floats, G, True)
    want = ga.grid_additive_reference(idx, [], floats, G, True)
    torch.cuda.synchronize()
    npt.assert_array_equal(got[0].cpu().numpy(), want[0].cpu().numpy())
    npt.assert_array_equal(got[1].cpu().numpy(), want[1].cpu().numpy())


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


@pytest.mark.parametrize("P_MAX,route", [(8, "b3×3"), (4, "sort")])
def test_moments_past_b3_raise_naming_a6(cuda, monkeypatch, P_MAX, route):
    """Named for the raise this replaced (ROADMAP A4): var's terms past B3's
    partition (cut to P_MAX buckets) on the card, split into calls of one
    term or through "sort", against the plain moment version."""
    monkeypatch.setattr(gp, "P_MAX", P_MAX)
    G = 120_000
    idx, bases, terms = _moment_inputs(300_007, G, "var", cuda, seed=4)
    name, counts, sums = grid_plan.moment_sums(idx, bases, terms, G)
    assert name == route
    want = gm.grid_moments_reference(idx, bases, terms, G)
    torch.cuda.synchronize()
    npt.assert_array_equal(counts.cpu().numpy(), want[0].cpu().numpy())
    npt.assert_allclose(sums.cpu().numpy(), want[1].cpu().numpy(), rtol=1e-9, atol=1e-9)


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


def test_extreme_wrapper_raises_where_its_kernel_does_not_fit(cuda, monkeypatch):
    idx = torch.zeros(10, dtype=torch.int32, device=cuda)
    x = torch.zeros(10, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="does not fit"):
        gp.grid_partition_extreme(idx, [x], ["min"], [None], 2 ** 30)
    with pytest.raises(ValueError, match="does not fit"):
        gp.grid_partition_extreme(idx, [x] * (gp.MAX_EXT + 1), ["min"] * (gp.MAX_EXT + 1),
                                  [None] * (gp.MAX_EXT + 1), 100)
    with pytest.raises(ValueError, match="contiguous"):
        gp.grid_partition_extreme(idx[::2], [x[::2]], ["min"], [None], 100)
    # past B3x's partition (cut to 2 buckets) the plan takes "sort", not a raise
    monkeypatch.setattr(gp, "P_MAX", 2)
    monkeypatch.setattr(gp, "RESIDENT_BYTES", 1 << 16)
    keys = torch.arange(10, dtype=torch.int32, device=cuda) * 3001
    name, (grid,) = grid_plan.grid_extremes(keys, [x + 1], ["min"], [None], 30_011)
    assert name == "sort"
    assert torch.equal(grid, ge.grid_extreme_batch(keys, [x + 1], ["min"], [None], 30_011)[0])


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


def test_config2_group_on_the_card(cuda):
    """BASELINE config 2's query group of chip_smoke.py (filtered mean / std
    / min / max of four virtual columns, two means by selection, a count
    binned by phi) at 1e6 rows on the card: against plain torch on the same
    tensors (counts, min and max exact, means and stds within the bound of
    unordered summation) and against the port on the CPU; B1 launched three
    times a tile on its lane route, B4 once a tile on its lane route."""
    import chip_smoke
    cols = chip_smoke.config2_columns(1_000_000, cuda)
    on_card = chip_smoke.config2_frame(vaex_tpu_torch, cols)
    on_cpu = chip_smoke.config2_frame(vaex_tpu_torch, {k: v.cpu() for k, v in cols.items()})
    b1, b4 = ga.grid_additive.launches, gm.grid_moments.launches
    got = chip_smoke.config2_group(on_card)
    tiles = on_card.executor.trace_log[-1]["tiles"]
    assert ga.grid_additive.launches - b1 == 3 * tiles
    assert gm.grid_moments.launches - b4 == tiles
    assert ga.grid_additive.last_route == ga.LANE and gm.grid_moments.last_route == gm.LANE
    chip_smoke.config2_check(got, chip_smoke.config2_plain(cols))
    want = chip_smoke.config2_group(on_cpu)
    for name in ("min", "max", "count phi"):
        npt.assert_array_equal(got[name], want[name], err_msg=name)
    for name in ("mean", "std", "mean by selection"):
        npt.assert_allclose(got[name], want[name], rtol=1e-9, atol=1e-12, err_msg=name)


def _h2o_like(seed, n):
    rng = np.random.default_rng(seed)
    v = rng.uniform(0, 100, n)
    v[::31] = np.nan
    return {"a": rng.integers(1, 41, n), "b": rng.integers(0, 30_000, n),
            "w": rng.integers(0, 500, n) * 1_000_003, "v": v, "i": rng.integers(-50, 50, n)}


def _same_frames(got, want):
    assert got.get_column_names() == want.get_column_names()
    for name in want.get_column_names():
        g, w = np.asarray(got.evaluate(name)), np.asarray(want.evaluate(name))
        if w.dtype.kind == "f":
            npt.assert_allclose(g, w, rtol=1e-9, atol=1e-9, err_msg=name)
        else:
            npt.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("keys", [["w"], ["a", "b"], ["a", "b", "w", "i", "a2", "b2"]])
def test_one_sort_groupby_on_the_card(cuda, keys):
    """The one-sort plan on CUDA tensors (packed: one wide key, two keys
    past 1e6 combinations; unpacked: six keys past 2^62) against the same
    query on the CPU."""
    arrays = _h2o_like(5, 200_000)
    arrays["a2"] = arrays["a"] * 7_919_999
    arrays["b2"] = arrays["b"] * 7_919_999
    aggs = {"n": "count", "s": agg.sum("v"), "si": agg.sum("i"), "m": agg.mean("v"),
            "hi": agg.max("v"), "sd": agg.std("v", ddof=1), "med": agg.median("v")}
    on_card = vaex_tpu_torch.from_arrays(**arrays).to_device(cuda)
    on_cpu = vaex_tpu_torch.from_arrays(**arrays).to_device("cpu")
    got, want = on_card.groupby(keys, agg=aggs), on_cpu.groupby(keys, agg=aggs)
    record = on_card.executor.trace_log[-1]
    assert record["groupby"] == "one-sort" and record["device"].startswith("cuda")
    assert record["mode"] == ("unpacked" if len(keys) == 6 else "packed")
    _same_frames(got, want)


def test_percentiles_and_top_k_on_the_card(cuda):
    """The exact and the approximate median, a percentile and the top-k per
    group on CUDA tensors against the CPU; the approximate median's count
    grid runs a hand-written kernel of the additive plan."""
    arrays = _h2o_like(6, 300_000)
    aggs = {"med": agg.median("v"), "p90": agg.percentile_approx("v", 90),
            "approx": agg.median_approx("v", exact=False),
            "top": agg.nth_largest("v", 1), "low": agg.min_n("i", 3),
            "sel": agg.nth_smallest("v", 0, selection="i > 0")}
    on_card = vaex_tpu_torch.from_arrays(**arrays).to_device(cuda)
    on_cpu = vaex_tpu_torch.from_arrays(**arrays).to_device("cpu")
    on_card._tile_rows = on_cpu._tile_rows = 100_000  # three tiles
    launches = {name: k.launches for name, k in grid_plan.KERNELS.items()}
    got = on_card.groupby("a", agg=aggs, sort=True)
    want = on_cpu.groupby("a", agg=aggs, sort=True)
    strategies = {k: v for task in on_card.executor.trace_log[-1]["strategies"]
                  for k, v in task.items()}  # the task of no selection, and that of i > 0
    name = strategies["percentile"]
    assert grid_plan.KERNELS[name].launches - launches[name] >= 3  # one call a tile
    assert strategies["percentile_exact"] == strategies["topk"] == "sort"
    _same_frames(got, want)


def _topk_rows(n, G, device, kind, seed=0):
    """idx over G cells with rows outside [0, G) (sorted: runs of one cell
    across neighbouring lanes), and values of the kind: float64 with NaN,
    +-inf and -0.0, float32, int64 of few values (ties) with the type's
    ends, or int64 with NaT; a mask of missing rows."""
    g = torch.Generator(device=device).manual_seed(seed)
    idx = torch.randint(-2, G + 3, (n,), generator=g, device=device, dtype=torch.int32)
    if kind == "sorted":
        idx = idx.sort().values
    if kind in ("f64", "f32", "sorted"):
        v = torch.randn(n, generator=g, device=device, dtype=torch.float64).round()
        for step, special in ((13, float("nan")), (17, float("inf")), (19, float("-inf")),
                              (23, -0.0)):
            v[::step] = special
        v = v.to(torch.float32) if kind == "f32" else v
    else:
        v = torch.randint(1, 6, (n,), generator=g, device=device, dtype=torch.int64)
        v[::29] = torch.iinfo(torch.int64).min
        v[::31] = torch.iinfo(torch.int64).max
    mask = torch.rand(n, generator=g, device=device) < 0.1
    return idx, v, mask


@pytest.mark.parametrize("kind", ["f64", "f32", "i64", "nat", "sorted"])
@pytest.mark.parametrize("k", [1, 2, 3, 8, 16])
def test_topk_kernel_matches_plain(cuda, k, kind):
    """``grid_topk`` (the rounds kernel) folding three tiles into one state,
    largest and smallest, against its plain version on the CPU: exact by
    value."""
    G, n = 1 << 16, 3_000_000
    idx, v, mask = _topk_rows(n, G, cuda, kind)
    for largest in (True, False):
        state = torch.full((G, k), gt.fill(v.dtype, largest), dtype=v.dtype, device=cuda)
        plain = state.cpu()
        before = gt.grid_topk.launches
        for t in range(3):
            rows = slice(t * n // 3, (t + 1) * n // 3)
            m = None if t == 1 else mask[rows]  # a tile with no mask
            route, _ = gt.grid_topk(idx[rows], v[rows], m, G, k, largest, state,
                                    nat=kind == "nat")
            assert route == gt.ROUTE
            gt.grid_topk_reference(idx[rows].cpu(), v[rows].cpu(), None if m is None else m.cpu(),
                                   G, k, largest, plain, nat=kind == "nat")
        torch.cuda.synchronize()
        assert gt.grid_topk.launches == before + 3
        npt.assert_array_equal(state.cpu().numpy(), plain.numpy())


def test_topk_kernel_past_l2_matches_plain(cuda):
    """Past L2 (2e6 cells, the plan's most slots there), both ends: the
    kernel against its plain version, exact by value."""
    G, n, k = 2_000_003, 6_000_000, gt.K_PAST_L2
    assert not gt.resident_fits(G)
    assert grid_plan.topk_strategy(G, k, torch.float64, "cuda") == gt.ROUTE
    idx, v, mask = _topk_rows(n, G, cuda, "f64", seed=3)
    for largest in (True, False):
        state = torch.full((G, k), gt.fill(v.dtype, largest), dtype=v.dtype, device=cuda)
        plain = state.cpu()
        gt.grid_topk(idx, v, mask, G, k, largest, state)
        gt.grid_topk_reference(idx.cpu(), v.cpu(), mask.cpu(), G, k, largest, plain)
        npt.assert_array_equal(state.cpu().numpy(), plain.numpy())


def test_topk_rounds_route_on_the_card(cuda):
    """The rounds route of ``OpTopK`` at G = 2^20 over three tiles (a float
    column, a ties-heavy int column of values 1..5, a selection) against
    the same query on the CPU's sort; every tile and op takes the route."""
    rng = np.random.default_rng(8)
    n, G = 6_000_000, 1 << 20
    f = rng.uniform(0, 100, n)
    f[::37] = np.nan
    arrays = {"u": rng.uniform(0, 1, n), "f": f, "i": rng.integers(1, 6, n),
              "s": rng.uniform(0, 1, n)}
    aggs = {"a": agg.max_n("f", 3), "b": agg.nth_largest("i", 1), "c": agg.min_n("i", 4),
            "d": agg.nth_smallest("f", 0, selection="s > 0.5")}
    on_card = vaex_tpu_torch.from_arrays(**arrays).to_device(cuda)
    on_cpu = vaex_tpu_torch.from_arrays(**arrays).to_device("cpu")
    on_card._tile_rows = on_cpu._tile_rows = n // 3
    routes, launches = dict(agg.OpTopK.routes), gt.grid_topk.launches
    args = dict(by=["u"], limits=[0, 1], shape=G, agg=aggs)
    got = on_card.binby(**args)
    strategies = on_card.executor.trace_log[-1]["strategies"]
    assert [task["topk"] for task in strategies] == [grid_plan.B3X_L2_TOPK] * 2
    assert agg.OpTopK.routes["rounds"] - routes["rounds"] == 4 * 3  # an op and tile each
    assert agg.OpTopK.routes["sort"] == routes["sort"]
    assert gt.grid_topk.launches - launches == 4 * 3
    want = on_cpu.binby(**args)
    assert on_cpu.executor.trace_log[-1]["strategies"][0]["topk"] == "sort"
    for name in aggs:
        npt.assert_array_equal(np.asarray(got[name]), np.asarray(want[name]), err_msg=name)


def _index_keys(kind, M, g):
    """Right keys of a join index: "dense" arange(M) shuffled, "gapped" every
    third value of a range missing, "duplicated" M keys over M / 4 values,
    "float" distinct float64 halves with NaN and -0.0."""
    if kind == "dense":
        return torch.randperm(M, generator=g)
    if kind == "gapped":
        keys = torch.arange(M * 3 // 2)
        return keys[keys % 3 != 0][torch.randperm(M, generator=g)]
    if kind == "duplicated":
        return torch.randint(0, max(M // 4, 1), (M,), generator=g)
    keys = (torch.randperm(2 * M, generator=g)[:M] - M).to(torch.float64) / 2
    keys[::97] = float("nan")
    keys[keys == 0] = -0.0
    return keys


@pytest.mark.parametrize("kind", ["dense", "gapped", "duplicated", "float"])
@pytest.mark.parametrize("M", [100_000, 10_000_000])
def test_sorted_index_on_the_card_matches_its_plain_version(cuda, M, kind):
    """``SortedIndex.map_index`` (B6 on the card) and ``map_index_duplicates``
    on CUDA against the same index on the CPU (``searchsorted``)."""
    from vaex_tpu_torch.ops.nullable import NA
    from vaex_tpu_torch.ops.setops import SortedIndex
    g = torch.Generator().manual_seed(M + len(kind))
    keys = _index_keys(kind, M, g)
    mask = torch.rand(M, generator=g) < 0.01
    x = torch.randint(-10, int(M * 1.6) + 10, (1_000_003,), generator=g)
    x = x.to(torch.float64) / 2 if kind == "float" else x
    if kind == "float":
        x[::101] = float("nan")
    x_mask = torch.rand(x.shape[0], generator=g) < 0.02
    host = SortedIndex(keys, mask)
    card = SortedIndex(keys.to(cuda), mask.to(cuda))
    assert card.has_duplicates == host.has_duplicates == (kind == "duplicated")
    before = probe.probe.launches
    got = card.map_index(NA(x.to(cuda), x_mask.to(cuda)))
    assert probe.probe.launches == before + 1
    assert card.route(got.device) in (probe.B6, probe.B6_WIDE)
    want = host.map_index(NA(x, x_mask))
    npt.assert_array_equal(got.cpu().numpy(), want.numpy())
    if kind == "duplicated":
        for a, b in zip(card.map_index_duplicates(NA(x.to(cuda), x_mask.to(cuda)), 7),
                        host.map_index_duplicates(NA(x, x_mask), 7)):
            npt.assert_array_equal(a.cpu().numpy(), b.numpy())


def test_join_on_the_card_matches_the_cpu(cuda):
    """A left join with duplicates and an inner join on the card give the
    rows of the same joins on the CPU; the lookup stays a CUDA tensor."""
    rng = np.random.default_rng(5)
    left = {"key": rng.integers(0, 5000, 300_000), "x": rng.random(300_000)}
    keys = np.concatenate([np.arange(0, 4000, 2), np.arange(0, 4000, 10)])
    right = {"key": keys, "label": rng.integers(0, 100, len(keys))}
    out = {}
    for device in ("cpu", cuda):
        lf = vaex_tpu_torch.from_arrays(**left).to_device(device)
        rf = vaex_tpu_torch.from_arrays(**right).to_device(device)
        out[str(device)] = []
        for how in ("left", "inner"):
            joined = lf.join(rf, on="key", how=how, allow_duplication=True)
            out[str(device)].append((joined, joined.executor.trace_log[-1]["probe"]))
    for (on_cpu, _), (on_card, route) in zip(out["cpu"], out[str(cuda)]):
        assert on_card.dataset["label"].index.is_cuda
        assert route in (probe.B6, probe.B6_WIDE)
        for name in ("key", "x", "label"):
            a, b = on_cpu.evaluate(name), on_card.evaluate(name)
            npt.assert_array_equal(np.ma.getmaskarray(a), np.ma.getmaskarray(b))
            npt.assert_array_equal(np.ma.getdata(a), np.ma.getdata(b))
        assert on_card.sum("label") == on_cpu.sum("label")


@pytest.mark.parametrize("P_MAX", [2, 64])
def test_grids_past_b3_on_the_card_match_the_cpu(cuda, monkeypatch, P_MAX):
    """With B3's partition cut to P_MAX buckets and the resident budget to
    64 KiB, a 403 x 403 grid over 1e6 rows takes "sort" (P_MAX 2) or the
    split of the four std's twelve terms (P_MAX 64) on the card: count, mean,
    std of four columns, max and first equal the same frame's on the CPU
    (ints exact, floats to rtol 1e-9 and atol 1e-9)."""
    from vaex_tpu_torch.ops import grid_sort
    monkeypatch.setattr(gp, "P_MAX", P_MAX)
    monkeypatch.setattr(gp, "RESIDENT_BYTES", 1 << 16)
    rng = np.random.default_rng(P_MAX)
    n = 1_000_000
    arrays = {c: rng.normal(0, 1, n) for c in "xyvw"}
    arrays["v"][::37] = np.nan
    arrays["t"] = rng.permutation(n)
    kw = dict(binby=["x", "y"], limits=[[-3, 3], [-3, 3]], shape=400)
    out = {}
    for device in ("cpu", cuda):
        df = vaex_tpu_torch.from_arrays(**arrays).to_device(device)
        out[str(device)] = (df.count(**kw), df.mean("v", **kw),
                            df.std(["v", "x", "y", "w"], **kw), df.max("w", **kw),
                            df.first("v", "t", **kw))
        if device is cuda:
            assert df.executor.trace_log[-1]["strategies"][0]["first"] == (
                grid_sort.SORT if P_MAX == 2 else "b3x")
    for got, want in zip(out[str(cuda)], out["cpu"]):
        npt.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-9, atol=1e-9)


def test_materialize_and_sample_on_the_card(cuda):
    """materialize leaves a CUDA tensor (with its mask), sample picks the
    rows numpy's draw picks, vrange sums on the card."""
    from vaex_tpu_torch.column import ColumnMasked
    rng = np.random.default_rng(8)
    n = 1_000_000
    x = rng.normal(0, 1, n)
    m = np.ma.MaskedArray(rng.normal(0, 1, n), rng.random(n) < 0.1)
    df = vaex_tpu_torch.from_arrays(x=x, m=m).to_device(cuda)
    df["r"] = "sqrt(x**2 + m**2)"
    got = df.materialize("r")
    col = got.dataset["r"]
    assert isinstance(col, ColumnMasked) and col.data.is_cuda and col.mask.is_cuda
    assert got.sum("r") == pytest.approx(df.sum("r"), rel=1e-12)
    picked = df.sample(n=10_000, random_state=42)
    rows = np.random.default_rng(42).choice(n, 10_000, replace=False)
    assert picked.sum("x") == pytest.approx(x[rows].sum(), rel=1e-12)
    assert picked.dataset["x"].index.is_cuda
    big = vaex_tpu_torch.vrange(0, 10 ** 8).to_device(cuda)
    assert big.sum("x") == 10 ** 8 * (10 ** 8 - 1) // 2 and big.count("x") == 10 ** 8


def _two_devices(arrays, cuda):
    return {str(d): vaex_tpu_torch.from_arrays(**arrays).to_device(d) for d in ("cpu", cuda)}


@pytest.mark.parametrize("G_cells,route", [(40, grid_plan.B2), (4000, grid_plan.B3)])
def test_nunique_presence_route_on_the_card(cuda, G_cells, route):
    """The presence grid of nunique per cell runs the additive kernel the
    plan names for its [G * n_values] cells (B2 or B3, by size) and gives
    the CPU's counts; the sorted pairs too, past a lowered cap."""
    rng = np.random.default_rng(G_cells)
    n = 1_000_000
    arrays = {"k": rng.integers(0, G_cells, n), "v": rng.integers(0, 1000, n).astype(float)}
    arrays["v"][::13] = np.nan
    kw = dict(binby="k", limits=[-0.5, G_cells - 0.5], shape=G_cells)
    frames = _two_devices(arrays, cuda)
    out = {}
    for device, df in frames.items():
        kernel = grid_plan.KERNELS[route]
        before = kernel.launches
        out[device] = df.nunique("v", dropnan=True, **kw)
        log = df.executor.trace_log[-1]
        n_values = df._set("v").count
        assert log["strategies"][0]["presence"] == grid_plan.strategy(
            n, (G_cells + 3) * n_values, 0, 0, True) == route
        if device != "cpu":
            assert kernel.launches > before and log["probe"] == probe.B6
    npt.assert_array_equal(out[str(cuda)], out["cpu"])
    gb = {d: df.groupby("k", agg={"v": vaex_tpu_torch.agg.nunique("v")}, sort=True)
          for d, df in frames.items()}
    npt.assert_array_equal(gb[str(cuda)].evaluate("v"), gb["cpu"].evaluate("v"))


def test_nunique_sorted_route_on_the_card(cuda, monkeypatch):
    monkeypatch.setattr(agg, "NUNIQUE_PRESENCE_MAX", 1000)
    rng = np.random.default_rng(3)
    n = 2_000_000
    arrays = {"k": rng.integers(0, 50, n), "w": rng.integers(0, 300_000, n)}
    out = {}
    for device, df in _two_devices(arrays, cuda).items():
        df._tile_rows = 1 << 19
        out[device] = df.groupby("k", agg={"w": "nunique"}, sort=True).evaluate("w")
        assert df.executor.trace_log[-1]["strategies"][0]["nunique"] == "sort"
    npt.assert_array_equal(out[str(cuda)], out["cpu"])


def test_uint64_through_b3x_and_b6_on_the_card(cuda):
    """uint64 min / max by a key (B3x over the order images), sum, isin and
    a groupby over the uint64 key (B6 over the images of its set) on the
    card equal the CPU's, values past 2^63 included."""
    rng = np.random.default_rng(11)
    n = 1_000_000
    low = rng.integers(0, 7, n).astype(np.uint64)
    u = np.where(rng.random(n) < 0.5, low | np.uint64(1 << 63), low)
    u[::101] = np.uint64(2 ** 64 - 1)
    arrays = {"k": rng.integers(0, 200, n), "u": u, "x": rng.random(n)}
    kw = dict(binby="k", limits=[-0.5, 199.5], shape=200)
    out = {}
    for device, df in _two_devices(arrays, cuda).items():
        before = (gp.grid_partition_extreme.launches, probe.probe.launches)
        out[device] = (df.min("u", **kw), df.max("u", **kw), df.sum("u"), df.minmax("u"),
                       df.u.isin([3, 2 ** 63 + 5, 2 ** 64 - 1]).sum(),
                       df.groupby("u", agg={"n": "count", "x": "sum"}, sort=True))
        if device != "cpu":
            assert gp.grid_partition_extreme.launches > before[0]
            assert probe.probe.launches > before[1]
    cpu, card = out["cpu"], out[str(cuda)]
    for got, want in zip(card[:5], cpu[:5]):
        assert np.asarray(got).dtype == np.asarray(want).dtype
        npt.assert_array_equal(np.asarray(got), np.asarray(want))
    for name in ("u", "n"):
        npt.assert_array_equal(card[5].evaluate(name), cpu[5].evaluate(name))
    npt.assert_allclose(card[5].evaluate("x"), cpu[5].evaluate("x"), rtol=1e-9)
    assert int(card[1].max()) == 2 ** 64 - 1


def test_shift_and_rolling_stay_on_the_card(cuda):
    """shift, diff and rolling on a CUDA frame leave their columns as views
    over CUDA tensors, and their statistics equal the CPU's."""
    from vaex_tpu_torch.shift import ColumnShifted
    rng = np.random.default_rng(12)
    n = 1_000_003
    arrays = {"x": rng.normal(0, 1, n), "m": np.ma.MaskedArray(rng.normal(0, 1, n),
                                                               rng.random(n) < 0.1)}
    frames = _two_devices(arrays, cuda)
    card = frames[str(cuda)]
    card._tile_rows = frames["cpu"]._tile_rows = 1 << 18
    shifted = card.shift(3, ["x", "m"])
    for name in ("x", "m"):
        col = shifted.dataset[name]
        assert isinstance(col, ColumnShifted) and col.device.type == "cuda"
    rolled = card.rolling(4, column="m", edge="left").mean()
    for k in range(4):
        col = rolled.dataset[f"__m_shift_{k}"]
        assert (col.device if isinstance(col, ColumnShifted) else col.data.device).type == "cuda"
    assert card.diff(2, "x").dataset["__x_original"] is card.dataset["x"]
    stats = {}
    for device, df in frames.items():
        stats[device] = [df.shift(3, ["x", "m"]).sum("m"), df.diff(-2, "x").sum("x"),
                         df.rolling(4, column="m", edge="left").mean().mean("m"),
                         df.rolling(5, column="x", fill_value=0).max().max("x"),
                         df.shift(7, "x", fill_value=1.5, trim=True).count("x")]
    npt.assert_allclose(stats[str(cuda)], stats["cpu"], rtol=1e-9)


def test_finishers_on_the_card(cuda):
    """cov, mode, mutual_information, describe, healpix_count and a stat
    ratio on the card equal the CPU's (counts and centres exact, floats to
    rtol 1e-9)."""
    rng = np.random.default_rng(13)
    n = 1_000_000
    arrays = {"k": rng.integers(0, 50, n), "x": rng.normal(0, 1, n),
              "y": rng.normal(0, 1, n), "v": rng.integers(0, 5, n),
              "source_id": rng.integers(0, 12 * 4 ** 12 * 2 ** 35, n)}
    out = {}
    for device, df in _two_devices(arrays, cuda).items():
        ratio = vaex_tpu_torch.stat.mean("x") / vaex_tpu_torch.stat.std("x")
        out[device] = (df.cov(["x", "y", "v"], binby="k", limits=[-0.5, 49.5], shape=50),
                       df.mode("x", binby="k", limits=[-0.5, 49.5], shape=50, mode_shape=32),
                       df.mutual_information("x", "y", mi_shape=64),
                       df.healpix_count(healpix_level=5),
                       ratio.calculate(df, binby="k", limits=[-0.5, 49.5], shape=50),
                       df.describe())
    cpu, card = out["cpu"], out[str(cuda)]
    npt.assert_allclose(card[0], cpu[0], rtol=1e-9, atol=1e-12)
    npt.assert_array_equal(card[1], cpu[1])
    npt.assert_allclose(card[2], cpu[2], rtol=1e-12)
    npt.assert_array_equal(card[3], cpu[3])
    npt.assert_allclose(card[4], cpu[4], rtol=1e-9)
    for name in arrays:
        for row in ("count", "NA", "min", "max"):
            assert card[5][name][row] == cpu[5][name][row]
        for row in ("mean", "std"):
            assert card[5][name][row] == pytest.approx(cpu[5][name][row], rel=1e-9)


def _string_arrays(seed=5, n=300_000, k=1500):
    rng = np.random.default_rng(seed)
    labels = np.asarray([f"id{i:05d}" for i in range(k)] + ["", "é"], dtype=object)
    s = labels[rng.integers(0, len(labels), n)].astype(object)
    s[::97] = None
    return {"s": s, "g": rng.integers(0, 7, n).astype(np.int64), "x": rng.normal(size=n)}


@pytest.mark.parametrize("staged", [True, False])
def test_string_groupby_and_isin_on_the_card(cuda, staged, monkeypatch):
    """A string key's groupby and isin on the card (staged: the codes on the
    card, B2 over 1503 codes; unstaged: the set grouper and the host stage,
    the pass on the card) against the same frame on the CPU."""
    from vaex_tpu_torch import settings
    arrays = _string_arrays()
    values = ["id00003", "é", "", "none"]
    out = {}
    for device in ("cpu", str(cuda)):
        monkeypatch.setattr(settings, "DEVICE", device)
        df = vaex_tpu_torch.from_arrays(**arrays)
        df = df.to_device(device) if staged else df
        gb = df.groupby(["s"], agg={"x": "sum", "c": "count"}, sort=True)
        two = df.groupby(["s", "g"], agg={"c": "count"}, sort=True)
        assert df.executor.trace_log[-1]["device"].startswith(device)
        out[device] = (gb.s.tolist(), gb.x.tolist(), gb.c.tolist(), two.s.tolist(),
                       two.c.tolist(), int(df.count(selection=df.s.isin(values))),
                       dict(df.s.value_counts()))
    cpu, card = out["cpu"], out[str(cuda)]
    assert card[0] == cpu[0] and card[2] == cpu[2] and card[3:] == cpu[3:]
    npt.assert_allclose(card[1], cpu[1], rtol=1e-9, atol=1e-9)


# ------------------------------------------ the executor's tail on the card


def _udf_scaled(x, k):
    return x * 0.5 + k


def test_a_cache_hit_on_the_card(cuda):
    """The set grouper of 1e5 keys twice: over card tensors both runs build
    the set (a card tensor has no exact key: a write through ``.data``
    would not show in one); over the same keys as host arrays, whose
    passes run on the card, the second set build is served from the
    device LRU, and clearing it returns the card's memory."""
    from vaex_tpu_torch import cache
    cache.clear()
    g = torch.Generator(device=cuda).manual_seed(3)
    k = torch.randint(0, 10 ** 12, (2_000_000,), generator=g, device=cuda) % 100_003 * 1_000_003
    x = torch.ones(k.shape[0], dtype=torch.float64, device=cuda)
    card = vaex_tpu_torch.from_arrays(k=k, x=x).to_device(cuda)
    host = vaex_tpu_torch.from_arrays(k=k.cpu().numpy(), x=x.cpu().numpy())
    with cache.memory():
        for df, hit in ((card, False), (host, True)):
            first = df.groupby("k").agg("count")
            tasks = [e["tasks"] for e in df.executor.trace_log[-2:]]
            assert tasks[0] == ["set-create"]
            n = len(df.executor.trace_log)
            second = df.groupby("k").agg("count")
            assert ([e["tasks"] for e in df.executor.trace_log[n:]] == [["aggregations"]]) == hit
            assert second["count"].tolist() == first["count"].tolist()
    del first, second
    held = cache.device_backend.nbytes
    before = torch.cuda.memory_allocated()
    assert held > 0 and cache.clear() == held
    assert torch.cuda.memory_allocated() <= before - held // 2


def test_a_pickled_cuda_frame(cuda, monkeypatch):
    import pickle
    from vaex_tpu_torch import settings
    monkeypatch.setattr(settings, "DEVICE", str(cuda))
    rng = np.random.default_rng(5)
    df = vaex_tpu_torch.from_arrays(k=rng.integers(0, 50, 100_000),
                                    x=rng.normal(size=100_000)).to_device(cuda)
    df["y"] = df.x * 2
    df = df.filter("x > -1").categorize("k", labels=list(range(50)))
    back = pickle.loads(pickle.dumps(df))
    assert back.dataset["x"].device.type == "cuda"
    want = df.groupby("k", agg={"s": agg.sum("y"), "c": "count"})
    got = back.groupby("k", agg={"s": agg.sum("y"), "c": "count"})
    assert got["c"].tolist() == want["c"].tolist() and got["s"].tolist() == want["s"].tolist()


def test_a_udf_pass_on_the_card(cuda, monkeypatch):
    """A UDF's host stage, its result copied to the card, grouped there;
    with multiprocessing after CUDA started the pool is a forkserver's."""
    from vaex_tpu_torch import multiprocessing as port_mp
    from vaex_tpu_torch import settings
    monkeypatch.setattr(settings, "NUM_PROCESSES", 2)
    rng = np.random.default_rng(6)
    arrays = {"k": rng.integers(0, 20, 200_000), "x": rng.normal(size=200_000)}
    out = []
    try:
        for device, mp in (("cpu", False), (str(cuda), False), (str(cuda), True)):
            df = vaex_tpu_torch.from_arrays(**arrays).to_device(device)
            df["u"] = df.apply(_udf_scaled, ["x", "k"], multiprocessing=mp)
            gb = df.groupby("k", agg={"s": agg.sum("u"), "sd": agg.std("u")}, sort=True)
            assert df.executor.trace_log[-1]["device"].startswith(device)
            assert df.executor.trace_log[-1]["host_stage"] == ["u"]
            out.append((gb["s"].values, gb["sd"].values))
        assert port_mp._pool._ctx.get_start_method() == "forkserver"
    finally:
        port_mp.close_pool()
    npt.assert_allclose(out[1][0], out[0][0], rtol=1e-9)
    npt.assert_array_equal(out[2][0], out[1][0])
    npt.assert_array_equal(out[2][1], out[1][1])


@pytest.mark.parametrize("expression", ["u // 3", "u % 7", "u & 65535", "u >> 60", "u + k",
                                        "sqrt(u)", "u ** 3", "u // w", "maximum(u, w)"])
def test_uint64_expressions_on_the_card(cuda, expression):
    rng = np.random.default_rng(7)
    arrays = {"u": rng.integers(0, 2 ** 64, 100_000, dtype=np.uint64),
              "w": rng.integers(1, 2 ** 64, 100_000, dtype=np.uint64),
              "k": rng.integers(-5, 5, 100_000)}
    got = vaex_tpu_torch.from_arrays(**arrays).to_device(cuda).evaluate(expression)
    want = vaex_tpu_torch.from_arrays(**arrays).to_device("cpu").evaluate(expression)
    assert got.dtype == want.dtype
    if got.dtype.kind == "f":  # the card's float64 sqrt may differ by an ulp
        npt.assert_allclose(got, want, rtol=1e-15)
    else:
        npt.assert_array_equal(got, want)


# the streamed pass over a file (vaex_tpu_torch.stream): page-locked slots,
# a copy stream, events

def _file_frame(tmp_path, n, ext, seed=3):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 50, n).astype(np.int64)
    x = rng.normal(0, 1, n)
    path = str(tmp_path / f"t.{ext}")
    vaex_tpu_torch.from_arrays(k=k, x=x).export(path)
    staged = vaex_tpu_torch.from_arrays(k=k, x=x).to_device("cuda")
    return vaex_tpu_torch.open(path), staged


def _groupby(df):
    return df.groupby("k", agg={"s": agg.sum("x"), "c": "count"}, sort=True)


@pytest.mark.parametrize("ext", ["arrow", "parquet"])
@pytest.mark.parametrize("tile_rows", [7, 1000, 65_536])
def test_pinned_streaming_at_tiny_tiles_equals_the_staged_answer(cuda, tmp_path, ext,
                                                                 tile_rows):
    from vaex_tpu_torch import stream
    stream.clear_proofs()
    n = 200_003 if tile_rows > 7 else 20_003
    df, staged = _file_frame(tmp_path, n, ext)
    df._tile_rows = tile_rows
    want = _groupby(staged)
    for wire in ("int64", "int32"):  # the first pass proves k, the second narrows it
        got = _groupby(df)
        s = df.executor.trace_log[-1]["stream"]
        assert s["pinned"] and s["ring"] == 3 and s["mode"] == "transfer-ahead"
        assert df.executor.trace_log[-1]["device"].startswith("cuda")
        assert got["c"].tolist() == want["c"].tolist()
        npt.assert_allclose(got["s"].tolist(), want["s"].tolist(), rtol=1e-9, atol=1e-9)
    assert s["wire"]["k"] == "int32"


def test_the_copy_stream_under_a_busy_compute_stream(cuda, tmp_path, monkeypatch):
    """Every tile's kernels queue behind a long sleep on the compute stream,
    so the producer runs ahead of them: a tile read before its copy, or a
    device buffer handed out again before the compute stream read it
    (record_stream), moves the counts."""
    from vaex_tpu_torch import stream, tasks
    stream.clear_proofs()
    df, staged = _file_frame(tmp_path, 300_007, "arrow", seed=5)
    df._tile_rows = 4096
    want = _groupby(staged)
    real = tasks.TaskAggregations.update

    def busy(self, state, ctx):
        torch.cuda._sleep(200_000)
        return real(self, state, ctx)
    monkeypatch.setattr(tasks.TaskAggregations, "update", busy)
    for _ in range(2):
        got = _groupby(df)
        assert got["c"].tolist() == want["c"].tolist()
        npt.assert_allclose(got["s"].tolist(), want["s"].tolist(), rtol=1e-9, atol=1e-9)
    assert df.executor.trace_log[-1]["stream"]["wire"]["k"] == "int32"


def test_a_cancelled_stream_on_the_card_leaves_no_thread(cuda, tmp_path):
    import threading
    from vaex_tpu_torch.execution import UserAbort
    df, staged = _file_frame(tmp_path, 100_003, "arrow")
    df._tile_rows = 1000
    calls = []
    cb = df.executor.signal_progress.connect(lambda p: calls.append(p) or len(calls) < 4)
    with pytest.raises(UserAbort):
        _groupby(df)
    df.executor.signal_progress.disconnect(cb)
    assert not [t for t in threading.enumerate() if t.name.startswith("vaex-tpu-torch-")]
    assert _groupby(df)["c"].tolist() == _groupby(staged)["c"].tolist()


def test_prefetch_and_a_ring_bounded_by_bytes_on_the_card(cuda, tmp_path, monkeypatch):
    """PREFETCH alone copies each tile in the pass (pageable); a small
    STREAM_RING_BYTES clamps the tile so that the page-locked slots stay
    within it; both give the staged answer."""
    from vaex_tpu_torch import settings, stream
    stream.clear_proofs()
    df, staged = _file_frame(tmp_path, 200_003, "arrow")
    want = _groupby(staged)
    monkeypatch.setattr(stream, "RING_TILE_ROWS_MIN", 1)
    budget = 3 * 18 * 5000  # 3 slots of k and x (8 B and a mask byte each), 5000 rows
    monkeypatch.setattr(settings, "STREAM_RING_BYTES", budget)
    got = _groupby(df)
    log = df.executor.trace_log[-1]
    assert log["tile_rows"] == 4096 and log["stream"]["pinned"]
    assert 0 < log["stream"]["ring_bytes"] <= budget
    assert got["c"].tolist() == want["c"].tolist()
    npt.assert_allclose(got["s"].tolist(), want["s"].tolist(), rtol=1e-9, atol=1e-9)
    monkeypatch.setattr(settings, "TRANSFER_AHEAD", 0)
    df._tile_rows = 4096
    got = _groupby(df)
    assert df.executor.trace_log[-1]["stream"]["mode"] == "prefetch"
    assert got["c"].tolist() == want["c"].tolist()
    npt.assert_allclose(got["s"].tolist(), want["s"].tolist(), rtol=1e-9, atol=1e-9)


# --------------------------------------------- multi-device execution (A12)
def _four_shards(frame):
    from vaex_tpu_torch.parallel import distributed_executor
    out = frame.copy()
    out.executor = distributed_executor(4, devices=["cuda:0"] * 4)
    return out


def _mesh_table(cuda, n=1_000_003, seed=5):
    g = torch.Generator(device=cuda).manual_seed(seed)
    cols = {"k": torch.randint(0, 100, (n,), generator=g, device=cuda),
            "w": torch.randint(0, 300_000, (n,), generator=g, device=cuda) * 3,
            "big": torch.randint(0, 2 ** 40, (n,), generator=g, device=cuda),
            "x": torch.rand(n, generator=g, device=cuda, dtype=torch.float64),
            "v": torch.randint(-1000, 1000, (n,), generator=g, device=cuda)}
    return vaex_tpu_torch.from_dataset(vaex_tpu_torch.DatasetArrays(cols)), cols


def _same_frames(got, want, float_rtol=1e-9):
    assert got.get_column_names() == want.get_column_names()
    for name in want.get_column_names():
        g, w = np.asarray(got[name].values), np.asarray(want[name].values)
        if w.dtype.kind == "f":
            npt.assert_allclose(g, w, rtol=float_rtol, atol=1e-9, err_msg=name)
        else:
            npt.assert_array_equal(g, w, err_msg=name)


def test_a_sharded_groupby_on_four_shards_of_the_card(cuda):
    df, _ = _mesh_table(cuda)
    df = df.categorize("k", labels=range(100))
    agg = {"s": vaex_tpu_torch.agg.sum("x"), "c": "count", "sd": vaex_tpu_torch.agg.std("x"),
           "mx": vaex_tpu_torch.agg.max("v")}
    with vaex_tpu_torch.cache.off():
        want = df.groupby("k", agg=agg, sort=True)
        sharded = _four_shards(df)
        before = ga.grid_additive.launches
        got = sharded.groupby("k", agg=agg, sort=True)
    assert ga.grid_additive.launches > before
    entry = sharded.executor.trace_log[-1]
    assert entry["mesh"]["shards"] == ["cuda:0"] * 4 and entry["device"] == "cuda:0"
    _same_frames(got, want)
    assert float(sharded.sum("x")) == float(sharded.sum("x"))  # the same bits twice


def test_the_shuffle_route_on_four_shards_of_the_card(cuda, monkeypatch):
    from vaex_tpu_torch import groupby
    df, _ = _mesh_table(cuda)
    agg = {"s": vaex_tpu_torch.agg.sum("v"), "c": "count", "m": vaex_tpu_torch.agg.mean("x"),
           "mn": vaex_tpu_torch.agg.min("x"), "sd": vaex_tpu_torch.agg.std("x")}
    with vaex_tpu_torch.cache.off():
        want = df.groupby("w", agg=agg, sort=True)
        monkeypatch.setattr(groupby, "SHUFFLE_MIN_G", 65_536)
        sharded = _four_shards(df)
        got = sharded.groupby("w", agg=agg, sort=True)
    entry = [e for e in sharded.executor.trace_log if e.get("shuffle") is True][-1]
    assert entry["devices"] == 4 and entry["strategies"]["additive"] in ("b2", "b3", "b3-l2")
    _same_frames(got, want)


def test_the_mesh_join_on_four_shards_of_the_card(cuda):
    g = torch.Generator(device=cuda).manual_seed(2)
    fact = vaex_tpu_torch.from_dataset(vaex_tpu_torch.DatasetArrays(
        {"key": torch.randint(0, 200_000, (1_000_003,), generator=g, device=cuda)}))
    dim = vaex_tpu_torch.from_dataset(vaex_tpu_torch.DatasetArrays(
        {"key": torch.arange(0, 150_000, device=cuda),
         "label": torch.randint(0, 100, (150_000,), generator=g, device=cuda)}))
    want = fact.join(dim, on="key")
    sharded = _four_shards(fact)
    before = probe.probe.launches + probe.probe.wide_launches
    got = sharded.join(dim, on="key")
    assert probe.probe.launches + probe.probe.wide_launches > before
    assert sharded.executor.trace_log[-1]["join"] == "mesh"
    a, b = got.dataset["label"], want.dataset["label"]
    assert torch.equal(a.index, b.index) and torch.equal(a.mask, b.mask)
    assert a.index.dtype == torch.int32 and a.index.is_cuda


def test_the_fused_mesh_groupby_on_four_shards_of_the_card(cuda):
    df, _ = _mesh_table(cuda)
    agg = {"c": "count", "s": vaex_tpu_torch.agg.sum("v"), "m": vaex_tpu_torch.agg.median("x")}
    with vaex_tpu_torch.cache.off():
        want = df.groupby("big", agg=agg, sort=True)
        sharded = _four_shards(df)
        got = sharded.groupby("big", agg=agg, sort=True)
    assert sharded.executor.trace_log[-1]["fused_mesh_groupby"] is True
    _same_frames(got, want, float_rtol=0)


def _sky(device, n=1_000_003, seed=25):
    """The same table on ``device`` whatever it is: drawn on the CPU."""
    g = torch.Generator().manual_seed(seed)
    cols = {"key": torch.randint(0, 100, (n,), generator=g),
            "x": torch.randn(n, generator=g, dtype=torch.float64),
            "ra": torch.rand(n, generator=g, dtype=torch.float64) * 360,
            "dec": torch.rand(n, generator=g, dtype=torch.float64) * 180 - 90}
    cols = {name: c.to(device) for name, c in cols.items()}
    return vaex_tpu_torch.from_dataset(vaex_tpu_torch.DatasetArrays(cols)).categorize(
        "key", labels=range(100))


def test_a_service_over_a_frame_on_the_card(cuda):
    """The same wire messages to a service over a cuda frame and over the
    same frame on the CPU: the same answers, the served frame still on the
    card, its kernels launched."""
    from vaex_tpu_torch.server.client import Client
    from vaex_tpu_torch.server.service import DummyTransport, Service
    frames = {"cuda": _sky(cuda), "cpu": _sky(torch.device("cpu"))}
    remote = {k: Client(DummyTransport(Service({"sky": df})))["sky"] for k, df in frames.items()}
    for dfr in remote.values():
        dfr["r"] = "sqrt(x**2 + 1)"
        dfr.select("dec > 0")
    before = ga.grid_additive.launches
    with vaex_tpu_torch.cache.off():
        got = {k: (dfr.count(binby=["x"], limits=[-3, 3], shape=64, selection=True),
                   dfr.mean("r", selection=True),
                   dfr.groupby("key", agg={"s": ("sum", "x"), "n": "count"}))
               for k, dfr in remote.items()}
    assert ga.grid_additive.launches > before
    npt.assert_array_equal(got["cuda"][0], got["cpu"][0])
    npt.assert_allclose(got["cuda"][1], got["cpu"][1], rtol=1e-12)
    npt.assert_array_equal(got["cuda"][2]["n"], got["cpu"][2]["n"])
    npt.assert_allclose(got["cuda"][2]["s"], got["cpu"][2]["s"], rtol=1e-9, atol=1e-9)
    assert all(t.is_cuda for t in frames["cuda"].dataset.values() if isinstance(t, torch.Tensor))


def test_linked_views_on_the_card(cuda):
    """One brush regrids a histogram and a heatmap of a cuda frame in one
    pass, B1 and B2 launched, the grids equal the CPU frame's."""
    from vaex_tpu_torch import jupyter
    grids = {}
    for name, device in (("cuda", cuda), ("cpu", torch.device("cpu"))):
        df = _sky(device)
        hist = jupyter.GridModel(df, [jupyter.Axis(df, "x", shape=64)], selection=[None, True])
        heat = jupyter.GridModel(df, [jupyter.Axis(df, "ra", shape=128),
                                      jupyter.Axis(df, "dec", shape=128)], selection=[None, True])
        hist.compute()
        heat.compute()
        before = (df.executor.passes, ga.grid_additive.launches, gw.grid_window.launches)
        with vaex_tpu_torch.cache.off():
            df.select("x > 1")
        assert df.executor.passes == before[0] + 1
        if name == "cuda":
            assert ga.grid_additive.launches > before[1] and gw.grid_window.launches > before[2]
        grids[name] = (hist.grid, heat.grid)
    for a, b in zip(grids["cuda"], grids["cpu"]):
        npt.assert_array_equal(a, b)


def _blobs(device, n=200_000, seed=0):
    """Eight float64 features around 16 centres, a float key, made from
    ``seed`` on ``device``."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    centres = torch.rand((16, 8), generator=g, dtype=torch.float64) * 20 - 10
    which = torch.randint(0, 16, (n,), generator=g)
    cols = {f"x{d}": (centres[which, d] + torch.randn(n, generator=g, dtype=torch.float64))
            .to(device) for d in range(8)}
    return vaex_tpu_torch.from_dataset(vaex_tpu_torch.DatasetArrays(cols))


def test_kmeans_fit_on_the_card(cuda):
    """KMeans on a cuda frame: each run's counts and sums through B1 (its
    launches counted), the centroids and inertia those of the same fit on
    the CPU (the plain version), the same bits when fitted twice."""
    features = [f"x{d}" for d in range(8)]
    kw = dict(features=features, n_clusters=16, n_init=3, max_iter=10, random_state=42,
              chunk_size=70_000)
    fits = {}
    for name, device in (("cuda", cuda), ("cpu", torch.device("cpu"))):
        df = _blobs(device)
        before = ga.grid_additive.launches
        fits[name] = vaex_tpu_torch.ml.KMeans(**kw).fit(df)
        if name == "cuda":
            # a launch per run and tile (three tiles of one sub-tile each) an iteration
            assert ga.grid_additive.launches - before == 3 * 3 * len(fits[name].inertias_)
            again = vaex_tpu_torch.ml.KMeans(**kw).fit(df)
            assert again.cluster_centers_ == fits[name].cluster_centers_
            pred = fits[name].predict(df)
    assert len(fits["cuda"].inertias_) == len(fits["cpu"].inertias_)
    npt.assert_allclose(fits["cuda"].cluster_centers_, fits["cpu"].cluster_centers_,
                        rtol=1e-9, atol=1e-12)
    npt.assert_allclose(fits["cuda"].inertia_, fits["cpu"].inertia_, rtol=1e-9)
    npt.assert_array_equal(pred, fits["cpu"].predict(_blobs(torch.device("cpu"))))


def test_standard_scaler_fit_launches_b4(cuda):
    df = _blobs(cuda, n=100_000)
    before = (ga.grid_additive.launches, gm.grid_moments.launches)
    with vaex_tpu_torch.cache.off():
        t = vaex_tpu_torch.ml.StandardScaler(features=["x0", "x1", "x2"]).fit(df)
    assert gm.grid_moments.launches > before[1] and ga.grid_additive.launches > before[0]
    for f, m, s in zip(t.features, t.mean_, t.std_):
        x = df.dataset[f]
        npt.assert_allclose(m, float(x.mean()), rtol=1e-9)
        npt.assert_allclose(s, float(x.std(correction=0)), rtol=1e-9)


@pytest.mark.parametrize("kernel,G,kind", [
    ("b4", 103, "var"), ("b4", 181, "var"), ("b4", 40, "corr"), ("b4", 64, "corr"),
    ("b5", 10_609, "var"), ("b5", 10_609, "corr"), ("b5", 60_000, "var")])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.int64])
def test_moment_kernels_take_a_shift_table(cuda, kernel, G, kind, dtype):
    """B4 (its lane and warp routes) and B5 with a shift a cell: a [G] table
    of each cell's offset, int64 for an int64 base, rows outside [0, G)
    dropped, against the plain version; the values lie 1e12 apart by cell,
    so the tables' sums are those of the cells' noise."""
    n = 400_009
    g = torch.Generator(device=cuda).manual_seed(G)
    idx = torch.randint(-2, G + 3, (n,), generator=g, device=cuda, dtype=torch.int32)
    offset = torch.linspace(-1e12, 1e12, G, device=cuda, dtype=torch.float64)
    cell = idx.clamp(0, G - 1).to(torch.int64)
    bases, tables = [], []
    for _ in range(1 if kind == "var" else 2):
        x = offset[cell] + torch.randn(n, generator=g, device=cuda, dtype=torch.float64) * 10
        if dtype == torch.int64:
            bases.append(x.round().to(torch.int64))
            tables.append(offset.round().to(torch.int64))
        else:
            bases.append(x.to(dtype))
            tables.append(offset.to(dtype).to(torch.float64))
    terms = agg.VAR_TERMS if kind == "var" else agg.CORR_TERMS
    fn = gm.grid_moments if kernel == "b4" else gm.grid_moments_window
    plain = gm.grid_moments_reference if kernel == "b4" else gm.grid_moments_window_reference
    before = fn.launches
    got = fn(idx, bases, terms, G, tables)
    assert fn.launches == before + 1
    want = plain(idx, bases, terms, G, tables)
    torch.cuda.synchronize()
    npt.assert_array_equal(got[0].cpu().numpy(), want[0].cpu().numpy())
    npt.assert_allclose(got[1].cpu().numpy(), want[1].cpu().numpy(), rtol=1e-9, atol=1e-6)
    if kernel == "b5":
        assert gm.grid_moments_window.last_parts == gm.n_parts(G, len(terms), 1, len(bases))
