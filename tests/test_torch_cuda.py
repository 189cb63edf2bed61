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
    assert strategy["extremes"] == "torch"
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
