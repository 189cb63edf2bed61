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
from vaex_tpu_torch.ops import grid_additive as ga
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
    [strategy] = df.executor.trace_log[-1]["strategies"]
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
