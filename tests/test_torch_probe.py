"""The port's set probe (vaex_tpu_torch.ops.probe) against the TPU kernel it
replaces, vaex_tpu.ops.pallas_probe._probe_kernel, and against numpy; and
the probes of a pass (vaex_tpu_torch.ops.setops.device_map_ordinal /
device_isin) against vaex_tpu's.

The Pallas kernel runs here in interpret mode: a test-local monkeypatch
gives the module a ``pl`` whose ``pallas_call`` interprets the kernel body
on the CPU.  On the CPU the port's wrapper takes its plain version.  Ordinals
are integers: every comparison is exact.
"""

import functools
import types

import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch
from jax.experimental import pallas as pl

from vaex_tpu.ops import pallas_probe
from vaex_tpu.ops import setops as ref_setops
from vaex_tpu.ops.nullable import NA as RefNA
from vaex_tpu_torch.ops import probe as probe_module
from vaex_tpu_torch.ops import setops
from vaex_tpu_torch.ops.nullable import NA

DTYPES = ["int8", "int32", "int64", "float32", "float64"]


@pytest.fixture
def interpret_pallas(monkeypatch):
    shim = types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True), BlockSpec=pl.BlockSpec)
    monkeypatch.setattr(pallas_probe, "pl", shim)


def _inputs(seed, dtype, M, n):
    """M sorted unique keys of ``dtype`` and n rows: hits, misses, rows below
    the first and above the last key and, for floats, -0.0 and NaN."""
    rng = np.random.default_rng(seed)
    dtype = np.dtype(dtype)
    if dtype == np.int8:
        pool = np.arange(-100, 100)
        M = min(M, 150)
    else:
        pool = np.arange(-3 * M, 3 * M + 1)
    keys = np.sort(rng.choice(pool, M, replace=False)).astype(dtype)
    if dtype.kind == "f":
        keys = np.where(keys == 0, 0.0, keys * 0.5).astype(dtype)  # halves, and the key 0.0
    lo, hi = (keys[0] - 3, keys[-1] + 3) if dtype != np.int8 else (-128, 127)
    x = rng.integers(int(np.floor(lo)), int(np.ceil(hi)) + 1, n).astype(dtype)
    if dtype.kind == "f":
        x = (x * 0.5).astype(dtype)
        x[::7] = -0.0
        x[3::11] = np.nan
    if n:
        x[::5] = rng.choice(keys, len(x[::5]))  # certain hits
    return keys, x


def _numpy_ordinals(keys, x):
    idx = np.clip(np.searchsorted(keys, x), 0, len(keys) - 1)
    return np.where(keys[idx] == x, idx, -1).astype(np.int32)


@pytest.mark.parametrize("n", [0, 1, 4097])
@pytest.mark.parametrize("M", [1, 64, 500, 2048])
@pytest.mark.parametrize("dtype", DTYPES)
def test_probe_matches_numpy(dtype, M, n):
    keys, x = _inputs(M + n, dtype, M, n)
    got = probe_module.probe(torch.as_tensor(keys), torch.as_tensor(x))
    assert got.dtype == torch.int32 and got.shape == (n,)
    npt.assert_array_equal(got.numpy(), _numpy_ordinals(keys, x))
    if np.dtype(dtype).kind == "f" and n > 11:
        assert (got.numpy()[3::11][np.isnan(x[3::11])] == -1).all()  # NaN finds nothing
        if (keys == 0).any():  # -0.0 finds the key 0.0
            zero = int(np.flatnonzero(keys == 0)[0])
            assert (got.numpy()[np.signbit(x) & (x == 0)] == zero).all()


@pytest.mark.parametrize("dtype,M,n", [
    ("int64", 500, 10_000), ("float64", 65, 5_000), ("int64", 2048, 4097),
    ("int32", 100, 4097), ("float32", 301, 4097), ("int8", 64, 1), ("float64", 1, 0)])
def test_probe_matches_the_pallas_kernel(interpret_pallas, dtype, M, n):
    keys, x = _inputs(M, dtype, M, n)
    want = np.asarray(pallas_probe.probe_ordinals(jnp.asarray(keys), jnp.asarray(x)))
    got = probe_module.probe_reference(torch.as_tensor(keys), torch.as_tensor(x))
    npt.assert_array_equal(got.numpy(), want)


def test_probe_widens_mixed_dtypes():
    keys = torch.tensor([-2, 0, 3, 2 ** 40], dtype=torch.int64)
    got = probe_module.probe(keys, torch.tensor([3, -2, 1, 0], dtype=torch.int8))
    assert got.tolist() == [2, 0, -1, 1]
    got = probe_module.probe(keys, torch.tensor([3.0, 0.5, -0.0, float("nan")]))
    assert got.tolist() == [2, -1, 1, -1]
    got = probe_module.probe(torch.tensor([False, True]), torch.tensor([True, False, True]))
    assert got.tolist() == [1, 0, 1]


def test_probe_refuses_what_the_kernel_does_not_take():
    keys = torch.arange(4)
    with pytest.raises(ValueError, match="1-d"):
        probe_module.probe(keys, torch.zeros(2, 2))
    if probe_module.UINT64 is not None:
        with pytest.raises(NotImplementedError, match="ROADMAP queue A5"):
            probe_module.probe(keys, torch.zeros(3, dtype=probe_module.UINT64))


def test_plan_fills_the_card_within_its_limits():
    for M in (1, 64, 2048, 16_384, probe_module.MAX_KEYS):
        for n in (0, 1, 1_000_003, 100_000_000):
            n_ctas, threads = probe_module.plan(n, M, 132)
            assert 1 <= n_ctas and threads in (512, 1024)
            per_sm = -(-n_ctas // 132)
            assert per_sm * threads <= probe_module.SM_THREADS
            assert per_sm * (M * 8 + 1024) <= probe_module.SM_SMEM
    assert probe_module.MAX_KEYS * 8 <= probe_module.SMEM_BUDGET
    assert setops.probe_route(probe_module.MAX_KEYS) == "b6"
    assert setops.probe_route(probe_module.MAX_KEYS + 1) == "b6-wide"


@pytest.mark.parametrize("M", [29_057, 50_000, 1_000_003, 2 ** 31 - 1])
def test_wide_plan_keeps_the_samples_within_shared_memory(M):
    for n in (0, 1, 1_000_003, 100_000_000):
        n_ctas, threads, S = probe_module.plan_wide(n, M, 132)
        samples = -(-M // S)
        assert S >= 2 and S & (S - 1) == 0
        assert samples <= probe_module.TOP_KEYS < -(-M // (S // 2)) or S == 2
        assert 1 <= n_ctas and threads == 512
        per_sm = -(-n_ctas // 132)
        assert per_sm * threads <= probe_module.SM_THREADS
        assert per_sm * (samples * 8 + 1024) <= probe_module.SM_SMEM


def _handles(keys, has_nan, has_null):
    n = len(keys)
    return (ref_setops.DeviceSetHandle(jnp.asarray(keys), n, has_nan, has_null),
            setops.DeviceSetHandle(torch.as_tensor(keys), n, has_nan, has_null))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("has_null", [False, True])
@pytest.mark.parametrize("has_nan", [False, True])
@pytest.mark.parametrize("dtype,M", [("float64", 65), ("int64", 500), ("float32", 0)])
def test_device_probes_match_vaex_tpu(dtype, M, has_nan, has_null, masked):
    if M:
        keys, x = _inputs(M + 17, dtype, M, 3_000)
    else:
        keys, x = np.empty(0, dtype), np.array([1.0, np.nan, -0.0, 2.5] * 10, dtype)
    mask = (np.random.default_rng(3).random(len(x)) < 0.2) if masked else None
    ref_handle, handle = _handles(keys, has_nan, has_null)
    ref_x = RefNA(jnp.asarray(x), None if mask is None else jnp.asarray(mask))
    port_x = NA(torch.as_tensor(x), None if mask is None else torch.as_tensor(mask))
    got = setops.device_map_ordinal(handle, port_x)
    assert got.dtype == torch.int32
    npt.assert_array_equal(got.numpy(),
                           np.asarray(ref_setops.device_map_ordinal(ref_handle, ref_x)))
    got = setops.device_isin(handle, port_x)
    assert got.dtype == torch.bool
    npt.assert_array_equal(got.numpy(), np.asarray(ref_setops.device_isin(ref_handle, ref_x)))
    assert handle.route == ("b6" if M else None)
