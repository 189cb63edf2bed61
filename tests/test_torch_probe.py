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
        tree = probe_module.build_tree(torch.arange(M, dtype=torch.int64) * 7, narrow=False)
        assert tree.route == "b6" and tree.smem == probe_module.tree_bytes(M, 8)
        assert tree.unroll == probe_module.ROUTE_UNROLL["b6"]
        for n in (0, 1, 1_000_003, 100_000_000):
            n_ctas, threads = probe_module.plan(n, tree.smem, 132, tree.unroll)
            assert 1 <= n_ctas and threads in (512, 1024)
            per_sm = -(-n_ctas // 132)
            assert per_sm * threads <= probe_module.SM_THREADS
            assert per_sm * (tree.smem + 1024) <= probe_module.SM_SMEM
    for key_bytes in (8, 4):
        most = probe_module.max_keys(key_bytes)
        assert probe_module.tree_bytes(most, key_bytes) <= probe_module.SMEM_BUDGET \
            < probe_module.tree_bytes(most + 1, key_bytes)
        assert probe_module.probe_route(most, key_bytes) == "b6"
        assert probe_module.probe_route(most + 1, key_bytes) == "b6-wide"
    # 4-byte keys reach twice as far: the isin with 50 000 ids takes b6
    assert probe_module.NARROW_MAX_KEYS == probe_module.max_keys(4) >= 2 * probe_module.MAX_KEYS
    assert probe_module.probe_route(50_000, 4) == "b6"
    assert probe_module.probe_route(50_000) == "b6-wide"
    assert probe_module.probe_route(probe_module.MAX_KEYS) == "b6"
    assert probe_module.probe_route(probe_module.MAX_KEYS + 1) == "b6-wide"


@pytest.mark.parametrize("M", [29_057, 50_000, 1_000_003, 2 ** 31 - 1])
def test_wide_plan_keeps_the_samples_within_shared_memory(M):
    """The top levels of a wide tree that the kernel stages fit
    ``WIDE_SMEM``, and one more level would not; the levels fit the
    kernel."""
    line = probe_module.LINE_BYTES
    counts = probe_module.level_counts(M, line // 8)
    assert len(counts) - 1 <= probe_module.MAX_LEVELS
    if M <= 1_000_003:
        keys = torch.arange(M, dtype=torch.float64)
        tree = probe_module.build_tree(keys)
        assert tree.counts == tuple(counts) and tree.route == "b6-wide"
        assert tree.unroll == probe_module.ROUTE_UNROLL["b6-wide"]
        staged = tree.offsets[tree.shared_levels] * line
        assert tree.smem == staged <= probe_module.WIDE_SMEM
        assert tree.shared_levels == tree.levels or \
            staged + counts[tree.shared_levels] * line > probe_module.WIDE_SMEM
        for n in (0, 1, 1_000_003, 100_000_000):
            n_ctas, threads = probe_module.plan(n, tree.smem, 132, tree.unroll)
            per_sm = -(-n_ctas // 132)
            assert per_sm * threads <= probe_module.SM_THREADS
            assert per_sm * (tree.smem + 1024) <= probe_module.SM_SMEM


INT64 = np.iinfo(np.int64)
# a 32-byte line holds L = 4 8-byte keys (8 4-byte ones), an inner node
# L + 1 children: M at the edges of a leaf, of a node's leaves
# (L * (L + 1) = 20, 72) and of a third level (L * (L + 1)^2 = 100, 648)
TREE_CASES = [(M, dtype) for dtype in ("int64", "float64")
              for M in (1, 3, 4, 5, 7, 8, 9, 15, 16, 17, 20, 21, 72, 73, 100, 101, 500, 648,
                        649, 50_000)]


@pytest.mark.parametrize("narrow", [False, True])
@pytest.mark.parametrize("M,dtype", TREE_CASES)
def test_tree_search_matches_the_plain_probe(M, dtype, narrow):
    """B6's layout searched in plain torch (the kernel's walk: one line per
    level, the child clamped, equality at a position below M) gives
    probe_reference's ordinals, the int set both narrow and wide (a float
    set is never narrow)."""
    keys, x = _inputs(M + 32 * (1 + narrow), dtype, M, 6_000)
    want = probe_module.probe_reference(torch.as_tensor(keys), torch.as_tensor(x))
    tree = probe_module.build_tree(torch.as_tensor(keys), narrow=narrow)
    assert tree.kind == (1 if dtype == "float64" else 2 if narrow else 0)
    assert tree.route == probe_module.probe_route(M, tree.key_bytes)
    assert tree.leaves.numel() == tree.counts[-1] * tree.L
    got = probe_module.tree_search_reference(tree, torch.as_tensor(x))
    npt.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("dtype", ["int64", "float64"])
def test_tree_search_at_the_sentinel_edge_keys(dtype):
    """Keys equal to the pad (INT64_MAX, +inf) and the other extremes are
    found where they are and nowhere else; -0.0 finds 0.0; NaN finds
    nothing."""
    if dtype == "int64":
        keys = np.array([INT64.min, -5, 0, 7, INT64.max - 1, INT64.max], np.int64)
        x = np.array([INT64.max, INT64.min, INT64.max - 1, 3, 7, 0, INT64.min + 1], np.int64)
    else:
        keys = np.array([-np.inf, -1.5, 0.0, 2.0, np.finfo(np.float64).max, np.inf])
        x = np.array([np.inf, -np.inf, -0.0, np.nan, 2.0, 1.0, np.finfo(np.float64).max])
    for M in (len(keys), 3, 2):
        k = torch.as_tensor(keys[-M:])
        want = _numpy_ordinals(keys[-M:], x)
        for narrow in (False, True):
            tree = probe_module.build_tree(k, narrow=narrow)
            got = probe_module.tree_search_reference(tree, torch.as_tensor(x))
            npt.assert_array_equal(got.numpy(), want)
            npt.assert_array_equal(probe_module.probe(k, torch.as_tensor(x)).numpy(), want)


@pytest.mark.parametrize("span,narrow", [(2 ** 32 - 1, True), (2 ** 32, False)])
def test_narrow_keys_need_a_range_below_2_32(span, narrow):
    """An int set spanning 2^32 - 1 is stored as 4-byte offsets, one spanning
    2^32 is not; rows outside the range miss before the search, also
    where the offset would wrap."""
    lo = -(2 ** 40)
    keys = np.array([lo, lo + 1, lo + 2 ** 31, lo + span - 1, lo + span], np.int64)
    x = np.concatenate([keys, keys - 1, keys + 1, [lo + 2 ** 32, lo - 2 ** 32, lo + 2 ** 33,
                                                  INT64.max, INT64.min]]).astype(np.int64)
    tree = probe_module.build_tree(torch.as_tensor(keys), narrow=True)
    assert (tree.kind == probe_module.KIND_NARROW) == narrow
    assert tree.inner.dtype == tree.leaves.dtype == (torch.int32 if narrow else torch.int64)
    got = probe_module.tree_search_reference(tree, torch.as_tensor(x))
    npt.assert_array_equal(got.numpy(), _numpy_ordinals(keys, x))
    got32 = probe_module.tree_search_reference(
        tree, torch.as_tensor(np.arange(-5, 5, dtype=np.int32)))
    npt.assert_array_equal(got32.numpy(), -np.ones(10, np.int32))


@pytest.mark.parametrize("M,dtype,n", [(1, "int64", 300), (17, "float64", 700),
                                       (500, "int64", 2_000)])
def test_tree_search_matches_the_pallas_kernel(interpret_pallas, M, dtype, n):
    keys, x = _inputs(M + 3, dtype, M, n)
    want = np.asarray(pallas_probe.probe_ordinals(jnp.asarray(keys), jnp.asarray(x)))
    tree = probe_module.build_tree(torch.as_tensor(keys))
    got = probe_module.tree_search_reference(tree, torch.as_tensor(x))
    npt.assert_array_equal(got.numpy(), want)


def test_handle_builds_its_tree_once_per_dtype():
    """A handle builds B6's tree once per compare dtype and shares it with
    the later handles of its set; a probe on the CPU, which takes the plain
    version, builds none but records the route the card would take."""
    oset = setops.SortedSet("int64")
    oset.update(np.array([5, 1, 9, 1, 3], np.int64))
    handle = setops.DeviceSetHandle.of(oset, "cpu")
    rows = NA(torch.tensor([9, 2, 1], dtype=torch.int64))
    assert setops.device_map_ordinal(handle, rows).tolist() == [3, -1, 0]
    assert handle.trees == {} and handle.route == "b6"
    tree = handle.tree(torch.int64)
    assert handle.tree(torch.int64) is tree and handle.trees[torch.int64] is tree
    again = setops.DeviceSetHandle.of(oset, "cpu")  # a later pass shares the build
    assert again.trees is handle.trees
    again.tree(torch.float64)
    assert set(handle.trees) == {torch.int64, torch.float64}
    oset.update(np.array([4], np.int64))  # a changed set forgets its trees
    assert setops.DeviceSetHandle.of(oset, "cpu").trees == {}


@pytest.mark.parametrize("M,narrow,route", [
    (500, False, "b6"), (probe_module.MAX_KEYS + 1, False, "b6-wide"),
    (50_000, True, "b6"), (probe_module.NARROW_MAX_KEYS + 1, True, "b6-wide")])
def test_a_cpu_probe_records_the_cards_route(M, narrow, route):
    """The route a CPU probe records is its tree's on the card: an int set
    of ``NARROW_MIN_KEYS`` keys or more within 2^32 on 4-byte keys, one
    spread past 2^32 on 8-byte keys."""
    keys = torch.arange(M, dtype=torch.int64) * (3 if narrow else 2 ** 22)
    handle = setops.DeviceSetHandle(keys, M, False, False)
    rows = keys[::7].clone()
    npt.assert_array_equal(setops.device_probe(handle, rows).numpy(), np.arange(0, M, 7))
    assert handle.route == route == probe_module.build_tree(keys).route
    assert handle.trees == {}


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
