"""The result cache of vaex_tpu_torch (vaex_tpu/cache.py): every backend,
hits and misses, the set build, the filter mask and the one-sort groupby
served from it, and its key, which is exact where vaex_tpu's samples: two
tables that differ in one row outside the sample, and a tensor written in
place after a cached query, share no result."""

import importlib.util

import numpy as np
import numpy.testing as npt
import pytest
import torch

import vaex_tpu
import vaex_tpu_torch
from torch_port_helpers import same_frames, seeded_arrays
from vaex_tpu_torch import cache


@pytest.fixture(autouse=True)
def fresh_cache():
    cache.clear()
    yield
    cache.clear()


def _passes(df, f):
    p0 = df.executor.passes
    out = f()
    return out, df.executor.passes - p0


def test_a_set_build_is_served_from_the_cache():
    arrays = seeded_arrays(5, 3000, 20)
    ref, port = same_frames(arrays)
    want = ref.unique("k")
    h0, m0 = cache.hits, cache.misses
    got, passes = _passes(port, lambda: port.unique("k"))
    assert got == want and passes == 1 and cache.misses == m0 + 1
    again, passes = _passes(port, lambda: port.unique("k"))
    assert again == want and passes == 0 and cache.hits == h0 + 1
    with cache.off():
        assert not cache.is_on()
        _, passes = _passes(port, lambda: port.unique("k"))
        assert passes == 1
    assert cache.is_on()


def test_an_aggregation_is_never_served_from_the_cache():
    _, port = same_frames(seeded_arrays(5, 3000, 20))
    _, first = _passes(port, lambda: port.sum("x"))
    _, second = _passes(port, lambda: port.sum("x"))
    assert first == second == 1


def test_tables_that_differ_outside_any_sample_share_no_result():
    """vaex_tpu's fingerprint hashes a head, a stride and a tail: row 1501 of
    5000 is in none, so its cache serves one table's set to the other
    (ROADMAP, known problems of the reference); the port's key is exact."""
    a = np.arange(5000) % 7
    b = a.copy()
    b[1501] = 99
    left = vaex_tpu_torch.from_arrays(k=a).to_device("cpu")
    right = vaex_tpu_torch.from_arrays(k=b).to_device("cpu")
    with cache.memory():
        assert left.unique("k") == list(range(7))
        assert right.unique("k") == list(range(7)) + [99]
    ref_left, ref_right = vaex_tpu.from_arrays(k=a), vaex_tpu.from_arrays(k=b)
    assert ref_left.unique("k") == list(range(7))
    assert ref_right.unique("k") == list(range(7))  # the other table's set


def test_host_tables_that_differ_in_one_row_share_no_result(monkeypatch):
    from vaex_tpu_torch import settings
    monkeypatch.setattr(settings, "DEVICE", "cpu")
    a = np.arange(5000) % 7
    b = a.copy()
    b[1501] = 99
    assert vaex_tpu_torch.from_arrays(k=a).unique("k") == list(range(7))
    assert vaex_tpu_torch.from_arrays(k=b).unique("k") == list(range(7)) + [99]
    # the same values in another array: a content key, served
    c = a.copy()
    df = vaex_tpu_torch.from_arrays(k=c)
    _, passes = _passes(df, lambda: df.unique("k"))
    assert passes == 0


def test_an_in_place_write_after_a_cached_query_gives_the_new_answer():
    k = torch.arange(4000) % 11
    port = vaex_tpu_torch.from_arrays(k=k, x=torch.ones(4000, dtype=torch.float64)).to_device(
        "cpu")
    assert port.unique("k") == list(range(11))
    assert port.nunique("k") == 11
    k[3999] = 500  # in place, after the cached set
    assert port.unique("k") == list(range(11)) + [500]
    assert port.nunique("k") == 12
    view = port.dataset["k"][100:200]
    view += 1000  # through a view of the same storage
    assert 1010 in port.unique("k")
    got = port.groupby("k", agg="count")
    assert dict(zip(got["k"].tolist(), got["count"].tolist()))[500] == 1


def test_a_filter_mask_is_served_and_keyed_by_the_filter():
    _, port = same_frames(seeded_arrays(6, 3000, 20))
    a = port[port.x > 0]
    first, passes = _passes(a, lambda: len(a.extract()))
    assert passes == 1  # the mask; the extracted frame's length needs no pass
    second, passes = _passes(a, lambda: len(a.extract()))
    assert second == first and passes == 0
    b = port[port.x > 1]
    assert len(b.extract()) == int((port.evaluate("x") > 1).sum())


def test_the_one_sort_groupby_is_served_from_the_cache():
    rng = np.random.default_rng(3)
    arrays = {"a": rng.integers(0, 5_000_000, 4000), "b": rng.integers(0, 9, 4000),
              "v": rng.normal(0, 1, 4000)}
    port = vaex_tpu_torch.from_arrays(**arrays).to_device("cpu")
    agg = {"s": vaex_tpu_torch.agg.sum("v"), "c": "count"}
    first, _ = _passes(port, lambda: port.groupby(["a", "b"], agg=agg, sort=True))
    assert port.executor.trace_log[-1]["groupby"] == "one-sort"
    n_log = len(port.executor.trace_log)
    second, passes = _passes(port, lambda: port.groupby(["a", "b"], agg=agg, sort=True))
    assert passes == 0 and len(port.executor.trace_log) == n_log
    for name in ("a", "b", "s", "c"):
        npt.assert_array_equal(second[name].values, first[name].values)
    port.dataset["v"][0] += 1.0  # a value column written in place: sorted again
    third, passes = _passes(port, lambda: port.groupby(["a", "b"], agg=agg, sort=True))
    assert passes == 1
    npt.assert_allclose(third["s"].values.sum(), first["s"].values.sum() + 1.0, rtol=1e-12)


def test_clear_returns_the_device_lrus_bytes():
    _, port = same_frames(seeded_arrays(7, 3000, 20))
    port.unique("k")
    held = cache.device_backend.nbytes
    assert held > 0 and cache.clear() == held and cache.device_backend.nbytes == 0


def test_the_device_lru_evicts_past_its_bytes():
    lru = cache.MemoryCacheLRU(size_limit=1000)
    lru.set("a", torch.zeros(100))  # 400 bytes
    lru.set("b", torch.zeros(100))
    assert lru.get("a") is not None  # a is now the most recent
    lru.set("c", torch.zeros(100))
    assert lru.get("b") is None and lru.get("a") is not None and lru.nbytes == 800
    lru.set("big", torch.zeros(1000))  # larger than the whole LRU: not kept
    assert lru.get("big") is None and lru.nbytes == 800


def test_memory_backends():
    for backend in (cache.MemoryCache(), cache.MemoryCacheLRU(1 << 20)):
        backend.set("k", {"v": 1})
        assert backend.get("k") == {"v": 1} and len(backend) == 1
        backend.clear()
        assert backend.get("k") is None


def test_disk_backend_keeps_content_keys_only(tmp_path):
    disk = cache.DiskCache(str(tmp_path), size_limit=1 << 20)
    key = cache.key("a", 1)
    disk.set(key, np.arange(5))
    npt.assert_array_equal(disk.get(key), np.arange(5))
    identity_key = cache.key("b", content=False)
    disk.set(identity_key, 1)
    assert disk.get(identity_key) is None and len(disk) == 1
    # past its size the least recently read file goes
    small = cache.DiskCache(str(tmp_path / "small"), size_limit=3000)
    for i in range(5):
        small.set(cache.key(i), np.zeros(200))
    assert len(small) < 5
    disk.clear()
    assert len(disk) == 0


def test_a_string_set_through_the_disk_backend(tmp_path, monkeypatch):
    from vaex_tpu_torch import settings
    monkeypatch.setattr(settings, "DEVICE", "cpu")
    values = np.array(["a", "b", "a", None, "c"] * 100, dtype=object)
    with cache.disk(str(tmp_path)):
        df = vaex_tpu_torch.from_arrays(s=values)
        assert df.unique("s") == ["a", "b", "c", None]
        assert len(cache.DiskCache(str(tmp_path))) == 1
        again = vaex_tpu_torch.from_arrays(s=values.copy())
        _, passes = _passes(again, lambda: again.unique("s"))
        assert passes == 0


def test_multilevel_fills_the_faster_level(tmp_path):
    fast, slow = cache.MemoryCache(), cache.DiskCache(str(tmp_path))
    both = cache.MultilevelCache(fast, slow)
    key = cache.key("x")
    slow.set(key, 7)
    assert both.get(key) == 7 and fast.get(key) == 7
    both.clear()
    assert both.get(key) is None


def test_redis_backend_through_a_client():
    class Client:
        def __init__(self):
            self.data = {}

        def get(self, k):
            return self.data.get(k)

        def set(self, k, v):
            self.data[k] = v

        def flushdb(self):
            self.data.clear()
    redis = cache.RedisCache(client=Client())
    key = cache.key("r")
    redis.set(key, [1, 2])
    assert redis.get(key) == [1, 2]
    redis.set(cache.key("t", content=False), 1)
    assert len(redis.client.data) == 1
    redis.clear()
    assert redis.get(key) is None
    if importlib.util.find_spec("redis") is None:
        with pytest.raises(ImportError):
            cache.RedisCache()


def test_configure_and_context_managers():
    try:
        cache.configure("disabled")
        assert not cache.is_on()
        cache.configure("memory_lru")
        assert cache.is_on()
        with pytest.raises(ValueError):
            cache.configure("nowhere")
    finally:
        cache.configure("memory")
    with cache.memory_infinite(clear_on_exit=True):
        assert cache.is_on()
    with cache.memory(size_limit=1 << 10):
        assert cache.is_on()
