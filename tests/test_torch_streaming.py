"""The streamed pass (vaex_tpu_torch.stream) on the CPU, and the file key.

A pass over host columns of more than one tile goes through the producer
thread and its ring of slots (unpinned here, no CUDA streams); every answer
is held to the same query with the synchronous copy (``PREFETCH =
TRANSFER_AHEAD = 0``, the plain version) and to vaex_tpu over the same
file.  Counts and int sums exact, floats to the contract.
"""

import os
import sys
import threading

import numpy as np
import numpy.testing as npt
import pytest

import vaex_tpu
import vaex_tpu_torch
from vaex_tpu_torch import cache, column, dataset, settings, stream, utils
from vaex_tpu_torch.execution import UserAbort
from torch_port_helpers import ATOL, RTOL

STREAM_THREADS = ("vaex-tpu-torch-stream", "vaex-tpu-torch-io")


@pytest.fixture(autouse=True)
def on_the_cpu(monkeypatch):
    monkeypatch.setattr(settings, "DEVICE", "cpu")
    stream.clear_proofs()
    yield
    assert not stream_threads()


def stream_threads():
    return [t.name for t in threading.enumerate() if t.name.startswith(STREAM_THREADS)]


def arrays(seed, n=3001, wide=None):
    """k an int64 key in 0..9 (``wide`` at row 17 where given), x float64,
    m a masked float64, u uint64 below 2^31, f float32 values as float64."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 10, n).astype(np.int64)
    if wide is not None:
        k[17] = wide
    return {"k": k, "x": rng.normal(0, 1, n),
            "m": np.ma.MaskedArray(rng.normal(0, 1, n), rng.random(n) < 0.1),
            "u": rng.integers(0, 1000, n).astype(np.uint64),
            "f": rng.normal(0, 1, n).astype(np.float32).astype(np.float64)}


def write(tmp_path, name, data, package=vaex_tpu_torch):
    path = str(tmp_path / name)
    package.from_arrays(**data).export(path)
    return path


def groupby(df, package=vaex_tpu_torch):
    a = package.agg
    return df.groupby("k", agg={"s": a.sum("x"), "c": "count", "sm": a.sum("m"),
                                "su": a.sum("u"), "mf": a.mean("f")}, sort=True)


def answer(out):
    return {name: out[name].tolist() for name in out.get_column_names()}


def same(got, want):
    assert got["k"] == want["k"] and got["c"] == want["c"] and got["su"] == want["su"]
    for name in ("s", "sm", "mf"):
        npt.assert_allclose(got[name], want[name], rtol=RTOL, atol=ATOL, err_msg=name)


class synchronous:
    def __init__(self, monkeypatch):
        self.mp = monkeypatch

    def __enter__(self):
        self.mp.setattr(settings, "PREFETCH", 0)
        self.mp.setattr(settings, "TRANSFER_AHEAD", 0)

    def __exit__(self, *exc):
        self.mp.setattr(settings, "PREFETCH", 2)
        self.mp.setattr(settings, "TRANSFER_AHEAD", 2)


def sources(tmp_path, data):
    """The same rows as host frames of every kind a stream reads."""
    out = {}
    for ext in ("hdf5", "arrow", "parquet"):
        out[ext] = vaex_tpu_torch.open(write(tmp_path, f"t.{ext}", data))
    out["arrays"] = vaex_tpu_torch.from_arrays(**data)
    half = len(data["k"]) // 3
    for i, part in enumerate(({n: a[:half] for n, a in data.items()},
                              {n: a[half:] for n, a in data.items()})):
        write(tmp_path, f"p{i}.parquet", part)
    out["concat"] = vaex_tpu_torch.open(str(tmp_path / "p*.parquet"))
    merged = vaex_tpu_torch.open(str(tmp_path / "t.hdf5"))[["k", "x", "m", "u"]]
    merged.add_column("f", data["f"])
    out["merged"] = merged
    return out


@pytest.mark.parametrize("tile_rows", (7, 64, 1000))
@pytest.mark.parametrize("ahead", (1, 2, 4))
def test_the_ring_gives_the_synchronous_answer(tmp_path, monkeypatch, tile_rows, ahead):
    data = arrays(1)
    monkeypatch.setattr(settings, "TRANSFER_AHEAD", ahead)
    want = answer(groupby(vaex_tpu.open(write(tmp_path, "ref.hdf5", data, vaex_tpu)), vaex_tpu))
    for name, df in sources(tmp_path, data).items():
        df._tile_rows = tile_rows
        got = answer(groupby(df))
        log = df.executor.trace_log[-1]
        assert log["stream"]["mode"] == "transfer-ahead", name
        assert log["stream"]["ring"] == ahead + 1
        assert log["tiles"] == -(-len(data["k"]) // tile_rows)
        same(got, want)
        with synchronous(monkeypatch):
            same(answer(groupby(df)), got)
            assert df.executor.trace_log[-1]["stream"] is None
        monkeypatch.setattr(settings, "TRANSFER_AHEAD", ahead)


def test_prefetch_alone_reads_ahead_and_copies_in_the_pass(tmp_path, monkeypatch):
    data = arrays(2)
    want = answer(groupby(vaex_tpu_torch.from_arrays(**data).to_device("cpu")))
    monkeypatch.setattr(settings, "TRANSFER_AHEAD", 0)
    for name, df in sources(tmp_path, data).items():
        df._tile_rows = 100
        same(answer(groupby(df)), want)
        assert df.executor.trace_log[-1]["stream"]["mode"] == "prefetch", name


@pytest.mark.parametrize("budget_rows", (5, 300, 2000))
def test_the_ring_is_bounded_by_bytes(tmp_path, monkeypatch, budget_rows):
    """The tile shrinks to the largest power of two whose ring of slots fits
    STREAM_RING_BYTES (5 columns of 8 bytes and a mask byte, 3 slots)."""
    data = arrays(4)
    want = answer(groupby(vaex_tpu_torch.from_arrays(**data).to_device("cpu")))
    monkeypatch.setattr(stream, "RING_TILE_ROWS_MIN", 1)
    monkeypatch.setattr(settings, "STREAM_RING_BYTES", 3 * 45 * budget_rows)
    df = vaex_tpu_torch.open(write(tmp_path, "t.hdf5", data))
    df._tile_rows = 1000
    same(answer(groupby(df)), want)
    log = df.executor.trace_log[-1]
    tile = min(1000, 1 << (budget_rows.bit_length() - 1))
    assert log["tile_rows"] == tile and log["tiles"] == -(-len(data["k"]) // tile)
    assert 0 < log["stream"]["ring_bytes"] <= max(3 * 45 * budget_rows, 3 * 45 * 1000)
    if budget_rows < 1000:
        assert log["stream"]["ring_bytes"] <= settings.STREAM_RING_BYTES
    monkeypatch.setattr(settings, "TRANSFER_AHEAD", 0)  # prefetch holds no slots
    same(answer(groupby(df)), want)
    assert df.executor.trace_log[-1]["tile_rows"] == 1000


def test_the_ring_keeps_its_least_tile_past_the_budget(tmp_path, monkeypatch):
    monkeypatch.setattr(settings, "STREAM_RING_BYTES", 1)
    df = vaex_tpu_torch.open(write(tmp_path, "t.hdf5", arrays(5)))
    assert stream.ring_tile_rows(df.dataset, ["k", "x"], 1 << 26) == stream.RING_TILE_ROWS_MIN
    assert stream.ring_tile_rows(df.dataset, ["k", "x"], 100) == stream.RING_TILE_ROWS_MIN


def test_a_single_tile_is_copied_synchronously(tmp_path):
    df = vaex_tpu_torch.open(write(tmp_path, "t.hdf5", arrays(3)))
    groupby(df)
    assert df.executor.trace_log[-1]["stream"] is None


@pytest.mark.parametrize("tile_rows", (7, 250))
def test_a_cancel_stops_the_producer(tmp_path, tile_rows):
    data = arrays(4)
    df = vaex_tpu_torch.open(write(tmp_path, "t.hdf5", data))
    df._tile_rows = tile_rows
    want = answer(groupby(df))
    calls = []
    cb = df.executor.signal_progress.connect(lambda p: calls.append(p) or len(calls) < 3)
    with pytest.raises(UserAbort):
        groupby(df)
    df.executor.signal_progress.disconnect(cb)
    assert len(calls) == 3 and not stream_threads()
    same(answer(groupby(df)), want)


@pytest.mark.parametrize("at", (0, 2, 9))
def test_an_exception_in_the_producer_raises_in_the_pass(tmp_path, monkeypatch, at):
    data = arrays(5)
    df = vaex_tpu_torch.open(write(tmp_path, "t.hdf5", data))
    df._tile_rows = 100
    want = answer(groupby(df))
    real = type(df.dataset).chunk_iterator

    def failing(self, columns, chunk_size=None, reverse=False):
        for i, chunk in enumerate(real(self, columns, chunk_size, reverse)):
            if i == at:
                raise OSError("the disk went away")
            yield chunk
    monkeypatch.setattr(type(df.dataset), "chunk_iterator", failing)
    with pytest.raises(OSError, match="went away"):
        groupby(df)
    assert not stream_threads()
    monkeypatch.setattr(type(df.dataset), "chunk_iterator", real)
    same(answer(groupby(df)), want)


def test_an_exception_in_the_pass_stops_the_producer(tmp_path, monkeypatch):
    from vaex_tpu_torch import tasks
    df = vaex_tpu_torch.open(write(tmp_path, "t.hdf5", arrays(6)))
    df._tile_rows = 50
    real, calls = tasks.TaskAggregations.update, []

    def update(self, state, ctx):
        calls.append(1)
        if len(calls) == 4:
            raise ValueError("a kernel failed")
        return real(self, state, ctx)
    monkeypatch.setattr(tasks.TaskAggregations, "update", update)
    with pytest.raises(ValueError, match="kernel failed"):
        groupby(df)
    assert not stream_threads()


def test_the_ring_under_a_tiny_switch_interval(tmp_path, monkeypatch):
    """More IO threads than cores, a switch every microsecond, 7-row tiles:
    a tile read before its copy, or out of order, moves the counts."""
    data = arrays(7, 20_000)
    monkeypatch.setattr(settings, "NUM_THREADS_IO", 4 * (os.cpu_count() or 1))
    monkeypatch.setattr(stream, "PARALLEL_COPY_ROWS", 2)
    df = vaex_tpu_torch.open(write(tmp_path, "t.hdf5", data))
    df._tile_rows = 7
    want = answer(groupby(vaex_tpu_torch.from_arrays(**data).to_device("cpu")))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        same(answer(groupby(df)), want)
    finally:
        sys.setswitchinterval(interval)


def wire(df):
    return df.executor.trace_log[-1]["stream"]["wire"]


def test_a_proven_column_is_narrowed_on_the_wire(tmp_path):
    data = arrays(8)
    df = vaex_tpu_torch.open(write(tmp_path, "t.hdf5", data))
    df._tile_rows = 500
    first = answer(groupby(df))
    prepass, aggregation = df.executor.trace_log[-2:]
    # the raw key's dense pre-pass proves k; the aggregation ships it narrow
    assert prepass["stream"]["wire"] == {"k": "int64"}
    assert aggregation["stream"]["wire"] == {"k": "int32", "x": "float64", "m": "float64",
                                             "u": "int64", "f": "float64"}
    second = answer(groupby(df))
    assert wire(df) == {"k": "int32", "x": "float64", "m": "float64", "u": "int32",
                        "f": "float32"}
    same(second, first)
    assert second["su"] == first["su"] and second["mf"] == first["mf"]
    stats = df.executor.trace_log[-1]["stream"]
    assert stats["wire_bytes"] == len(data["k"]) * (4 + 8 + 8 + 4 + 4) + int(
        sum(np.ma.getmaskarray(data["m"])[i:i + 500].any() * min(500, len(data["k"]) - i)
            for i in range(0, len(data["k"]), 500)))
    # a reopen of the same file keeps the proof: its key is the file's
    again = vaex_tpu_torch.open(str(tmp_path / "t.hdf5"))
    again._tile_rows = 500
    same(answer(groupby(again)), first)
    assert wire(again)["k"] == "int32"


def test_a_wide_value_behind_a_declared_category_is_not_narrowed(tmp_path, monkeypatch):
    data = arrays(9, wide=2 ** 32 + 3)  # wraps to 3 as an int32
    path = write(tmp_path, "t.hdf5", data)
    staged = vaex_tpu_torch.from_arrays(**data).to_device("cpu").categorize(
        "k", labels=range(10))
    want = answer(groupby(staged))
    df = vaex_tpu_torch.open(path).categorize("k", labels=range(10))
    df._tile_rows = 256
    for _ in range(2):
        same(answer(groupby(df)), want)
        assert wire(df)["k"] == "int64"
    with synchronous(monkeypatch):
        same(answer(groupby(df)), want)
    # the reference narrows on the category and wraps the value into bin 3
    ref = vaex_tpu.open(path).categorize("k", labels=range(10))
    assert ref.groupby("k", agg={"c": "count"}, sort=True)["c"].tolist() != want["c"]


def test_a_value_outside_float32_keeps_a_column_wide(tmp_path):
    data = arrays(10)
    data["f"] = data["f"].copy()
    data["f"][100] = 0.1  # not a float32
    df = vaex_tpu_torch.open(write(tmp_path, "t.arrow", data))
    df._tile_rows = 333
    first = answer(groupby(df))
    answer(groupby(df))
    assert wire(df)["f"] == "float64" and wire(df)["k"] == "int32"
    same(answer(groupby(df)), first)
    assert answer(groupby(df))["mf"] == first["mf"]


def test_a_filtered_row_is_in_the_proof(tmp_path):
    data = arrays(11, wide=-(2 ** 40))
    df = vaex_tpu_torch.open(write(tmp_path, "t.hdf5", data))
    df = df[df.k >= 0]  # drops the wide row
    df._tile_rows = 400
    staged = vaex_tpu_torch.from_arrays(**data).to_device("cpu")
    want = answer(groupby(staged[staged.k >= 0]))
    for _ in range(2):
        same(answer(groupby(df)), want)
        assert wire(df)["k"] == "int64"


def test_a_proof_is_not_reused_for_another_file(tmp_path):
    narrow, wide = arrays(12), arrays(12, wide=2 ** 31)
    a = vaex_tpu_torch.open(write(tmp_path, "a.hdf5", narrow))
    b_path = write(tmp_path, "b.hdf5", wide)
    a._tile_rows = 1000
    groupby(a)
    groupby(a)
    assert wire(a)["k"] == "int32"
    b = vaex_tpu_torch.open(b_path)
    b._tile_rows = 1000
    want = answer(groupby(vaex_tpu_torch.from_arrays(**wide).to_device("cpu")))
    for _ in range(2):
        same(answer(groupby(b)), want)
        assert wire(b)["k"] == "int64"
    # the same name rewritten: a new inode, a new key, a new proof
    write(tmp_path, "a.hdf5", wide)
    a2 = vaex_tpu_torch.open(str(tmp_path / "a.hdf5"))
    a2._tile_rows = 1000
    same(answer(groupby(a2)), want)
    assert wire(a2)["k"] == "int64"


def test_uint64_past_int32_is_not_narrowed(tmp_path):
    data = arrays(13)
    data["u"] = data["u"] | np.uint64(1 << 63)
    df = vaex_tpu_torch.open(write(tmp_path, "t.parquet", data))
    df._tile_rows = 700
    want = answer(groupby(vaex_tpu_torch.from_arrays(**data).to_device("cpu")))
    for _ in range(2):
        same(answer(groupby(df)), want)
    assert wire(df)["u"] == "int64"


# the file key (a file's identity, not its bytes)

def counting_hashes(monkeypatch):
    calls = []
    real = utils.hash_array_data
    for m in (utils, column, dataset):
        monkeypatch.setattr(m, "hash_array_data", lambda ar: calls.append(len(ar)) or real(ar))
    return calls


@pytest.mark.parametrize("ext", ("hdf5", "arrow", "parquet", "fits"))
def test_a_key_never_reads_the_file(tmp_path, monkeypatch, ext):
    df = vaex_tpu_torch.open(write(tmp_path, f"t.{ext}", arrays(14)))
    calls = counting_hashes(monkeypatch)
    with cache.memory(clear_on_exit=True):
        first = sorted(np.asarray(df.unique("k")).tolist())
        passes = df.executor.passes
        assert sorted(np.asarray(df.unique("k")).tolist()) == first == list(range(10))
        assert df.executor.passes == passes  # a hit
    assert calls == []
    frame, content = df._cache_key(["k"])
    assert content is False  # the file's identity holds on this machine only


@pytest.mark.parametrize("ext", ("hdf5", "arrow"))
def test_a_rewritten_file_never_gets_the_old_answer(tmp_path, ext):
    data = arrays(15)
    path = write(tmp_path, f"t.{ext}", data)
    size = os.path.getsize(path)
    with cache.memory(clear_on_exit=True):
        before = sorted(np.asarray(vaex_tpu_torch.open(path).unique("k")).tolist())
        data["k"] = data["k"].copy()
        data["k"][0] = 10  # a new key, the same size
        write(tmp_path, f"t.{ext}", data)
        assert os.path.getsize(path) == size
        after = sorted(np.asarray(vaex_tpu_torch.open(path).unique("k")).tolist())
    assert before == list(range(10)) and after == list(range(11))


def test_an_open_mapping_keeps_the_old_bytes(tmp_path):
    data = arrays(16)
    path = write(tmp_path, "t.hdf5", data)
    old = vaex_tpu_torch.open(path)
    write(tmp_path, "t.hdf5", arrays(17))
    npt.assert_array_equal(old.evaluate("x"), data["x"])


def test_hashed_survives_a_reopen_through_its_sidecar(tmp_path, monkeypatch):
    path = write(tmp_path, "t.hdf5", arrays(18))
    calls = counting_hashes(monkeypatch)
    ds = vaex_tpu_torch.open(path).dataset.hashed()
    assert len(calls) == 5 and os.path.exists(path + ".d/hashes.yaml")
    again = vaex_tpu_torch.open(path).dataset.hashed()
    assert len(calls) == 5  # read from the sidecar
    assert again.fingerprint() == ds.fingerprint()
    df = vaex_tpu_torch.from_dataset(again)
    key, content = df._cache_key(["k", "x"])
    assert content is True
    assert key == vaex_tpu_torch.from_dataset(ds)._cache_key(["k", "x"])[0]
    with cache.memory(clear_on_exit=True):
        assert sorted(np.asarray(df.unique("k")).tolist()) == list(range(10))
    assert len(calls) == 5
    # a rewrite makes the sidecar stale
    write(tmp_path, "t.hdf5", arrays(19))
    vaex_tpu_torch.open(path).dataset.hashed()
    assert len(calls) == 10


def test_the_key_of_a_slice_is_derived_from_the_file(tmp_path, monkeypatch):
    df = vaex_tpu_torch.open(write(tmp_path, "t.hdf5", arrays(20)))
    calls = counting_hashes(monkeypatch)
    part = df[100:2000]
    key, content = part._cache_key(["k"])
    assert calls == [] and content is False
    assert key != df._cache_key(["k"])[0]
    with cache.memory(clear_on_exit=True):
        assert sorted(np.asarray(part.unique("k")).tolist()) == sorted(
            np.unique(arrays(20)["k"][100:2000]).tolist())
