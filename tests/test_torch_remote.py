"""Remote objects through fsspec (vaex_tpu_torch.io.remote against
vaex_tpu.io.remote), on fsspec's in-memory filesystem: no network.

An HDF5 object is read through the 1 MiB block cache and a query fetches
only the blocks of the columns and rows it reads; a Parquet object is read
by ranges; anything else is fetched whole once into the local cache.
"""

import numpy as np
import numpy.testing as npt
import pytest

import vaex_tpu
import vaex_tpu_torch
from vaex_tpu_torch import settings
from torch_port_helpers import ATOL, RTOL

fsspec = pytest.importorskip("fsspec")


@pytest.fixture(autouse=True)
def caches(tmp_path, monkeypatch):
    monkeypatch.setattr(settings, "DEVICE", "cpu")
    monkeypatch.setenv("VAEX_TPU_TORCH_FILE_CACHE", str(tmp_path / "port-cache"))
    monkeypatch.setenv("VAEX_TPU_FILE_CACHE", str(tmp_path / "ref-cache"))


def upload(tmp_path, name, arrays, package=vaex_tpu_torch):
    """``arrays`` written by ``package`` to a local file, copied to the
    memory filesystem: its url."""
    local = str(tmp_path / name)
    package.from_arrays(**arrays).export(local)
    fs = fsspec.filesystem("memory")
    remote = f"/{tmp_path.name}/{name}"
    with open(local, "rb") as f, fs.open(remote, "wb") as out:
        out.write(f.read())
    return f"memory://{remote}"


def columns(seed, n=400_000):
    """Three columns of 3.2 MB each: several 1 MiB blocks apiece."""
    rng = np.random.default_rng(seed)
    return {"x": rng.random(n), "y": rng.random(n), "z": rng.integers(0, 9, n).astype(np.int64)}


def test_hdf5_fetches_only_the_blocks_a_query_reads(tmp_path):
    from vaex_tpu_torch.io.remote import ColumnBlockedRemote
    arrays = columns(1)
    url = upload(tmp_path, "t.hdf5", arrays)
    df = vaex_tpu_torch.open(url)
    col = df.dataset["x"]
    assert isinstance(col, ColumnBlockedRemote)
    cached = col.cached
    total = len(np.asarray(cached.present))
    npt.assert_array_equal(col[0:1000], arrays["x"][:1000])
    first = cached.blocks_fetched
    assert 0 < first <= 3 < total
    assert float(df.sum("x")) == pytest.approx(float(arrays["x"].sum()), rel=RTOL)
    after_x = cached.blocks_fetched
    assert after_x < total  # y and z were not fetched
    ref = vaex_tpu.open(url)
    for name in arrays:
        npt.assert_array_equal(df.evaluate(name), ref.evaluate(name))
    assert cached.blocks_fetched == total


def test_the_block_cache_survives_a_reopen(tmp_path):
    url = upload(tmp_path, "r.hdf5", columns(2))
    df = vaex_tpu_torch.open(url)
    s1 = float(df.sum("y"))
    again = vaex_tpu_torch.open(url)
    fetched = again.dataset["y"].cached.blocks_fetched
    assert fetched > 0  # present before this frame read a row
    assert float(again.sum("y")) == s1
    assert again.dataset["y"].cached.blocks_fetched == fetched


def test_remote_parquet_reads_by_ranges(tmp_path):
    arrays = columns(3, 50_000)
    url = upload(tmp_path, "t.parquet", arrays, vaex_tpu)
    df = vaex_tpu_torch.open(url)
    assert type(df.dataset).__name__ == "ParquetDataset"
    df._tile_rows = 8192  # a streamed pass over the row groups
    got = df.groupby("z", agg={"s": vaex_tpu_torch.agg.sum("x"), "c": "count"}, sort=True)
    want = vaex_tpu.open(url).groupby("z", agg={"s": vaex_tpu.agg.sum("x"), "c": "count"},
                                      sort=True)
    assert got["c"].tolist() == want["c"].tolist()
    npt.assert_allclose(got["s"].tolist(), want["s"].tolist(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("ext", ("arrow", "csv", "fits"))
def test_other_formats_are_fetched_whole_once(tmp_path, ext):
    import os
    arrays = columns(4, 1000)
    url = upload(tmp_path, f"t.{ext}", arrays)
    df = vaex_tpu_torch.open(url)
    cache_dir = tmp_path / "port-cache"
    assert len(os.listdir(cache_dir)) == 1
    for name in arrays:
        npt.assert_array_equal(df.evaluate(name), arrays[name])
    vaex_tpu_torch.open(url)
    assert len(os.listdir(cache_dir)) == 1


def test_a_remote_column_is_keyed_without_reading_it(tmp_path, monkeypatch):
    from vaex_tpu_torch import cache, column, dataset, utils
    url = upload(tmp_path, "k.hdf5", columns(5))
    calls = []
    real = utils.hash_array_data
    for m in (utils, column, dataset):
        monkeypatch.setattr(m, "hash_array_data", lambda ar: calls.append(1) or real(ar))
    df = vaex_tpu_torch.open(url)
    with cache.memory(clear_on_exit=True):
        first = sorted(np.asarray(df.unique("z")).tolist())
        passes = df.executor.passes
        assert sorted(np.asarray(df.unique("z")).tolist()) == first == list(range(9))
        assert df.executor.passes == passes
    assert calls == []
