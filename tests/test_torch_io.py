"""Files: every format of vaex_tpu written by one package and opened by the
other (vaex_tpu_torch.io against vaex_tpu.io), on the same seeded arrays.

Each file is read by both packages; the values must agree exactly (ints,
floats, NaN, nulls, datetimes as int64 nanoseconds, NaT), and the port's
groupby and statistics over the file agree with vaex_tpu's to the float
contract.  The binary formats also hold the port to the source arrays.
Where vaex_tpu is wrong the test holds the port to numpy / pyarrow and names
the fault (ROADMAP, "Known problems of the reference"): its HDF5 writer
keeps no string nulls (vaex_tpu/io/hdf5.py:165-176), and its VOTable writer
writes a datetime or a bool as a double its reader cannot parse.
"""

import datetime
import glob
import os

import numpy as np
import numpy.testing as npt
import pytest

import vaex_tpu
import vaex_tpu_torch
from vaex_tpu_torch import settings
from torch_port_helpers import ATOL, RTOL, STRING_FORMS, host_list, string_arrays, string_frames

FORMATS = ("hdf5", "arrow", "feather", "parquet", "csv", "json", "fits", "vot")
BINARY = ("hdf5", "arrow", "feather", "parquet")
PACKAGES = {"vaex_tpu": vaex_tpu, "port": vaex_tpu_torch}


@pytest.fixture(autouse=True)
def on_the_cpu(monkeypatch):
    """Frames opened from files are not staged: their passes run on the CPU."""
    monkeypatch.setattr(settings, "DEVICE", "cpu")


def rich_arrays(seed, n=60):
    """x float64 with NaN, k an int64 key in 0..4, m a masked float64, mi a
    masked int64, t datetime64[ns] with NaT, u uint64 past 2^63, s strings
    with nulls, b bool."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, n)
    x[::7] = np.nan
    t = (np.datetime64("2020-01-01") + rng.integers(0, 1000, n).astype("m8[D]")).astype("M8[ns]")
    t[::5] = np.datetime64("NaT")
    s = np.asarray([f"s{v}" for v in rng.integers(0, 5, n)], dtype=object)
    s[::4] = None
    return {
        "x": x,
        "k": rng.integers(0, 5, n).astype(np.int64),
        "m": np.ma.MaskedArray(rng.normal(0, 1, n), rng.random(n) < 0.2),
        "mi": np.ma.MaskedArray(rng.integers(0, 9, n).astype(np.int64), rng.random(n) < 0.2),
        "t": t,
        "u": np.where(rng.random(n) < 0.5, np.uint64(1 << 63), np.uint64(3)) + np.arange(
            n, dtype=np.uint64),
        "s": s,
        "b": rng.random(n) < 0.5,
    }


def norm(values):
    """Host values as comparable Python values: None where missing, "nan"
    for NaN, a datetime as its int64 nanoseconds (pandas' Timestamp, which
    vaex_tpu gives for an arrow timestamp, as the port's int)."""
    out = []
    for v in host_list(values):
        if type(v).__name__ == "Timestamp":
            v = v.value
        elif isinstance(v, (datetime.datetime, datetime.date)):
            v = str(v)
        elif isinstance(v, float) and v != v:
            v = "nan"
        out.append(v)
    return out


def source(arrays, name):
    """The expected values of a source column, as :func:`norm` gives them."""
    a = arrays[name]
    if a.dtype.kind == "M":
        return [None if np.isnat(v) else int(v.view(np.int64)) for v in a]
    return norm(a)


def columns_of(ext, writer):
    """The columns a format carries in both packages: vaex_tpu writes a
    datetime and a bool into a VOTable as doubles its reader cannot parse."""
    names = list(rich_arrays(0))
    if ext == "vot" and writer == "vaex_tpu":
        names.remove("t")
        names.remove("b")
    return names


def write(package, arrays, path):
    PACKAGES[package].from_arrays(**arrays).export(path)


@pytest.mark.parametrize("writer", sorted(PACKAGES))
@pytest.mark.parametrize("ext", FORMATS)
def test_a_file_one_package_writes_opens_alike_in_both(tmp_path, ext, writer):
    arrays = rich_arrays(3)
    names = columns_of(ext, writer)
    path = str(tmp_path / f"t.{ext}")
    write(writer, {n: arrays[n] for n in names}, path)
    ref, port = vaex_tpu.open(path), vaex_tpu_torch.open(path)
    assert len(port) == len(ref) == len(arrays["x"])
    assert port.get_column_names() == ref.get_column_names()
    for name in names:
        got, want = norm(port.evaluate(name)), norm(ref.evaluate(name))
        if ext == "hdf5" and name == "s" and writer == "port":
            # vaex_tpu reads a null the port wrote as "" (it ignores the mask)
            assert want == ["" if v is None else v for v in source(arrays, "s")]
            want = source(arrays, "s")
        assert got == want, name
        if ext in BINARY:
            expected = source(arrays, name)
            if ext == "hdf5" and name == "s" and writer == "vaex_tpu":
                expected = ["" if v is None else v for v in expected]  # its writer's ""
            assert got == expected, name


@pytest.mark.parametrize("writer", sorted(PACKAGES))
@pytest.mark.parametrize("ext", FORMATS)
def test_groupby_and_statistics_over_a_file_agree(tmp_path, ext, writer):
    arrays = rich_arrays(5, n=500)
    arrays = {n: arrays[n] for n in ("x", "k", "m")}
    path = str(tmp_path / f"t.{ext}")
    write(writer, arrays, path)
    ref, port = vaex_tpu.open(path), vaex_tpu_torch.open(path)
    port._tile_rows = ref._tile_rows = 128  # several tiles: the port streams them
    aggs = {"s": "sum", "mu": "mean", "sd": "std"}
    want = ref.groupby("k", agg={name: getattr(vaex_tpu.agg, a)("m") for name, a in aggs.items()}
                       | {"c": "count"}, sort=True)
    got = port.groupby("k", agg={name: getattr(vaex_tpu_torch.agg, a)("m")
                                 for name, a in aggs.items()} | {"c": "count"}, sort=True)
    assert got["k"].tolist() == want["k"].tolist()
    assert got["c"].tolist() == want["c"].tolist()
    for name in aggs:
        npt.assert_allclose(got[name].tolist(), want[name].tolist(), rtol=RTOL, atol=ATOL)
    for stat in ("sum", "mean", "std", "min", "max", "count"):
        for col in ("x", "m"):
            npt.assert_allclose(float(getattr(port, stat)(col)), float(getattr(ref, stat)(col)),
                                rtol=RTOL, atol=ATOL, err_msg=f"{stat}({col})")
    assert port.executor.trace_log[-1]["stream"]["mode"] == "transfer-ahead"


@pytest.mark.parametrize("ext", ("hdf5", "arrow", "parquet", "csv", "feather"))
@pytest.mark.parametrize("form", STRING_FORMS)
def test_strings_with_nulls_round_trip(tmp_path, ext, form):
    arrays = string_arrays(11, 90)
    ref_frame, port_frame = string_frames(arrays, form)
    # every file holds plain strings: the groups of vaex_tpu's plain frame
    want_groups = vaex_tpu.from_arrays(**arrays).groupby("s", agg={"x": vaex_tpu.agg.sum("x")},
                                                         sort=True)
    for package, frame in (("vaex_tpu", ref_frame), ("port", port_frame)):
        path = str(tmp_path / f"{package}.{ext}")
        if package == "vaex_tpu" and ext == "hdf5" and form != "plain":
            with pytest.raises(TypeError):  # vaex_tpu's HDF5 writer fails on encoded strings
                frame.export(path)
            continue
        frame.export(path)
        ref, port = vaex_tpu.open(path), vaex_tpu_torch.open(path)
        for name in ("s", "t", "x", "iv", "g"):
            got, want = norm(port.evaluate(name)), norm(ref.evaluate(name))
            expected = norm(arrays[name])
            if ext == "hdf5" and name == "s" and package == "port":
                # vaex_tpu's reader drops the mask the port writes for strings
                assert want == ["" if v is None else v for v in expected]
                want = expected
            if ext == "hdf5" and name == "s" and package == "vaex_tpu":
                # vaex_tpu's writer turns a null string into ""
                assert want == ["" if v is None else v for v in expected]
            elif ext != "csv":
                assert got == expected, name
            assert got == want, (package, name)
        if ext == "csv" or (ext == "hdf5" and package == "vaex_tpu"):
            continue  # the file holds "" where the frame held a null
        # vaex_tpu's groupby over dictionary-encoded strings (its files keep
        # the dictionary type) loses the null group: the port's is held to
        # vaex_tpu's over plain strings in memory
        got = port.groupby("s", agg={"x": vaex_tpu_torch.agg.sum("x")}, sort=True)
        assert norm(got["s"].tolist()) == norm(want_groups["s"].tolist())
        npt.assert_allclose(got["x"].tolist(), want_groups["x"].tolist(), rtol=RTOL, atol=ATOL)


def test_hdf5_maps_its_columns_and_masks(tmp_path):
    arrays = rich_arrays(7, 50)
    path = str(tmp_path / "t.hdf5")
    vaex_tpu_torch.from_arrays(**arrays).export_hdf5(path)
    ds = vaex_tpu_torch.open(path).dataset
    assert isinstance(ds["x"], np.memmap)
    assert isinstance(ds["m"], np.ma.MaskedArray) and isinstance(ds["m"].data, np.ndarray)
    assert ds.logical["t"] == np.dtype("M8[ns]") and ds.logical["u"] == np.dtype("uint64")
    assert norm(vaex_tpu_torch.open(path).evaluate("mi")) == norm(arrays["mi"])


def test_timedelta_survives_hdf5(tmp_path):
    td = np.arange(10).astype("m8[s]")
    td[3] = np.timedelta64("NaT")
    path = str(tmp_path / "td.hdf5")
    vaex_tpu_torch.from_arrays(td=td).export_hdf5(path)
    back = vaex_tpu_torch.open(path).evaluate("td")
    assert back.dtype == td.dtype
    npt.assert_array_equal(back.view(np.int64), td.view(np.int64))
    ref = np.asarray(vaex_tpu.open(path).evaluate("td"))
    npt.assert_array_equal(ref.view(np.int64), td.view(np.int64))
    with pytest.raises(TypeError):  # vaex_tpu's writer has no path for a timedelta64
        vaex_tpu.from_arrays(td=td).export_hdf5(str(tmp_path / "ref.hdf5"))


def test_virtual_columns_and_filters_are_written_as_values(tmp_path):
    arrays = rich_arrays(9, 80)
    for package in (vaex_tpu, vaex_tpu_torch):
        df = package.from_arrays(x=arrays["x"], k=arrays["k"])
        df["y"] = df.x * 2 + df.k
        df = df[df.k > 1]
        df.export_parquet(str(tmp_path / f"{package.__name__}.parquet"))
    ref = vaex_tpu.open(str(tmp_path / "vaex_tpu.parquet"))
    port = vaex_tpu_torch.open(str(tmp_path / "vaex_tpu_torch.parquet"))
    assert port.get_column_names() == ref.get_column_names() == ["x", "k", "y"]
    for name in ("x", "k", "y"):
        assert norm(port.evaluate(name)) == norm(ref.evaluate(name))


def test_a_staged_frame_is_written_tile_by_tile(tmp_path, monkeypatch):
    arrays = rich_arrays(13, 1000)
    arrays = {n: arrays[n] for n in ("x", "k", "m", "t", "u", "b")}
    df = vaex_tpu_torch.from_arrays(**arrays).to_device("cpu")
    df._tile_rows = 128
    seen = []
    real = vaex_tpu_torch.DataFrame.evaluate

    def evaluate(self, expression, *args, **kwargs):
        value = real(self, expression, *args, **kwargs)
        seen.append(len(value))
        return value
    monkeypatch.setattr(vaex_tpu_torch.DataFrame, "evaluate", evaluate)
    for ext in BINARY:
        seen.clear()
        path = str(tmp_path / f"tiles.{ext}")
        df.export(path)
        assert max(seen) == 128, ext
        monkeypatch.setattr(vaex_tpu_torch.DataFrame, "evaluate", real)
        back = vaex_tpu_torch.open(path)
        for name in arrays:
            assert norm(back.evaluate(name)) == source(arrays, name), (ext, name)
        monkeypatch.setattr(vaex_tpu_torch.DataFrame, "evaluate", evaluate)


def test_parquet_reads_only_the_row_groups_a_slice_reaches(tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq
    x = np.arange(1000, dtype=np.float64)
    pq.write_table(pa.table({"x": x}), str(tmp_path / "g.parquet"), row_group_size=100)
    df = vaex_tpu_torch.open(str(tmp_path / "g.parquet"))
    col = df.dataset["x"]
    read = []
    real = col.dataset.file.read_row_group
    col.dataset.file.read_row_group = lambda rg, **kw: read.append(rg) or real(rg, **kw)
    npt.assert_array_equal(col[250:420], x[250:420])
    assert read == [2, 3, 4]
    assert df[250:420].sum("x") == x[250:420].sum()


def test_open_many_and_globs(tmp_path):
    arrays = rich_arrays(17, 120)
    arrays = {n: arrays[n] for n in ("x", "k", "m")}
    for i in range(3):
        part = {n: a[i * 40:(i + 1) * 40] for n, a in arrays.items()}
        vaex_tpu_torch.from_arrays(**part).export(str(tmp_path / f"part-{i}.hdf5"))
    paths = sorted(glob.glob(str(tmp_path / "part-*.hdf5")))
    for port in (vaex_tpu_torch.open_many(paths), vaex_tpu_torch.open(str(tmp_path / "part-*.hdf5"))):
        ref = vaex_tpu.open_many(paths)
        assert len(port) == len(ref) == 120
        port._tile_rows = 32  # tiles across the files' ends
        for name in arrays:
            assert norm(port.evaluate(name)) == norm(ref.evaluate(name)) == source(arrays, name)
        got = port.groupby("k", agg={"s": vaex_tpu_torch.agg.sum("m")}, sort=True)
        want = ref.groupby("k", agg={"s": vaex_tpu.agg.sum("m")}, sort=True)
        npt.assert_allclose(got["s"].tolist(), want["s"].tolist(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("ext", ("csv", "parquet"))
def test_convert_writes_hdf5_once(tmp_path, ext):
    arrays = {"a": np.arange(20, dtype=np.int64), "b": np.linspace(0, 1, 20)}
    path = str(tmp_path / f"in.{ext}")
    vaex_tpu.from_arrays(**arrays).export(path)
    port = vaex_tpu_torch.open(path, convert=True)
    assert os.path.exists(path + ".hdf5")
    assert type(port.dataset).__name__ == "Hdf5Dataset"
    assert norm(port.evaluate("a")) == norm(arrays["a"])
    npt.assert_array_equal(port.evaluate("b"), arrays["b"])
    mtime = os.stat(path + ".hdf5").st_mtime_ns
    vaex_tpu_torch.open(path, convert=True)
    assert os.stat(path + ".hdf5").st_mtime_ns == mtime
    if ext == "csv":
        target = str(tmp_path / "other.hdf5")
        df = vaex_tpu_torch.from_csv(path, convert=target)
        assert os.path.exists(target) and df.sum("a") == 190


def test_export_many_as_the_reference(tmp_path):
    arrays = {"x": np.arange(10.0), "i": np.arange(10, dtype=np.int64)}
    ref_paths = vaex_tpu.from_arrays(**arrays).export_many(
        str(tmp_path / "ref-{i:02d}.parquet"), max_rows_per_file=4)
    port_paths = vaex_tpu_torch.from_arrays(**arrays).export_many(
        str(tmp_path / "port-{i:02d}.parquet"), max_rows_per_file=4)
    assert [os.path.basename(p)[3:] for p in ref_paths] == [
        os.path.basename(p)[4:] for p in port_paths]
    for r, p in zip(ref_paths, port_paths):
        assert norm(vaex_tpu_torch.open(p).evaluate("i")) == norm(vaex_tpu.open(r).evaluate("i"))
    assert vaex_tpu_torch.open_many(port_paths).sum("i") == 45


def test_export_partitioned_as_the_reference(tmp_path):
    arrays = {"g": np.array([0, 0, 1, 2, 2, 2], dtype=np.int64), "x": np.arange(6.0)}
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    ref = vaex_tpu.from_arrays(**arrays).export_partitioned(str(tmp_path / "ref" / "d.parquet"),
                                                           by="g")
    port = vaex_tpu_torch.from_arrays(**arrays).export_partitioned(
        str(tmp_path / "port" / "d.parquet"), by="g")
    assert [os.path.relpath(p, tmp_path / "port") for p in port] == [
        os.path.relpath(p, tmp_path / "ref") for p in ref]
    for r, p in zip(ref, port):
        assert norm(vaex_tpu_torch.open(p).evaluate("x")) == norm(vaex_tpu.open(r).evaluate("x"))


def test_example_is_the_reference_example():
    ref, port = vaex_tpu.example(), vaex_tpu_torch.example()
    assert port.get_column_names() == ref.get_column_names()
    for name in ref.get_column_names():
        npt.assert_array_equal(port.evaluate(name), ref.evaluate(name))


def test_from_json_ascii_and_arrow_dataset(tmp_path):
    import pyarrow.dataset as pads
    arrays = {"a": np.arange(5, dtype=np.int64), "b": np.linspace(0, 1, 5)}
    vaex_tpu.from_arrays(**arrays).export(str(tmp_path / "t.json"))
    with open(tmp_path / "t.txt", "w") as f:
        f.write("a b\n" + "".join(f"{a} {b!r}\n" for a, b in zip(*arrays.values())))
    vaex_tpu.from_arrays(**arrays).export_parquet(str(tmp_path / "t.parquet"))
    for name, reader in (("json", lambda p: p.from_json(str(tmp_path / "t.json"))),
                         ("ascii", lambda p: p.from_ascii(str(tmp_path / "t.txt"))),
                         ("arrow dataset", lambda p: p.from_arrow_dataset(
                             pads.dataset(str(tmp_path / "t.parquet"))))):
        ref, port = reader(vaex_tpu), reader(vaex_tpu_torch)
        for col in arrays:
            assert norm(port.evaluate(col)) == norm(ref.evaluate(col)), (name, col)


def test_gadget_snapshot_opens_by_its_records(tmp_path):
    import struct
    n = 7
    rng = np.random.default_rng(1)
    pos, vel = rng.random((n, 3)).astype(np.float32), rng.random((n, 3)).astype(np.float32)
    header = struct.pack("=6I6dddii6iiiddddii6ii60x", n, 0, 0, 0, 0, 0, *[0.0] * 6, 0.0, 0.0,
                         0, 0, n, 0, 0, 0, 0, 0, 0, 1, 1.0, 0.3, 0.7, 0.7, 0, 0, *[0] * 6, 0)
    path = str(tmp_path / "snapshot_000")
    with open(path, "wb") as f:
        for block in (header, pos.tobytes(), vel.tobytes()):
            f.write(struct.pack("I", len(block)) + block + struct.pack("I", len(block)))
    ref, port = vaex_tpu.open(path), vaex_tpu_torch.open(path)
    for i, name in enumerate(("x", "y", "z")):
        npt.assert_array_equal(port.evaluate(name), pos[:, i])
        npt.assert_array_equal(port.evaluate("v" + name), vel[:, i])
        npt.assert_array_equal(port.evaluate(name), ref.evaluate(name))
    assert float(port.sum("x")) == pytest.approx(float(pos[:, 0].sum(dtype=np.float64)))


def test_votable_parse_and_nulls():
    from vaex_tpu.io.votable import parse_votable as ref_parse
    from vaex_tpu_torch.io.votable import parse_votable
    body = b"""<?xml version="1.0"?>
    <VOTABLE xmlns="http://www.ivoa.net/xml/VOTable/v1.3" version="1.4">
      <RESOURCE type="results"><TABLE>
        <FIELD name="ra" datatype="double"/>
        <FIELD name="n" datatype="int"><VALUES null="-999"/></FIELD>
        <FIELD name="s" datatype="char" arraysize="*"/>
        <DATA><TABLEDATA>
          <TR><TD>10.5</TD><TD>3</TD><TD>a &amp; b</TD></TR>
          <TR><TD>11.5</TD><TD>-999</TD><TD/></TR>
        </TABLEDATA></DATA>
      </TABLE></RESOURCE>
    </VOTABLE>"""
    got, want = parse_votable(body), ref_parse(body)
    for name in ("ra", "n", "s"):
        assert norm(got[name]) == norm(want[name]), name
    assert norm(got["n"]) == [3, None] and norm(got["s"]) == ["a & b", None]


def test_opening_needs_no_optional_package_at_import():
    import subprocess
    import sys
    code = ("import sys; import vaex_tpu_torch; "
            "assert not {'h5py', 'fsspec', 'yaml', 'pyarrow'} & set(sys.modules), "
            "sorted({'h5py', 'fsspec', 'yaml', 'pyarrow'} & set(sys.modules))")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_unknown_extension_raises(tmp_path):
    path = tmp_path / "t.unknown"
    path.write_bytes(b"not a table")
    with pytest.raises(IOError):
        vaex_tpu_torch.open(str(path))
    with pytest.raises(ValueError):
        vaex_tpu_torch.from_arrays(x=np.arange(3.0)).export(str(tmp_path / "t.unknown"))
