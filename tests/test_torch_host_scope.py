"""The host scope of the port (ROADMAP A9): which stage an expression runs
in, what the host stage ships to the pass device, strings on a device as
dictionary codes (``DictNA``), the string columns (``ColumnString``,
``ColumnDictionary``), string sets and their caches, the datatype and
array conversions, and the temporal operations the host stage computes;
the same seeded arrays through vaex_tpu where it answers."""

import numpy as np
import numpy.testing as npt
import pyarrow as pa
import pytest
import torch

import vaex_tpu
import vaex_tpu_torch
from torch_port_helpers import (assert_same_list, binby_arrays, host_list, string_arrays,
                                string_frames)
from vaex_tpu_torch import array_types, settings
from vaex_tpu_torch.column import ColumnDictionary, ColumnString
from vaex_tpu_torch.datatype import DataType, has_torch_dtype
from vaex_tpu_torch.ops.nullable import DictNA, HostStage
from vaex_tpu_torch.ops.setops import SortedSet
from vaex_tpu_torch.scopes import expression_is_device, ship


@pytest.fixture(autouse=True)
def cpu(monkeypatch):
    monkeypatch.setattr(settings, "DEVICE", "cpu")


@pytest.fixture(scope="module")
def staged():
    return string_frames(string_arrays(17, 800), "staged")


@pytest.mark.parametrize("expression,device", [
    ("x * 2", True), ("s == 'a'", True), ("isin_set(s, v)", True), ("ismissing(s)", True),
    ("str_upper(s)", False), ("str_len(s) + x", False), ("s + t", False), ("s + '!'", False),
    ("s == t", False),
    ("sqrt(s)", False), ("s < t", False)])
def test_the_stage_of_an_expression_on_a_staged_frame(staged, expression, device):
    """Device where the staged codes carry it; host where a host-only
    function is called or strings meet what codes do not carry."""
    _, port = staged
    port = port.copy()
    port.add_variable("v", SortedSet("string"))
    assert expression_is_device(port, expression) is device


def test_an_unstaged_string_column_runs_in_the_host_stage():
    _, port = string_frames(string_arrays(17, 100), "plain")
    assert not expression_is_device(port, "s == 'a'")
    assert expression_is_device(port, "x + 1")
    assert port.count(selection="s == 'a'") == sum(
        v == "a" for v in string_arrays(17, 100)["s"])
    assert port.executor.trace_log[-1]["host_stage"] == ["s == 'a'"]


def test_a_temporal_expression_runs_where_it_is_carried():
    port = vaex_tpu_torch.from_arrays(**binby_arrays(3, 200)).to_device("cpu")
    assert expression_is_device(port, "td * 2")
    assert expression_is_device(port, "d - d")
    assert not expression_is_device(port, "where(td > 0, td, 0)")
    assert not expression_is_device(port, "sqrt(td)")
    with pytest.raises(HostStage):
        port._evaluate_tile("td", 0, 10).__pow__(2)


def test_ship_strings_numbers_and_temporal_values():
    values = pa.array(["b", None, "a", "b"])
    out = ship(values, torch.device("cpu"), 4)
    assert isinstance(out, DictNA)
    assert out.mask.tolist() == [False, True, False, False]
    assert [out.labels[int(c)].as_py() for c, m in zip(out.data, out.mask) if not m] == [
        "b", "a", "b"]
    encoded = ship(values.dictionary_encode(), torch.device("cpu"), 4)
    assert encoded.labels.to_pylist() == ["b", "a"]
    masked = ship(np.ma.MaskedArray([1, 2, 3], [False, True, False]), torch.device("cpu"), 3)
    assert masked.data.tolist() == [1, 2, 3] and masked.mask.tolist() == [False, True, False]
    td = ship(np.array([1, 2], "m8[ms]"), torch.device("cpu"), 2)
    assert td.logical == np.dtype("m8[ms]")
    assert ship(np.int64(5), torch.device("cpu"), 3).data.tolist() == [5, 5, 5]
    with pytest.raises(TypeError, match="cannot go to the device"):
        ship(np.array([{}], dtype=object), torch.device("cpu"), 1)


def test_dict_na_compares_per_label():
    labels = pa.array(["a", "b", None, "c"])
    x = DictNA(torch.tensor([0, 1, 2, 3, 0], dtype=torch.int32),
               torch.tensor([False, False, False, False, True]), labels)
    eq = x == "a"
    assert eq.data.tolist()[:2] == [True, False] and eq.mask.tolist() == [
        False, False, True, False, True]
    gt = x > "a"
    assert gt.data[[1, 3]].tolist() == [True, True]
    assert ("b" < x).data[[1, 3]].tolist() == [False, True]
    assert (x != None).data[:4].tolist() == [True] * 4  # noqa: E711
    for op in (lambda: x * 2, lambda: -x, lambda: x + "!", lambda: x == 3, lambda: x == x):
        with pytest.raises(HostStage):
            op()


def test_column_string_takes_slices_concats_and_fingerprints():
    col = ColumnString(np.asarray(["a", None, "bc", "é"], dtype=object))
    assert DataType(col.type).is_string and len(col) == 4
    assert col[1:3].to_pylist() == [None, "bc"]
    taken = col.take(torch.tensor([3, 0]), torch.tensor([False, True]))
    assert taken.array.to_pylist() == ["é", None]
    # the fingerprint hashes every row: two columns that differ past row 1000 differ
    base = np.asarray(["x"] * 3000, dtype=object)
    other = base.copy()
    other[2500] = "y"
    assert ColumnString(base).fingerprint() != ColumnString(other).fingerprint()
    assert ColumnString(base).fingerprint() == ColumnString(base.copy()).fingerprint()
    df = vaex_tpu_torch.from_arrays(s=base[:5], x=np.arange(5.0))
    both = vaex_tpu_torch.concat([df, vaex_tpu_torch.from_arrays(s=other[:3], x=np.zeros(3))])
    assert both.s.tolist() == ["x"] * 8


def test_column_dictionary_codes_stay_on_their_device(staged):
    _, port = staged
    col = port.dataset["s"]
    assert isinstance(col, ColumnDictionary) and col.codes.dtype == torch.int32
    assert port.dataset["__s_codes"] is col.codes
    taken = port.take(torch.tensor([0, 5, 9]))
    assert isinstance(taken.dataset["s"], ColumnDictionary)
    assert host_list(taken.evaluate("s")) == [host_list(port.evaluate("s"))[i]
                                              for i in (0, 5, 9)]
    tile = col.tile(0, 10)
    assert isinstance(tile, DictNA) and (tile.mask is None) == (not col.has_null)


def test_a_chunked_dictionary_reads_every_chunks_labels():
    """vaex_tpu's ``_category_meta`` reads only chunk 0's labels; the port
    unifies the chunks' dictionaries first."""
    chunks = pa.chunked_array([pa.array(["a", "b"]).dictionary_encode(),
                               pa.array(["c", "a"]).dictionary_encode()])
    port = vaex_tpu_torch.from_arrays(s=chunks, x=np.arange(4.0))
    assert port.is_category("s")
    out = port.groupby("s", agg={"x": "sum"}, sort=True)
    assert host_list(out.evaluate("s")) == ["a", "b", "c"]
    assert host_list(out.evaluate("x")) == [3.0, 1.0, 2.0]


def test_a_null_label_in_a_dictionary_does_not_raise():
    """vaex_tpu raises TypeError for a null among a dictionary's values
    (setops.py:186); the port counts its rows as missing."""
    array = pa.DictionaryArray.from_arrays(pa.array([0, 1, 2, 1], type=pa.int32()),
                                           pa.array(["a", None, "b"]))
    port = vaex_tpu_torch.from_arrays(s=array)
    assert port.unique("s") == ["a", "b", None]
    assert dict(port.s.value_counts()) == {"missing": 2, "a": 1, "b": 1}
    staged = port.to_device("cpu")
    assert int(staged.count("s")) == 2


def test_the_label_cache_holds_its_labels():
    """A string set's per-labels ordinals are keyed by the labels array it
    holds, never by a buffer address that another array may take over."""
    oset = SortedSet("string")
    oset.update(np.asarray(["a", "b"], dtype=object))
    first = oset.label_ordinals(pa.array(["b", "x"]))
    npt.assert_array_equal(first, [1, -1])
    for _ in range(40):  # arrays made and dropped: none is mistaken for another
        labels = pa.array(["x", "a"])
        npt.assert_array_equal(oset.label_ordinals(labels), [-1, 0])


def test_datatypes_and_conversions():
    assert not has_torch_dtype(DataType(pa.string()))
    assert DataType(pa.dictionary(pa.int32(), pa.string())).is_encoded
    assert DataType(pa.string()).numpy == np.dtype(object)
    assert DataType(pa.string()) == DataType(pa.string()) != DataType(np.dtype("int64"))
    ref = vaex_tpu.from_arrays(**string_arrays(2, 50))
    port = vaex_tpu_torch.from_arrays(**string_arrays(2, 50))
    assert port.dtypes == {k: str(v) for k, v in ref.dtypes.items()}
    assert port.get_column_names(strings=False) == ref.get_column_names(strings=False)
    values = array_types.to_numpy(pa.array(["a", None]))
    assert isinstance(values, np.ma.MaskedArray) and values.mask.tolist() == [False, True]
    assert array_types.to_numpy(pa.array([1, None])).dtype == np.int64
    joined = array_types.concat([pa.array(["a"]), pa.array(["b"]).dictionary_encode()])
    assert joined.to_pylist() == ["a", "b"]


def test_exporters_and_fillna_with_strings():
    arrays = string_arrays(6, 40)
    ref, port = string_frames(arrays, "staged")
    import pandas as pd
    got = port.to_pandas_df()["s"].tolist()[:5]
    want = ref.to_pandas_df()["s"].tolist()[:5]
    assert [None if pd.isna(v) else v for v in got] == [None if pd.isna(v) else v for v in want]
    assert [None if pd.isna(v) else v for v in got] == list(arrays["s"][:5])
    table = port.to_arrow_table(["s", "x"])
    assert table.column("s").to_pylist() == host_list(ref.evaluate("s"))
    filled = port.fillna(0)
    assert "s" not in filled.virtual_columns
    assert host_list(filled.evaluate("s")) == host_list(port.evaluate("s"))
    pdf = port.to_pandas_df(["s", "x"])
    back = vaex_tpu_torch.from_pandas(pdf)
    assert host_list(back.evaluate("s")) == host_list(port.evaluate("s"))


def test_from_arrays_of_numpy_string_dtypes():
    for values in (np.asarray(["a", "bc"]), np.asarray(["a", "bc"], dtype=object),
                   np.ma.MaskedArray(np.asarray(["a", "bc"], dtype=object), [False, True])):
        port = vaex_tpu_torch.from_arrays(s=values)
        assert isinstance(port.dataset["s"], ColumnString)
        assert port.s.str.len().tolist()[0] == 1
    assert_same_list(host_list(port.evaluate("s")), ["a", None])


def test_from_arrow_table_and_filtered_strings():
    """``from_arrow_table`` takes string columns as they are; the rows a
    filter keeps, sliced and taken, read back as vaex_tpu reads them."""
    arrays = string_arrays(8, 300)
    table = pa.table({"s": pa.array(arrays["s"], type=pa.string()), "x": arrays["x"],
                      "g": arrays["g"]})
    ref, port = vaex_tpu.from_arrow_table(table), vaex_tpu_torch.from_arrow_table(table)
    assert port.get_column_names() == ref.get_column_names()
    for df_ref, df_port in ((ref, port), (ref.to_device(), port.to_device("cpu"))):
        for expression in ("s", "str_upper(s)"):
            got = df_port[df_port.x > 0][5:40].evaluate(expression)
            want = df_ref[df_ref.x > 0][5:40].evaluate(expression)
            assert host_list(got) == host_list(want)
        assert host_list(df_port.take([3, 1, 4]).evaluate("s")) == host_list(
            df_ref.take([3, 1, 4]).evaluate("s"))
