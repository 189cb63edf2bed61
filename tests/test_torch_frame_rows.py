"""The rest of a frame's row operations (ROADMAP A6): the port against
vaex_tpu on the same frames.

``evaluate`` with rows, a selection and ``filtered``; ``evaluate_iterator``;
``dropna`` / ``dropmissing`` / ``dropnan`` / ``dropinf`` and ``fillna``; the
exporters (``to_arrays``, ``to_dict``, ``to_items``, ``to_records``,
``to_pandas_df``, ``to_arrow_table``, ``to_copy``) and ``materialize``;
``sample``, ``shuffle``, ``split`` and ``split_random``; ``vrange``,
``vconstant``, ``from_items`` and ``from_pandas``; ``shape``, ``dtypes``,
``is_masked``, ``length_original``, ``length_unfiltered``, ``count_rows``;
``Expression.evaluate`` / ``to_numpy`` / ``values``.  The columns are an
int64, a float64 with NaN and +-inf, a masked float64, a datetime64 with
NaT and a virtual column, on a plain frame, a filtered one, a taken one and
a concatenation, 2e4 seeded rows.  Values are compared exactly (they are
gathers and elementwise expressions, the same on both sides), sums to rtol
1e-6 / atol 1e-7.
"""

import numpy as np
import numpy.testing as npt
import pandas as pd
import pytest
import torch

import vaex_tpu
import vaex_tpu_torch
from torch_port_helpers import ATOL, RTOL
from vaex_tpu_torch import settings

N = 20_000
NAMES = ["i", "f", "m", "d", "k", "v"]


def _arrays(seed=0, n=N):
    rng = np.random.default_rng(seed)
    f = rng.normal(0, 10, n)
    f[::17] = np.nan
    f[1::23] = np.inf
    f[2::29] = -np.inf
    d = (np.datetime64("2021-01-01") + rng.integers(0, 900, n).astype("m8[D]")).astype("M8[ns]")
    d[::31] = np.datetime64("NaT")
    return {"i": rng.integers(-1000, 1000, n).astype(np.int64), "f": f,
            "m": np.ma.MaskedArray(rng.normal(0, 1, n), rng.random(n) < 0.1), "d": d,
            "k": rng.integers(0, 5, n).astype(np.int64)}


TAKE = np.random.default_rng(9).integers(0, N, 7_000)

KINDS = {
    "plain": lambda df, pkg: df,
    "filtered": lambda df, pkg: df[df.i > -400],
    "taken": lambda df, pkg: df.take(TAKE),
    "concat": lambda df, pkg: pkg.concat([df, df[df.k == 2]]),
}


def _pair(kind, arrays=None):
    """The same frame of ``kind`` in both packages, with the virtual column
    ``v``; the port's on the CPU device."""
    arrays = arrays or _arrays()
    frames = []
    for pkg, df in ((vaex_tpu, vaex_tpu.from_arrays(**arrays)),
                    (vaex_tpu_torch, vaex_tpu_torch.from_arrays(**arrays).to_device("cpu"))):
        df = KINDS[kind](df, pkg)
        df["v"] = "f * 2 + i"
        frames.append(df)
    return frames


def _same(got, want, what=""):
    """Two host arrays hold the same rows: the same missing ones and the same
    values, in the same dtype, elsewhere (NaN equal to NaN)."""
    got_mask, want_mask = np.ma.getmaskarray(got), np.ma.getmaskarray(want)
    npt.assert_array_equal(got_mask, want_mask, err_msg=f"{what}: missing rows")
    got, want = np.ma.getdata(got)[~got_mask], np.ma.getdata(want)[~want_mask]
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    npt.assert_array_equal(got, want, err_msg=what)


def _same_frames(port, ref, names=NAMES):
    assert len(port) == len(ref)
    for name in names:
        _same(port.evaluate(name), ref.evaluate(name), name)


@pytest.mark.parametrize("kind", KINDS)
def test_evaluate_rows_selection_and_filter(kind):
    ref, port = _pair(kind)
    n = len(ref)
    assert len(port) == n
    for name in NAMES:
        _same(port.evaluate(name), ref.evaluate(name), name)
        _same(port.evaluate(name, 100, 3_000), ref.evaluate(name, 100, 3_000), name)
        _same(port.evaluate(name, i2=50), ref.evaluate(name, i2=50), name)
        _same(port.evaluate(name, selection="k == 3"), ref.evaluate(name, selection="k == 3"),
              name)
        _same(port.evaluate(name, 10, 5_000, selection="f > 0"),
              ref.evaluate(name, 10, 5_000, selection="f > 0"), name)
        _same(port[name].evaluate(7, 900), ref[name].evaluate(7, 900), name)
    assert port.evaluate("i", 0, 5, array_type="list") == ref.evaluate("i", 0, 5,
                                                                       array_type="list")
    assert port.evaluate("m", 0, 40, array_type="python") == ref.evaluate(
        "m", 0, 40, array_type="python")
    _same(port.v.to_numpy(), ref.v.to_numpy(), "to_numpy")
    _same(port.f.values, ref.f.values, "values")
    out = np.empty(n, dtype=np.int64)
    assert port.evaluate("i", out=out) is out
    _same(out, ref.evaluate("i"), "out")


def test_evaluate_takes_named_selections_and_unfiltered_rows():
    ref, port = _pair("filtered")
    for df in (ref, port):
        df.select("k < 2")
        df.select("f > 0", name="pos")
    for selection in (True, "pos", "default"):
        _same(port.evaluate("v", selection=selection), ref.evaluate("v", selection=selection),
              str(selection))
    # the filter off: every row of the dataset
    _same(port.evaluate("i", filtered=False), ref.evaluate("i", filtered=False), "filtered")
    _same(port.evaluate("v", 3, 60, filtered=False), ref.evaluate("v", 3, 60, filtered=False),
          "filtered rows")
    # the filter off and a selection: the selection's rows among all rows
    # (vaex_tpu drops the selection there too; ROADMAP, known problems)
    plain_ref, _ = _pair("plain")
    _same(port.evaluate("v", filtered=False, selection="k < 2"),
          plain_ref.evaluate("v", selection="k < 2"), "unfiltered selection")
    got = port.evaluate("i", selection=["k < 2", "pos"])
    _same(got[0], ref.evaluate("i", selection="k < 2"), "list")
    _same(got[1], ref.evaluate("i", selection="pos"), "list")


@pytest.mark.parametrize("kind", ["plain", "filtered"])
def test_evaluate_iterator_yields_the_reference_chunks(kind):
    ref, port = _pair(kind)
    want = list(ref.evaluate_iterator("v", chunk_size=6_000))
    got = list(port.evaluate_iterator("v", chunk_size=6_000))
    assert [(a, b) for a, b, _ in got] == [(a, b) for a, b, _ in want]
    for (_, _, g), (_, _, w) in zip(got, want):
        _same(g, w, "chunk")
    # rows [s1, s2) of the rows the filter keeps (the reference reads all)
    part = list(port.evaluate_iterator("i", 1_000, 9_500, chunk_size=4_000))
    assert [(a, b) for a, b, _ in part] == [(1_000, 5_000), (5_000, 9_000), (9_000, 9_500)]
    _same(np.concatenate([c for _, _, c in part]), ref.evaluate("i", 1_000, 9_500), "s1 s2")
    empty = port[port.i > 10 ** 6]
    assert [(a, b, len(c)) for a, b, c in empty.evaluate_iterator("i")] == [(0, 0, 0)]


@pytest.mark.parametrize("kind", KINDS)
def test_dropping_and_filling(kind):
    ref, port = _pair(kind)
    for call in (lambda df: df.dropna(), lambda df: df.dropna(["m"]),
                 lambda df: df.dropna(column_names=["f", "v"]), lambda df: df.dropmissing(),
                 lambda df: df.dropnan(), lambda df: df.dropnan(["i", "m"]),
                 lambda df: df.dropinf(), lambda df: df.dropinf(["f"])):
        got, want = call(port), call(ref)
        _same_frames(got, want)
        assert got.count_rows() == want.count_rows()
    got, want = port.fillna(0, column_names=["f", "m", "i", "v"]), ref.fillna(
        0, column_names=["f", "m", "i", "v"])
    _same_frames(got, want)
    npt.assert_allclose(got.sum(["f", "m", "v"]), want.sum(["f", "m", "v"]), rtol=RTOL,
                        atol=ATOL)
    got, want = port.fillna(-1.5), ref.fillna(-1.5)
    _same_frames(got, want, ["f", "m", "v", "i"])
    assert not np.ma.getmaskarray(port.fillna(2, ["m"]).evaluate("m")).any()


def test_dropna_refuses_another_how():
    _, port = _pair("plain")
    with pytest.raises(NotImplementedError, match="how='any'"):
        port.dropna(how="all")


@pytest.mark.parametrize("kind", KINDS)
def test_exporters(kind):
    ref, port = _pair(kind)
    for g, w in zip(port.to_arrays(), ref.to_arrays()):
        _same(g, w, "to_arrays")
    got, want = port.to_dict(["i", "v"], selection="k == 1"), ref.to_dict(["i", "v"],
                                                                          selection="k == 1")
    assert list(got) == list(want)
    for name in want:
        _same(got[name], want[name], name)
    assert [n for n, _ in port.to_items(virtual=False)] == [n for n, _ in
                                                            ref.to_items(virtual=False)]
    got, want = port.to_records(selection="k == 4"), ref.to_records(selection="k == 4")
    assert len(got) == len(want)
    for g, w in zip(got[:50], want[:50]):
        assert g.keys() == w.keys()
        for name in ("i", "k", "m"):
            assert g[name] == w[name] or (g[name] != g[name] and w[name] != w[name]), name
    assert port.to_records(index=3) == {n: v for n, v in zip(port.get_column_names(), [
        port.evaluate(n, 3, 4, array_type="python")[0] for n in port.get_column_names()])}
    pd.testing.assert_frame_equal(port.to_pandas_df(), ref.to_pandas_df())
    pd.testing.assert_frame_equal(port.to_pandas_df(["m", "i"], selection="f > 1"),
                                  ref.to_pandas_df(["m", "i"], selection="f > 1"))
    got, want = port.to_arrow_table(), ref.to_arrow_table()
    assert got.schema == want.schema  # arrow's equals holds NaN unequal to NaN
    assert [c.null_count for c in got.columns] == [c.null_count for c in want.columns]
    pd.testing.assert_frame_equal(got.to_pandas(), want.to_pandas())
    got, want = port.to_copy(selection="k < 3"), ref.to_copy(selection="k < 3")
    _same_frames(got, want)
    assert port.to_copy(virtual=False).get_column_names() == ref.to_copy(
        virtual=False).get_column_names()
    copied = port.to_copy(selections=False)
    assert not copied.selections and copied.get_column_names() == port.get_column_names()


@pytest.mark.parametrize("kind", KINDS)
def test_materialize(kind, monkeypatch):
    ref, port = _pair(kind)
    for df in (ref, port):
        df["w"] = "m * 4 + k"  # exact in both: no rounding an FMA could skip
    got, want = port.materialize("v"), ref.materialize("v")
    assert "v" not in got.virtual_columns and "v" in got.dataset
    assert isinstance(got.dataset["v"], torch.Tensor) and got.dataset["v"].device.type == "cpu"
    assert "w" in got.virtual_columns
    _same_frames(got, want, NAMES + ["w"])
    got, want = port.materialize(), ref.materialize()
    assert not got.virtual_columns
    from vaex_tpu_torch.column import ColumnMasked
    assert isinstance(got.dataset["w"], ColumnMasked)  # m's mask carried, on the CPU
    _same_frames(got, want, NAMES + ["w"])
    npt.assert_allclose(got.sum(["v", "w"]), want.sum(["v", "w"]), rtol=RTOL, atol=ATOL)
    # a frame of host arrays no one staged gets host arrays
    monkeypatch.setattr(settings, "DEVICE", "cpu")
    host = vaex_tpu_torch.from_arrays(x=np.arange(5.0))
    host["y"] = "x * 2"
    assert isinstance(host.materialize("y").dataset["y"], np.ndarray)
    with pytest.raises(KeyError):
        port.materialize("i")


@pytest.mark.parametrize("kind", KINDS)
def test_sample_shuffle_and_splits_pick_the_reference_rows(kind):
    ref, port = _pair(kind)
    for call in (lambda df: df.sample(n=500, random_state=42),
                 lambda df: df.sample(frac=0.1, random_state=7),
                 lambda df: df.sample(n=300, replace=True, random_state=1),
                 lambda df: df.sample(n=200, weights="abs(i) + 1", random_state=3),
                 lambda df: df.shuffle(random_state=42)):
        _same_frames(call(port), call(ref))
    for into in (3, [0.25, 0.5, 0.25]):
        got, want = port.split(into), ref.split(into)
        assert [len(g) for g in got] == [len(w) for w in want]
        for g, w in zip(got, want):
            _same_frames(g, w, ["i", "v"])
    got, want = port.split_random([0.8, 0.2], random_state=1), ref.split_random(
        [0.8, 0.2], random_state=1)
    assert [len(g) for g in got] == [len(w) for w in want]
    for g, w in zip(got, want):
        _same_frames(g, w, ["i", "d", "v"])


@pytest.mark.parametrize("kind", KINDS)
def test_small_accessors(kind):
    ref, port = _pair(kind)
    assert port.shape == ref.shape
    assert port.dtypes == dict(ref.dtypes)
    for name in ("i", "f", "m", "d"):
        assert port.is_masked(name) == ref.is_masked(name), name
    assert port.is_masked("m * 2") and not port.is_masked("v")
    assert port.length_original() == ref.length_original()
    assert port.length_unfiltered() == ref.length_unfiltered()
    assert port.count_rows() == ref.count_rows() == len(ref)


def test_vrange_vconstant_and_constructors(monkeypatch):
    monkeypatch.setattr(settings, "DEVICE", "cpu")
    n = 10 ** 7
    df = vaex_tpu_torch.vrange(0, n)
    col = df.dataset["x"]
    assert isinstance(col, vaex_tpu_torch.ColumnVirtualRange) and len(col) == n
    assert df.sum("x") == n * (n - 1) // 2 and df.count("x") == n
    for args in ((5, 100, 7), (0, 50, 1, "f4")):
        got, want = vaex_tpu_torch.vrange(*args), vaex_tpu.vrange(*args)
        _same(got.evaluate("x"), want.evaluate("x"), str(args))
        _same(got.evaluate("x * 2", 2, 5), want.evaluate("x * 2", 2, 5), str(args))
    # a negative step: numpy's arange (vaex_tpu's length formula gives a row
    # past stop; ROADMAP, known problems of the reference)
    _same(vaex_tpu_torch.vrange(10, -3, -2).evaluate("x"), np.arange(10, -3, -2), "step -2")
    ref, port = vaex_tpu.vrange(3, 40_003, 3), vaex_tpu_torch.vrange(3, 40_003, 3)
    _same_frames(port.take([5, 0, 13_332]), ref.take([5, 0, 13_332]), ["x"])
    _same_frames(port[port.x > 100][10:20], ref[ref.x > 100][10:20], ["x"])
    got = vaex_tpu_torch.vrange(10).concat(vaex_tpu_torch.vrange(4))
    npt.assert_array_equal(got.evaluate("x"), np.r_[np.arange(10), np.arange(4)])
    for pkg in (vaex_tpu, vaex_tpu_torch):
        df = pkg.from_items(("a", np.arange(4)), ("b", np.arange(4.0)))
        df.add_column("c", pkg.vconstant(2.5, 4))
        assert df.get_column_names() == ["a", "b", "c"]
        npt.assert_array_equal(df.evaluate("c"), np.full(4, 2.5))
    pdf = pd.DataFrame({"a": [1, 2, 3], "s": ["x", None, "z"], "f": [0.5, np.nan, 2.0]},
                       index=[10, 11, 12])
    got = vaex_tpu_torch.from_pandas(pdf, copy_index=True)
    want = vaex_tpu.from_pandas(pdf, copy_index=True)
    assert got.get_column_names() == want.get_column_names() == ["a", "s", "f", "index"]
    for name in ("a", "f", "index"):
        _same(got.evaluate(name), want.evaluate(name), name)
    # a string column is a host string column (an arrow array): its rows as numpy
    strings = vaex_tpu_torch.array_types.to_numpy(got.dataset["s"][:])
    assert list(np.ma.getmaskarray(strings)) == [False, True, False]
