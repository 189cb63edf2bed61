"""Virtual columns, renaming, dropping and added columns of the port against
vaex_tpu on the same arrays (the port on device="cpu"): the cases of
tests/test_expression.py (``test_ufuncs``, ``test_virtual_columns``),
tests/test_dataframe.py (expand, add_column, rename, drop, ordinal_encode,
copy and deleting a virtual column) and tests/test_cornercases.py (the chain
of virtual columns, a renamed physical column, name mangling), a groupby
and a binby over an expression key, the self-reference rules of
``add_virtual_column``, the dataset nodes behind them, and the memo of a
dense key's range under a redefined virtual column.

Ints, counts, min and max exact; floats to the repo's contract (1e-6
relative, 1e-7 absolute; ``torch_port_helpers.RTOL, ATOL``).
"""

import importlib
import pkgutil
import subprocess
import sys

import numpy as np
import numpy.testing as npt
import pytest
import torch

import vaex_tpu
import vaex_tpu_torch
from torch_port_helpers import ATOL, RTOL, assert_same_frame, same_frames
from vaex_tpu_torch.column import ColumnVirtualConstant
from vaex_tpu_torch.utils import find_valid_name

X = np.arange(10, dtype="f8")


def base_arrays():
    """tests/conftest.py's base frame without its string column."""
    return dict(x=X.copy(), y=X ** 2, g=np.array([0, 0, 0, 0, 1, 1, 1, 1, 2, 2], dtype="i8"),
                m=np.ma.MaskedArray(X.copy(), X < 2), f=np.where(X == 9, np.nan, X),
                i=np.arange(10, dtype="i4"))


@pytest.fixture(params=[None, 3], ids=["one tile", "tiles of 3"])
def frames(request):
    return same_frames(base_arrays(), tile_rows=request.param)


def _close(got, want):
    npt.assert_allclose(np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64),
                        rtol=RTOL, atol=ATOL)


def test_ufuncs(frames):
    ref, port = frames
    for expression in ("sin(x)", "sqrt(y)", "log(x + 1)", "arctan2(x, y + 1)", "clip(x, 2, 5)",
                       "maximum(x, 5)"):
        _close(port[expression].tolist(), ref[expression].tolist())
    _close(port.mean("sqrt(x)"), ref.mean("sqrt(x)"))
    assert np.asarray(port.mean("sqrt(i)")).dtype == np.float64


def test_virtual_columns(frames):
    ref, port = frames
    for df in (ref, port):
        df["r"] = df.x + df.y
        df["r2"] = df.r * 2  # virtual referencing virtual
        df["rho"] = "sqrt(x**2 + y**2)"
    for name in ("r", "r2", "rho"):
        _close(port[name].tolist(), ref[name].tolist())
        _close(port.sum(name), ref.sum(name))
    assert port.sum("r2") == ref.sum("r2") == 2 * (X + X ** 2).sum()
    assert port.get_column_names() == ref.get_column_names()
    assert port.data_type("rho") == np.float64 and port.rho.dtype == np.float64
    _close(port.mean(["r", "rho"], selection=[None, "x > 3"]),
           ref.mean(["r", "rho"], selection=[None, "x > 3"]))


def test_expand_and_variables(frames):
    ref, port = frames
    for df in (ref, port):
        df["a"] = df.x * 2
        df["b"] = df.a + 1
    expanded = port["b"].expand().expression
    assert "a" not in expanded and expanded == ref["b"].expand().expression
    _close(port[expanded].tolist(), X * 2 + 1)
    assert port["b"].variables() == ref["b"].variables() == {"x"}
    assert port["b"].expand(stop=["a"]).expression == ref["b"].expand(stop=["a"]).expression
    assert port.b.fingerprint() != port.a.fingerprint()


def test_expression_statistics_and_convenience(frames):
    ref, port = frames
    for stat in ("count", "sum", "mean", "std", "var", "min", "max", "minmax"):
        _close(getattr(port.f, stat)(), getattr(ref.f, stat)())
    for name in ("fillna", "fillmissing"):
        _close(getattr(port.m, name)(-1.0).tolist(), getattr(ref.m, name)(-1.0).tolist())
    assert port.m.isna().tolist() == ref.m.isna().tolist()
    assert port.f.notna().tolist() == ref.f.notna().tolist()
    _close(port.x.clip(2, 5).tolist(), ref.x.clip(2, 5).tolist())
    _close(abs(port.x - 4).tolist(), abs(ref.x - 4).tolist())
    _close(port.x.abs().tolist(), ref.x.abs().tolist())
    # where(condition, other): this expression where the condition holds
    _close(port.x.where(port.x > 4, -1).tolist(), ref["where(x > 4, x, -1)"].tolist())


def test_add_column(frames):
    ref, port = frames
    for df in (ref, port):
        df.add_column("w", np.ones(10))
        df.add_column("c", 3)  # a scalar: a constant column
        df["v"] = np.arange(10) * 2  # an array through __setitem__
    assert port.sum("w") == ref.sum("w") == 10
    assert port.sum("c") == ref.sum("c") == 30
    assert port.sum("v") == ref.sum("v")
    assert isinstance(port.dataset["c"], ColumnVirtualConstant)
    assert port.get_column_names() == ref.get_column_names()
    for df in (ref, port):
        df.add_column("w", np.full(10, 2.0))  # replaces the column of that name
    assert port.sum("w") == ref.sum("w") == 20
    with pytest.raises(ValueError, match="length"):
        port.add_column("bad", np.ones(3))


def test_rename(frames):
    ref, port = frames
    for df in (ref, port):
        df["r"] = df.x * 2
        df.rename("x", "xx")
        df.rename("r", "rr")
    assert port.get_column_names() == ref.get_column_names()
    assert "xx" in port.get_column_names() and "rr" in port.get_column_names()
    _close(port["rr"].tolist(), ref["rr"].tolist())  # its expression was rewritten
    assert port.virtual_columns == ref.virtual_columns


def test_rename_physical_and_aggregate(frames):
    ref, port = frames
    for df in (ref, port):
        df.rename("x", "xx")
        assert df.sum("xx") == X.sum()
        with pytest.raises(Exception):
            df.sum("x")


def test_drop(frames):
    ref, port = frames
    for df in (ref, port):
        df["r"] = df.x + 1
    for columns in ("x", ["x", "r"], port.x):
        got, want = port.drop(columns), ref.drop(str(columns) if not isinstance(columns, list)
                                                 else columns)
        assert got.get_column_names() == want.get_column_names()
    dropped = port.drop("x")
    assert "x" in port.get_column_names()  # not in place
    _close(dropped.sum("r"), ref.drop("x").sum("r"))  # its data stays under r
    del port["g"]
    del ref["g"]
    assert port.get_column_names() == ref.get_column_names()


def test_copy_delete_virtual_and_column_count():
    arrays = {"x": np.arange(5.0),
              "m": np.ma.MaskedArray(np.arange(5.0), [True, False, False, False, False])}
    ref, port = same_frames(arrays)
    for df in (ref, port):
        df["v"] = "x * 2"
        df.select("x > 1")
    assert port.column_count() == ref.column_count() == 3
    copy = port.copy()
    assert copy.virtual_columns == port.virtual_columns and copy.has_selection()
    assert copy.count(selection=True) == ref.count(selection=True) == 3
    copy["w"] = "v + 1"
    assert "w" not in port.get_column_names()
    for df in (ref, port):
        df.delete_virtual_column("v")
        assert "v" not in df.get_column_names()
        with pytest.raises(KeyError):
            df.delete_virtual_column("nope")
    assert "v" in copy.get_column_names()
    _close(copy.sum("w"), (np.arange(5.0) * 2 + 1).sum())


def test_get_column_names(frames):
    ref, port = frames
    for df in (ref, port):
        df["r"] = df.x + 1
        df["__h"] = df.x * 3
    for kwargs in ({}, {"virtual": False}, {"hidden": True}, {"regex": "^[xy]"},
                   {"virtual": False, "hidden": True}):
        assert port.get_column_names(**kwargs) == ref.get_column_names(**kwargs), kwargs
    assert port.column_count() == ref.column_count()
    assert port.column_count(hidden=True) == ref.column_count(hidden=True)


@pytest.mark.parametrize("depth", [1, 20, 60])
def test_virtual_column_chain_depth(depth):
    ref, port = same_frames({"x": X.copy()})
    for df in (ref, port):
        name = "x"
        for i in range(depth):
            df[f"v{i}"] = df[name] + 1
            name = f"v{i}"
    _close(port[name].tolist(), X + depth)
    assert port.sum(name) == ref.sum(name) == (X + depth).sum()
    assert port.executor.trace_log[-1]["rows"] == 10


def test_self_reference_rules(frames):
    """x = x * 2 of a virtual x takes its old definition; of a physical x it
    hides the data as __x and reads that."""
    ref, port = frames
    for df in (ref, port):
        df["r"] = df.y + 1
        df["r"] = df.r * 2
        df["x"] = df.x * 3
    assert port.virtual_columns == ref.virtual_columns
    assert port.get_column_names(hidden=True) == ref.get_column_names(hidden=True)
    _close(port.r.tolist(), (X ** 2 + 1) * 2)
    _close(port.x.tolist(), X * 3)
    _close(port.sum("x + r"), ref.sum("x + r"))
    assert port.data_type("x") == np.float64


def test_column_name_mangling():
    """A name that is not an identifier is renamed on entry, as in
    vaex_tpu; find_valid_name gives the reference's names."""
    ref, port = same_frames({"weird name": np.arange(3.0), "xi % 5": np.arange(3.0)})
    assert port.get_column_names() == ref.get_column_names() == ["weird_name", "xi___5"]
    assert port.sum("weird_name") == ref.sum("weird_name") == 3.0
    for name in ("xi % 5", "1st", "a-b", "class", "ok"):
        assert find_valid_name(name) == vaex_tpu.utils.find_valid_name(name)
    assert find_valid_name("x", used=["x", "x_1"]) == "x_2"


def test_groupby_and_binby_over_an_expression_key():
    rng = np.random.default_rng(8)
    arrays = {"xi": rng.integers(-20, 20, 500).astype(np.int64), "v": rng.normal(0, 1, 500)}
    ref, port = same_frames(arrays)
    got = port.groupby("xi % 5", agg={"s": vaex_tpu_torch.agg.sum("v"), "c": "count"},
                       sort=True)
    want = ref.groupby("xi % 5", agg={"s": vaex_tpu.agg.sum("v"), "c": "count"}, sort=True)
    assert got.get_column_names() == ["xi___5", "s", "c"]
    assert_same_frame(want, got)
    for df in (ref, port):
        df["k"] = "abs(xi) // 4"
    assert_same_frame(ref.groupby("k", agg="count", sort=True),
                      port.groupby("k", agg="count", sort=True))
    grid = port.count(binby="xi % 5", limits=[0, 5], shape=5)
    npt.assert_array_equal(grid, ref.count(binby="xi % 5", limits=[0, 5], shape=5))
    _close(port.mean("v", binby=["sqrt(abs(xi))"], limits=[0, 5], shape=4),
           ref.mean("v", binby=["sqrt(abs(xi))"], limits=[0, 5], shape=4))
    got = port.binby("xi % 5", agg={"c": "count"}, limits=[0, 5], shape=5)
    want = ref.binby("xi % 5", agg={"c": "count"}, limits=[0, 5], shape=5)
    assert got.dims == want.dims == ("xi % 5",)
    npt.assert_array_equal(np.asarray(got), np.asarray(want))


def test_ordinal_encode():
    """The numeric counterpart of tests/test_dataframe.py:225: a virtual
    column of codes that is a category, grouped as vaex_tpu groups it."""
    rng = np.random.default_rng(9)
    k = rng.choice([7.5, -2.0, 3.25, np.nan], 300)
    arrays = {"k": k, "v": rng.normal(0, 1, 300)}
    ref, port = same_frames(arrays)
    ref, port = ref.ordinal_encode("k"), port.ordinal_encode("k")
    assert port.is_category("k_ordinal") and ref.is_category("k_ordinal")
    assert port.category_labels("k_ordinal") == ref.category_labels("k_ordinal")
    npt.assert_array_equal(port.evaluate("k_ordinal"), np.asarray(ref.evaluate("k_ordinal")))
    assert_same_frame(ref.groupby("k_ordinal", agg={"s": vaex_tpu.agg.sum("v")}, sort=True),
                      port.groupby("k_ordinal", agg={"s": vaex_tpu_torch.agg.sum("v")},
                                   sort=True))
    explicit = port.ordinal_encode("k", values=[3.25, 7.5])
    assert explicit.category_count("k_ordinal") == 2


def test_redefined_virtual_key_is_not_read_from_the_memo(monkeypatch):
    """The dense pre-pass remembers a raw key's range per frame; a virtual
    key redefined under the same name has another range, which a groupby
    must see: a fresh pre-pass and a grouper over the new range."""
    from vaex_tpu_torch import groupby
    rng = np.random.default_rng(10)
    arrays = {"id4": rng.integers(1, 101, 2000).astype(np.int64),
              "id6": rng.integers(1, 1001, 2000).astype(np.int64), "v": rng.normal(0, 1, 2000)}
    for first, second in (("id6", "id4"), ("id4", "id6")):
        ref, port = same_frames(arrays)
        for df in (ref, port):
            df["k"] = first
        assert_same_frame(ref.groupby("k", agg="count", sort=True),
                          port.groupby("k", agg="count", sort=True))
        for df in (ref, port):
            df["k"] = second
        passes = port.executor.passes
        gb = groupby.GroupBy(port, "k", sort=True)
        assert port.executor.passes == passes + 1  # the pre-pass ran again
        assert gb.groupers[0].N == arrays[second].max() - arrays[second].min() + 1
        assert_same_frame(ref.groupby("k", agg="count", sort=True), gb.agg("count"))
        for df in (ref, port):  # the first definition again: its range is remembered
            df["k"] = first
        passes = port.executor.passes
        assert groupby.GroupBy(port, "k").groupers[0].N == (
            arrays[first].max() - arrays[first].min() + 1)
        assert port.executor.passes == passes


def test_dataset_nodes_keep_device_and_logical_and_fingerprint_apart():
    from vaex_tpu_torch.dataset import DatasetArrays
    d = np.array(["2020-01-01", "NaT", "2021-06-01"], dtype="M8[ns]")
    base = DatasetArrays({"t": torch.arange(3), "d": d}, device="cpu")
    renamed = base.renamed({"t": "u"})
    dropped = base.dropped("t")
    merged = dropped.merged(DatasetArrays({"w": np.ones(3)}))
    assert list(renamed) == ["u", "d"] and list(dropped) == ["d"] and list(merged) == ["d", "w"]
    for node in (renamed, dropped, merged):
        assert node.device == torch.device("cpu") and node.logical["d"] == d.dtype
        assert node.row_count == 3
    prints = {node.fingerprint() for node in (base, renamed, dropped, merged,
                                              base.renamed({"t": "v"}))}
    assert len(prints) == 5
    with pytest.raises(NameError, match="duplicate"):
        base.merged(DatasetArrays({"t": np.ones(3)}))
    with pytest.raises(ValueError, match="row counts"):
        base.merged(DatasetArrays({"w": np.ones(4)}))


def test_port_and_chip_smoke_import_neither_jax_nor_vaex_tpu():
    """Every module of vaex_tpu_torch, and chip_smoke.py, imported in a
    fresh interpreter, pulls in no module of jax or vaex_tpu."""
    names = ["vaex_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(vaex_tpu_torch.__path__, "vaex_tpu_torch.")]
    code = ("import importlib, sys; "
            f"[importlib.import_module(m) for m in {names!r}]; import chip_smoke; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'vaex_tpu')); "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
    assert importlib.util.find_spec("vaex_tpu_torch.selections") is not None
