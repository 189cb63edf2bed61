"""The frame's API tail in vaex_tpu_torch, held to vaex_tpu on the same
seeded arrays: the text of a frame and an expression, the active range,
``columns``, ``col``, ``unit``, iteration, ``close``, ``execute_async``,
``Expression.nop`` / ``ast``, and ``Dataset.close`` / ``shallow_copy`` /
``dtypes``."""

import ast
import asyncio

import numpy as np
import numpy.testing as npt
import pytest

import vaex_tpu_torch
from torch_port_helpers import RTOL, same_frames, seeded_arrays, string_arrays


@pytest.fixture
def frames():
    arrays = seeded_arrays(2, 40, 5)
    arrays["m"] = np.ma.MaskedArray(np.arange(40.0), np.arange(40) % 7 == 0)
    return same_frames(arrays)


@pytest.mark.parametrize("rows", [0, 3, 10, 40])
def test_repr_is_vaex_tpus_text(frames, rows):
    ref, port = frames
    ref, port = ref[:rows], port[:rows]
    assert repr(port) == repr(ref)
    assert port._repr_html_() == ref._repr_html_()


def test_repr_of_virtual_columns_and_strings(monkeypatch):
    from vaex_tpu_torch import settings
    monkeypatch.setattr(settings, "DEVICE", "cpu")
    arrays = string_arrays(3, 12)
    import vaex_tpu
    ref, port = vaex_tpu.from_arrays(**arrays), vaex_tpu_torch.from_arrays(**arrays)
    for df in (ref, port):
        df["z"] = df.x * 2
    assert repr(port) == repr(ref)


@pytest.mark.parametrize("expression", ["x", "x * 2 + y", "k", "m", "x > 0"])
def test_expression_repr_is_vaex_tpus_text(frames, expression):
    ref, port = frames
    assert repr(port[expression]) == repr(ref[expression])


def test_active_range(frames):
    ref, port = frames
    for df in (ref, port):
        df.set_active_range(5, 25)
    assert len(port) == len(ref) == 20
    assert port.length_original() == ref.length_original() == 40
    npt.assert_allclose(port.sum("x"), ref.sum("x"), rtol=RTOL)
    npt.assert_array_equal(port.evaluate("k"), ref.evaluate("k"))
    for df in (ref, port):
        df.set_active_fraction(0.25)
    assert len(port) == len(ref) == 10
    npt.assert_allclose(port.mean("y"), ref.mean("y"), rtol=RTOL)
    port.set_active_range(0, 40)
    assert len(port) == 40


def test_columns_col_unit_iter_close(frames):
    ref, port = frames
    assert sorted(port.columns) == sorted(ref.columns)
    assert port.col.x.expression == ref.col.x.expression == "x"
    npt.assert_allclose(port.col.x.sum(), ref.col.x.sum(), rtol=RTOL)
    assert list(port) == list(ref)
    port.units["x"] = "m/s"
    assert port.unit("x") == "m/s" and port.unit("y") is None and ref.unit("y") is None
    assert port.copy().unit("x") == "m/s"
    port.close()
    ref.close()


def test_execute_async(frames):
    _, port = frames
    total = port.sum("x", delay=True)
    asyncio.run(port.execute_async())
    npt.assert_allclose(total.get(), port.evaluate("x").sum(), rtol=RTOL)


def test_expression_nop_and_ast(frames):
    ref, port = frames
    p0 = port.executor.passes
    assert port.x.nop() is None
    e = port.x * 2 + port.y
    assert ast.dump(e.ast) == ast.dump((ref.x * 2 + ref.y).ast)
    assert isinstance(e.ast, ast.BinOp)
    assert port.executor.passes >= p0


def test_dataset_close_shallow_copy_dtypes(frames):
    ref, port = frames
    ds = port.dataset
    assert ds.shallow_copy() is ds and ref.dataset.shallow_copy() is ref.dataset
    assert ds.close() is None
    got = {name: dt.name for name, dt in ds.dtypes().items()}
    want = {name: str(np.dtype(dt.numpy if hasattr(dt, "numpy") else dt))
            for name, dt in ref.dataset.dtypes().items()}
    assert got == want


def test_dataset_dtypes_keep_logical_types():
    arrays = {"d": np.arange(4).astype("M8[s]"), "u": np.arange(4, dtype=np.uint64)}
    port = vaex_tpu_torch.from_arrays(**arrays).to_device("cpu")
    dtypes = port.dataset.dtypes()
    assert dtypes["d"].numpy == np.dtype("M8[s]") and dtypes["u"].numpy == np.uint64
