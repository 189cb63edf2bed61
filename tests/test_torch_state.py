"""State, pickling, progress and cancelling of vaex_tpu_torch, held to
vaex_tpu on the same seeded arrays (tests/test_state.py and
tests/test_wholepass.py:76-100 are the reference's models): a state is
vaex_tpu's JSON, written by either package and loaded by the other; a
pickled frame comes back staged as it was; a progress callback sees each
tile and cancels a pass by returning False."""

import io
import json
import pickle

import numpy as np
import numpy.testing as npt
import pytest
import torch

import vaex_tpu
import vaex_tpu_torch
from torch_port_helpers import (ATOL, RTOL, assert_same_frame, host_list, same_frames,
                                seeded_arrays, string_arrays, string_frames)
from vaex_tpu_torch import settings
from vaex_tpu_torch.execution import ExecutorLocal, UserAbort
from vaex_tpu_torch.progress import ProgressBar


def _decorate(df):
    """Virtual columns, a variable, a filter and a named selection."""
    df["r"] = df.x * 2 + 1
    df["w"] = "r + y"
    df.add_variable("scale", 3.5)
    df["z"] = "x * scale"
    df = df.filter("x > -50")
    df.select("y > 0", name="up")
    return df


def _statistics(df):
    return [df.count(), df.sum("r"), df.mean("w"), df.std("z"), df.min("r"), df.max("z"),
            df.count(selection="up"), df.mean("x", selection="up"),
            df.sum("x", binby="k", limits=[0, 10], shape=10)]


def _close(got, want):
    for g, w in zip(got, want):
        npt.assert_allclose(np.asarray(g, np.float64), np.asarray(w, np.float64),
                            rtol=RTOL, atol=ATOL)


@pytest.fixture
def arrays():
    return seeded_arrays(3, 3000, 10)


def test_state_roundtrip_matches_the_original(arrays):
    _, port = same_frames(arrays)
    port = _decorate(port)
    fresh = vaex_tpu_torch.from_arrays(**arrays).to_device("cpu")
    fresh.state_set(port.state_get())
    assert fresh.get_column_names() == port.get_column_names()
    assert fresh.filter_expression == port.filter_expression
    assert len(fresh) == len(port)
    for got, want in zip(_statistics(fresh), _statistics(port)):
        npt.assert_array_equal(got, want)


@pytest.mark.parametrize("writer", ["vaex_tpu", "port"])
def test_a_state_loads_across_the_packages(tmp_path, arrays, writer):
    """A state without functions is plain JSON in vaex_tpu's format: what one
    package writes the other loads, and the statistics agree."""
    ref, port = same_frames(arrays)
    ref, port = _decorate(ref), _decorate(port)
    path = str(tmp_path / "state.json")
    (ref if writer == "vaex_tpu" else port).state_write(path)
    with open(path) as f:
        json.load(f)
    ref2, port2 = same_frames(arrays)
    ref2.state_load(path)
    port2.state_load(path)
    assert len(port2) == len(ref2) == len(ref)
    _close(_statistics(port2), _statistics(ref2))


def test_state_carries_sets_arrays_and_categories(arrays):
    ref, port = same_frames(arrays, category="k", labels=list(range(10)))
    for df in (ref, port):
        df["sel"] = df.k.isin([1, 3, 7])
        df.add_variable("weights", np.linspace(0, 1, 10))
    state = port.state_get()
    json.dumps({k: v for k, v in state.items()})
    fresh = vaex_tpu_torch.from_arrays(**arrays).to_device("cpu")
    fresh.state_set(state)
    assert fresh.is_category("k") and fresh.category_labels("k") == list(range(10))
    assert fresh.count(selection="sel") == ref.count(selection="sel")
    npt.assert_array_equal(fresh.evaluate_variable("weights"), np.linspace(0, 1, 10))
    got = fresh.groupby("k", agg="count")
    want = ref.groupby("k", agg="count")
    assert got["count"].tolist() == want["count"].tolist()


def test_state_of_a_staged_string_category(monkeypatch):
    monkeypatch.setattr(settings, "DEVICE", "cpu")
    ref, port = string_frames(string_arrays(4, 400), "staged")
    state = port.state_get()
    assert state["categories"]["s"]["codes_column"] == "__s_codes"
    json.dumps(state)
    fresh = vaex_tpu_torch.from_arrays(**string_arrays(4, 400)).to_device("cpu")
    fresh.state_set(state)
    assert fresh.category_labels("s") == port.category_labels("s")
    assert fresh.groupby("s", agg="count")["count"].tolist() == (
        port.groupby("s", agg="count")["count"].tolist())
    # on an unstaged frame the codes column is missing: the key is read from its values
    host = vaex_tpu_torch.from_arrays(**string_arrays(4, 400))
    host.state_set(state)
    assert not host.is_category("s") or host.category_labels("s") == port.category_labels("s")
    assert sorted(host.s.value_counts().tolist()) == sorted(ref.s.value_counts().tolist())


def test_state_carries_the_active_range(arrays):
    _, port = same_frames(arrays)
    port.set_active_range(100, 900)
    fresh = vaex_tpu_torch.from_arrays(**arrays).to_device("cpu")
    fresh.state_set(port.state_get())
    assert len(fresh) == 800 and fresh.state_get()["active_range"] == [100, 900]
    npt.assert_allclose(fresh.sum("x"), arrays["x"][100:900].sum(), rtol=RTOL)


def test_set_filter_false_keeps_the_frames_filter(arrays):
    _, port = same_frames(arrays)
    state = port.filter("x > 0").state_get()
    fresh = vaex_tpu_torch.from_arrays(**arrays).to_device("cpu").filter("x < 0")
    fresh.state_set(state, set_filter=False)
    assert fresh.filter_expression == "x < 0"


# ------------------------------------------------------------------ pickling


@pytest.mark.parametrize("staged", [True, False])
def test_pickle_roundtrip(monkeypatch, arrays, staged):
    monkeypatch.setattr(settings, "DEVICE", "cpu")
    port = vaex_tpu_torch.from_arrays(**arrays)
    if staged:
        port = port.to_device("cpu")
    port = _decorate(port).categorize("k", labels=list(range(10)))
    back = pickle.loads(pickle.dumps(port))
    assert (back.dataset.device is None) == (not staged)
    if staged:
        assert all(isinstance(back.dataset[n], torch.Tensor) for n in ("x", "y", "k"))
    else:
        assert isinstance(back.dataset["x"], np.ndarray)
    for got, want in zip(_statistics(back), _statistics(port)):
        npt.assert_array_equal(got, want)
    assert back.groupby("k", agg={"s": vaex_tpu_torch.agg.sum("x")})["s"].tolist() == (
        port.groupby("k", agg={"s": vaex_tpu_torch.agg.sum("x")})["s"].tolist())


def test_pickle_of_strings_uint64_and_datetimes(monkeypatch):
    monkeypatch.setattr(settings, "DEVICE", "cpu")
    arrays = string_arrays(9, 300)
    arrays["u"] = np.arange(300, dtype=np.uint64) * np.uint64(2 ** 60 // 300)
    arrays["d"] = np.arange(300).astype("M8[s]")
    port = vaex_tpu_torch.from_arrays(**arrays).to_device("cpu")
    back = pickle.loads(pickle.dumps(port))
    for name in ("s", "t", "u", "d", "x"):
        assert host_list(back.evaluate(name)) == host_list(port.evaluate(name)), name
    assert back.is_category("s")


def test_unpickled_cuda_frame_goes_to_the_default_device(monkeypatch, arrays):
    """A frame staged to "cuda" is staged to settings.DEVICE again: here
    the CPU stands in for the card."""
    from vaex_tpu_torch.dataframe import _unpickle
    monkeypatch.setattr(settings, "DEVICE", "cpu")
    port = vaex_tpu_torch.from_arrays(**arrays).to_device("cpu")
    func, (columns, logical, device, state) = port.__reduce__()
    assert device == "cpu"
    back = func(columns, logical, "cuda", state)
    assert back.dataset.device == torch.device("cpu")
    assert back.sum("x") == port.sum("x")


def test_vaex_tpu_pickles_the_same_frame(arrays):
    ref, port = same_frames(arrays)
    ref, port = _decorate(ref), _decorate(port)
    ref2, port2 = pickle.loads(pickle.dumps(ref)), pickle.loads(pickle.dumps(port))
    _close(_statistics(port2), _statistics(ref2))


# ------------------------------------------------------ progress, cancelling


def test_progress_sees_each_tile_and_ends_at_one():
    n = 64 * 1024
    port = vaex_tpu_torch.from_arrays(x=np.arange(n, dtype="f8")).to_device("cpu")
    port.executor = ExecutorLocal()
    port._tile_rows = 1024
    seen = []
    port.executor.signal_progress.connect(lambda p: seen.append(p) or True)
    assert port.sum("x") == np.arange(n, dtype="f8").sum()
    assert len(seen) == 64 and seen[-1] == 1.0
    assert all(a < b for a, b in zip(seen, seen[1:]))


def test_a_false_progress_cancels_the_pass():
    n = 64 * 1024
    port = vaex_tpu_torch.from_arrays(x=np.arange(n, dtype="f8"),
                                      g=np.arange(n) % 16).to_device("cpu")
    port.executor = ExecutorLocal()
    port._tile_rows = 1024
    calls = []
    cb = port.executor.signal_progress.connect(lambda p: calls.append(p) or len(calls) < 2)
    cancelled = []
    port.executor.signal_cancel.connect(lambda: cancelled.append(True))
    total = port.sum("x", delay=True)
    port.execute()  # the pass stops; execute returns
    assert len(calls) == 2 and cancelled == [True]
    with pytest.raises(UserAbort):
        total.get()
    port.executor.signal_progress.disconnect(cb)
    # the executor stays usable and the next query is right
    got = port.groupby("g", agg={"s": vaex_tpu_torch.agg.sum("x")}, sort=True)
    want = [np.arange(n, dtype="f8")[np.arange(n) % 16 == g].sum() for g in range(16)]
    npt.assert_allclose(got["s"].tolist(), want, rtol=RTOL)


def test_progress_argument_and_bar():
    port = vaex_tpu_torch.from_arrays(x=np.arange(10, dtype="f8")).to_device("cpu")
    port._tile_rows = 3
    out = io.StringIO()
    assert port.sum("x", progress=ProgressBar(out=out)) == 45
    assert "%" in out.getvalue() and "100.00%" in out.getvalue()
    seen = []
    port.mean("x", progress=lambda p: seen.append(p) or True)
    assert seen == [0.3, 0.6, 0.9, 1.0]
    assert not port.executor.signal_progress.callbacks  # disconnected after the call
    with pytest.raises(UserAbort):
        port.std("x", progress=lambda p: False)
    assert port.std("x") == np.std(np.arange(10.0))


def test_signals_frame_each_pass():
    port = vaex_tpu_torch.from_arrays(x=np.arange(10, dtype="f8")).to_device("cpu")
    events = []
    port.executor.signal_begin.connect(lambda: events.append("begin"))
    port.executor.signal_end.connect(lambda: events.append("end"))
    port.sum("x")
    assert events == ["begin", "end"]


def test_the_passes_counter(arrays):
    ref, port = same_frames(arrays)
    for df in (ref, port):
        p0 = df.executor.passes
        df.sum("x")
        assert df.executor.passes == p0 + 1
        trace = df.executor.trace_log[-1]
        assert trace["rows"] == len(arrays["x"]) and trace["wall_s"] >= 0


def test_reference_progress_cancel_model():
    """tests/test_state.py:test_progress_cancel, on the port."""
    port = vaex_tpu_torch.from_arrays(x=np.arange(10, dtype="f8")).to_device("cpu")
    port._tile_rows = 2
    calls = []
    cb = port.executor.signal_progress.connect(lambda f: calls.append(f) or len(calls) < 2)
    try:
        task = port.sum("x", delay=True)
        port.execute()
        assert task.exception is not None
    finally:
        port.executor.signal_progress.disconnect(cb)
