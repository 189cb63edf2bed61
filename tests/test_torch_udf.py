"""Python UDFs in vaex_tpu_torch, held to vaex_tpu on the same seeded
arrays: ``add_function``, ``df.apply``, ``Expression.apply``, ``jit`` and
its aliases, ``map_reduce``, and ``multiprocessing=True``.  A UDF runs in
the host stage of a pass and its result is copied to the pass device, so
it works as a groupby key, a filter, a selection and a binby axis."""

import numpy as np
import numpy.testing as npt
import pytest

import vaex_tpu
import vaex_tpu_torch
from torch_port_helpers import ATOL, RTOL, same_frames, seeded_arrays
from vaex_tpu_torch import multiprocessing as port_mp
from vaex_tpu_torch import settings


def scaled(x, k):
    return x * 0.5 + k


def bucket(k):
    return k % 3


def positive(x):
    return x > 0


@pytest.fixture
def frames():
    ref, port = same_frames(seeded_arrays(11, 4000, 12))
    return ref, port


def _both(frames, make):
    ref, port = frames
    make(ref)
    make(port)
    return ref, port


def test_apply_matches_vaex_tpu(frames):
    ref, port = _both(frames, lambda df: df.__setitem__("u", df.apply(scaled, ["x", "k"])))
    npt.assert_allclose(port.evaluate("u"), ref.evaluate("u"), rtol=RTOL, atol=ATOL)
    npt.assert_allclose(port.sum("u"), ref.sum("u"), rtol=RTOL)
    npt.assert_allclose(port.std("u"), ref.std("u"), rtol=RTOL)
    assert port.data_type("u") == ref.data_type("u")


def test_a_udf_runs_in_the_host_stage(frames):
    from vaex_tpu_torch.scopes import expression_is_device
    _, port = _both(frames, lambda df: df.__setitem__("u", df.apply(scaled, ["x", "k"])))
    assert not expression_is_device(port, "u")
    port.sum("u + 1")
    trace = port.executor.trace_log[-1]
    assert trace["host_stage"] == ["u + 1"]


def test_add_function_by_name(frames):
    def f(df):
        df.add_function("twice", lambda a: a * 2)
        df["t"] = "twice(x) + twice(iv)"
    ref, port = _both(frames, f)
    npt.assert_allclose(port.evaluate("t"), ref.evaluate("t"), rtol=RTOL)
    assert "twice" in port.functions


def test_row_wise_and_expression_apply(frames):
    ref, port = frames
    want = ref.x.apply(lambda v: v * 3 if v > 0 else -1.0).evaluate()
    got = port.x.apply(lambda v: v * 3 if v > 0 else -1.0).evaluate()
    npt.assert_allclose(got, want, rtol=RTOL)
    got = port.x.apply(np.cos, vectorize=True).sum()
    npt.assert_allclose(got, ref.x.apply(np.cos, vectorize=True).sum(), rtol=RTOL)


def test_jit_is_the_identity(frames):
    ref, port = frames
    for name in ("jit", "jit_numba", "jit_jax"):
        e = getattr(port.x * 2 + port.y, name)()
        assert e.expression == getattr(ref.x * 2 + ref.y, name)().expression
        npt.assert_allclose(e.sum(), (ref.x * 2 + ref.y).sum(), rtol=RTOL)


def test_a_udf_as_a_groupby_key(frames):
    ref, port = _both(frames, lambda df: df.__setitem__("b", df.apply(bucket, ["k"])))
    got = port.groupby("b", agg={"s": vaex_tpu_torch.agg.sum("x"),
                                 "sd": vaex_tpu_torch.agg.std("x")}, sort=True)
    want = ref.groupby("b", agg={"s": vaex_tpu.agg.sum("x"), "sd": vaex_tpu.agg.std("x")},
                       sort=True)
    assert got["b"].tolist() == want["b"].tolist()
    npt.assert_allclose(got["s"].tolist(), want["s"].tolist(), rtol=RTOL)
    npt.assert_allclose(got["sd"].tolist(), want["sd"].tolist(), rtol=RTOL)


def test_a_udf_as_filter_selection_and_binby_axis(frames):
    def f(df):
        df["p"] = df.apply(positive, ["x"])
        df["u"] = df.apply(scaled, ["x", "k"])
    ref, port = _both(frames, f)
    assert len(port[port.p]) == len(ref[ref.p])
    npt.assert_allclose(port[port.p].sum("y"), ref[ref.p].sum("y"), rtol=RTOL)
    assert port.count(selection="p") == ref.count(selection="p")
    npt.assert_allclose(port.mean("y", selection=port.p), ref.mean("y", selection=ref.p),
                        rtol=RTOL)
    got = port.count(binby="u", limits=[-100, 100], shape=16)
    want = ref.count(binby="u", limits=[-100, 100], shape=16)
    npt.assert_array_equal(got, want)
    assert port.minmax("u").tolist() == pytest.approx(ref.minmax("u").tolist(), rel=RTOL)


def test_map_reduce_matches_vaex_tpu(frames):
    ref, port = frames
    for df in (ref, port):
        df._tile_rows = 1000

    def part(x):
        return float(np.nansum(x)), len(x)

    def join(a, b):
        return a[0] + b[0], a[1] + b[1]
    got = port.map_reduce(part, join, ["x"])
    want = ref.map_reduce(part, join, ["x"])
    assert got[1] == want[1] == 4000
    npt.assert_allclose(got[0], want[0], rtol=RTOL)
    spans = port.map_reduce(lambda i1, i2, x: [(i1, i2)], lambda a, b: a + b, ["x"], info=True)
    assert spans == [(0, 1000), (1000, 2000), (2000, 3000), (3000, 4000)]
    kept = port[port.x > 0].map_reduce(lambda x: len(x), lambda a, b: a + b, ["x"],
                                       pre_filter=True)
    assert kept == int((port.evaluate("x") > 0).sum())
    assert port.map_reduce(lambda x: x.sum(), None, ["iv"]) == [
        v.sum() for v in np.split(port.evaluate("iv"), 4)]


def test_multiprocessing_gives_the_same_bits(monkeypatch):
    """A pool of processes from a "forkserver" context, never "fork" (a
    process that started CUDA must not fork), gets numpy chunks and gives
    the same values bit for bit."""
    monkeypatch.setattr(settings, "NUM_PROCESSES", 2)
    rng = np.random.default_rng(4)
    n = 3 * port_mp.MIN_ROWS
    arrays = {"x": rng.normal(0, 1, n), "y": rng.normal(0, 1, n), "k": rng.integers(0, 5, n)}
    port = vaex_tpu_torch.from_arrays(**arrays).to_device("cpu")
    port["h1"] = port.apply(np.hypot, ["x", "y"])
    port["h2"] = port.apply(np.hypot, ["x", "y"], multiprocessing=True)
    try:
        one = port.groupby("k", agg={"s": vaex_tpu_torch.agg.sum("h1"),
                                     "sd": vaex_tpu_torch.agg.std("h1")}, sort=True)
        two = port.groupby("k", agg={"s": vaex_tpu_torch.agg.sum("h2"),
                                     "sd": vaex_tpu_torch.agg.std("h2")}, sort=True)
        assert port_mp._pool is not None
        assert port_mp._pool._ctx.get_start_method() == "forkserver"
        npt.assert_array_equal(one["s"].values, two["s"].values)
        npt.assert_array_equal(one["sd"].values, two["sd"].values)
        npt.assert_array_equal(port.evaluate("h2"), np.hypot(arrays["x"], arrays["y"]))
    finally:
        port_mp.close_pool()
    assert port_mp._pool is None


def test_udfs_survive_the_state_and_a_pickle(frames):
    import pickle
    _, port = _both(frames, lambda df: df.__setitem__("u", df.apply(scaled, ["x", "k"])))
    fresh = vaex_tpu_torch.from_arrays(**seeded_arrays(11, 4000, 12)).to_device("cpu")
    fresh.state_set(port.state_get())
    npt.assert_array_equal(fresh.evaluate("u"), port.evaluate("u"))
    back = pickle.loads(pickle.dumps(port))
    npt.assert_array_equal(back.evaluate("u"), port.evaluate("u"))
