"""The port's groupby over raw (uncategorized) keys against vaex_tpu on the
same arrays (the port on device="cpu"): the dense grouper of a narrow int
key, the set grouper of a wide-range int key and of float and masked keys,
``row_limit``, two raw keys on the cartesian grid, the combined grouper, and
all of them on a filtered frame.

Keys, counts and int sums are exact; float aggregates hold to 1e-6 relative
and 1e-7 absolute.  The grouper each key takes and the probe's route, which
the port chooses as on a GPU, are asserted too.
"""

import numpy as np
import numpy.testing as npt
import pytest

import vaex_tpu
import vaex_tpu_torch
from torch_port_helpers import assert_same_frame, key_arrays, same_frames
from vaex_tpu_torch import cache
from vaex_tpu_torch import groupby as port_groupby

N = 6_000


def _aggs(pkg):
    return {"s": pkg.agg.sum("x"), "c": "count", "si": pkg.agg.sum("iv"),
            "m_x": pkg.agg.mean("x"), "sd": pkg.agg.std("x"), "lo": pkg.agg.min("iv"),
            "hi": pkg.agg.max("x")}


@pytest.fixture(scope="module")
def frames():
    return same_frames(key_arrays(31, N), tile_rows=1_777)


def _last(df):
    return df.executor.trace_log[-1]


@pytest.mark.parametrize("ascending", [True, False])
@pytest.mark.parametrize("key,grouper,probe", [
    ("k", "GrouperDense", None), ("b", "GrouperDense", None), ("w", "Grouper", "b6"),
    ("f", "Grouper", "b6"), ("m", "Grouper", "b6"), ("fm", "Grouper", "b6")])
def test_groupby_one_raw_key(frames, key, grouper, probe, ascending):
    ref, port = frames
    want = ref.groupby(key, agg=_aggs(vaex_tpu), sort=True, ascending=ascending)
    gb = port.groupby(key, sort=True, ascending=ascending)
    assert type(gb.groupers[0]).__name__ == grouper
    got = gb.agg(_aggs(vaex_tpu_torch))
    assert _last(port)["probe"] == probe
    assert_same_frame(want, got)


def test_dense_grouper_drops_the_values_no_row_has():
    rng = np.random.default_rng(32)
    arrays = {"k": rng.choice([-7, 0, 3, 4, 900], 2_000), "x": rng.normal(0, 1, 2_000)}
    ref, port = same_frames(arrays)
    got = port.groupby("k", agg={"c": "count", "x": "sum"})
    assert got["k"].tolist() == [-7, 0, 3, 4, 900]
    assert_same_frame(ref.groupby("k", agg={"c": "count", "x": "sum"}, sort=True), got)
    # without a count among the aggregations too
    assert_same_frame(ref.groupby("k", agg={"x": "mean"}, sort=True),
                      port.groupby("k", agg={"x": "mean"}))


def test_dense_pre_pass_is_one_fused_pass_and_is_remembered(frames):
    _, port = frames
    port = port.copy()
    port.executor = type(port.executor)()
    port.dataset.remembered.clear()
    port.groupby(["k", "b"], agg="count")
    log = port.executor.trace_log
    assert len(log) == 2  # the pre-pass over both keys, then the aggregation
    assert port.executor.passes == 2
    port.groupby(["k", "b"], agg={"x": "sum"})
    assert port.executor.passes == 3  # the pre-pass is not run again
    # a filtered frame counts its rows in the same pre-pass
    filtered = port[port.iv < 0]
    gb = filtered.groupby("k")
    assert port.executor.passes == 4 and gb.df._filtered_length == len(filtered)
    assert port.executor.passes == 5  # len(filtered) above had to count again


@pytest.mark.parametrize("key,want", [
    ("w", "Grouper"),      # range past 2^22
    ("m", "Grouper"),      # missing values
    ("f", "Grouper"),      # not an integer
    ("k + 0", "GrouperDense")])
def test_make_grouper_picks_dense_only_where_it_is_valid(frames, key, want):
    _, port = frames
    assert type(port.groupby(key).groupers[0]).__name__ == want


def test_row_limit(frames):
    ref, port = frames
    with pytest.raises(vaex_tpu_torch.RowLimitException):
        port.groupby("w", agg="count", row_limit=10)
    with pytest.raises(vaex_tpu_torch.RowLimitException):
        port.groupby("k", agg="count", row_limit=10)  # no dense grouper under a limit
    got = port.groupby("k", agg={"c": "count"}, row_limit=1_000, sort=True)
    assert_same_frame(ref.groupby("k", agg={"c": "count"}, row_limit=1_000, sort=True), got)


@pytest.mark.parametrize("keys", [["k", "b"], ["k", "w"], ["w", "fm"], ["m", "f"]])
def test_groupby_two_raw_keys_cartesian(frames, keys):
    ref, port = frames
    aggs = lambda pkg: {"c": "count", "s": pkg.agg.sum("x"), "si": pkg.agg.sum("iv")}  # noqa: E731
    want = ref.groupby(keys, agg=aggs(vaex_tpu), sort=False)
    gb = port.groupby(keys, sort=False)
    assert gb.combined is None
    got = gb.agg(aggs(vaex_tpu_torch))
    assert_same_frame(want, got)


@pytest.mark.parametrize("keys", [["k", "b"], ["k", "w", "b"], ["cat", "w"], ["w", "fm"]])
def test_groupby_combined(frames, keys):
    ref, port = frames
    ref = ref.categorize("iv", min_value=-100, labels=list(range(-100, 100)))
    port = port.categorize("iv", min_value=-100, labels=list(range(-100, 100)))
    keys = ["iv" if k == "cat" else k for k in keys]
    aggs = lambda pkg: {"c": "count", "s": pkg.agg.sum("x"), "m_x": pkg.agg.mean("x")}  # noqa: E731
    want = ref.groupby(keys, agg=aggs(vaex_tpu), sort=True, assume_sparse=True)
    gb = port.groupby(keys, sort=True, assume_sparse=True)
    assert gb.combined is not None and len(gb.binners) == 1
    got = gb.agg(aggs(vaex_tpu_torch))
    assert _last(port)["probe"] == "b6"
    assert len(got) == gb.combined.N
    assert_same_frame(want, got)


def test_groupby_combines_past_a_million_combinations(monkeypatch):
    rng = np.random.default_rng(33)
    n = 3_000
    arrays = {"a": rng.integers(0, 1_500, n), "b": rng.integers(0, 1_200, n),
              "x": rng.normal(0, 1, n)}
    ref, port = same_frames(arrays)
    gb = port.groupby(["a", "b"], sort=True)
    assert gb.combined is not None  # 1500 * 1200 > 1e6
    assert_same_frame(ref.groupby(["a", "b"], agg={"c": "count", "x": "sum"}, sort=True),
                      gb.agg({"c": "count", "x": "sum"}))
    assert port.groupby(["a", "b"], assume_sparse=False).combined is None
    with pytest.raises(ValueError, match="overflows int64"):
        fake = [type("G", (), {"N": 2 ** 31})() for _ in range(2)]
        port_groupby.GrouperCombined(fake, port)


@pytest.mark.parametrize("keys,sparse", [("k", "auto"), ("w", "auto"), ("fm", "auto"),
                                         (["k", "w"], "auto"), (["k", "w"], True)])
def test_groupby_of_a_filtered_frame(frames, keys, sparse):
    ref, port = frames
    values = [0, 3 * 1_000_003, 11 * 1_000_003, 17]
    rf, pf = ref[ref.w.isin(values) & (ref.k > 10)], port[port.w.isin(values) & (port.k > 10)]
    aggs = lambda pkg: {"c": "count", "s": pkg.agg.sum("x"), "lo": pkg.agg.min("iv")}  # noqa: E731
    want = rf.groupby(keys, agg=aggs(vaex_tpu), sort=True, assume_sparse=sparse)
    got = pf.groupby(keys, agg=aggs(vaex_tpu_torch), sort=True, assume_sparse=sparse)
    assert _last(port)["probe"] == "b6"  # the filter's isin at the least
    assert 0 < len(got) <= len(port.groupby(keys, agg="count"))
    if keys != "fm":
        assert len(got) < len(port.groupby(keys, agg="count"))  # the filter took groups away
    assert_same_frame(want, got)


def test_rows_outside_a_grouper_set_drop():
    """A row whose key is not in the grouper's set probes to -1 and leaves
    the result; it does not fall into the first group."""
    port = vaex_tpu_torch.from_arrays(k=np.array([5.5, 7.5, 5.5, 9.5]),
                                      x=np.ones(4)).to_device("cpu")
    gb = port[port.k < 9].groupby("k")
    assert gb.groupers[0].set.keys.tolist() == [5.5, 7.5]
    gb.df._filter = None  # every row now reaches the binner, 9.5 among them
    out = gb.agg({"c": "count"})
    assert out["k"].tolist() == [5.5, 7.5] and out["c"].tolist() == [2, 1]


def test_groupby_a_wide_set_goes_past_the_kernel(frames, monkeypatch):
    """A set past the shared-memory kernel's range takes the kernel's second,
    two-level form (on the CPU, as every probe, its plain version).  The
    GroupBy is built without ``agg=``: with it, this wide int key would take
    the one-sort plan, which builds no set."""
    from vaex_tpu_torch.ops import probe
    monkeypatch.setattr(probe, "MAX_KEYS", 20)
    ref, port = frames
    got = port.groupby("w", sort=True).agg({"c": "count"})  # 50 keys > 20
    assert _last(port)["probe"] == "b6-wide"
    assert_same_frame(ref.groupby("w", agg={"c": "count"}, sort=True), got)
    npt.assert_array_equal(got["c"].tolist(),
                           np.unique(key_arrays(31, N)["w"], return_counts=True)[1])


def test_a_wide_raw_key_skips_the_dense_pre_pass(frames):
    """A sample of the column already spans more than the dense grouper
    takes, so the key goes to its set build without a min + max pass (the
    classic path: a GroupBy built without ``agg=``)."""
    _, port = frames
    port = port.copy()
    port.executor = type(port.executor)()
    port.dataset.remembered.clear()
    with cache.off():  # the set build itself, not an earlier test's cached set
        port.groupby("w").agg("count")
    assert [entry["tasks"] for entry in port.executor.trace_log] == [
        ["set-create"], ["aggregations"]]


@pytest.mark.parametrize("keys,combine", [("k", "auto"), (["k", "b"], False), (["b", "k"], True)])
def test_a_column_changed_in_place_is_measured_again(keys, combine):
    """The range remembered of a key is checked against the rows each
    aggregation bins: after the column changed in place, no row is lost."""
    rng = np.random.default_rng(34)
    k = rng.integers(0, 50, 4_000)
    arrays = {"k": k, "b": rng.integers(0, 3, 4_000), "x": rng.normal(0, 1, 4_000)}
    port = vaex_tpu_torch.from_arrays(**arrays).to_device("cpu")
    first = port.groupby(keys, agg={"c": "count"}, sort=True, assume_sparse=combine)
    assert sum(first["c"].tolist()) == 4_000
    column = port.dataset["k"]
    column[:100] = 77  # past the remembered [0, 49]
    column[100:200] = -5
    arrays["k"] = np.asarray(column).copy()
    ref, _ = same_frames(arrays)
    got = port.groupby(keys, agg={"c": "count", "x": "sum"}, sort=True, assume_sparse=combine)
    assert sum(got["c"].tolist()) == 4_000
    assert_same_frame(ref.groupby(keys, agg={"c": "count", "x": "sum"}, sort=True,
                                  assume_sparse=combine), got)
