"""The port's join against vaex_tpu on the same seeded arrays (the port on
device="cpu", where B6's wrapper takes its plain version).

The nine cases of tests/test_join.py, then seeded joins of every ``how``
with gapped, doubled, NaN and masked keys over several tiles: the joined
rows, their order, their missing values and their values must equal
vaex_tpu's exactly, the duplicates in the reference's order.  Then joins of
joins and the statistics on a joined column that BASELINE config 4 runs
(sum, groupby, ``value_counts``, ``isin``).  Where vaex_tpu answers and the
port cannot yet, the test pins the raise and its ROADMAP queue.
"""

import numpy as np
import numpy.testing as npt
import pytest
import torch

import vaex_tpu
import vaex_tpu_torch
from torch_port_helpers import assert_same_rows, same_frame_pair, same_frames
from vaex_tpu_torch.column import ColumnIndexed


@pytest.fixture
def pair():
    return same_frame_pair(
        {"key": np.array([0, 1, 2, 3, 4], dtype="i8"), "x": np.arange(5, dtype="f8")},
        {"key": np.array([2, 3, 4, 5], dtype="i8"), "y": np.array([20.0, 30.0, 40.0, 50.0])})


def _both(pair, **kwargs):
    (ref_left, ref_right), (port_left, port_right) = pair
    return ref_left.join(ref_right, **kwargs), port_left.join(port_right, **kwargs)


# ------------------------------------------------- the cases of test_join.py
@pytest.mark.parametrize("how", ["left", "inner", "right"])
def test_join_how(pair, how):
    ref, port = _both(pair, on="key", how=how)
    assert_same_rows(ref, port)


def test_join_different_keys(pair):
    (ref_left, _), (port_left, _) = pair
    right = {"k2": np.array([2, 3, 4, 5], dtype="i8"), "y": np.array([20.0, 30.0, 40.0, 50.0])}
    ref_right, port_right = same_frames(right)
    assert_same_rows(ref_left.join(ref_right, left_on="key", right_on="k2"),
                     port_left.join(port_right, left_on="key", right_on="k2"))


def test_join_duplicates(pair):
    (ref_left, _), (port_left, _) = pair
    right = {"key": np.array([2, 2, 3], dtype="i8"), "y": np.array([20.0, 21.0, 30.0])}
    ref_right, port_right = same_frames(right)
    for left, rt in ((ref_left, ref_right), (port_left, port_right)):
        with pytest.raises(ValueError, match="allow_duplication"):
            left.join(rt, on="key")
    ref = ref_left.join(ref_right, on="key", allow_duplication=True)
    port = port_left.join(port_right, on="key", allow_duplication=True)
    assert len(port) == 6
    assert_same_rows(ref, port)


def test_join_suffix(pair):
    (ref_left, _), (port_left, _) = pair
    right = {"key": np.array([2, 3, 4, 5], dtype="i8"), "x": np.array([20.0, 30.0, 40.0, 50.0])}
    ref_right, port_right = same_frames(right)
    for left, rt in ((ref_left, ref_right), (port_left, port_right)):
        with pytest.raises(NameError, match="exists in both"):
            left.join(rt, on="key")
    ref = ref_left.join(ref_right, on="key", rsuffix="_r")
    port = port_left.join(port_right, on="key", rsuffix="_r")
    assert "x_r" in port.get_column_names()
    assert_same_rows(ref, port)
    assert_same_rows(ref_left.join(ref_right, on="key", rprefix="r_", lsuffix="_l"),
                     port_left.join(port_right, on="key", rprefix="r_", lsuffix="_l"))


def test_join_string_key_waits_for_the_host_scope():
    """A join on a string key, which waited for the host scope (ROADMAP A9),
    now gives vaex_tpu's rows, staged or not."""
    left = {"k": np.asarray(["a", "b", "c"], dtype=object), "x": np.arange(3.0)}
    right = {"k": np.asarray(["b", "c", "d"], dtype=object), "y": np.arange(3.0) * 10}
    ref = vaex_tpu.from_arrays(**left).join(vaex_tpu.from_arrays(**right), on="k")
    assert ref["y"].tolist() == [None, 0.0, 10.0]
    port_left = vaex_tpu_torch.from_arrays(**left).to_device("cpu")
    port_right = vaex_tpu_torch.from_arrays(**right).to_device("cpu")
    port = port_left.join(port_right, on="k")
    assert port["y"].tolist() == ref["y"].tolist()
    assert port["k"].tolist() == ref["k"].tolist()


def test_join_virtual_columns_carried(pair):
    (ref_left, ref_right), (port_left, port_right) = pair
    ref_right, port_right = ref_right.copy(), port_right.copy()
    ref_right["y2"] = ref_right["y"] * 2
    port_right["y2"] = port_right["y"] * 2
    ref, port = ref_left.join(ref_right, on="key"), port_left.join(port_right, on="key")
    assert port.virtual_columns["y2"] == ref.virtual_columns["y2"]
    assert_same_rows(ref, port)


def test_join_filtered(pair):
    (ref_left, ref_right), (port_left, port_right) = pair
    ref = ref_left.filter("key > 0").join(ref_right, on="key")
    port = port_left.filter("key > 0").join(port_right, on="key")
    assert len(port) == 4 and not port.filtered
    assert_same_rows(ref, port)
    # a filtered right frame too
    assert_same_rows(ref_left.join(ref_right[ref_right.y < 45], on="key", how="inner"),
                     port_left.join(port_right[port_right.y < 45], on="key", how="inner"))


def test_join_over_a_mesh_waits_for_multi_device(pair):
    (_, _), (port_left, port_right) = pair
    with pytest.raises(NotImplementedError, match="ROADMAP queue A12"):
        port_left.join(port_right, on="key", mesh=object())


# --------------------------------------------------------- seeded joins
def _tables(seed, n_left, n_right, kind):
    """A left table of keys drawn from a range that the right table covers
    with gaps (every third key missing) and doubles (every fifth twice or
    three times); ``kind``: "int" int64 keys, "int32" left int32 against
    int64, "float" float64 keys with NaN and -0.0 on both sides, "masked"
    masked int keys on both sides."""
    rng = np.random.default_rng(seed)
    span = n_right
    right_keys = np.array([k for k in range(span) if k % 3] * 1
                          + [k for k in range(span) if k % 5 == 0 and k % 3]
                          + [k for k in range(span) if k % 15 == 1], dtype=np.int64)
    right_keys = right_keys[rng.permutation(len(right_keys))]
    left_keys = rng.integers(-2, span + 2, n_left).astype(np.int64)
    left = {"key": left_keys, "x": rng.normal(0, 1, n_left), "i": np.arange(n_left)}
    right = {"key": right_keys, "y": rng.normal(0, 1, len(right_keys)),
             "j": rng.integers(-50, 50, len(right_keys)).astype(np.int32),
             "r": np.arange(len(right_keys))}
    if kind == "int32":
        left["key"] = left_keys.astype(np.int32)
    elif kind == "float":
        for table in (left, right):
            key = table["key"].astype(np.float64) / 2
            key[::17] = np.nan
            key[key == 0] = -0.0
            table["key"] = key
    elif kind == "masked":
        left["key"] = np.ma.MaskedArray(left_keys, rng.random(n_left) < 0.1)
        right["key"] = np.ma.MaskedArray(right_keys, rng.random(len(right_keys)) < 0.1)
    return left, right


@pytest.mark.parametrize("kind", ["int", "int32", "float", "masked"])
@pytest.mark.parametrize("how", ["left", "inner", "right"])
def test_seeded_join_matches_vaex_tpu_exactly(kind, how):
    left, right = _tables(11, 3000, 700, kind)
    (ref_left, ref_right), (port_left, port_right) = same_frame_pair(left, right, tile_rows=512)
    ref = ref_left.join(ref_right, on="key", how=how, allow_duplication=True, rsuffix="_r")
    port = port_left.join(port_right, on="key", how=how, allow_duplication=True, rsuffix="_r")
    # i and r number the left and right rows: the order of the duplicates too
    assert_same_rows(ref, port)
    if how == "left":  # the extra rows after the left ones, left rows ascending
        extra = port.evaluate("i")[len(left["x"]):]
        assert len(extra) and (np.diff(extra) >= 0).all()


def test_unique_right_keys_need_no_duplication():
    """A dim table of unique keys (config 4's shape, cut down): no extra rows,
    an int32 lookup and every left row matched."""
    rng = np.random.default_rng(4)
    left = {"key": rng.integers(0, 1000, 20_000).astype(np.int64), "x": rng.random(20_000)}
    right = {"key": np.arange(1000, dtype=np.int64),
             "label": rng.integers(0, 100, 1000).astype(np.int64)}
    (ref_left, ref_right), (port_left, port_right) = same_frame_pair(left, right, tile_rows=4096)
    ref, port = ref_left.join(ref_right, on="key"), port_left.join(port_right, on="key")
    label = port.dataset["label"]
    assert isinstance(label, ColumnIndexed) and label.mask is None
    assert label.index.dtype == torch.int32 and label.source is port_right.dataset["label"]
    assert port.executor.trace_log[-1]["probe"] == "b6"
    assert_same_rows(ref, port)
    assert port.sum("label") == ref.sum("label")
    npt.assert_allclose(port.sum("x"), ref.sum("x"), rtol=1e-12)


def test_joins_of_joins():
    left, right = _tables(12, 2000, 300, "int")
    (ref_left, ref_right), (port_left, port_right) = same_frame_pair(left, right, tile_rows=700)
    third = {"j": np.arange(-50, 50, 2, dtype=np.int32), "z": np.arange(50) * 1.5}
    ref_third, port_third = same_frames(third)
    ref = ref_left.join(ref_right, on="key", allow_duplication=True).join(
        ref_third, on="j", how="inner")
    port = port_left.join(port_right, on="key", allow_duplication=True).join(
        port_third, on="j", how="inner")
    assert_same_rows(ref, port)
    # the joined frame as the right side, filtered and sliced first
    ref2 = ref_third.join(ref[ref.x > 0][10:400], on="j", how="left", allow_duplication=True,
                          rsuffix="_r")
    port2 = port_third.join(port[port.x > 0][10:400], on="j", how="left",
                            allow_duplication=True, rsuffix="_r")
    assert_same_rows(ref2, port2)
    # one hop: a take of the joined right columns reads the source directly
    z = port.take([5, 3, 1]).dataset["z"]
    assert isinstance(z, ColumnIndexed) and z.source is port_third.dataset["z"]


def test_statistics_on_a_joined_column():
    """What BASELINE config 4 asks of the joined frame: sum, groupby of the
    dim's label with a sum and a count, value_counts, an isin count."""
    left, right = _tables(13, 5000, 400, "masked")
    right["label"] = (np.arange(len(right["y"])) % 7).astype(np.int64)
    (ref_left, ref_right), (port_left, port_right) = same_frame_pair(left, right, tile_rows=999)
    ref = ref_left.join(ref_right, on="key", allow_duplication=True, rsuffix="_r")
    port = port_left.join(port_right, on="key", allow_duplication=True, rsuffix="_r")
    assert port.sum("label") == ref.sum("label")
    assert port.count("label") == ref.count("label")
    want = ref.groupby("label", agg={"x": "sum", "n": "count"}, sort=True)
    got = port.groupby("label", agg={"x": "sum", "n": "count"}, sort=True)
    assert got["label"].tolist() == want["label"].tolist()
    assert got["n"].tolist() == want["n"].tolist()
    npt.assert_allclose(got["x"].tolist(), want["x"].tolist(), rtol=1e-12, atol=1e-12)
    got_vc, want_vc = port["label"].value_counts(), ref["label"].value_counts()
    assert got_vc.to_dict() == want_vc.to_dict()
    ids = [0, 3, 5, 700, -1]
    assert port.count(selection=port.key.isin(ids)) == ref.count(selection=ref.key.isin(ids))
    assert port.count(selection=port.label.isin([1, 2])) == ref.count(
        selection=ref.label.isin([1, 2]))


@pytest.mark.parametrize("kind", ["dense", "gapped", "duplicated", "float", "masked"])
def test_sorted_index_matches_vaex_tpu(kind):
    """``SortedIndex.map_index`` and ``map_index_duplicates`` against
    vaex_tpu's ``SortedIndex`` on the same keys: the first right row of each
    left value (-1 for none, NaN or masked) and the further matches, in the
    reference's order."""
    from vaex_tpu.ops.setops import SortedIndex as RefIndex
    from vaex_tpu_torch.ops.nullable import NA
    from vaex_tpu_torch.ops.setops import SortedIndex
    rng = np.random.default_rng(len(kind))
    keys = {"dense": rng.permutation(5000), "gapped": rng.permutation(7500)[:5000] * 3,
            "duplicated": rng.integers(0, 1200, 5000),
            "float": rng.integers(-3000, 3000, 5000) / 2.0,
            "masked": rng.integers(0, 4000, 5000)}[kind]
    mask = rng.random(5000) < 0.05 if kind == "masked" else None
    values = rng.integers(-10, 8000, 20_000)
    values = values / 2.0 if kind == "float" else values
    values_mask = rng.random(20_000) < 0.03 if kind == "masked" else None
    if kind == "float":
        keys[::97] = np.nan
        values[::89] = np.nan
    ref = RefIndex(keys, mask)
    port = SortedIndex(torch.as_tensor(keys), None if mask is None else torch.as_tensor(mask))
    x = NA(torch.as_tensor(values), None if values_mask is None else torch.as_tensor(values_mask))
    assert port.has_duplicates == ref.has_duplicates
    npt.assert_array_equal(port.map_index(x).numpy(), ref.map_index(values, mask=values_mask))
    for got, want in zip(port.map_index_duplicates(x, 11),
                         ref.map_index_duplicates(values, 11, mask=values_mask)):
        npt.assert_array_equal(got.numpy(), want)
