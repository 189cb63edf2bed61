"""The port's row operations against vaex_tpu on the same seeded arrays (the
port on device="cpu"): ``take`` (host ints, index tensors, masked rows),
``extract``, ``trim``, ``head``, ``tail``, ``concat`` (frames of differing
columns) and the take, slice and sort of filtered frames.  The rows, their
order, their missing values and their values must be vaex_tpu's exactly;
statistics over the lazy nodes must be vaex_tpu's too (ints exact, float
sums to 1e-12).  Then the port's own contract: a take of a take is one hop,
each node remembers for itself, a node's fingerprint follows its rows, and
``to_device`` keeps a masked column as two tensors.
"""

import numpy as np
import numpy.testing as npt
import pytest
import torch

import vaex_tpu
import vaex_tpu_torch
from torch_port_helpers import assert_same_rows, key_arrays, same_frames
from vaex_tpu_torch.column import ColumnConcatenated, ColumnIndexed, ColumnMasked

N = 3000
NAMES = ["k", "w", "f", "m", "fm", "b", "x", "iv"]


@pytest.fixture(scope="module")
def frames():
    return same_frames(key_arrays(31, N), tile_rows=700)


def _stats_match(ref, port):
    """Statistics over the frame's rows, through passes of several tiles."""
    for name in ("k", "m", "iv", "b"):
        assert port.sum(name) == ref.sum(name), name
        assert port.count(name) == ref.count(name), name
        assert port.min(name) == ref.min(name) and port.max(name) == ref.max(name), name
    npt.assert_allclose(port.sum("x"), ref.sum("x"), rtol=1e-12)
    npt.assert_array_equal(port.count(binby="b", limits=[0, 7], shape=7),
                           ref.count(binby="b", limits=[0, 7], shape=7))
    want = ref.groupby("k", agg={"n": "count"}, sort=True)
    got = port.groupby("k", agg={"n": "count"}, sort=True)
    assert got["k"].tolist() == want["k"].tolist() and got["n"].tolist() == want["n"].tolist()


INDICES = {
    "host": [5, 0, 2999, 17, 17, -1, -3000, 1234],
    "reversed": list(range(N - 1, -1, -7)),
    "empty": np.array([], dtype=np.int64),
}


@pytest.mark.parametrize("indices", list(INDICES))
def test_take_host_indices(frames, indices):
    ref, port = frames
    rows = INDICES[indices]
    assert_same_rows(ref.take(rows), port.take(rows), NAMES)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_take_index_tensor(frames, dtype):
    ref, port = frames
    rows = np.random.default_rng(1).integers(0, N, 5000)
    got = port.take(torch.as_tensor(rows, dtype=dtype))
    assert_same_rows(ref.take(rows), got, NAMES)
    _stats_match(ref.take(rows), got)
    with pytest.raises(IndexError):
        port.take(torch.tensor([0, N], dtype=dtype))
    with pytest.raises(IndexError):
        port.take([N])


def test_take_with_masked_rows(frames):
    """A take node whose mask marks rows that hold no value (a join's
    unmatched rows): every column is missing there, as in vaex_tpu's
    ``take(masked=True)``."""
    ref, port = frames
    rng = np.random.default_rng(2)
    rows = rng.integers(0, N, 2500)
    mask = rng.random(2500) < 0.2
    ref_ds = ref.dataset.take(np.ma.MaskedArray(rows, mask), masked=True)
    port_ds = port.dataset.take(torch.as_tensor(np.where(mask, 0, rows)), torch.as_tensor(mask))
    ref_t, port_t = ref._rebind_dataset(ref_ds), port._rebind_dataset(port_ds)
    assert_same_rows(ref_t, port_t, NAMES)
    _stats_match(ref_t, port_t)


def test_extract_and_trim(frames):
    ref, port = frames
    rf, pf = ref[ref.x > 0], port[port.x > 0]
    got, want = pf.extract(), rf.extract()
    assert not got.filtered and len(got) == len(want) == len(pf)
    assert isinstance(got.dataset["k"], ColumnIndexed)
    assert got.dataset["k"].index.dtype == torch.int32
    assert_same_rows(want, got, NAMES)
    _stats_match(want, got)
    assert port.extract().dataset is port.dataset  # nothing to extract: the same node
    assert_same_rows(ref[100:400].trim(), port[100:400].trim(), NAMES)
    assert port.trim(inplace=True) is port


@pytest.mark.parametrize("filtered", [False, True])
def test_head_and_tail(frames, filtered):
    ref, port = frames
    if filtered:
        ref, port = ref[ref.k > 10], port[port.k > 10]
    for n in (0, 5, 10, 10_000):
        assert_same_rows(ref.head(n), port.head(n), NAMES)
        assert_same_rows(ref.tail(n), port.tail(n), NAMES)
    assert len(port.head()) == 10


@pytest.mark.parametrize("how", ["take", "slice", "sort", "sort-desc", "sort-two"])
def test_rows_of_a_filtered_frame(frames, how):
    ref, port = frames
    run = {"take": lambda df: df.take([0, 3, 3, -1, 200]),
           "slice": lambda df: df[20:700],
           "sort": lambda df: df.sort("iv"),
           "sort-desc": lambda df: df.sort("f", ascending=False),
           "sort-two": lambda df: df.sort(["b", "k"], ascending=[True, False])}[how]
    want, got = run(ref[ref.k < 30]), run(port[port.k < 30])
    assert not got.filtered
    assert_same_rows(want, got, NAMES)
    _stats_match(want, got)


def test_concat_keeps_the_common_columns():
    arrays = key_arrays(32, 1000)
    other = {name: col[:700] for name, col in key_arrays(33, 700).items() if name != "w"}
    other["extra"] = np.arange(700)
    (ref_a, port_a), (ref_b, port_b) = same_frames(arrays, tile_rows=300), same_frames(
        other, tile_rows=300)
    want, got = ref_a.concat(ref_b), port_a.concat(port_b)
    assert "w" not in got.get_column_names() and "extra" not in got.get_column_names()
    assert isinstance(got.dataset["k"], ColumnConcatenated)
    assert_same_rows(want, got)
    _stats_match(want, got)
    # three frames, one filtered, through the module-level concat
    want = vaex_tpu.concat([ref_b, ref_a[ref_a.k > 0], ref_b])
    got = vaex_tpu_torch.concat([port_b, port_a[port_a.k > 0], port_b])
    assert len(got.dataset["k"].columns) == 3  # a concat of a concat is flat
    assert_same_rows(want, got)
    _stats_match(want, got)
    assert vaex_tpu_torch.concat([port_a]) is port_a
    # rows of a concat: slices, takes and a sort across the parts
    for run in (lambda df: df[650:1200], lambda df: df.take([0, 1999, 1000, 999]),
                lambda df: df.sort("iv")):
        assert_same_rows(run(want), run(got))


def test_a_take_of_a_take_is_one_hop(frames):
    ref, port = frames
    once = port.take(list(range(100, 2000)))
    twice = once.take([5, 1, 1800])
    col = twice.dataset["x"]
    assert isinstance(col, ColumnIndexed) and col.source is port.dataset["x"]
    assert col.index.tolist() == [105, 101, 1900]
    assert_same_rows(ref.take(list(range(100, 2000))).take([5, 1, 1800]), twice, NAMES)


def test_each_node_remembers_for_itself(frames):
    """The dense pre-pass is remembered per node: a take of other rows
    measures its keys again, and its groupby matches vaex_tpu's."""
    ref, port = frames
    port = port.copy()
    port.groupby("k", agg={"n": "count"})
    assert port.dataset.remembered
    taken = port.take(list(range(0, N, 2)))
    assert not taken.dataset.remembered
    got = taken.groupby("k", agg={"n": "count"}, sort=True)
    want = ref.take(list(range(0, N, 2))).groupby("k", agg={"n": "count"}, sort=True)
    assert got["n"].tolist() == want["n"].tolist()
    assert taken.dataset.remembered is not port.dataset.remembered


def test_fingerprints_follow_the_rows(frames):
    _, port = frames
    a, b = port.take([1, 2, 3]), port.take([1, 2, 3])
    assert a.dataset.fingerprint() == b.dataset.fingerprint()
    assert port.take([1, 2, 4]).dataset.fingerprint() != a.dataset.fingerprint()
    assert port.take(torch.tensor([1, 2, 3])).dataset.fingerprint() == a.dataset.fingerprint()
    filtered = port[port.k > 3].extract().dataset.fingerprint()
    assert filtered == port[port.k > 3].extract().dataset.fingerprint()
    assert filtered != port[port.k > 4].extract().dataset.fingerprint()
    assert port.concat(port).dataset.fingerprint() != port.dataset.fingerprint()


def test_to_device_keeps_masked_and_lazy_columns_on_the_device(frames):
    ref, port = frames
    arrays = key_arrays(34, 500)
    staged = vaex_tpu_torch.from_arrays(**arrays).to_device("cpu")
    m = staged.dataset["m"]
    assert isinstance(m, ColumnMasked) and m.data.dtype == torch.int64
    npt.assert_array_equal(m.mask.numpy(), np.ma.getmaskarray(arrays["m"]))
    taken = port.take([3, 2, 1]).to_device("cpu")
    assert isinstance(taken.dataset["fm"], ColumnIndexed)
    assert_same_rows(ref.take([3, 2, 1]), taken, NAMES)
