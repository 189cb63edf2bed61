"""Per-cell top-k, the port against vaex_tpu on the same seeded arrays:
``max_n``, ``min_n``, ``nth_largest`` and ``nth_smallest`` on float (with
NaN), masked, int and datetime columns, per group and per cell of
``binby``, over several tiles, with groups that hold fewer than k values
and ``selection=``.

Values are exact.  A slot no value fills holds NaN in a float column; an
int column keeps the identity the reference's ``get_result`` leaves there
(the int type's min for ``max_n``, its max for ``min_n``): the tests pin
it (ROADMAP, "Known problems of the reference itself").
"""

import numpy as np
import numpy.testing as npt
import pytest

import vaex_tpu
import vaex_tpu_torch
from torch_port_helpers import assert_same_frame, same_frames


def _arrays(seed, n=5000, k=40):
    """A key k in 0..k-1 whose last keys hold one or two rows, v float with
    NaN, vm masked, i int64, u for continuous bins."""
    rng = np.random.default_rng(seed)
    key = rng.integers(0, k - 3, n)
    key[:5] = [k - 3, k - 2, k - 2, k - 1, k - 1]
    v = rng.normal(0, 10, n)
    v[::11] = np.nan
    v[3] = np.nan  # one of the two rows of the last key
    return {"k": key, "v": v, "vm": np.ma.MaskedArray(rng.normal(0, 1, n), rng.random(n) < 0.3),
            "i": rng.integers(-10 ** 12, 10 ** 12, n), "u": rng.uniform(0, 1, n)}


@pytest.fixture(scope="module")
def frames():
    return same_frames(_arrays(1), tile_rows=1200)


def _columns(df, names):
    return {name: np.asarray(df.evaluate(name)) for name in names}


@pytest.mark.parametrize("column", ["v", "vm", "i"])
@pytest.mark.parametrize("largest", [True, False])
def test_max_n_and_min_n_per_group(frames, column, largest):
    ref, port = frames
    name = "max_n" if largest else "min_n"
    want = ref.groupby("k", agg={"t": getattr(vaex_tpu.agg, name)(column, 3)}, sort=True)
    got = port.groupby("k", agg={"t": getattr(vaex_tpu_torch.agg, name)(column, 3)}, sort=True)
    g, w = np.asarray(got.evaluate("t")), np.asarray(want.evaluate("t"))
    assert g.shape == w.shape == (40, 3) and g.dtype == w.dtype
    npt.assert_array_equal(g, w)
    npt.assert_array_equal(np.asarray(got.evaluate("k")), np.asarray(want.evaluate("k")))
    if column == "i":  # the reference's identity fills an int column's empty slots
        fill = np.iinfo(np.int64).min if largest else np.iinfo(np.int64).max
        assert (g[-3, 1:] == fill).all()
    else:
        assert np.isnan(g[-3, 1:]).all()
    assert port.executor.trace_log[-1]["strategies"][0]["topk"] == "sort"


@pytest.mark.parametrize("n", [0, 1, 4])
def test_nth_largest_and_nth_smallest(frames, n):
    ref, port = frames

    def aggs(pkg):
        a = pkg.agg
        return {"l": a.nth_largest("v", n), "s": a.nth_smallest("i", n),
                "m": a.nth_largest("vm", n)}
    want = ref.groupby("k", agg=aggs(vaex_tpu), sort=True)
    got = port.groupby("k", agg=aggs(vaex_tpu_torch), sort=True)
    assert_same_frame(want, got)
    assert got.get_column_names() == want.get_column_names()


def test_the_names_of_the_top_k_columns(frames):
    ref, port = frames
    specs = lambda a: [a.nth_largest("v", 1), a.max_n("v", 2), a.min_n("i", 2)]  # noqa: E731
    want = ref.groupby("k", agg={"v": specs(vaex_tpu.agg)})
    got = port.groupby("k", agg={"v": specs(vaex_tpu_torch.agg)})
    assert got.get_column_names() == want.get_column_names()


def test_top_k_with_a_selection_and_on_a_raw_key(frames):
    """A selection per aggregator; a raw key (the dense grouper, its empty
    values dropped)."""
    ref, port = frames
    want = ref.groupby("k", agg={"a": vaex_tpu.agg.nth_largest("v", 0, selection="u > 0.5"),
                                 "b": vaex_tpu.agg.nth_smallest("i", 1, selection="v > 0")},
                       sort=True)
    got = port.groupby("k", agg={"a": vaex_tpu_torch.agg.nth_largest("v", 0, selection="u > 0.5"),
                                 "b": vaex_tpu_torch.agg.nth_smallest("i", 1, selection="v > 0")},
                       sort=True)
    assert_same_frame(want, got)


@pytest.mark.parametrize("largest", [True, False])
def test_top_k_per_cell_of_binby(frames, largest):
    ref, port = frames
    name = "max_n" if largest else "min_n"
    args = dict(by=["u"], limits=[0, 1], shape=7)
    want = ref.binby(agg={"t": getattr(vaex_tpu.agg, name)("v", 2, selection="i > 0")}, **args)
    got = port.binby(agg={"t": getattr(vaex_tpu_torch.agg, name)("v", 2, selection="i > 0")},
                     **args)
    npt.assert_array_equal(np.asarray(got), np.asarray(want))
    assert np.asarray(got).shape == (7, 2)


def test_top_k_of_a_datetime_skips_nat():
    rng = np.random.default_rng(3)
    n = 2000
    d = (np.datetime64("2020-01-01") + rng.integers(0, 10 ** 6, n).astype("m8[s]"))
    d[::7] = np.datetime64("NaT")
    ref, port = same_frames({"k": rng.integers(0, 9, n), "d": d})
    want = ref.groupby("k", agg={"a": vaex_tpu.agg.nth_largest("d", 1),
                                 "b": vaex_tpu.agg.nth_smallest("d", 0)}, sort=True)
    got = port.groupby("k", agg={"a": vaex_tpu_torch.agg.nth_largest("d", 1),
                                 "b": vaex_tpu_torch.agg.nth_smallest("d", 0)}, sort=True)
    for name in ("a", "b"):
        g, w = np.asarray(got.evaluate(name)), np.asarray(want.evaluate(name))
        assert g.dtype == w.dtype == d.dtype
        npt.assert_array_equal(g, w)
