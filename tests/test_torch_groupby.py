"""The port's main path against vaex_tpu: a categorical single-key groupby
with sum and count (the bench.py workload), and the no-binby sum / count /
mean, on the same frame in both packages (the port on device="cpu").

Counts and int sums are exact; float sums hold to 1e-6 relative and 1e-7
absolute, the contract of the reference against pandas.
"""

import subprocess
import sys

import numpy as np
import numpy.testing as npt
import pytest
import torch

import vaex_tpu
import vaex_tpu_torch
from vaex_tpu_torch import settings
from vaex_tpu_torch.column import ColumnMasked
from torch_port_helpers import assert_same_frame, same_frames, seeded_arrays

K = 100

CASES = {
    # several tiles and a short last tile
    "tiles": dict(n=10_000, tile_rows=999),
    # keys outside [0, K) land in the edge bins and leave the result
    "out_of_range_keys": dict(n=5_000, key_low=-5, key_high=K + 7),
    "nan_in_x": dict(n=5_000, nan_every=7),
    "one_tile": dict(n=3_000),
}


def _aggs(pkg):
    return {"s": pkg.agg.sum("x"), "c": "count", "si": pkg.agg.sum("iv"),
            "sy": pkg.agg.sum("y"), "m": pkg.agg.mean("x")}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("sort", [True, False])
def test_groupby_main_path(case, sort):
    spec = dict(CASES[case])
    tile_rows = spec.pop("tile_rows", None)
    arrays = seeded_arrays(len(case), k=K, **spec)
    ref, port = same_frames(arrays, "k", labels=list(range(K)), tile_rows=tile_rows)
    want = ref.groupby("k", agg=_aggs(vaex_tpu), sort=sort)
    got = port.groupby("k", agg=_aggs(vaex_tpu_torch), sort=sort)
    assert_same_frame(want, got)


@pytest.mark.parametrize("labels", ["shuffled_ints", "strings"])
@pytest.mark.parametrize("ascending", [True, False])
def test_groupby_sort_on_shuffled_labels(labels, ascending):
    arrays = seeded_arrays(3, 4_000, k=20)
    rng = np.random.default_rng(4)
    names = (list(rng.permutation(20) * 3) if labels == "shuffled_ints"
             else [f"g{v:02d}" for v in rng.permutation(20)])
    ref, port = same_frames(arrays, "k", labels=names)
    aggs = {"c": "count", "x": "sum"}  # vaex's {column: aggregator} form for x
    want = ref.groupby("k", agg=aggs, sort=True, ascending=ascending)
    got = port.groupby("k", agg=aggs, sort=True, ascending=ascending)
    assert_same_frame(want, got)


def test_groupby_masked_values():
    arrays = seeded_arrays(5, 3_000, k=K)
    rng = np.random.default_rng(5)
    arrays["x"] = np.ma.MaskedArray(arrays["x"], rng.random(3_000) < 0.1)
    ref, port = same_frames(arrays, "k", labels=list(range(K)))
    aggs = lambda pkg: {"s": pkg.agg.sum("x"), "cx": pkg.agg.count("x"), "c": "count"}  # noqa: E731
    assert_same_frame(ref.groupby("k", agg=aggs(vaex_tpu), sort=True),
                      port.groupby("k", agg=aggs(vaex_tpu_torch), sort=True))


@pytest.mark.parametrize("stat", ["sum_x", "sum_iv", "sum_y", "count", "count_x",
                                  "mean_x", "sum_expr"])
@pytest.mark.parametrize("tile_rows", [None, 777])
def test_no_binby_stats(stat, tile_rows):
    arrays = seeded_arrays(6, 5_000, k=K, nan_every=13)
    ref, port = same_frames(arrays, tile_rows=tile_rows)
    calls = {
        "sum_x": lambda df: df.sum("x"),
        "sum_iv": lambda df: df.sum("iv"),
        "sum_y": lambda df: df.sum("y"),
        "count": lambda df: df.count(),
        "count_x": lambda df: df.count("x"),
        "mean_x": lambda df: df.mean("x"),
        "sum_expr": lambda df: df.sum("x * 2 + iv / 3"),
    }
    want, got = calls[stat](ref), calls[stat](port)
    if stat in ("sum_iv", "count", "count_x"):
        assert int(got) == int(want)
    else:
        npt.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-7)


def test_count_binby_category_matches():
    arrays = seeded_arrays(7, 4_000, k=K, key_low=-2, key_high=K + 2)
    ref, port = same_frames(arrays, "k", labels=list(range(K)))
    npt.assert_array_equal(port.count(binby="k"), ref.count(binby="k"))
    npt.assert_array_equal(port.count(binby="k", edges=True), ref.count(binby="k", edges=True))


def test_wide_int64_keys_land_in_the_edge_bins():
    """Keys beyond the int32 range are compared in int64: they are under- or
    overflow, never a data bin (vaex_tpu's int32 cast would wrap 2^32 + 5
    into bin 5; ROADMAP queue C)."""
    keys = np.array([2 ** 32 + 5, 5, -(2 ** 32) + 3, 3, 2 ** 40, -1], dtype=np.int64)
    df = vaex_tpu_torch.from_arrays(k=keys, x=np.ones(6)).to_device("cpu")
    df = df.categorize("k", labels=list(range(10)))
    out = df.groupby("k", agg={"c": "count"})
    want = np.zeros(10, np.int64)
    want[[5, 3]] = 1
    npt.assert_array_equal(out["c"].tolist(), want)
    npt.assert_array_equal(df.count(binby="k", edges=True),
                           [0, 2, 0, 0, 0, 1, 0, 1, 0, 0, 0, 0, 2])


def test_to_device_cpu_stages_tensors():
    arrays = seeded_arrays(8, 100, k=K)
    arrays["m"] = np.ma.MaskedArray(np.arange(100.0), np.arange(100) % 3 == 0)
    df = vaex_tpu_torch.from_arrays(**arrays).to_device("cpu")
    for name in ("k", "x", "iv", "y"):
        col = df.dataset[name]
        assert isinstance(col, torch.Tensor) and col.device.type == "cpu"
        npt.assert_array_equal(col.numpy(), arrays[name])
    # a masked column as its data and its mask, two tensors on the device
    m = df.dataset["m"]
    assert isinstance(m, ColumnMasked) and m.device.type == "cpu"
    npt.assert_array_equal(m.data.numpy(), arrays["m"].data)
    npt.assert_array_equal(m.mask.numpy(), np.ma.getmaskarray(arrays["m"]))
    assert len(df[10:25]) == 15
    npt.assert_array_equal(df[10:25]["iv"].tolist(), arrays["iv"][10:25])
    assert df.dataset.fingerprint() == vaex_tpu_torch.from_arrays(
        **arrays).to_device("cpu").dataset.fingerprint()


def test_host_frame_runs_on_the_settings_device(monkeypatch):
    """A frame of host arrays that no one staged runs its passes on
    ``settings.DEVICE``: the CPU when asked for, else the card, and without
    one torch raises rather than the pass quietly running on the CPU."""
    arrays = seeded_arrays(9, 500, k=K)
    df = vaex_tpu_torch.from_arrays(**arrays)
    monkeypatch.setattr(settings, "DEVICE", "cpu")
    npt.assert_allclose(df.sum("x"), arrays["x"].sum(), rtol=1e-12)
    assert df.executor.trace_log[-1]["device"] == "cpu"
    monkeypatch.setattr(settings, "DEVICE", "cuda")
    if torch.cuda.is_available():
        npt.assert_allclose(df.sum("x"), arrays["x"].sum(), rtol=1e-9)
        assert df.executor.trace_log[-1]["device"].startswith("cuda")
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            df.sum("x")


def test_staged_and_derived_frames_keep_their_device(monkeypatch):
    """A frame staged with ``to_device("cpu")`` runs there whatever
    ``settings.DEVICE`` says, even a pass over its host-side masked column
    alone; a groupby's result frame keeps the device of the pass that made
    it, and so do its slices and sorts."""
    monkeypatch.setattr(settings, "DEVICE", "cuda")
    arrays = seeded_arrays(10, 600, k=K)
    m = np.ma.MaskedArray(np.arange(600.0), np.arange(600) % 4 == 0)
    df = vaex_tpu_torch.from_arrays(m=m).to_device("cpu")
    assert isinstance(df.dataset["m"], ColumnMasked)
    assert df.sum("m") == m.sum() and df.executor.trace_log[-1]["device"] == "cpu"
    port = vaex_tpu_torch.from_arrays(**arrays).to_device("cpu").categorize(
        "k", labels=list(range(K)))
    out = port.groupby("k", agg={"s": vaex_tpu_torch.agg.sum("x")}, sort=True)
    assert out.dataset.device == torch.device("cpu")
    npt.assert_allclose(out.sum("s"), arrays["x"].sum(), rtol=1e-9)
    assert out.executor.trace_log[-1]["device"] == "cpu"
    assert out[5:9].dataset.device == out.sort("s").dataset.device == torch.device("cpu")


@pytest.mark.parametrize("query", ["non_category_key", "two_keys", "min", "first",
                                   "uint_sum", "selection"])
def test_outside_the_slice_raises_not_implemented(query):
    """What is still outside the port raises naming its ROADMAP item; what
    has been ported since (a raw key, a raw key beside a category, a
    selection, first, the sum of a uint32 column and of a uint64 one) gives
    vaex_tpu's result, and min of a bool column numpy's (vaex_tpu raises on
    the identity of a bool)."""
    arrays = seeded_arrays(9, 100, k=K)
    arrays["u"] = np.arange(100, dtype=np.uint32)
    arrays["u8"] = np.arange(100, dtype=np.uint64)
    arrays["b"] = arrays["iv"] > 0
    ref, port = same_frames(arrays, "k", labels=list(range(K)))
    ported = {
        "non_category_key": lambda df: df.groupby("iv", agg="count", sort=True),
        "two_keys": lambda df: df.groupby(["k", "iv"], agg="count", sort=True),
        "selection": lambda df: df.sum("x", selection="x > 0"),
        "first": lambda df: df.groupby("k", agg={"x": "first"}),
    }
    pending = {}
    if query == "uint_sum":
        assert_same_frame(ref.groupby("k", agg={"s": vaex_tpu.agg.sum("u")}),
                          port.groupby("k", agg={"s": vaex_tpu_torch.agg.sum("u")}))
        want = ref.groupby("k", agg={"s": vaex_tpu.agg.sum("u8")})
        got = port.groupby("k", agg={"s": vaex_tpu_torch.agg.sum("u8")})
        assert_same_frame(want, got)
        assert got.evaluate("s").dtype == np.uint64
    if query == "min":  # of a bool column
        out = port.groupby("k", agg={"b": "min"})
        want = [bool(arrays["b"][arrays["k"] == g].min()) if (arrays["k"] == g).any() else True
                for g in range(K)]
        assert out["b"].tolist() == want and out.evaluate("b").dtype == np.bool_
        with pytest.raises(ValueError, match="Invalid integer data type"):
            ref.groupby("k", agg={"b": "min"})
    elif query == "selection":
        npt.assert_allclose(float(ported[query](port)), float(ported[query](ref)),
                            rtol=1e-6, atol=1e-7)
    elif query in ported:
        assert_same_frame(ported[query](ref), ported[query](port))
    elif query in pending:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            pending[query]()


def test_port_imports_neither_jax_nor_vaex_tpu():
    code = ("import sys, vaex_tpu_torch; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'vaex_tpu')); "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
