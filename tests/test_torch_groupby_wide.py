"""The port's wide-grid path against vaex_tpu: categorical groupbys whose grid
is past kernel B1 (single keys at K = 1e4 .. 1e6, two keys on the cartesian
grid, ``count(binby=[a, b])``), on the same frames in both packages (the
port on device="cpu", where each kernel wrapper runs its plain version).

The port's plan picks the same kernel on the CPU as on a GPU, so the
strategy each pass records in ``trace_log`` is asserted too.  Counts and
int sums are exact; float sums hold to 1e-6 relative and 1e-7 absolute.
"""

import numpy as np
import numpy.testing as npt
import pytest

import vaex_tpu
import vaex_tpu_torch
from torch_port_helpers import assert_same_frame, same_frames, seeded_arrays


def _aggs(pkg):
    return {"s": pkg.agg.sum("x"), "c": "count", "m": pkg.agg.mean("x"),
            "si": pkg.agg.sum("iv"), "sy": pkg.agg.sum("y")}


def _strategies(df):
    """The kernel of the additive aggregators of each task of the last pass."""
    return [s["additive"] for s in df.executor.trace_log[-1]["strategies"]]


@pytest.mark.parametrize("K,n,sort_keys,strategy", [
    (10_000, 20_000, False, "b2"),
    (100_000, 30_000, False, "b3"),
    # pre-sorted keys: vaex_tpu's partition kernel overflows on them and
    # reruns on its sort path; the port's B3 takes them as they are
    (100_000, 30_000, True, "b3"),
    (1_000_000, 30_000, False, "b3"),
    (1_000_000, 30_000, True, "b3"),
])
def test_groupby_one_wide_key(K, n, sort_keys, strategy):
    arrays = seeded_arrays(K % 97 + n, n, k=K, nan_every=13)
    if sort_keys:
        arrays["k"] = np.sort(arrays["k"])
    ref, port = same_frames(arrays, "k", labels=list(range(K)))
    want = ref.groupby("k", agg=_aggs(vaex_tpu))
    got = port.groupby("k", agg=_aggs(vaex_tpu_torch))
    assert _strategies(port) == [strategy]
    assert len(got) == K  # one key keeps every category, empty ones included
    assert_same_frame(want, got)


def _two_keys(seed, n=20_000, k=100):
    arrays = seeded_arrays(seed, n, k=k)
    rng = np.random.default_rng(seed)
    arrays["k2"] = rng.integers(0, k, n).astype(np.int64)
    # a band of combinations no row has: the result drops them
    arrays["k2"][arrays["k"] < 10] = 7
    return arrays


def _categorized(arrays, k=100):
    ref, port = same_frames(arrays, "k", labels=list(range(k)))
    return (ref.categorize("k2", labels=list(range(k))),
            port.categorize("k2", labels=list(range(k))))


@pytest.mark.parametrize("sort", [True, False])
@pytest.mark.parametrize("with_count", [True, False])
def test_groupby_two_keys_cartesian(sort, with_count):
    ref, port = _categorized(_two_keys(11))
    aggs = lambda pkg: {**({"c": "count"} if with_count else {}),  # noqa: E731
                        "s": pkg.agg.sum("x"), "si": pkg.agg.sum("iv")}
    want = ref.groupby(["k", "k2"], agg=aggs(vaex_tpu), sort=sort)
    got = port.groupby(["k", "k2"], agg=aggs(vaex_tpu_torch), sort=sort)
    assert _strategies(port) == ["b2"]  # G = 103 * 103
    assert len(got) < 100 * 100  # the empty combinations are gone
    assert_same_frame(want, got)


def test_groupby_two_keys_sort_on_shuffled_labels():
    arrays = _two_keys(12, k=20)
    rng = np.random.default_rng(12)
    labels = list(rng.permutation(20) * 5)
    ref = vaex_tpu.from_arrays(**arrays).categorize("k", labels=labels)
    port = vaex_tpu_torch.from_arrays(**arrays).to_device("cpu").categorize("k", labels=labels)
    names = [f"g{v:02d}" for v in rng.permutation(20)]
    ref, port = ref.categorize("k2", labels=names), port.categorize("k2", labels=names)
    want = ref.groupby(["k2", "k"], agg={"c": "count", "x": "sum"}, sort=True)
    got = port.groupby(["k2", "k"], agg={"c": "count", "x": "sum"}, sort=True)
    assert_same_frame(want, got)


@pytest.mark.parametrize("ascending", [False, [True, False]])
def test_groupby_two_keys_sorts_each_key_its_way(ascending):
    """vaex_tpu sorts a cartesian result ascending whatever ``ascending``
    says (ROADMAP queue C); the port sorts each key its own way, as
    ``DataFrame.sort`` does."""
    _, port = _categorized(_two_keys(16))
    got = port.groupby(["k", "k2"], agg={"c": "count"}, sort=True, ascending=ascending)
    plain = port.groupby(["k", "k2"], agg={"c": "count"}, sort=False)
    want = plain.sort(["k", "k2"], ascending=ascending)
    for name in ("k", "k2", "c"):
        npt.assert_array_equal(got[name].tolist(), want[name].tolist())
    k, k2 = np.asarray(got["k"].tolist()), np.asarray(got["k2"].tolist())
    first_desc = ascending is False or ascending[0] is False
    assert (np.diff(k) <= 0).all() if first_desc else (np.diff(k) >= 0).all()
    inner = np.diff(k2)[np.diff(k) == 0]
    assert (inner < 0).all()  # k2 descends inside each k in both cases


def test_count_binby_two_categories():
    ref, port = _categorized(_two_keys(13))
    npt.assert_array_equal(port.count(binby=["k", "k2"]), ref.count(binby=["k", "k2"]))
    assert _strategies(port) == ["b2"]
    npt.assert_array_equal(port.count(binby=["k", "k2"], edges=True),
                           ref.count(binby=["k", "k2"], edges=True))
    npt.assert_allclose(port.sum("x", binby=["k", "k2"]), ref.sum("x", binby=["k", "k2"]),
                        rtol=1e-6, atol=1e-7)


def test_three_keys_past_the_cartesian_grid_raise_naming_a6():
    arrays = _two_keys(14, n=100)
    arrays["k3"] = arrays["k"] % 50
    df = vaex_tpu_torch.from_arrays(**arrays).to_device("cpu")
    for name, k in (("k", 100), ("k2", 100), ("k3", 101)):
        df = df.categorize(name, labels=list(range(k)))
    with pytest.raises(NotImplementedError, match="ROADMAP queue A6"):
        df.groupby(["k", "k2", "k3"], agg="count")


@pytest.mark.parametrize("ascending", [True, False, [True, False], [False, True]])
def test_sort_matches_vaex_tpu(ascending):
    rng = np.random.default_rng(15)
    arrays = {"a": rng.integers(-5, 5, 300), "b": rng.normal(0, 1, 300),
              "c": rng.integers(0, 3, 300).astype(np.int32)}
    ref, port = same_frames(arrays)
    by = ["a", "c"] if isinstance(ascending, list) else "a"
    assert_same_frame(ref.sort(by, ascending=ascending), port.sort(by, ascending=ascending))
