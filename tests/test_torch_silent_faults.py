"""The port's silent wrong answers C17-C19 of ROADMAP queue C and the last
public names of vaex_tpu (A15), each held to numpy or Python on seeded
arrays (C20, OneHotEncoder on a missing row, is in test_torch_ml.py):

* C17: a write that bumps no version counter (``k.numpy()[3] = ...``,
  ``k.data[3] = ...``, a write to the numpy array ``k`` was made from) is
  seen by the next ``unique``, ``value_counts``, ``unique`` of an ``isin``
  filter and one-sort groupby: a CPU tensor is keyed by its bytes;
* C18: the mean of an int64 column near 2^62 and of a uint64 column past
  2^63 adds in float64, as numpy's does (an int64 sum wraps), on the frame,
  binned, per group on the dense, set and one-sort plans and a 3-shard CPU
  mesh, in ``describe`` and StandardScaler's ``mean_``;
* C19: var, std, covar and corr from shifted moments, held to numpy over
  the centred data at offsets 1e4, 1e6 and 1e8, on datetime64[ns] within an
  hour of 2024-05-01 and on int64 near 2^62 (its std exactly 3.5); the
  plain versions of the moment kernels B4 and B5 with a shift.

At offset 1e4 the port is also held to vaex_tpu.  Past it the reference is
wrong and the tests pin its faults (ROADMAP, known problems of the
reference): its int mean divides a wrapped sum (vaex_tpu/agg.py:1077-1085),
its var from raw moments cancels (vaex_tpu/agg.py:1114).
"""

import numpy as np
import numpy.testing as npt
import pytest
import torch

import vaex_tpu
import vaex_tpu_torch
from torch_port_helpers import ATOL, RTOL
from vaex_tpu_torch import agg, cache, groupby
from vaex_tpu_torch.ops import grid_moments as gm
from vaex_tpu_torch.parallel import distributed_executor

N = 6000
K = 10
OFFSETS = {"y4": 1e4, "y6": 1e6, "y8": 1e8}
D0 = np.datetime64("2024-05-01T00:00:00", "ns")
X62 = 2 ** 62
WIDE = 10_000_019  # a key step whose span passes the dense plan's range


def _arrays(seed=21, n=N):
    """k a key in [0, K) and w = k * WIDE; a a binby axis of bin centres in
    [0, 1); y4 / y6 / y8 N(0, 1) plus 1e4 / 1e6 / 1e8 and z4 / z6 / z8
    correlated with them; d datetime64[ns] within an hour of 2024-05-01;
    x62 int64 of 2^62 and 2^62 + 7, half each; u uint64 past 2^63."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, K, n).astype(np.int64)
    out = {"k": k, "w": k * WIDE, "a": (rng.integers(0, 101, n) + 0.5) / 101}
    for name, off in OFFSETS.items():
        y = rng.normal(0, 1, n)
        out[name] = y + off
        out["z" + name[1:]] = 0.5 * y + rng.normal(0, 1, n) + 2 * off
    out["d"] = D0 + rng.integers(0, 3600 * 10 ** 9, n).astype("timedelta64[ns]")
    out["x62"] = X62 + rng.permutation(np.repeat([0, 7], n // 2)).astype(np.int64)
    out["u"] = (np.uint64(2 ** 63) + rng.integers(0, 2 ** 40, n).astype(np.uint64))
    return out


ARRAYS = _arrays()


def _centred(name):
    """A column less a constant near it, exactly, as float64: the data
    numpy's answers are taken over."""
    v = ARRAYS[name]
    if name in OFFSETS or name.startswith("z"):
        off = OFFSETS.get(name, 2 * OFFSETS.get("y" + name[1:], 0.0))
        return v - off  # within a factor 2 of the offset: exact
    if name == "d":
        return (v - D0).astype(np.int64).astype(np.float64)
    return (v - np.int64(X62)).astype(np.float64)


def _frame(**kw):
    df = vaex_tpu_torch.from_arrays(**ARRAYS).to_device("cpu")
    for key, value in kw.items():
        setattr(df, key, value)
    return df


def _close(got, want, err=""):
    npt.assert_allclose(np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64),
                        rtol=RTOL, atol=ATOL, err_msg=err)


def _per_group(values, keys, stat):
    return np.array([stat(values[keys == g]) for g in range(K)])


# ------------------------------------------------------------------- C17

def _write(how, k, src):
    if how == "numpy":
        k.numpy()[3] = 100
    elif how == "data":
        k.data[3] = 100
    else:
        src[3] = 100


def _counts(a):
    return sorted(zip(*[x.tolist() for x in np.unique(a, return_counts=True)]))


IDS = [100, 3 * WIDE]
# per query: (the frame it runs on, made once from the frame of k; the
# query; numpy's answer over k's values)
QUERIES = {
    "unique": (lambda df: df, lambda df: sorted(df.unique("k")),
               lambda a: sorted(np.unique(a).tolist())),
    "value_counts": (lambda df: df, lambda df: sorted(df.k.value_counts().to_dict().items()),
                     _counts),
    "isin": (lambda df: df[df.k.isin(IDS)], lambda df: sorted(df.unique("k")),
             lambda a: sorted(np.unique(a[np.isin(a, IDS)]).tolist())),
    "one-sort": (lambda df: df, lambda df: sorted(zip(*[df.groupby("k", agg="count")[c].tolist()
                                                        for c in ("k", "count")])),
                 _counts),
}


@pytest.mark.parametrize("query", list(QUERIES))
@pytest.mark.parametrize("how", ["numpy", "data", "source"])
def test_a_write_behind_the_version_counter_is_seen(how, query):
    """C17: the second query answers over the written value; before, the
    cache served the first answer (the tensor's identity and version did
    not change)."""
    frame, run, want = QUERIES[query]
    src = np.random.default_rng(3).integers(0, 7, 5000).astype(np.int64) * WIDE
    k = torch.from_numpy(src)
    df = frame(vaex_tpu_torch.from_arrays(k=k))
    cache.clear()
    with cache.memory():
        assert run(df) == want(src.copy())
        _write(how, k, src)
        assert src[3] == 100
        assert run(df) == want(src.copy())
        if query == "one-sort":
            assert df.executor.trace_log[-1].get("groupby") == "one-sort"


def test_a_cpu_tensor_is_keyed_by_its_bytes_and_a_card_tensor_by_none():
    from vaex_tpu_torch.utils import tensor_key
    a = torch.arange(10)
    key, content = tensor_key(a)
    assert content and tensor_key(a.clone()) == (key, True)
    a.data[0] = 5
    assert tensor_key(a)[0] != key
    if torch.cuda.is_available():
        assert tensor_key(a.cuda()) == (None, False)


# ------------------------------------------------------------------- C18

def _mean_cases():
    return ["x62", "u"]


@pytest.mark.parametrize("name", _mean_cases())
def test_an_int_mean_adds_in_float64(name):
    """C18: the frame, binned, describe and StandardScaler against numpy."""
    df, v = _frame(), ARRAYS[name]
    _close(df.mean(name), np.mean(v), name)
    bins = (ARRAYS["a"] * 101).astype(int)
    got = df.mean(name, binby="a", shape=101, limits=[0, 1])
    _close(got, [np.mean(v[bins == b]) for b in range(101)], name)
    _close(df.describe()[name]["mean"], np.mean(v), name)
    scaler = vaex_tpu_torch.ml.StandardScaler(features=[name]).fit(df)
    _close(scaler.mean_[0], np.mean(v), name)


def test_the_reference_divides_a_wrapped_int_sum():
    """vaex_tpu/agg.py:1077-1085, pinned: its mean of x62 is far from
    numpy's."""
    ref = vaex_tpu.from_arrays(x62=ARRAYS["x62"])
    assert abs(float(ref.mean("x62")) - np.mean(ARRAYS["x62"])) > 1e18


# ------------------------------------------------------------------- C19

STD_CASES = ["y4", "y6", "y8", "d", "x62"]
# the columns of each case of the tests below (1e4 beside 1e6: the raw
# moments held 1e-6 at 1e4 already)
CASES = {"1e4 and 1e6": ["y4", "y6"], "1e8": ["y8"], "datetime": ["d"], "2^62": ["x62"]}


@pytest.mark.parametrize("case", list(CASES))
def test_var_and_std_of_values_far_from_zero(case):
    """C19: the frame's var and std, binned at G = 103 (B4's grids) and
    10 609 (B5's), against numpy over the centred data."""
    df = _frame()
    for name in CASES[case]:
        c = _centred(name)
        _close(df.var(name), np.var(c), name)
        _close(df.std(name), np.std(c), name)
        for shape in (101, 10_607):
            bins = np.floor(ARRAYS["a"] * shape).astype(int)
            got = np.asarray(df.std(name, binby="a", shape=shape, limits=[0, 1]))
            want = np.full(shape, np.nan)
            for b in np.unique(bins):
                want[b] = np.std(c[bins == b])
            filled = ~np.isnan(want)
            _close(got[filled], want[filled], f"{name} {shape}")


def test_the_int64_std_near_2_62_is_exactly_3_5():
    """Half 2^62, half 2^62 + 7: the exact std is 3.5 (numpy's np.std of the
    int64 values gives 0.0: it casts 2^62 + 7 to 2^62 first)."""
    df = _frame()
    assert float(df.std("x62")) == 3.5 and float(df.var("x62")) == 12.25
    assert np.std(ARRAYS["x62"]) == 0.0


@pytest.mark.parametrize("offset", ["4", "6", "8"])
def test_covar_and_corr_of_values_far_from_zero(offset):
    """C19: covar and corr of the frame (df.covar, df.correlation, the
    moment ops through a groupby of one group), df.cov and PCA's
    covariance against numpy over the centred data."""
    y, z = "y" + offset, "z" + offset
    df, cy, cz = _frame(), _centred(y), _centred(z)
    cov = np.cov(np.stack([cy, cz]), bias=True)
    corr = np.corrcoef(cy, cz)[0, 1]
    _close(df.covar(y, z), cov[0, 1])
    _close(df.correlation(y, z), corr)
    _close(df.cov([y, z]), cov)
    one = df.groupby(df.k * 0, agg={"cv": agg.covar(y, z), "cr": agg.corr(y, z)})
    _close(one["cv"].values, [cov[0, 1]])
    _close(one["cr"].values, [corr])
    pca = vaex_tpu_torch.ml.PCA(features=[y, z]).fit(df)
    _close(sorted(pca.eigen_values_), np.linalg.eigvalsh(cov))


@pytest.mark.parametrize("case", [c for c in CASES if c != "datetime"])
def test_describe_and_the_scaler_take_the_shifted_std(case):
    df = _frame()
    for name in CASES[case]:
        c = _centred(name)
        _close(df.describe()[name]["std"], np.std(c), name)
        scaler = vaex_tpu_torch.ml.StandardScaler(features=[name]).fit(df)
        _close(scaler.std_[0], np.std(c), name)


def _plans():
    return ["dense", "set", "one-sort", "mesh"]


def _grouped(plan, monkeypatch, names):
    """(the per-group answers of the aggregations ``names`` on ``plan``,
    each key's group)."""
    df = _frame()
    key = "k" if plan in ("dense", "mesh") else "w"
    if plan == "set":
        df = df[df.a >= 0]  # a filtered frame leaves the one-sort plan: the set path
    if plan == "mesh":
        monkeypatch.setattr(groupby, "SHUFFLE_MIN_G", 1)
        df.executor = distributed_executor(3, devices=["cpu"] * 3)
    with cache.off():
        passes = df.executor.passes
        out = df.groupby(key, agg=names, sort=True)
    log = df.executor.trace_log[passes:]
    if plan == "one-sort":
        assert any(e.get("groupby") == "one-sort" for e in log)
    elif plan == "mesh":
        assert any(e.get("shuffle") is True for e in log)
    else:
        assert all("groupby" not in e for e in log)
    keys = np.asarray(out[key].values) // (WIDE if key == "w" else 1)
    return out, keys


@pytest.mark.parametrize("plan", _plans())
def test_per_group_means_stds_and_vars(plan, monkeypatch):
    """C18 and C19 per group, on each plan (the one-sort plan takes no
    datetime or uint64 value: the classic path's plans answer those)."""
    stds = [c for c in STD_CASES if plan != "one-sort" or c != "d"]
    means = [c for c in _mean_cases() if plan != "one-sort" or c != "u"]
    names = {}
    for c in stds:
        names[f"std_{c}"] = agg.std(c)
        names[f"var_{c}"] = agg.var(c)
    for c in means:
        names[f"mean_{c}"] = agg.mean(c)
    out, keys = _grouped(plan, monkeypatch, names)
    assert sorted(keys.tolist()) == list(range(K))
    k = ARRAYS["k"]
    for c in stds:
        cen = _centred(c)
        _close(out[f"std_{c}"].values, _per_group(cen, k, np.std)[keys], f"{plan} {c}")
        _close(out[f"var_{c}"].values, _per_group(cen, k, np.var)[keys], f"{plan} {c}")
    for c in means:
        _close(out[f"mean_{c}"].values, _per_group(ARRAYS[c], k, np.mean)[keys], f"{plan} {c}")


def test_at_offset_1e4_the_port_equals_vaex_tpu():
    """var and std, of the frame and binned (covar and corr: the next
    test)."""
    ref, port = vaex_tpu.from_arrays(**{c: ARRAYS[c] for c in ("y4", "a")}), _frame()
    for stat in ("var", "std"):
        _close(getattr(port, stat)("y4"), getattr(ref, stat)("y4"), stat)
        _close(getattr(port, stat)("y4", binby="a", shape=101, limits=[0, 1]),
               getattr(ref, stat)("y4", binby="a", shape=101, limits=[0, 1]), stat)


def test_the_reference_loses_var_far_from_zero():
    """vaex_tpu/agg.py:1114 and its covar from raw means
    (vaex_tpu/dataframe.py:1027-1038), pinned: its std at an offset of 1e8
    is off by more than 1e-3, its covar already at 1e4 by more than 1e-6,
    where the port holds 1e-6 of numpy over the centred data."""
    ref = vaex_tpu.from_arrays(**{c: ARRAYS[c] for c in ("y4", "z4", "y8")})
    assert abs(float(ref.std("y8")) / np.std(_centred("y8")) - 1) > 1e-3
    want = np.cov(np.stack([_centred("y4"), _centred("z4")]), bias=True)[0, 1]
    assert abs(float(ref.covar("y4", "z4")) / want - 1) > 1e-6


# ------------------------------------------------- the plain versions' shift

def _span_past_2_63(n=512, seed=5):
    rng = np.random.default_rng(seed)
    v = np.where(rng.random(n) < 0.5, -(2 ** 62) - rng.integers(0, 9, n),
                 2 ** 62 + rng.integers(0, 9, n)).astype(np.int64)
    return v, rng.integers(0, 7, n).astype(np.int32)


@pytest.mark.parametrize("shift", [0, 2 ** 62, -(2 ** 62) - 3])
def test_form_terms_subtracts_an_int64_shift_before_the_cast(shift):
    """v - s of an int64 base rounds once, where the span passes 2^63:
    exactly Python's float(int(v) - s)."""
    v, idx = _span_past_2_63()
    _, (x, xx) = gm.form_terms(torch.from_numpy(idx), [torch.from_numpy(v)], agg.VAR_TERMS,
                               [shift])
    want = np.array([float(int(a) - shift) for a in v])
    npt.assert_array_equal(x.numpy(), want)
    npt.assert_array_equal(xx.numpy(), want * want)


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.int64])
@pytest.mark.parametrize("reference", ["b4", "b5"])
def test_the_plain_versions_take_a_shift(dtype, reference):
    """grid_moments_reference / grid_moments_window_reference with a shift
    per base: the sums of u = x - a and v = y - b, against numpy."""
    rng = np.random.default_rng(9)
    n, G = 3000, 37
    idx = rng.integers(-1, G, n).astype(np.int32)
    if dtype == np.int64:
        x = (X62 + rng.integers(-50, 50, n)).astype(np.int64)
        y = (-(2 ** 61) + rng.integers(-50, 50, n)).astype(np.int64)
        shift, ux, uy = [X62, -(2 ** 61)], (x - X62).astype(float), (y + 2 ** 61).astype(float)
    else:
        x, y = (rng.normal(0, 1, n) + 1e6).astype(dtype), (rng.normal(0, 1, n) - 1e8).astype(dtype)
        shift = [1e6, -1e8]
        ux, uy = x.astype(np.float64) - 1e6, y.astype(np.float64) + 1e8
    fn = gm.grid_moments_reference if reference == "b4" else gm.grid_moments_window_reference
    counts, sums = fn(torch.from_numpy(idx), [torch.from_numpy(x), torch.from_numpy(y)],
                      agg.CORR_TERMS, G, shift)
    keep = idx >= 0
    b = idx[keep]
    npt.assert_array_equal(counts[0].numpy(), np.bincount(b, minlength=G))
    floats = [ux * uy, ux, uy, ux * ux, uy * uy]  # CORR_TERMS' float terms in order
    for got, terms in zip(sums.numpy(), floats):
        npt.assert_allclose(got, np.bincount(b, terms[keep], minlength=G), rtol=1e-12,
                            atol=1e-9)


# ------------------------------------------------------------------- A15

@pytest.mark.parametrize("name", ["Grouper", "GrouperCategory", "progress"])
def test_the_top_level_names_of_vaex_tpu(name):
    want, got = getattr(vaex_tpu, name), getattr(vaex_tpu_torch, name)
    assert type(got) is type(want)
    if isinstance(want, type):
        assert got.__name__ == want.__name__


def test_the_client_reexports_dummy_transport():
    from vaex_tpu.server.client import DummyTransport as want
    from vaex_tpu_torch.server.client import DummyTransport as got
    from vaex_tpu_torch.server.service import DummyTransport
    assert got is DummyTransport and got.__name__ == want.__name__


def test_settings_get_and_store_through_main_yml(tmp_path, monkeypatch):
    """A dotted-key main.yml read by both packages' settings alike."""
    pytest.importorskip("yaml")
    from vaex_tpu import settings as ref_settings
    from vaex_tpu_torch import settings
    text = "server:\n  port: 9123\n  host: here\ncache: disk\n"
    for home in (".vaex_tpu", ".vaex_tpu_torch"):
        (tmp_path / home).mkdir()
        (tmp_path / home / "main.yml").write_text(text)
    monkeypatch.setenv("HOME", str(tmp_path))
    for module in (ref_settings, settings):
        monkeypatch.setattr(module, "_main", {})
        module._load_yaml()
    for key in ("server.port", "server.host", "cache", "missing"):
        assert settings.get(key, "none") == ref_settings.get(key, "none")
    assert settings.get("server.port") == 9123
    settings.store("server.port", 1)
    assert settings.get("server.port") == 1
    (tmp_path / ".vaex_tpu_torch" / "main.yml").write_text(": [ not yaml")
    monkeypatch.setattr(settings, "_main", {})
    settings._load_yaml()  # a bad file leaves the settings empty and raises nothing
    assert settings.get("server.port") is None
