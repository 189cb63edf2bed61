"""Shared helpers of the differential tests between vaex_tpu (the JAX
reference) and vaex_tpu_torch (the PyTorch port)."""

import numpy as np
import numpy.testing as npt

import vaex_tpu
import vaex_tpu_torch

# the float contract of the reference against pandas: 1e-6 relative and
# 1e-7 absolute; integer aggregates are exact
RTOL, ATOL = 1e-6, 1e-7


def seeded_arrays(seed, n, k, key_low=0, key_high=None, nan_every=0):
    """One dict of numpy columns: an int64 key in [key_low, key_high), an
    f64 value x, an int64 value iv and an f32 value y."""
    rng = np.random.default_rng(seed)
    key_high = k if key_high is None else key_high
    x = rng.normal(0, 100, n)
    if nan_every:
        x[::nan_every] = np.nan
    return {
        "k": rng.integers(key_low, key_high, n).astype(np.int64),
        "x": x,
        "iv": rng.integers(-(2 ** 40), 2 ** 40, n).astype(np.int64),
        "y": rng.normal(0, 1, n).astype(np.float32),
    }


def key_arrays(seed, n):
    """Raw key columns of every kind the set-based paths take, and values:
    ``k`` int64 in a narrow range, ``w`` int64 over a range past 2^22, ``f``
    float64 with NaN, -0.0 and both infinities, ``m`` a masked int64, ``fm`` a
    masked float64 with NaN, ``b`` int32; ``x`` float64, ``iv`` int64."""
    rng = np.random.default_rng(seed)
    fm = rng.choice([0.5, 2.0, np.nan, -3.25], n)
    return {
        "k": rng.integers(-3, 40, n).astype(np.int64),
        "w": rng.integers(0, 50, n).astype(np.int64) * 1_000_003,
        "f": rng.choice([1.5, -0.0, 0.0, np.nan, np.inf, -np.inf, 7.25, -2.0], n),
        "m": np.ma.MaskedArray(rng.integers(0, 9, n).astype(np.int64), rng.random(n) < 0.1),
        "fm": np.ma.MaskedArray(fm, rng.random(n) < 0.15),
        "b": rng.integers(0, 7, n).astype(np.int32),
        "x": rng.normal(0, 10, n),
        "iv": rng.integers(-100, 100, n).astype(np.int64),
    }


def binby_arrays(seed, n, k=20):
    """Columns for binned statistics over continuous axes: ``x``, ``y`` float64
    normal axes (``x`` with NaN), ``xf`` a float32 axis, ``xi`` an int64 one,
    ``xm`` a masked axis; ``v`` float64 in [0, 100) with NaN, ``w`` float32,
    ``iv`` int64 near 2^40, ``vm`` a masked float64, ``b`` bool; ``t`` an
    order column (a permutation: no ties), ``tt`` one with ties; ``d`` a
    datetime64[ns] with NaT, ``td`` a timedelta64[s]; ``k`` an int64 key in
    [0, k) and ``id6`` one in [0, n // 10)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, n)
    x[::53] = np.nan
    v = rng.uniform(0, 100, n)
    v[::97] = np.nan
    d = (np.datetime64("2020-01-01") + rng.integers(0, 1000, n).astype("m8[D]")).astype("M8[ns]")
    d[::41] = np.datetime64("NaT")
    return {
        "x": x,
        "y": rng.normal(0, 1, n),
        "xf": rng.normal(0, 1, n).astype(np.float32),
        "xi": rng.integers(-50, 50, n).astype(np.int64),
        "xm": np.ma.MaskedArray(rng.normal(0, 1, n), rng.random(n) < 0.1),
        "v": v,
        "w": rng.normal(0, 1, n).astype(np.float32),
        "iv": rng.integers(-(2 ** 40), 2 ** 40, n).astype(np.int64),
        "vm": np.ma.MaskedArray(rng.normal(0, 10, n), rng.random(n) < 0.15),
        "b": rng.random(n) < 0.5,
        "t": rng.permutation(n).astype(np.int64),
        "tt": rng.integers(0, 50, n).astype(np.int64),
        "d": d,
        "td": rng.integers(-10 ** 6, 10 ** 6, n).astype("m8[s]"),
        "k": rng.integers(0, k, n).astype(np.int64),
        "id6": rng.integers(0, max(n // 10, 1), n).astype(np.int64),
    }


def same_frames(arrays, category=None, labels=None, tile_rows=None):
    """The same frame in both packages: (vaex_tpu frame, port frame on the
    CPU device), both categorized on ``category`` when given.  Masked and
    NaN-bearing columns cross as they are: the port keeps a masked column on
    the host and tiles it into the pass."""
    ref = vaex_tpu.from_arrays(**arrays)
    port = vaex_tpu_torch.from_arrays(**arrays).to_device("cpu")
    if category is not None:
        ref = ref.categorize(category, labels=labels)
        port = port.categorize(category, labels=labels)
    if tile_rows is not None:
        ref._tile_rows = tile_rows
        port._tile_rows = tile_rows
    return ref, port


def same_set(oset_ref, oset_port):
    """A vaex_tpu SortedSet and the port's hold the same keys, counts and
    NaN / null slots."""
    npt.assert_array_equal(np.asarray(oset_port.keys), np.asarray(oset_ref.keys))
    assert oset_port.keys.dtype == np.asarray(oset_ref.keys).dtype
    if oset_ref.counts is None:
        assert oset_port.counts is None
    else:
        npt.assert_array_equal(oset_port.counts, np.asarray(oset_ref.counts))
    for name in ("n_keys", "count", "nan_count", "null_count", "nan_ordinal", "null_ordinal",
                 "has_nan", "has_null"):
        assert getattr(oset_port, name) == getattr(oset_ref, name), name


def _values(column):
    """A result column as a float or int array; a missing value as NaN."""
    values = column.tolist()
    if any(v is None for v in values):
        return np.asarray([np.nan if v is None else v for v in values], dtype=np.float64), [
            v is None for v in values]
    return np.asarray(values), None


def assert_same_frame(ref, port):
    """Column names, order and values: ints exact, floats to the contract."""
    assert port.get_column_names() == ref.get_column_names()
    for name in ref.get_column_names():
        (want, want_null), (got, got_null) = _values(ref[name]), _values(port[name])
        assert got.shape == want.shape, name
        assert got_null == want_null, name
        if want.dtype.kind == "f" or got.dtype.kind == "f":
            npt.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=name)
        else:
            npt.assert_array_equal(got, want, err_msg=name)


def same_frame_pair(left, right, tile_rows=None):
    """Two dicts of arrays as the same pair of frames in both packages:
    ((vaex_tpu left, vaex_tpu right), (port left, port right)), the port's
    on the CPU device."""
    (ref_left, port_left), (ref_right, port_right) = (
        same_frames(arrays, tile_rows=tile_rows) for arrays in (left, right))
    return (ref_left, ref_right), (port_left, port_right)


def assert_same_rows(ref, port, names=None):
    """Column names and, for each column, the rows in order exactly: the
    same dtype, the same missing rows, the same values elsewhere (NaN equal
    to NaN, -0.0 to -0.0)."""
    names = names or ref.get_column_names()
    assert port.get_column_names() == ref.get_column_names()
    assert len(port) == len(ref)
    for name in names:
        want, got = ref.evaluate(name), port.evaluate(name)
        want_mask, got_mask = np.ma.getmaskarray(want), np.ma.getmaskarray(got)
        npt.assert_array_equal(got_mask, want_mask, err_msg=f"{name}: missing rows")
        want, got = np.ma.getdata(want)[~want_mask], np.ma.getdata(got)[~got_mask]
        assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
        npt.assert_array_equal(got, want, err_msg=name)
        if want.dtype.kind == "f":
            npt.assert_array_equal(np.signbit(got), np.signbit(want), err_msg=name)


def with_uint64(arrays, seed, name="u"):
    """``arrays`` and a uint64 column ``name``: small values, values past
    2^63 and the largest uint64, each row's top bit set at random."""
    rng = np.random.default_rng(seed)
    n = len(next(iter(arrays.values())))
    low = rng.integers(0, 7, n).astype(np.uint64)
    top = rng.random(n) < 0.5
    values = np.where(top, low | np.uint64(1 << 63), low)
    values[::11] = np.uint64(2 ** 64 - 1)
    return {**arrays, name: values}


def with_source_id(arrays, seed):
    """``arrays`` and a Gaia-like ``source_id``: int64 uniform in [0,
    12 * 4^12 * 2^35), a nested healpix index at level 12 times 2^35."""
    rng = np.random.default_rng(seed)
    n = len(next(iter(arrays.values())))
    return {**arrays, "source_id": rng.integers(0, 12 * 4 ** 12 * 2 ** 35, n).astype(np.int64)}


# strings: a few labels with empty, non-ASCII, padded and digit strings
STRING_LABELS = ["", "a", "ab", "Ab c", "é", "éclair", "日本語", "x3y", "  pad ", "ABC",
                 "a.b", "123", "b", "Title Case", "ba", "aaa"]
STRING_FORMS = ("plain", "dictionary", "staged")


def string_arrays(seed, n, k=len(STRING_LABELS), null_every=9):
    """``s`` and ``t`` object arrays of ``k`` labels of STRING_LABELS (a
    None every ``null_every`` rows of ``s``), ``x`` float64, ``iv`` int64
    and ``g`` an int64 key in 0..4."""
    rng = np.random.default_rng(seed)
    labels = np.asarray(STRING_LABELS[:k], dtype=object)
    s = labels[rng.integers(0, k, n)].astype(object)
    if null_every:
        s[::null_every] = None
    return {"s": s, "t": labels[rng.integers(0, k, n)].astype(object),
            "x": rng.normal(0, 10, n), "iv": rng.integers(-100, 100, n).astype(np.int64),
            "g": rng.integers(0, 5, n).astype(np.int64)}


def string_frames(arrays, form):
    """The same frame in both packages with its string columns as plain
    strings ("plain": arrow strings in the port, object arrays in
    vaex_tpu), arrow dictionary arrays ("dictionary"), or staged
    ("staged": vaex_tpu's ``to_device()``, the port's ``to_device("cpu")``,
    which dictionary-encode them).  A port frame that is not staged runs its
    passes on ``settings.DEVICE``: the caller sets it to "cpu"."""
    import pyarrow as pa
    if form == "dictionary":
        arrays = {name: pa.array(a, type=pa.string()).dictionary_encode()
                  if a.dtype == object else a for name, a in arrays.items()}
    ref = vaex_tpu.from_arrays(**arrays)
    port = vaex_tpu_torch.from_arrays(**arrays)
    if form == "staged":
        ref, port = ref.to_device(), port.to_device("cpu")
    return ref, port


def host_list(values):
    """Host values (an arrow array, plain or dictionary, a numpy or masked
    array, a list) as a list of Python values, None where missing."""
    if hasattr(values, "to_pylist"):
        if hasattr(values, "dictionary_decode"):
            values = values.dictionary_decode()
        return values.to_pylist()
    if isinstance(values, np.ma.MaskedArray):
        return [None if m else v for v, m in zip(values.data.tolist(),
                                                  np.ma.getmaskarray(values).tolist())]
    return list(np.asarray(values).tolist()) if not isinstance(values, list) else values


def assert_same_list(got, want, rtol=0.0):
    """Two lists of Python values: equal, None where missing, NaN equal to
    NaN, floats within ``rtol`` relative."""
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        if isinstance(w, float) and isinstance(g, (int, float)) and g is not None:
            if np.isnan(w):
                assert np.isnan(g), i
            else:
                assert abs(g - w) <= rtol * abs(w), (i, g, w)
        else:
            assert g == w, (i, g, w)


def special_floats(n, dtype, seed=0):
    """N(0, 10) in ``dtype`` with the dtype's largest finite value every
    173rd row, -0.0 every 41st, NaN every 31st, -inf every 89th and +inf
    every 97th (where two strides meet, the one named later wins)."""
    x = np.random.default_rng(seed).normal(0, 10, n).astype(dtype)
    i = np.arange(n)
    x[i % 41 == 0] = -0.0
    x[i % 173 == 0] = np.finfo(dtype).max
    x[i % 31 == 0] = np.nan
    x[i % 89 == 0] = -np.inf
    x[i % 97 == 0] = np.inf
    return x


def numpy_stat(values, stat):
    """numpy's nan-function of ``stat`` (sum, mean, std, var, min, max or
    count; ddof 0) over one group's values cast to float64."""
    v = np.asarray(values, dtype=np.float64)
    with np.errstate(all="ignore"):
        if stat == "count":
            return float(np.sum(~np.isnan(v)))
        if stat == "mean":
            return np.nansum(v) / np.sum(~np.isnan(v))
        return {"sum": np.nansum, "std": np.nanstd, "var": np.nanvar, "min": np.nanmin,
                "max": np.nanmax}[stat](v)


def assert_special(got, want, what, rtol=1e-9):
    """NaN where ``want`` has NaN, the same infinity where it has one, other
    floats within ``rtol`` relative."""
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, what
    npt.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=f"{what}: NaN")
    npt.assert_array_equal(np.isposinf(got), np.isposinf(want), err_msg=f"{what}: +inf")
    npt.assert_array_equal(np.isneginf(got), np.isneginf(want), err_msg=f"{what}: -inf")
    finite = np.isfinite(want)
    npt.assert_allclose(got[finite], want[finite], rtol=rtol, atol=0, err_msg=what)
