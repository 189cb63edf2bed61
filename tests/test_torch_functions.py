"""The port's expression functions against vaex_tpu's on the same frame
(the port on device="cpu"): every name of ``vaex_tpu/functions.py`` with a
device half that the port registers (the 31 unary and 8 binary ufuncs,
``round``, ``clip``, ``searchsorted``, ``digitize``, ``isfinite``,
``isinf``, ``fillmissing``, ``fillnan``, ``fillna``, ``pnpoly``) over int64,
int32, float32, float64-with-NaN and masked float64 and int64 columns,
across tile boundaries.

Values: ints and bools exact, floats to the repo's contract (1e-6 relative,
1e-7 absolute; ``torch_port_helpers.RTOL, ATOL``), missing values in the
same rows.  The result dtype is numpy's, from numpy on the same arrays: an
int input to a float function gives float64 (vaex_tpu gives float32 for
int32 and keeps an int dtype through ``floor`` and ``ceil``; ROADMAP,
"Known problems of the reference itself").  ``cbrt`` is held to numpy
within 1 ulp.
"""

import numpy as np
import numpy.testing as npt
import pytest
import torch

import vaex_tpu_torch
from torch_port_helpers import ATOL, RTOL, same_frames
from vaex_tpu_torch.registry import expression_namespace

N = 1000
UNARY = ["abs", "arccos", "arccosh", "arcsin", "arcsinh", "arctan", "arctanh", "cos", "cosh",
         "deg2rad", "exp", "expm1", "log", "log10", "log1p", "rad2deg", "sin", "sinc", "sinh",
         "sqrt", "tan", "tanh", "floor", "ceil", "sign", "degrees", "radians", "exp2", "log2",
         "rint", "cbrt", "isfinite", "isinf"]
BINARY = ["arctan2", "maximum", "minimum", "power", "fmod", "hypot", "copysign", "logaddexp"]
COLUMNS = ["i64", "i32", "f32", "f64n", "m", "mi"]
# the port's names beside those of UNARY and BINARY, each with its calls
OTHER = {
    "round": ["round({c})", "round({c}, 1)"],
    "clip": ["clip({c}, -1, 2)", "clip({c}, 0.5, None)", "clip({c}, None, 2)"],
    "searchsorted": ["searchsorted({c}, [-1, 0, 2.5])",
                     "searchsorted({c}, [-1, 0, 2.5], side='right')"],
    "digitize": ["digitize({c}, [-1, 0, 2.5])", "digitize({c}, [2.5, 0, -1])",
                 "digitize({c}, [-1, 0, 2.5], right=True)",
                 "digitize({c}, [2.5, 0, -1], right=True)"],
    "fillmissing": ["fillmissing({c}, 9)"],
    "fillnan": ["fillnan({c}, 9)"],
    "fillna": ["fillna({c}, 9)"],
    "pnpoly": ["pnpoly({c}, f64n, [-2, 3, 3, -2, 0], [-2, -2, 3, 3, 4])"],
}


def _arrays(seed=31):
    rng = np.random.default_rng(seed)
    f64n = rng.normal(0, 2, N)
    f64n[::7] = np.nan
    f64n[1:30:9] = [0.0, -0.0, 1.0, -1.0]
    return {
        "i64": rng.integers(-5, 6, N).astype(np.int64),
        "i32": rng.integers(1, 6, N).astype(np.int32),
        "f32": rng.normal(0, 2, N).astype(np.float32),
        "f64n": f64n,
        "m": np.ma.MaskedArray(rng.uniform(-3, 3, N), rng.random(N) < 0.1),
        "mi": np.ma.MaskedArray(rng.integers(-5, 6, N).astype(np.int64), rng.random(N) < 0.1),
    }


@pytest.fixture(scope="module")
def frames():
    return same_frames(_arrays(), tile_rows=333)


def _numpy_namespace():
    """The functions by their numpy meaning, for the result dtype."""
    ns = {name: getattr(np, name) for name in UNARY + BINARY}
    ns.update({
        "round": np.round, "clip": np.clip,
        "searchsorted": lambda ar, values, side="left": np.searchsorted(values, ar, side=side),
        "digitize": lambda x, bins, right=False: np.digitize(x, bins, right=right),
        "fillmissing": lambda x, v: np.ma.getdata(x),
        "fillnan": lambda x, v: x, "fillna": lambda x, v: np.ma.getdata(x),
        "pnpoly": lambda x, y, xs, ys: np.zeros(len(x), bool),
    })
    return ns


def numpy_dtype(expression, arrays):
    with np.errstate(all="ignore"):
        return np.asarray(eval(expression, _numpy_namespace(), dict(arrays))).dtype


def _same(got, want, what):
    got_mask, want_mask = np.ma.getmaskarray(got), np.ma.getmaskarray(want)
    npt.assert_array_equal(got_mask, want_mask, err_msg=f"missing rows, {what}")
    g, w = np.ma.getdata(got)[~got_mask], np.ma.getdata(want)[~want_mask]
    if g.dtype.kind in "biu" and w.dtype.kind in "biu":
        npt.assert_array_equal(g, w, err_msg=what)
    else:
        npt.assert_allclose(g.astype(np.float64), w.astype(np.float64), rtol=RTOL, atol=ATOL,
                            err_msg=what)


def _numpy(expression, column):
    """numpy's answer, missing where ``column`` is."""
    arrays = _arrays()
    plain = {name: np.ma.getdata(a) for name, a in arrays.items()}
    with np.errstate(all="ignore"):
        data = np.asarray(eval(expression, _numpy_namespace(), plain))
    return np.ma.MaskedArray(data, np.ma.getmaskarray(arrays[column]))


def _check(frames, expression, column=None):
    """The port against vaex_tpu, or against numpy for a call vaex_tpu's
    ``evaluate`` refuses (``digitize(..., right=True)``: its host half takes
    no keyword)."""
    ref, port = frames
    got = port.evaluate(expression)
    want = _numpy(expression, column) if "right=True" in expression else ref.evaluate(expression)
    _same(got, want, expression)
    assert got.dtype == numpy_dtype(expression, _arrays()), expression


@pytest.mark.parametrize("column", COLUMNS)
@pytest.mark.parametrize("name", UNARY)
def test_unary(frames, name, column):
    _check(frames, f"{name}({column})")


@pytest.mark.parametrize("column", COLUMNS)
@pytest.mark.parametrize("name", BINARY)
def test_binary(frames, name, column):
    """Against a float64 column with NaN, a Python int and a Python float
    (numpy 2 takes a Python number as weak: float32 stays float32)."""
    for other in ("f64n", "2", "2.5"):
        if name == "power" and column in ("i64", "mi") and other == "f64n":
            other = "i32"  # an int to an int power, every exponent positive
        _check(frames, f"{name}({column}, {other})")
        if other == "f64n":
            _check(frames, f"{name}({other}, {column})")
        elif name == "power" and column in ("i64", "mi"):
            _check(frames, f"{name}({column}, i32)")
        else:
            _check(frames, f"{name}({column}, {column})")


@pytest.mark.parametrize("column", COLUMNS)
@pytest.mark.parametrize("name", sorted(OTHER))
def test_other_functions(frames, name, column):
    for call in OTHER[name]:
        _check(frames, call.format(c=column), column)


def test_every_function_of_the_reference_is_registered():
    names = UNARY + BINARY + sorted(OTHER)
    assert len(set(names) - {"abs"}) == 48
    assert set(names) <= set(expression_namespace)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_cbrt_within_one_ulp(dtype):
    """``cbrt`` over 1e5 values across the exponent range, exact cubes,
    +-0, +-inf, the smallest subnormal and the largest float: within 1 ulp
    of numpy in float64; in float32 within 1 ulp of the correctly rounded
    root (numpy's own float32 cbrt is off by up to 2 ulp)."""
    rng = np.random.default_rng(3)
    info = np.finfo(dtype)
    exps = rng.integers(info.minexp // 3 * 3 + 3, info.maxexp - 1, 100_000)
    v = (rng.normal(0, 1, 100_000) * 2.0 ** exps).astype(dtype)
    v = np.concatenate([v, np.arange(-50, 51).astype(dtype) ** 3,
                        np.array([0.0, -0.0, np.inf, -np.inf, info.max, -info.max,
                                  info.smallest_subnormal], dtype)])
    got = vaex_tpu_torch.from_arrays(v=v).to_device("cpu").evaluate("cbrt(v)")
    assert got.dtype == dtype
    want = np.cbrt(v) if dtype == np.float64 else np.cbrt(v.astype(np.float64)).astype(dtype)
    finite = np.isfinite(want)
    npt.assert_array_equal(got[~finite], want[~finite])
    ulps = np.abs(got[finite] - want[finite]) / np.spacing(np.abs(want[finite]))
    assert ulps.max() <= 1
    npt.assert_array_equal(np.signbit(got), np.signbit(want))
    cubes = np.arange(-50, 51).astype(dtype)
    npt.assert_array_equal(got[100_000:100_101], cubes)


def test_numpy_edges_torch_answers_otherwise():
    """Where torch and numpy disagree the port answers as numpy: sign(nan)
    is NaN, an int fmod by 0 is 0, an int power with a negative exponent
    raises, sign of a bool raises, a NaN's searchsorted and digitize place
    it after every number, non-monotonic bins raise."""
    x = np.array([np.nan, -2.0, 0.0, 3.0])
    i = np.array([5, -5, 7, 0], dtype=np.int64)
    df = vaex_tpu_torch.from_arrays(x=x, i=i, b=i > 0).to_device("cpu")
    npt.assert_array_equal(df.evaluate("sign(x)"), np.sign(x))
    with np.errstate(all="ignore"):
        npt.assert_array_equal(df.evaluate("fmod(i, i * 0)"), np.fmod(i, i * 0))
    npt.assert_array_equal(df.evaluate("fmod(i, 3)"), np.fmod(i, 3))
    with pytest.raises(ValueError, match="negative integer powers"):
        df.evaluate("power(i, i)")
    with pytest.raises(ValueError, match="negative integer powers"):
        np.power(i, i)
    with pytest.raises(TypeError):
        df.evaluate("sign(b)")
    with pytest.raises(TypeError):
        np.sign(i > 0)
    for side in ("left", "right"):
        npt.assert_array_equal(df.evaluate(f"searchsorted(x, [0, 1, 2], side={side!r})"),
                               np.searchsorted([0, 1, 2], x, side=side))
    for bins in ([0, 1, 2], [2, 1, 0]):
        for right in (False, True):
            npt.assert_array_equal(df.evaluate(f"digitize(x, {bins}, right={right})"),
                                   np.digitize(x, bins, right=right))
    with pytest.raises(ValueError, match="monotonically"):
        df.evaluate("digitize(x, [0, 2, 1])")
    with pytest.raises(ValueError, match="monotonically"):
        np.digitize(x, [0, 2, 1])


def test_functions_on_the_expression_and_in_statistics(frames):
    """The registry's methods (``df.x.sqrt()``), ``lshift`` / ``rshift`` and
    a function inside a statistic, against vaex_tpu."""
    ref, port = frames
    assert port.f64n.sqrt().expression == ref.f64n.sqrt().expression == "sqrt(f64n)"
    assert port.f64n.arctan2(2).expression == "arctan2(f64n, 2)"
    for expression in ("i64 << 2", "i64 >> 1", "(mi << 3) >> 1"):
        _same(port.evaluate(expression), ref.evaluate(expression), expression)
    _same(port.evaluate((port.i64 << 2) >> 1), ref.evaluate((ref.i64 << 2) >> 1), "shifts")
    for stat in ("mean", "sum", "std", "min", "max", "count"):
        for expression in ("sqrt(abs(f64n))", "log1p(abs(m))", "clip(i64, -1, 2)",
                           "fillna(m, 0)"):
            got = getattr(port, stat)(expression)
            want = getattr(ref, stat)(expression)
            npt.assert_allclose(float(got), float(want), rtol=RTOL, atol=ATOL,
                                err_msg=f"{stat}({expression})")
    assert port.mean("sqrt(i64 * i64)").dtype == np.float64
    assert port.evaluate("sqrt(i64)").dtype == np.float64


def test_functions_on_tensors_keep_their_device():
    """A function of a tensor tile runs where the tensor lives, and a
    Python number joins it there as a 0-dim tensor."""
    fn = expression_namespace["maximum"]
    from vaex_tpu_torch.ops.nullable import NA
    out = fn(NA(torch.arange(4, dtype=torch.int32)), 2)
    assert out.data.dtype == torch.int32 and out.data.device.type == "cpu"
    npt.assert_array_equal(out.data.numpy(), [2, 2, 2, 3])
    out = expression_namespace["clip"](NA(torch.arange(4)), 0.5, 2)
    assert out.data.dtype == torch.float64
