"""Every host-only function of the port (41 ``str_*``, 19 ``dt_*``, 5
``td_*``, ``format`` and ``to_string``) against vaex_tpu on the same seeded
columns: strings (empty ones, non-ASCII, padded, nulls) in three forms
(plain, dictionary-encoded, staged), datetimes and timedeltas with NaT at
the s, ms and ns units.  Results are equal; a float result
(``td_total_seconds``) to 1e-12 relative.

Where vaex_tpu raises (``str_index_of``, ``str_extract_regex`` and
``str_count_substring`` of a dictionary column, which it does not run per
label; a ``dt_*`` function whose result is a string or a date over a column
with NaT), the port is held to vaex_tpu's answer on the plain strings, or
to pandas with NaT rows missing (ROADMAP, known problems)."""

import numpy as np
import pytest

import vaex_tpu
import vaex_tpu_torch
from torch_port_helpers import (STRING_FORMS, assert_same_list, host_list, string_arrays,
                                string_frames)
from vaex_tpu.registry import expression_namespace as ref_device
from vaex_tpu.registry import expression_namespace_host as ref_host
from vaex_tpu_torch import settings
from vaex_tpu_torch.registry import expression_namespace, expression_namespace_host

N = 600

# each str_* function with the arguments of its case(s)
STRING_CASES = {
    **{name: [""] for name in (
        "capitalize", "lower", "upper", "title", "swapcase", "isalnum", "isalpha", "isdigit",
        "isspace", "islower", "isupper", "istitle", "len", "byte_length", "reverse",
        "trim_whitespace", "isnumeric", "len_unicode", "strip", "lstrip", "rstrip")},
    "contains": ["'a'", "'é', regex=False", "'^[a-z]+$'"],
    "startswith": ["'a'"], "endswith": ["'b'"], "match": ["'a.*'", "'a%'"],
    "equals": ["'ab'"], "count": ["'a'", "'.', regex=False"], "find": ["'b'"],
    "replace": ["'a', 'X'", "'[ab]', '-', regex=True", "'a', 'Y', n=1"],
    "slice": ["1, 3", "0"], "pad": ["5", "6, side='right', fillchar='*'", "7, side='both'"],
    "ljust": ["5"], "rjust": ["5, fillchar='.'"], "zfill": ["4"], "repeat": ["2"],
    "cat": ["'!'", "t"], "split": ["'b'", "' ', max_splits=1"], "index_of": ["'a'"],
    "extract_regex": ["'(?P<first>[a-z])'"], "count_substring": ["'a'"],
}
STRING_CASES["strip"] = ["", "' a'"]
STRING_CASES["lstrip"] = ["", "'a'"]
STRING_CASES["rstrip"] = ["", "'d '"]
DT_PROPS = ["year", "month", "day", "hour", "minute", "second", "microsecond", "nanosecond",
            "dayofweek", "dayofyear", "daysinmonth", "quarter", "is_leap_year", "date",
            "weekofyear"]
DT_METHODS = {"strftime": "'%Y-%m-%d %H:%M'", "floor": "'h'", "day_name": "",
              "month_name": ""}
TD_FUNCTIONS = {"days": "", "seconds": "", "microseconds": "", "nanoseconds": "",
                "total_seconds": ""}


@pytest.fixture(autouse=True)
def cpu(monkeypatch):
    """Frames that are not staged run their passes on the CPU."""
    monkeypatch.setattr(settings, "DEVICE", "cpu")


@pytest.fixture(scope="module", params=STRING_FORMS)
def strings(request):
    return string_frames(string_arrays(31, N), request.param)


def test_the_host_only_functions_are_the_references():
    """69 host-only names, those of vaex_tpu: struct_get and struct_project
    among them since ROADMAP A13a."""
    port = set(expression_namespace_host) - set(expression_namespace)
    ref = set(ref_host) - set(ref_device)
    assert len(port) == 69
    assert port == ref
    assert {"struct_get", "struct_project"} <= port
    assert {n[:3] for n in port} >= {"str", "dt_", "td_"}
    assert sum(n.startswith("str_") for n in port) == 41
    assert sum(n.startswith("dt_") for n in port) == 19
    assert sum(n.startswith("td_") for n in port) == 5


def _same(ref, port, expression, rtol=0.0, fallback=None):
    """The port's values against vaex_tpu's, or, where vaex_tpu raises, the
    ``fallback`` callable's."""
    try:
        want = host_list(ref.evaluate(expression))
    except Exception:  # noqa: BLE001 - a fault of the reference, named above
        if fallback is None:
            raise
        want = fallback()
    got = host_list(port.evaluate(expression))
    assert_same_list(got, want, rtol)


@pytest.fixture(scope="module")
def plain_reference():
    return string_frames(string_arrays(31, N), "plain")[0]


@pytest.mark.parametrize("case", [(name, args) for name, cases in STRING_CASES.items()
                                  for args in cases], ids=lambda c: f"{c[0]}({c[1]})")
def test_string_function(strings, plain_reference, case):
    name, args = case
    ref, port = strings
    expression = f"str_{name}(s{', ' + args if args else ''})"
    _same(ref, port, expression,
          fallback=lambda: host_list(plain_reference.evaluate(expression)))


def test_string_join_of_a_split(strings):
    ref, port = strings
    _same(ref, port, "str_join(str_split(s, 'b'), '-')")


def test_every_string_function_has_a_case():
    names = {n[4:] for n in expression_namespace_host if n.startswith("str_")}
    assert names == set(STRING_CASES) | {"join"}


def test_string_methods_through_the_accessor(strings):
    """``df.s.str.upper()`` is ``str_upper(s)``; ``str_pandas`` the same."""
    ref, port = strings
    assert port.s.str.upper().expression == "str_upper(s)"
    assert port.s.str_pandas.len().expression == "str_len(s)"
    assert_same_list(host_list(port.s.str.contains("a", regex=False).evaluate()),
                     host_list(ref.s.str.contains("a", regex=False).evaluate()))


def _temporal_arrays(unit, seed=7, n=N):
    rng = np.random.default_rng(seed)
    span = {"s": 10 ** 9, "ms": 10 ** 12, "ns": 10 ** 17}[unit]
    d = rng.integers(-span, span, n).astype(f"M8[{unit}]")
    d[::13] = np.datetime64("NaT")
    td = rng.integers(-span // 1000, span // 1000, n).astype(f"m8[{unit}]")
    td[::11] = np.timedelta64("NaT")
    return {"d": d, "td": td, "x": rng.normal(0, 1, n)}


@pytest.fixture(scope="module", params=["s", "ms", "ns"])
def temporal(request):
    arrays = _temporal_arrays(request.param)
    return (vaex_tpu.from_arrays(**arrays),
            vaex_tpu_torch.from_arrays(**arrays).to_device("cpu"))


def _pandas(port, attr, *args):
    """pandas' answer over the port's datetimes, a NaT row missing."""
    import pandas as pd
    d = np.asarray(port.evaluate("d"))
    value = getattr(pd.Series(d).dt, attr)
    value = value(*args) if callable(value) else value
    return [None if nat else v for v, nat in zip(value.tolist(), np.isnat(d))]


@pytest.mark.parametrize("name", DT_PROPS)
def test_datetime_property(temporal, name):
    ref, port = temporal
    _same(ref, port, f"dt_{name}(d)", fallback=lambda: _pandas(port, name))
    assert getattr(port.d.dt, name).expression == f"dt_{name}(d)"


@pytest.mark.parametrize("name", sorted(DT_METHODS))
def test_datetime_method(temporal, name):
    ref, port = temporal
    args = DT_METHODS[name]
    _same(ref, port, f"dt_{name}(d{', ' + args if args else ''})",
          fallback=lambda: _pandas(port, name, *([eval(args)] if args else [])))


@pytest.mark.parametrize("name", sorted(TD_FUNCTIONS))
def test_timedelta_function(temporal, name):
    ref, port = temporal
    _same(ref, port, f"td_{name}(td)", rtol=1e-12 if name == "total_seconds" else 0.0)


def test_format_and_to_string():
    arrays = string_arrays(5, 200)
    arrays["xm"] = np.ma.MaskedArray(arrays["x"], arrays["iv"] > 50)
    ref = vaex_tpu.from_arrays(**arrays)
    port = vaex_tpu_torch.from_arrays(**arrays).to_device("cpu")
    for expression in ("format(x, '{:.3f}')", "to_string(iv)", "to_string(xm)",
                       "format(iv, '{:+d}')"):
        _same(ref, port, expression)


def test_a_staged_string_function_keeps_the_dictionary():
    """On a staged column a string function runs once per label and keeps
    the codes: its result is a dictionary array."""
    _, port = string_frames(string_arrays(3, 300), "staged")
    out = port.evaluate("str_upper(s)")
    assert hasattr(out, "dictionary") and len(out.dictionary) <= 16
    assert port.data_type("str_upper(s)").is_encoded
