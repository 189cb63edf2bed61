"""GraphQL on the port's frames (vaex_tpu_torch.graphql) against vaex_tpu's:
the queries of vaex_tpu's own GraphQL tests through both packages, on the
same frame, with the answers compared and held to the frame's statistics."""

import numpy as np
import pytest

import vaex_tpu
import vaex_tpu_torch
from vaex_tpu_torch import graphql, settings
from torch_port_helpers import ATOL, RTOL


@pytest.fixture(autouse=True)
def cpu(monkeypatch):
    monkeypatch.setattr(settings, "DEVICE", "cpu")


def base_arrays():
    """The canonical small frame of vaex_tpu's tests (tests/conftest.py)."""
    x = np.arange(10, dtype="f8")
    return dict(x=x, y=x ** 2, g=np.array([0, 0, 0, 0, 1, 1, 1, 1, 2, 2], dtype="i8"),
                m=np.ma.MaskedArray(x.copy(), x < 2), f=np.where(x == 9, np.nan, x),
                i=np.arange(10, dtype="i4"),
                name=np.asarray([f"n{int(v) % 3}" for v in x], dtype=object))


@pytest.fixture
def frames():
    return (vaex_tpu.from_arrays(**base_arrays()),
            vaex_tpu_torch.from_arrays(**base_arrays()).to_device("cpu"))


def same(a, b, where="data"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), where
        for k in a:
            same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{where}[{i}]")
    elif isinstance(a, float) and not isinstance(a, bool):
        assert b == pytest.approx(a, rel=RTOL, abs=ATOL, nan_ok=True), where
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


QUERIES = {
    "aggregates": "{ df { count min { x y } mean { x y } max { x y } } }",
    "sum_std_var": "{ df { sum { x i } std { y } var { f } } }",
    "groupby": "{ df { groupby { g { count keys min { x } } } } }",
    "groupby_stats": "{ df { groupby { g { mean { x y } max { i } sum { y } } } } }",
    "nested_groupby": "{ df { groupby { g { name { count } } } } }",
    "nested_groupby_keys": "{ df { groupby { name { count keys g { count mean { x } } } } } }",
    "rows": "{ df { row { x } } }",
    "rows_offset": "{ df { row(offset: 2) { x } } }",
    "rows_limit": "{ df { row(limit: 2) { x g } } }",
    "rows_both": "{ df { row(offset: 3, limit: 2) { x name } } }",
    "rows_masked": "{ df { row(limit: 4) { m f } } }",
    "where_eq": "{ df(where: {x: {_eq: 4}}) { row { x } } }",
    "where_or": "{ df(where: {_or: [{x: {_eq: 4}}, {x: {_eq: 5}}]}) { count } }",
    "where_not": "{ df(where: {_not: {x: {_lt: 8}}}) { count } }",
    "where_string": '{ df(where: {name: {_eq: "n0"}}) { count } }',
    "where_in": "{ df(where: {g: {_in: [0, 2]}}) { count mean { y } } }",
    "where_and": "{ df(where: {_and: [{x: {_gte: 2}}, {y: {_lte: 49}}]}) { count min { x } } }",
    "where_neq_gt": "{ df(where: {g: {_neq: 1}, x: {_gt: 1.5}}) { count sum { x } } }",
    "alias_query": "query Foo { frame: df { n: count } }",
    "comments": "# a comment\n{ df { count, mean { x } } }",
    "where_groupby": "{ df(where: {g_mag_missing: {_lt: 15}}) { count } }",
    "unbalanced": "{ df { count }",
    "unknown_field": "{ df { nosuchfield } }",
    "unknown_frame": "{ nosuchframe { count } }",
    "bad_character": "{ df { count } } $",
    "bad_operator": "{ df(where: {x: {_like: 3}}) { count } }",
}


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_execute(frames, name):
    ref, port = (df.graphql.execute(QUERIES[name]) for df in frames)
    assert bool(ref.errors) == bool(port.errors), (ref, port)
    if ref.errors:
        assert port.data is None
    else:
        same(ref.data, port.data)


def test_execute_against_the_frame(frames):
    """vaex_tpu's assertions (tests/test_misc.py:110-289) on the port."""
    df = frames[1]
    data = df.graphql.execute("{ df { count min { x y } mean { x y } max { x y } } }").data
    assert data["df"]["count"] == len(df)
    assert data["df"]["min"]["y"] == df.min("y") and data["df"]["max"]["x"] == df.max("x")
    assert data["df"]["mean"]["x"] == df.mean("x")
    data = df.graphql.execute("{ df { groupby { g { count keys min { x } } } } }").data
    dfg = df.groupby("g", agg={"xmin": vaex_tpu_torch.agg.min("x")}, sort=True)
    assert data["df"]["groupby"]["g"]["min"]["x"] == dfg["xmin"].tolist()
    assert data["df"]["groupby"]["g"]["keys"] == dfg["g"].tolist()
    assert data["df"]["groupby"]["g"]["count"] == df.groupby(
        "g", agg="count", sort=True)["count"].tolist()
    nested = df.graphql.execute("{ df { groupby { g { name { count } } } } }").data
    assert nested["df"]["groupby"]["g"]["name"]["count"] == df.groupby(
        ["g", "name"], agg="count", sort=True)["count"].tolist()
    rows = df.graphql.execute("{ df { row(offset: 3, limit: 2) { x } } }").data["df"]["row"]
    assert [r["x"] for r in rows] == df[3:5].x.tolist()
    assert df.graphql.execute(
        '{ df(where: {name: {_eq: "n0"}}) { count } }').data["df"]["count"] == 4


DICT_QUERIES = [
    {"where": {"x": {"_gt": 4}}, "count": True, "mean": ["x"],
     "groupby": {"by": ["g"], "agg": {"x": "sum"}}},
    {"where": {"name": {"_eq": "n0"}}, "count": True},
    {"where": {"_or": [{"x": {"_lt": 1}}, {"x": {"_gte": 9}}]}, "count": True},
    {"where": {"g": {"_in": [0, 2]}}, "count": True, "max": "y", "std": ["x", "y"]},
    {"row": {"offset": 2, "limit": 2, "columns": ["x", "g"]}},
    {"groupby": {"by": ["g", "name"], "agg": "count"}, "sum": ["i"]},
]


@pytest.mark.parametrize("case", range(len(DICT_QUERIES)))
def test_query_dict(frames, case):
    ref, port = (df.graphql.query(DICT_QUERIES[case]) for df in frames)
    same(ref, port)


def test_query_dict_answers(frames):
    out = frames[1].graphql.query(DICT_QUERIES[0])
    assert out["count"] == 5 and out["mean"]["x"] == np.mean(np.arange(5, 10.0))
    assert out["groupby"]["g"] == [1, 2] and out["groupby"]["x"] == [5.0 + 6 + 7, 8.0 + 9]
    assert frames[1].graphql.query(DICT_QUERIES[4])["rows"] == [{"x": 2.0, "g": 0},
                                                                {"x": 3.0, "g": 0}]


def test_where_runs_on_the_frame(frames):
    """A where clause is the frame's filter: the statistics below it run
    as passes of the port, as frames[1].filter(...) would."""
    df = frames[1]
    passes = df.executor.passes
    data = df.graphql.execute("{ df(where: {x: {_gt: 2}}) { count mean { y } } }").data
    assert df.executor.passes > passes
    assert data["df"] == {"count": 7, "mean": {"y": float(df.filter("x > 2").mean("y"))}}
    assert graphql._where_expression(df, {"x": {"_gt": 2}, "_not": {"g": {"_eq": 1}}}) == (
        "((x > 2)) & (~(((g == 1))))")


def test_phase25_query(frames):
    """The query chip_smoke.py's phase 25 serves, on a frame of its
    columns, through both packages."""
    rng = np.random.default_rng(25)
    n = 2000
    arrays = dict(key=rng.integers(0, 10, n).astype(np.int64), x=rng.normal(0, 1, n),
                  g_mag=rng.normal(15, 2, n).astype(np.float32))
    query = ("{ df(where: {g_mag: {_lt: 15}}) { count mean { x } "
             "groupby { key { count mean { x } } } } }")
    ref = vaex_tpu.from_arrays(**arrays).categorize("key", labels=list(range(10)))
    port = vaex_tpu_torch.from_arrays(**arrays).to_device("cpu").categorize(
        "key", labels=list(range(10)))
    got, want = port.graphql.execute(query), ref.graphql.execute(query)
    assert not got.errors
    same(want.data, got.data)
    keep = arrays["g_mag"] < 15
    assert got.data["df"]["count"] == int(keep.sum())
    assert got.data["df"]["groupby"]["key"]["count"] == np.bincount(
        arrays["key"][keep], minlength=10).tolist()


def test_parser():
    fields = graphql.parse_query('query Q { a: df(where: {s: {_eq: "q\\"x"}}, n: -1.5e2) '
                                 '{ row(limit: 2) { x } } }')
    [df] = fields
    assert df["alias"] == "a" and df["name"] == "df"
    assert df["args"] == {"where": {"s": {"_eq": 'q"x'}}, "n": -150.0}
    assert df["selections"][0]["args"] == {"limit": 2}
    with pytest.raises(graphql.GraphQLSyntaxError):
        graphql.parse_query('{ df(where: {s: {_eq: "open')


def test_schema_sdl(frames):
    ref, port = (df.graphql.schema_sdl() for df in frames)
    assert port == ref
    assert "type Query" in port and "input DataFrameWhere" in port


def test_schema_graphene(frames):
    pytest.importorskip("graphene")
    schema = frames[1].graphql.schema()
    result = schema.execute("{ df(where: {x: {_gt: 4}}) { count mean { x } } }")
    assert not result.errors and result.data["df"]["count"] == 5
