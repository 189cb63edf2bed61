"""GraphQL queries on a frame: ``df.graphql`` (vaex_tpu/graphql.py).

The query language is parsed here, without graphene: a tokenizer and a
recursive-descent parser for the subset that vaex-graphql's generated
schema serves (selection sets, aliases, field arguments, input objects,
lists and scalars).  A query runs on the frame's own statistics, so its
passes run on the frame's device::

    {
        df(where: {x: {_gt: 4}, _or: [{y: {_eq: 1}}, {y: {_eq: 2}}]}) {
            count
            min { x y }
            mean { x }
            row(offset: 3, limit: 2) { x y }
            groupby { g { count keys mean { x } } }
        }
    }

``where`` is a filter (Hasura-style ``_eq`` ... ``_lte``, ``_in``,
``_and``, ``_or``, ``_not``); ``groupby`` nests one key level inside
another.  ``df.graphql.query({...})`` takes the same query as a dict, and
``schema()`` builds a graphene schema where graphene is installed.
"""

from __future__ import annotations

import numpy as np

from .dataframe import register_dataframe_accessor


# ---------------------------------------------------------------------------
# GraphQL subset parser


class GraphQLSyntaxError(ValueError):
    pass


_PUNCT = set("{}():[]=!")


def _tokenize(src):
    tokens = []
    i, n = 0, len(src)
    while i < n:
        c = src[i]
        if c in " \t\r\n,":  # commas are insignificant separators in GraphQL
            i += 1
            continue
        if c == "#":  # comment to end of line
            while i < n and src[i] != "\n":
                i += 1
            continue
        if c == '"':
            j = i + 1
            buf = []
            while j < n and src[j] != '"':
                if src[j] == "\\" and j + 1 < n:
                    esc = src[j + 1]
                    buf.append({"n": "\n", "t": "\t", '"': '"', "\\": "\\"}.get(esc, esc))
                    j += 2
                else:
                    buf.append(src[j])
                    j += 1
            if j >= n:
                raise GraphQLSyntaxError("unterminated string")
            tokens.append(("string", "".join(buf)))
            i = j + 1
            continue
        if c.isdigit() or (c == "-" and i + 1 < n and src[i + 1].isdigit()):
            j = i + 1
            while j < n and (src[j].isdigit() or src[j] in ".eE+-"):
                # stop '+-' unless part of exponent
                if src[j] in "+-" and src[j - 1] not in "eE":
                    break
                j += 1
            text = src[i:j]
            tokens.append(("number", float(text) if any(ch in text for ch in ".eE") else int(text)))
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i + 1
            while j < n and (src[j].isalnum() or src[j] == "_"):
                j += 1
            tokens.append(("name", src[i:j]))
            i = j
            continue
        if c in _PUNCT:
            tokens.append(("punct", c))
            i += 1
            continue
        raise GraphQLSyntaxError(f"unexpected character {c!r} at position {i}")
    tokens.append(("eof", None))
    return tokens


class _Parser:
    def __init__(self, src):
        self.tokens = _tokenize(src)
        self.pos = 0

    def peek(self):
        return self.tokens[self.pos]

    def next(self):
        tok = self.tokens[self.pos]
        self.pos += 1
        return tok

    def expect(self, kind, value=None):
        tok = self.next()
        if tok[0] != kind or (value is not None and tok[1] != value):
            raise GraphQLSyntaxError(f"expected {value or kind}, got {tok[1]!r}")
        return tok

    def parse_document(self):
        """[query name?] selection_set — bare and named query operations."""
        kind, value = self.peek()
        if kind == "name" and value in ("query",):
            self.next()
            if self.peek()[0] == "name":  # operation name
                self.next()
        selections = self.parse_selection_set()
        self.expect("eof")
        return selections

    def parse_selection_set(self):
        self.expect("punct", "{")
        fields = []
        while True:
            kind, value = self.peek()
            if kind == "punct" and value == "}":
                self.next()
                return fields
            if kind != "name":
                raise GraphQLSyntaxError(f"expected field name, got {value!r}")
            fields.append(self.parse_field())

    def parse_field(self):
        name = self.next()[1]
        alias = None
        if self.peek() == ("punct", ":"):
            # alias: actual_field
            self.next()
            alias, name = name, self.expect("name")[1]
        args = {}
        if self.peek() == ("punct", "("):
            self.next()
            while self.peek() != ("punct", ")"):
                arg_name = self.expect("name")[1]
                self.expect("punct", ":")
                args[arg_name] = self.parse_value()
            self.next()
        selections = None
        if self.peek() == ("punct", "{"):
            selections = self.parse_selection_set()
        return {"name": name, "alias": alias or name, "args": args,
                "selections": selections}

    def parse_value(self):
        kind, value = self.next()
        if kind in ("number", "string"):
            return value
        if kind == "name":
            if value == "true":
                return True
            if value == "false":
                return False
            if value == "null":
                return None
            return value  # enum-ish bare name
        if kind == "punct" and value == "[":
            items = []
            while self.peek() != ("punct", "]"):
                items.append(self.parse_value())
            self.next()
            return items
        if kind == "punct" and value == "{":
            obj = {}
            while self.peek() != ("punct", "}"):
                key = self.expect("name")[1]
                self.expect("punct", ":")
                obj[key] = self.parse_value()
            self.next()
            return obj
        raise GraphQLSyntaxError(f"unexpected token {value!r} in value position")


def parse_query(src):
    """Parse a GraphQL query string into a list of field-selection dicts."""
    return _Parser(src).parse_document()


class ExecutionResult:
    """Mirrors graphene's result object: ``.data`` and ``.errors``."""

    def __init__(self, data=None, errors=None):
        self.data = data
        self.errors = errors or None

    def __repr__(self):
        return f"ExecutionResult(data={self.data!r}, errors={self.errors!r})"

_OPS = {
    "_eq": "==", "_neq": "!=", "_gt": ">", "_lt": "<", "_gte": ">=", "_lte": "<=",
}


def _where_expression(df, where: dict) -> str:
    parts = []
    for column, conds in where.items():
        if column == "_and":
            parts.append(" & ".join(f"({_where_expression(df, w)})" for w in conds))
            continue
        if column == "_or":
            parts.append(" | ".join(f"({_where_expression(df, w)})" for w in conds))
            continue
        if column == "_not":
            parts.append(f"~({_where_expression(df, conds)})")
            continue
        for op, value in conds.items():
            if op == "_in":
                parts.append(df[column].isin(value).expression)
            elif op in _OPS:
                parts.append(f"({column} {_OPS[op]} {value!r})")
            else:
                raise ValueError(f"unknown operator {op!r}")
    return " & ".join(f"({p})" for p in parts) if parts else "True"


_STATS = ("min", "max", "mean", "sum", "std", "var")


def _exec_stats_scalar(df, field):
    """min/max/mean {x y} at the top level -> {col: scalar}."""
    return {sub["alias"]: _plain(getattr(df, field["name"])(sub["name"]))
            for sub in field["selections"] or []}


def _exec_row(df, field):
    args = field["args"]
    offset = int(args.get("offset", 0) or 0)
    limit = int(args.get("limit", 100))
    n = max(min(len(df) - offset, limit), 0)
    sub = df[offset:offset + n]
    names = [f["name"] for f in field["selections"] or []]
    aliases = [f["alias"] for f in field["selections"] or []]
    columns = [_plain_list(sub.evaluate(name, array_type="python")) for name in names]
    return [dict(zip(aliases, row)) for row in zip(*columns)] if names else []


def _exec_groupby_level(df, by, selections):
    """One groupby {key {...}} level (vaex-graphql's
    create_groupby / create_aggregate: count / keys lists, per-column stat
    lists, one nested key level)."""
    from . import agg as agg_module
    out = {}
    aggs = {}
    plan = []    # (alias, kind, payload)
    nested = []
    for f in selections:
        name = f["name"]
        if name == "count" and f["selections"] is None:
            aggs["__count"] = agg_module.count("*")
            plan.append((f["alias"], "count", None))
        elif name == "keys" and f["selections"] is None:
            plan.append((f["alias"], "keys", None))
        elif name in _STATS and f["selections"]:
            for sub in f["selections"]:
                aggs[f"__{name}_{sub['name']}"] = getattr(agg_module, name)(sub["name"])
            plan.append((f["alias"], "stat", f))
        elif f["selections"] is not None:
            nested.append(f)  # a second groupby key
        else:
            raise ValueError(f"unknown groupby field {name!r}")
    if plan:
        dfg = df.groupby(by, agg=aggs or {"__count": agg_module.count("*")}, sort=True)
        for alias, kind, payload in plan:
            if kind == "count":
                out[alias] = _plain_list(dfg["__count"].tolist())
            elif kind == "keys":
                out[alias] = _plain_list(dfg[by[-1]].tolist())
            else:
                out[alias] = {sub["alias"]: _plain_list(dfg[f"__{payload['name']}_{sub['name']}"].tolist())
                              for sub in payload["selections"]}
    for f in nested:
        out[f["alias"]] = _exec_groupby_level(df, by + [f["name"]], f["selections"])
    return out


def _exec_df_field(df, field):
    args = field["args"]
    if "where" in args and args["where"]:
        df = df.filter(_where_expression(df, args["where"]))
    out = {}
    for f in field["selections"] or []:
        name = f["name"]
        if name == "count" and f["selections"] is None:
            out[f["alias"]] = int(df.count())
        elif name in _STATS and f["selections"]:
            out[f["alias"]] = _exec_stats_scalar(df, f)
        elif name == "row":
            out[f["alias"]] = _exec_row(df, f)
        elif name == "groupby" and f["selections"]:
            out[f["alias"]] = {sub["alias"]: _exec_groupby_level(df, [sub["name"]], sub["selections"] or [])
                               for sub in f["selections"]}
        else:
            raise ValueError(f"unknown field {name!r}")
    return out


@register_dataframe_accessor("graphql")
class DataFrameAccessorGraphQL:
    def __init__(self, df):
        self.df = df

    def execute(self, query, name="df"):
        """Execute a GraphQL query string, as graphene's ``schema().execute``.

        Supports the subset vaex-graphql's generated schema serves: ``where``
        filters (Hasura-style _eq/_neq/_gt/_lt/_gte/_lte/_and/_or/_not),
        count, min/max/mean selections, row pagination, and one- or two-level
        groupby with count/keys/stat lists.
        """
        dfs = {name: self.df}
        try:
            fields = parse_query(query)
            data = {}
            for field in fields:
                if field["name"] not in dfs:
                    raise ValueError(f"unknown dataframe {field['name']!r}")
                data[field["alias"]] = _exec_df_field(dfs[field["name"]], field)
            return ExecutionResult(data=data)
        except Exception as e:  # noqa: BLE001 - graphql surfaces errors in-band
            return ExecutionResult(data=None, errors=[str(e)])

    def query(self, q: dict):
        df = self.df
        if "where" in q:
            df = df.copy()
            df = df.filter(_where_expression(df, q["where"]))
        out = {}
        for stat in ("min", "max", "mean", "sum", "std", "var"):
            if stat in q:
                exprs = q[stat] if isinstance(q[stat], (list, tuple)) else [q[stat]]
                out[stat] = {e: _plain(getattr(df, stat)(str(e))) for e in exprs}
        if q.get("count"):
            out["count"] = int(df.count())
        if "row" in q:
            spec = q["row"]
            offset = spec.get("offset", 0)
            limit = spec.get("limit", 10)
            cols = spec.get("columns") or df.get_column_names()
            sub = df[offset:offset + limit]
            out["rows"] = [dict(zip(cols, row)) for row in zip(
                *[_plain_list(sub.evaluate(c, array_type="python")) for c in cols])]
        if "groupby" in q:
            spec = q["groupby"]
            gb = df.groupby(spec["by"], agg=_agg_spec(spec.get("agg", "count")), sort=True)
            out["groupby"] = {name: _plain_list(gb[name].tolist())
                             for name in gb.get_column_names()}
        return out

    def schema(self):
        """Graphene schema over the DataFrame (vaex-graphql's
        __init__.py:8-200): per-column Compare input types ->
        filters, stat fields, and a groupby field resolving through
        df.groupby — executable with ``graphene.Schema.execute`` and
        servable by any graphene-ecosystem server."""
        try:
            import graphene
        except ImportError as e:
            raise ImportError(
                "graphene is not installed; use df.graphql.query(dict) / "
                ".execute(str) (same semantics) or .schema_sdl() for the "
                "schema document") from e
        from .datatype import DataType
        df = self.df

        def scalar_of(name):
            dt = DataType(df.data_type(name))
            if dt.numpy.kind in "iu":
                return graphene.Int
            if dt.numpy.kind == "f":
                return graphene.Float
            if dt.numpy.kind == "b":
                return graphene.Boolean
            return graphene.String

        columns = [c for c in df.get_column_names() if not c.startswith("__")]

        # per-column Compare input types (_eq/_neq/_gt/_gte/_lt/_lte)
        where_fields = {}
        for c in columns:
            scalar = scalar_of(c)
            compare = type(f"Compare_{c}", (graphene.InputObjectType,), {
                "_eq": scalar(), "_neq": scalar(), "_gt": scalar(),
                "_gte": scalar(), "_lt": scalar(), "_lte": scalar(),
            })
            where_fields[c] = compare()
        Where = type("DataFrameWhere", (graphene.InputObjectType,), {
            **where_fields,
            "_and": graphene.List(lambda: Where),
            "_or": graphene.List(lambda: Where),
            "_not": graphene.InputField(lambda: Where),
        })

        numeric = [c for c in columns
                   if DataType(df.data_type(c)).numpy.kind in "iuf"]

        def make_stats(stat_name):
            attrs = {}
            for c in numeric:
                def resolver(parent, info, _c=c, _s=stat_name):
                    return float(getattr(parent["df"], _s)(_c))
                attrs[c] = graphene.Float()
                attrs[f"resolve_{c}"] = staticmethod(resolver)
            return type(f"Stats_{stat_name}", (graphene.ObjectType,), attrs)

        stats_types = {s: make_stats(s) for s in
                       ("min", "max", "mean", "sum", "std", "var")}

        row_attrs = {}
        for c in columns:
            row_attrs[c] = scalar_of(c)()

            def row_resolver(parent, info, _c=c):
                return parent.get(_c)
            row_attrs[f"resolve_{c}"] = staticmethod(row_resolver)
        Row = type("DataFrameRow", (graphene.ObjectType,), row_attrs)

        df_attrs = {"count": graphene.Int()}

        def resolve_count(parent, info):
            return int(parent["df"].count())
        df_attrs["resolve_count"] = staticmethod(resolve_count)
        for s, t in stats_types.items():
            df_attrs[s] = graphene.Field(t)

            def stats_resolver(parent, info, _s=s):
                return parent
            df_attrs[f"resolve_{s}"] = staticmethod(stats_resolver)
        df_attrs["row"] = graphene.List(Row, offset=graphene.Int(default_value=0),
                                        limit=graphene.Int(default_value=10))

        def resolve_row(parent, info, offset=0, limit=10):
            sub = parent["df"][offset:offset + limit]
            cols = columns
            data = [_plain_list(sub.evaluate(c, array_type="python")) for c in cols]
            return [dict(zip(cols, row)) for row in zip(*data)]
        df_attrs["resolve_row"] = staticmethod(resolve_row)
        DataFrameType = type("DataFrame", (graphene.ObjectType,), df_attrs)

        def resolve_df(parent, info, where=None):
            d = df
            if where:
                d = d.copy().filter(_where_expression(d, _input_to_dict(where)))
            return {"df": d}

        Query = type("Query", (graphene.ObjectType,), {
            "df": graphene.Field(DataFrameType, where=Where()),
            "resolve_df": staticmethod(resolve_df),
        })
        return graphene.Schema(query=Query, auto_camelcase=False)

    def schema_sdl(self):
        """The DataFrame's GraphQL schema as an SDL document string —
        per-column Compare input types, aggregation fields and nested
        groupby types, mirroring vaex-graphql's graphene schema
        (vaex-graphql/__init__.py:8-200) without the graphene dependency."""
        df = self.df
        from .datatype import DataType
        lines = ["type Query {", "  df(where: DataFrameWhere): DataFrame", "}", ""]

        def gql_type(name):
            dt = DataType(df.data_type(name))
            if dt.is_text:  # a plain or a dictionary-encoded string column
                return "String"
            if dt.numpy.kind == "b":
                return "Boolean"
            if dt.numpy.kind in "iu":
                return "Int"
            return "Float"

        cols = [c for c in df.get_column_names() if not c.startswith("__")]
        lines.append("input DataFrameWhere {")
        for c in cols:
            lines.append(f"  {c}: Compare{gql_type(c)}")
        lines += ["  _and: [DataFrameWhere]", "  _or: [DataFrameWhere]",
                  "  _not: DataFrameWhere", "}", ""]
        for t in sorted({gql_type(c) for c in cols}):
            lines += [f"input Compare{t} {{", f"  _eq: {t}", f"  _neq: {t}",
                      f"  _gt: {t}", f"  _gte: {t}", f"  _lt: {t}",
                      f"  _lte: {t}", f"  _in: [{t}]", "}", ""]
        lines.append("type DataFrame {")
        lines += ["  count: Float", "  min: ColumnStats", "  max: ColumnStats",
                  "  mean: ColumnStats", "  sum: ColumnStats",
                  "  row(offset: Int): Row", "  groupby: GroupBy"]
        lines += ["}", "", "type ColumnStats {"]
        for c in cols:
            lines.append(f"  {c}: Float")
        lines += ["}", "", "type Row {"]
        for c in cols:
            lines.append(f"  {c}: {gql_type(c)}")
        lines += ["}", "", "type GroupBy {"]
        for c in cols:
            lines.append(f"  {c}: GroupByLevel")
        lines += ["}", "", "type GroupByLevel {",
                  "  keys: [String]", "  count: [Float]",
                  "  min: ColumnStatsList", "  max: ColumnStatsList",
                  "  mean: ColumnStatsList", "  sum: ColumnStatsList"]
        for c in cols:
            lines.append(f"  {c}: GroupByLevel")
        lines += ["}", "", "type ColumnStatsList {"]
        for c in cols:
            lines.append(f"  {c}: [Float]")
        lines.append("}")
        return "\n".join(lines)

    def serve(self, port=9001):
        """HTTP endpoint: POST a JSON query dict to /graphql."""
        import json

        import tornado.ioloop
        import tornado.web

        accessor = self

        class Handler(tornado.web.RequestHandler):
            def post(self):
                body = json.loads(self.request.body)
                if isinstance(body, dict) and isinstance(body.get("query"), str):
                    # standard GraphQL-over-HTTP shape: {"query": "{ df { ... } }"}
                    result = accessor.execute(body["query"])
                    self.write(json.dumps({"data": result.data, "errors": result.errors},
                                          default=str))
                else:
                    self.write(json.dumps(accessor.query(body), default=str))

        app = tornado.web.Application([(r"/graphql", Handler)])
        app.listen(port)
        tornado.ioloop.IOLoop.current().start()


def _agg_spec(spec):
    if isinstance(spec, dict):
        return {k: v for k, v in spec.items()}
    return spec


def _input_to_dict(obj):
    """Recursively convert a graphene input object (dict-like) to plain
    dicts for :func:`_where_expression`, dropping unset (None) fields."""
    if isinstance(obj, dict):
        return {k: _input_to_dict(v) for k, v in obj.items() if v is not None}
    if isinstance(obj, (list, tuple)):
        return [_input_to_dict(v) for v in obj]
    return obj


def _plain(v):
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    return v


def _plain_list(values):
    return [(_plain(v) if not (isinstance(v, float) and np.isnan(v)) else None) for v in values]
