"""The client of a served frame (vaex_tpu/server/client.py).

``connect("ws://host:port")`` lists the served frames and returns a
:class:`Client` mapping each name to a :class:`DataFrameRemote`.  The
remote frame keeps its state (virtual columns, selections, the filter) on
the client and ships it with every call, so ``dfr["v"] = dfr.x * 2;
dfr.sum("v")`` runs on the server's frame with ``v`` added.  The wire is
vaex_tpu's, so this client also talks to vaex_tpu's service.
"""

from __future__ import annotations

import json

import numpy as np

from .service import DummyTransport, decode_result, encode_result  # noqa: F401  (re-exported)


class WebsocketTransport:
    def __init__(self, url):
        from websockets.sync.client import connect as ws_connect
        self._ws = ws_connect(url if url.endswith("/websocket") else url.rstrip("/") + "/websocket")
        self._msg_id = 0

    def request(self, msg, on_progress=None):
        self._msg_id += 1
        msg["msg_id"] = self._msg_id
        self._ws.send(json.dumps(msg))
        while True:
            reply = json.loads(self._ws.recv())
            if reply.get("msg_id") != self._msg_id:
                continue
            if "progress" in reply and "result" not in reply and "error" not in reply:
                if on_progress is not None:
                    on_progress(reply["progress"])
                continue
            return reply

    def close(self):
        self._ws.close()


class Client:
    def __init__(self, transport, token=None, token_trusted=None, on_progress=None):
        self.transport = transport
        self.token = token
        self.token_trusted = token_trusted
        self.on_progress = on_progress
        self._frames = {}
        self.update()

    def _auth(self):
        auth = {}
        if self.token is not None:
            auth["token"] = self.token
        if self.token_trusted is not None:
            auth["token-trusted"] = self.token_trusted
        return auth or None

    def update(self):
        msg = {"command": "list"}
        if self._auth():
            msg["auth"] = self._auth()
        reply = self.transport.request(msg)
        if "error" in reply:
            raise RuntimeError(reply["error"])
        info = decode_result(reply["result"])
        self._frames = {name: DataFrameRemote(self, name, meta) for name, meta in info.items()}

    def __getitem__(self, name):
        return self._frames[name]

    def __iter__(self):
        return iter(self._frames)

    def keys(self):
        return self._frames.keys()

    def _call(self, df_name, method, args=(), kwargs=None, state=None):
        msg = {"command": "call", "df": df_name, "method": method,
               "args": encode_result(list(args)),
               "kwargs": encode_result(dict(kwargs or {})),
               "state": state}
        if self._auth():
            msg["auth"] = self._auth()
        try:
            reply = self.transport.request(msg, on_progress=self.on_progress)
        except TypeError:  # transports without progress support
            reply = self.transport.request(msg)
        if "error" in reply:
            raise RuntimeError(reply["error"] + "\n" + reply.get("traceback", ""))
        return decode_result(reply["result"])

    def close(self):
        if hasattr(self.transport, "close"):
            self.transport.close()


class ExpressionRemote:
    """Operator-overloaded expression against a remote df."""

    def __init__(self, df, expression):
        self.df = df
        self.expression = str(expression)

    def __str__(self):
        return self.expression

    def _binop(self, op, other, reflected=False):
        rhs = other.expression if isinstance(other, ExpressionRemote) else repr(other)
        a, b = (rhs, self.expression) if reflected else (self.expression, rhs)
        return ExpressionRemote(self.df, f"({a} {op} {b})")

    def evaluate(self, i1=None, i2=None):
        return self.df.evaluate(self.expression, i1, i2)

    def tolist(self):
        values = self.evaluate()
        return values.tolist(None) if isinstance(values, np.ma.MaskedArray) else list(values)

    def sum(self, **kw):
        return self.df.sum(self.expression, **kw)

    def mean(self, **kw):
        return self.df.mean(self.expression, **kw)

    def min(self, **kw):
        return self.df.min(self.expression, **kw)

    def max(self, **kw):
        return self.df.max(self.expression, **kw)

    def count(self, **kw):
        return self.df.count(self.expression, **kw)


for _op in ["+", "-", "*", "/", "**", "%", ">", ">=", "<", "<=", "==", "!=", "&", "|"]:
    _names = {"+": "add", "-": "sub", "*": "mul", "/": "truediv", "**": "pow", "%": "mod",
              ">": "gt", ">=": "ge", "<": "lt", "<=": "le", "==": "eq", "!=": "ne",
              "&": "and", "|": "or"}
    _name = _names[_op]
    def _make(op):
        def f(self, other):
            return self._binop(op, other)
        return f
    def _make_r(op):
        def f(self, other):
            return self._binop(op, other, reflected=True)
        return f
    setattr(ExpressionRemote, f"__{_name}__", _make(_op))
    if _name not in ("gt", "ge", "lt", "le", "eq", "ne"):
        setattr(ExpressionRemote, f"__r{_name}__", _make_r(_op))


class DataFrameRemote:
    """Mirrors the DataFrame stats/evaluate surface over the wire."""

    def __init__(self, client, name, meta):
        self.client = client
        self.name = name
        self.column_names = list(meta["column_names"])
        self.dtypes = dict(meta["dtypes"])
        self._row_count = meta["row_count"]
        self.virtual_columns = {}
        self.variables = {}
        self.selections = {}

    # -- local state ---------------------------------------------------------
    def _state(self):
        return {
            "version": 1,
            "column_names": self.column_names + list(self.virtual_columns),
            "virtual_columns": dict(self.virtual_columns),
            "variables": {},
            "selections": {name: sel.encode() for name, sel in self.selections.items()},
            "categories": {},
            "active_range": [0, self._row_count],
        }

    def __setitem__(self, name, expression):
        self.virtual_columns[name] = str(expression)
        if name not in self.column_names:
            self.column_names.append(name)

    def __getitem__(self, name):
        return ExpressionRemote(self, name)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        if name in self.__dict__.get("column_names", ()) or name in self.__dict__.get("virtual_columns", {}):
            return ExpressionRemote(self, name)
        raise AttributeError(name)

    def select(self, expression, mode="replace", name="default"):
        from ..selections import SelectionExpression
        previous = self.selections.get(name)
        self.selections[name] = SelectionExpression(str(expression), previous,
                                                   mode if previous is not None else "replace")

    def filter(self, expression, mode="and"):
        import copy
        from ..encoding import FILTER_SELECTION_NAME
        from ..selections import SelectionExpression
        out = copy.copy(self)
        out.virtual_columns = dict(self.virtual_columns)
        out.selections = dict(self.selections)
        previous = out.selections.get(FILTER_SELECTION_NAME)
        out.selections[FILTER_SELECTION_NAME] = SelectionExpression(
            str(expression), previous, mode if previous is not None else "replace")
        return out

    def get_column_names(self):
        return [n for n in self.column_names if not n.startswith("__")]

    # -- forwarding ----------------------------------------------------------
    def _rmi(self, method, *args, **kwargs):
        return self.client._call(self.name, method, args, kwargs, state=self._state())

    def __len__(self):
        return self._rmi("__len__")

    def count(self, *args, **kwargs):
        return self._rmi("count", *args, **kwargs)

    def sum(self, *args, **kwargs):
        return self._rmi("sum", *args, **kwargs)

    def mean(self, *args, **kwargs):
        return self._rmi("mean", *args, **kwargs)

    def std(self, *args, **kwargs):
        return self._rmi("std", *args, **kwargs)

    def var(self, *args, **kwargs):
        return self._rmi("var", *args, **kwargs)

    def min(self, *args, **kwargs):
        return self._rmi("min", *args, **kwargs)

    def max(self, *args, **kwargs):
        return self._rmi("max", *args, **kwargs)

    def minmax(self, *args, **kwargs):
        return self._rmi("minmax", *args, **kwargs)

    def limits(self, *args, **kwargs):
        return self._rmi("limits", *args, **kwargs)

    def unique(self, *args, **kwargs):
        return self._rmi("unique", *args, **kwargs)

    def nunique(self, *args, **kwargs):
        return self._rmi("nunique", *args, **kwargs)

    def evaluate(self, expression, i1=None, i2=None, **kwargs):
        return self._rmi("evaluate", str(expression), i1, i2)

    def percentile_approx(self, *args, **kwargs):
        return self._rmi("percentile_approx", *args, **kwargs)

    def median_approx(self, *args, **kwargs):
        return self._rmi("median_approx", *args, **kwargs)

    def correlation(self, *args, **kwargs):
        return self._rmi("correlation", *args, **kwargs)

    def mode(self, *args, **kwargs):
        return self._rmi("mode", *args, **kwargs)

    def groupby(self, by, agg="count", sort=True):
        """Remote groupby: agg spec as 'count' or {name: ('sum', 'col')};
        returns {column: numpy array}."""
        wire_agg = agg
        if isinstance(agg, dict):
            wire_agg = {k: (list(v) if isinstance(v, (list, tuple)) else v)
                        for k, v in agg.items()}
        return self._rmi("groupby_agg", by, wire_agg, sort=sort)


def connect(url, token=None, token_trusted=None, on_progress=None) -> Client:
    """The frames served at ``url`` (``ws://localhost:9000``).

    ``token``/``token_trusted`` authenticate against a locked server;
    ``on_progress(fraction)`` receives streamed progress during computations.
    """
    if url.startswith("dummy:"):
        raise ValueError("use Client(DummyTransport(service)) for in-process tests")
    return Client(WebsocketTransport(url), token=token, token_trusted=token_trusted,
                  on_progress=on_progress)
