"""The port's server (vaex_tpu_torch.server) against vaex_tpu's: the same
wire messages through both services, every ASGI route through both apps,
each package's client against the other's service, and the two faults of
vaex_tpu's app that the port does not copy (the query string read without
percent-decoding, tokens compared with ``==``)."""

import asyncio
import hmac
import json
import socket
import threading
import time
import urllib.parse

import numpy as np
import numpy.testing as npt
import pytest

import vaex_tpu
import vaex_tpu_torch
from vaex_tpu.server import asgi as ref_asgi
from vaex_tpu.server import client as ref_client
from vaex_tpu.server import service as ref_service
from vaex_tpu_torch import settings
from vaex_tpu_torch.server import asgi, client, service
from torch_port_helpers import ATOL, RTOL, same_frames, seeded_arrays

N = 3000


@pytest.fixture(autouse=True)
def cpu(monkeypatch):
    monkeypatch.setattr(settings, "DEVICE", "cpu")


def arrays():
    a = seeded_arrays(19, N, 20)
    a["t"] = np.random.default_rng(5).permutation(N).astype(np.int64)
    return a


@pytest.fixture
def frames():
    ref, port = same_frames(arrays())
    return ref, port


def services(frames, **kwargs):
    ref, port = frames
    return ref_service.Service({"t": ref}, **kwargs), service.Service({"t": port}, **kwargs)


def same(a, b, where=""):
    """Two decoded wire values agree: ints and strings exactly, floats to
    the contract's tolerance, NaN with NaN."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), where
        for k in a:
            same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ma.MaskedArray) or isinstance(b, np.ma.MaskedArray):
        npt.assert_array_equal(np.ma.getmaskarray(a), np.ma.getmaskarray(b), where)
        same(np.ma.getdata(a)[~np.ma.getmaskarray(a)], np.ma.getdata(b)[~np.ma.getmaskarray(b)],
             where)
    elif isinstance(a, (np.ndarray, np.generic, float, int)) and not isinstance(a, bool):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, where
        if a.dtype.kind in "iub" and b.dtype.kind in "iub":
            npt.assert_array_equal(a, b, where)
        else:
            npt.assert_allclose(b.astype(float), a.astype(float), rtol=RTOL, atol=ATOL,
                                equal_nan=True, err_msg=where)
    else:
        assert a == b, where


def call_msg(method, args=(), kwargs=None, state=None, auth=None, df="t"):
    msg = {"command": "call", "df": df, "method": method,
           "args": ref_service.encode_result(list(args)),
           "kwargs": ref_service.encode_result(dict(kwargs or {})), "state": state}
    if auth is not None:
        msg["auth"] = auth
    return msg


def both(services_, msg, on_progress=(None, None)):
    """The decoded replies of both services to one message (the message is
    JSON on the wire: it crosses as its JSON text)."""
    text = json.dumps(msg)
    replies = [ref_service.DummyTransport(services_[0]).request(json.loads(text),
                                                               on_progress=on_progress[0]),
               service.DummyTransport(services_[1]).request(json.loads(text),
                                                           on_progress=on_progress[1])]
    replies = [json.loads(json.dumps(r)) for r in replies]
    assert ("error" in replies[0]) == ("error" in replies[1]), replies
    return replies


def answers(services_, msg):
    ref, port = both(services_, msg)
    assert "error" not in port, port.get("traceback")
    return ref_service.decode_result(ref["result"]), service.decode_result(port["result"])


def test_list(frames):
    ref, port = answers(services(frames), {"command": "list"})
    assert ref == port
    assert port["t"]["row_count"] == N and port["t"]["column_names"] == ["k", "x", "iv", "y", "t"]


CALLS = {
    "count": ((), {}),
    "count_x": (("x",), {}),
    "count_binby": ((), {"binby": ["y"], "limits": [[-2, 2]], "shape": 16}),
    "sum": (("iv",), {}),
    "mean": (("x",), {}),
    "mean_binby": (("x",), {"binby": ["k"], "limits": [[0, 20]], "shape": 20}),
    "std": (("y",), {}),
    "var": (("x",), {"selection": "y > 0"}),
    "min": (("x",), {}),
    "max": (("iv",), {}),
    "minmax": (("y",), {}),
    "first": (("x", "t"), {}),
    "nunique": (("k",), {}),
    "limits": (("x",), {}),
    "limits_percentage": (("y",), {"percentage": 90}),
    "percentile_approx": (("y",), {"percentage": 25}),
    "median_approx": (("x",), {}),
    "covar": (("x", "y"), {}),
    "correlation": (("x", "y"), {}),
    "mode": (("y",), {}),
    "unique": (("k",), {"array_type": "numpy"}),
    "evaluate": (("x * 2", 10, 20), {}),
    "__len__": ((), {}),
    "data_type": (("y",), {}),
}


@pytest.mark.parametrize("name", sorted(CALLS))
def test_allowed_method(frames, name):
    """Every method of ALLOWED_METHODS (and more shapes of a few) answers
    the same through both services."""
    method = name if name in service.ALLOWED_METHODS else name.split("_")[0]
    args, kwargs = CALLS[name]
    ref, port = answers(services(frames), call_msg(method, args, kwargs))
    if method == "unique":
        ref, port = np.sort(ref), np.sort(port)
    same(ref, port, name)


def test_every_allowed_method_covered():
    covered = {n if n in service.ALLOWED_METHODS else n.split("_")[0] for n in CALLS}
    assert covered | {"groupby_agg"} == service.ALLOWED_METHODS == ref_service.ALLOWED_METHODS
    assert service.TRUSTED_METHODS == ref_service.TRUSTED_METHODS


@pytest.mark.parametrize("agg", ["count", {"s": ["sum", "x"], "n": "count"},
                                 {"m": ["mean", "y"], "v": ["max", "iv"]}])
def test_groupby_agg(frames, agg):
    ref, port = answers(services(frames), call_msg("groupby_agg", ("k", agg)))
    same(ref, port, "groupby_agg")


def state_of(package, frame):
    """A client-side state: a virtual column, a selection and a filter."""
    df = package.from_arrays(**{c: np.zeros(1) for c in frame.get_column_names()})
    df["r"] = "sqrt(x**2 + y**2)"
    df.select("y > 0.5")
    return df.filter("k < 15").state_get()


@pytest.mark.parametrize("method,args,kwargs", [
    ("sum", ("r",), {}),
    ("count", (), {"selection": True}),
    ("mean", ("r",), {"binby": ["k"], "limits": [[0, 20]], "shape": 20, "selection": True}),
    ("__len__", (), {}),
])
def test_state(frames, method, args, kwargs):
    """A virtual column, a selection and a filter sent as state; the state
    either package writes reads the same in both services."""
    for package in (vaex_tpu, vaex_tpu_torch):
        state = json.loads(json.dumps(state_of(package, frames[0])))
        ref, port = answers(services(frames), call_msg(method, args, kwargs, state=state))
        same(ref, port, f"{package.__name__} {method}")
    direct = frames[1].filter("k < 15")
    direct["r"] = "sqrt(x**2 + y**2)"
    if method == "sum":
        same(direct.sum("r"), port)


def test_method_not_allowed(frames):
    for method in ("state_set", "add_function", "export", "__init__"):
        ref, port = both(services(frames), call_msg(method, ({},)))
        assert "not allowed" in port["error"] and "not allowed" in ref["error"]


def test_unknown_frame_and_command(frames):
    ref, port = both(services(frames), call_msg("sum", ("x",), df="nope"))
    assert "nope" in port["error"]
    ref, port = both(services(frames), {"command": "shutdown"})
    assert "unknown command" in port["error"]


def test_progress_and_cancel(frames):
    """Progress fractions never decrease and end at 1.0; a callback that
    returns False cancels the pass with an error reply, and the next call
    answers."""
    for f in frames:
        f._tile_rows = 500
    svcs = services(frames)
    seen = ([], [])
    with vaex_tpu.cache.off(), vaex_tpu_torch.cache.off():
        ref, port = both(svcs, call_msg("sum", ("x",)),
                         on_progress=(seen[0].append, seen[1].append))
        same(ref_service.decode_result(ref["result"]), service.decode_result(port["result"]))
        for fractions in seen:
            assert fractions and fractions[-1] == 1.0
            assert all(a <= b for a, b in zip(fractions, fractions[1:]))
        ref, port = both(svcs, call_msg("mean", ("y",)),
                         on_progress=(lambda f: False, lambda f: False))
        assert "error" in port and "error" in ref
        ref, port = answers(svcs, call_msg("mean", ("y",)))
        same(ref, port)
        same(frames[1].mean("y"), port)


def function_state(package):
    local = package.from_arrays(x=np.zeros(1))
    local.add_function("f", lambda x: x * 3)
    local["v"] = "f(x)"
    return local.state_get()


AUTH_CASES = [
    # (service kwargs, auth presented, state with a pickled function, allowed)
    ({}, None, False, True),
    ({}, None, True, False),
    ({"trusted": True}, None, True, True),
    ({"token": "secret"}, None, False, False),
    ({"token": "secret"}, {"token": "wrong"}, False, False),
    ({"token": "secret"}, {"token": "secret"}, False, True),
    ({"token": "secret"}, {"token": "secret"}, True, False),
    ({"token": "secret"}, {"token": "secreté"}, False, False),
    ({"token": "secret", "token_trusted": "super"}, {"token-trusted": "super"}, True, True),
    ({"token": "secret", "token_trusted": "super"}, {"token": "secret", "token-trusted": "bad"},
     False, True),
    ({"token": "secret", "token_trusted": "super"}, {"token-trusted": "bad"}, False, False),
    ({"token_trusted": "super"}, None, False, True),
    ({"token_trusted": "super"}, {"token-trusted": "bad"}, False, False),
    ({"token_trusted": "super"}, {"token-trusted": "super"}, True, True),
]


@pytest.mark.parametrize("case", range(len(AUTH_CASES)))
def test_auth(frames, case):
    kwargs, auth, with_function, allowed = AUTH_CASES[case]
    state = function_state(vaex_tpu) if with_function else None
    method, args = ("sum", ("v",)) if with_function else ("count", ())
    svcs = services(frames, **kwargs)
    ref, port = both(svcs, call_msg(method, args, state=state, auth=auth))
    assert ("error" not in port) == allowed, port
    if allowed:
        same(ref_service.decode_result(ref["result"]), service.decode_result(port["result"]))
    listing = {"command": "list", **({"auth": auth} if auth else {})}
    ref, port = both(svcs, listing)


def test_token_compare_is_constant_time(frames, monkeypatch):
    """The port compares tokens with hmac.compare_digest; vaex_tpu's
    Service.check_auth and its ASGI app compare them with ``==``
    (vaex_tpu/server/service.py:88-101, asgi.py:120-124), whose time
    depends on where two tokens first differ."""
    calls = []
    real = hmac.compare_digest

    def recording(a, b):
        calls.append((a, b))
        return real(a, b)
    monkeypatch.setattr(hmac, "compare_digest", recording)
    svcs = services(frames, token="secret")
    ref_app, port_app = (asgi_module.create_app(s) for asgi_module, s in
                         zip((ref_asgi, asgi), svcs))
    assert drive_http(ref_app, "GET", "/dataset", "token=secret")[0] == 200
    assert svcs[0].check_auth({"token": "secret"}) is False
    assert calls == []  # vaex_tpu's fault: no constant-time compare anywhere
    for token, status in (("secret", 200), ("secreT", 401), ("", 401)):
        assert drive_http(port_app, "GET", "/dataset", f"token={token}")[0] == status
    assert svcs[1].check_auth({"token": "secret"}) is False
    # the empty token is no token: nothing to compare
    assert len(calls) == 3 and all(isinstance(a, bytes) for a, _ in calls)
    assert service.token_matches("secret", "secret")
    assert not service.token_matches(None, "secret")
    assert not service.token_matches(b"secret", "secret")


# --------------------------------------------------------------------- ASGI


def drive_http(app, method, path, query="", body=None, headers=()):
    """(status, JSON or text body) of one request to an ASGI app, driven
    in-process."""
    scope = {"type": "http", "method": method, "path": path,
             "query_string": query.encode(), "headers": list(headers)}
    incoming = [{"type": "http.request", "body": body or b"", "more_body": False}]
    sent = []

    async def receive():
        return incoming.pop(0)

    async def send(event):
        sent.append(event)

    asyncio.run(app(scope, receive, send))
    raw = b"".join(e.get("body", b"") for e in sent[1:])
    try:
        return sent[0]["status"], json.loads(raw)
    except ValueError:
        return sent[0]["status"], raw.decode()


def apps(frames, **kwargs):
    ref_svc, port_svc = services(frames, **kwargs)
    return ref_asgi.create_app(ref_svc), asgi.create_app(port_svc)


ROUTES = [
    ("GET", "/hello", "", None),
    ("GET", "/", "", None),
    ("GET", "/docs", "", None),
    ("GET", "/dataset", "", None),
    ("GET", "/dataset/t", "", None),
    ("GET", "/dataset/t/", "", None),
    ("GET", "/dataset/nope", "", None),
    ("GET", "/histogram/t/x", "", None),
    ("GET", "/histogram/t/y", "shape=16&min=-1&max=1", None),
    ("GET", "/histogram/t/x", "shape=8&filter=y>0", None),
    ("GET", "/histogram/nope/x", "", None),
    ("GET", "/histogram/t/nosuchcolumn", "", None),
    ("POST", "/histogram", "", {"dataset_id": "t", "expression": "y", "shape": 10,
                                "min": -2, "max": 2, "filter": "k < 5"}),
    ("GET", "/heatmap/t/x/y", "", None),
    ("GET", "/heatmap/t/x/y", "shape_x=8&shape_y=4&filter=k<10", None),
    ("GET", "/heatmap/nope/x/y", "", None),
    ("POST", "/heatmap", "", {"dataset_id": "t", "expression_x": "y",
                              "expression_y": "k", "shape_x": 5, "shape_y": 20}),
    ("GET", "/nothing/here", "", None),
    ("DELETE", "/dataset", "", None),
]


@pytest.mark.parametrize("route", range(len(ROUTES)))
def test_asgi_route(frames, route):
    method, path, query, body = ROUTES[route]
    body = None if body is None else json.dumps(body).encode()
    (rs, rbody), (ps, pbody) = (drive_http(app, method, path, query, body)
                                for app in apps(frames))
    assert rs == ps, (rbody, pbody)
    if ps == 200 and isinstance(pbody, dict):
        same(rbody, pbody, path)
    elif ps == 200:  # the pages differ by the package's name alone
        assert rbody == pbody or "/openapi.json" in pbody
    if path.startswith("/histogram/t") and ps == 200:
        assert sum(pbody["values"]) <= N


def test_asgi_histogram_is_the_frames_count(frames):
    port = frames[1]
    _, h = drive_http(apps(frames)[1], "GET", "/histogram/t/y", "shape=16&min=-1&max=1")
    npt.assert_array_equal(h["values"], port.count(binby=["y"], limits=[[-1, 1]], shape=16))
    npt.assert_allclose(h["centers"], np.linspace(-1, 1, 33)[1::2], rtol=1e-12)


def test_asgi_openapi(frames):
    (rs, rdoc), (ps, pdoc) = (drive_http(app, "GET", "/openapi.json") for app in apps(frames))
    assert rs == ps == 200
    assert rdoc["paths"] == pdoc["paths"]
    assert pdoc["info"]["title"] == "vaex_tpu_torch server"


def test_asgi_percent_decoding(frames):
    """A percent-encoded filter reaches the frame decoded.  vaex_tpu's app
    splits the query string without decoding it (vaex_tpu/server/asgi.py:
    147-151), so ``y%20%3E%200`` reaches its frame as that text and the
    request fails; the port answers with the frame's own count."""
    ref_app, port_app = apps(frames)
    query = "shape=8&min=-2&max=2&filter=y%20%3E%200"
    status, h = drive_http(port_app, "GET", "/histogram/t/y", query)
    assert status == 200
    want = frames[1].count(binby=["y"], limits=[[-2, 2]], shape=8, selection="y > 0")
    npt.assert_array_equal(h["values"], want)
    y = arrays()["y"]
    assert sum(h["values"]) == int(((y > 0) & (y < 2)).sum())
    status, _ = drive_http(ref_app, "GET", "/histogram/t/y", query)
    assert status == 500  # vaex_tpu's fault
    # the same filter written with '+' for its spaces, as HTML forms send it
    status, h2 = drive_http(port_app, "GET", "/histogram/t/y", query.replace("%20", "+"))
    assert status == 200 and h2["values"] == h["values"]


def test_asgi_token(frames):
    """Every route but /, /hello, /docs and /openapi.json needs the token,
    as a query argument (percent-decoded) or an x-token header."""
    token = "a+b/c=d"
    ref_app, port_app = apps(frames, token=token)
    for app in (ref_app, port_app):
        assert drive_http(app, "GET", "/dataset")[0] == 401
        assert drive_http(app, "GET", "/hello")[0] == 200
        assert drive_http(app, "GET", "/dataset", headers=[(b"x-token", token.encode())]) == (
            200, ["t"])
        assert drive_http(app, "POST", "/heatmap", body=b"{}")[0] == 401
    encoded = "token=a%2Bb%2Fc%3Dd"
    assert drive_http(port_app, "GET", "/dataset", encoded) == (200, ["t"])
    assert drive_http(ref_app, "GET", "/dataset", encoded)[0] == 401  # vaex_tpu's fault
    assert drive_http(port_app, "GET", "/dataset", "token=a%2Bb")[0] == 401


def drive_websocket(app, messages):
    incoming = [{"type": "websocket.connect"}] + [
        {"type": "websocket.receive", "text": json.dumps(m)} for m in messages] + [
        {"type": "websocket.disconnect"}]
    sent = []

    async def receive():
        return incoming.pop(0)

    async def send(event):
        sent.append(event)

    asyncio.run(app({"type": "websocket", "path": "/websocket", "headers": []}, receive, send))
    assert sent[0]["type"] == "websocket.accept"
    return [json.loads(e["text"]) for e in sent[1:]]


def test_asgi_websocket(frames):
    messages = [{"msg_id": "1", "command": "list"},
                {"msg_id": 2, **call_msg("std", ("x",))},
                {"msg_id": "3", **call_msg("groupby_agg", ("k", {"s": ["sum", "x"], "n": "count"}))},
                {"msg_id": "4", **call_msg("no_such_method")}]
    ref, port = (drive_websocket(app, messages) for app in apps(frames))
    assert [r["msg_id"] for r in port] == ["1", 2, "3", "4"]
    assert "error" in port[3] and "error" in ref[3]
    for r, p in zip(ref[:3], port[:3]):
        same(ref_service.decode_result(r["result"]), service.decode_result(p["result"]))


def test_asgi_lifespan(frames):
    incoming = [{"type": "lifespan.startup"}, {"type": "lifespan.shutdown"}]
    sent = []

    async def receive():
        return incoming.pop(0)

    async def send(event):
        sent.append(event)

    asyncio.run(apps(frames)[1]({"type": "lifespan"}, receive, send))
    assert [e["type"] for e in sent] == ["lifespan.startup.complete", "lifespan.shutdown.complete"]


# ------------------------------------------------ expressions from the wire


def exploits(path):
    """Expressions that open ``path`` for writing through Python's objects
    rather than the data, each by another way in."""
    return [
        f"x.__init__.__globals__['__builtins__']['open']({path!r}, 'w').close() is None",
        f"sqrt.__globals__['__builtins__']['open']({path!r}, 'w').close() is None",
        f"x.data.numpy().tofile({path!r}) is None",
    ]


def selection_spec(expression):
    return {"type": "expression", "expression": expression, "mode": "replace",
            "previous": None}


@pytest.mark.parametrize("way", range(3))
def test_a_request_expression_cannot_reach_python(frames, tmp_path, way):
    """Every place a request carries an expression refuses one that leaves
    the expression language, over REST (400) and over the websocket (an
    error reply), before any pass evaluates it: no file is opened."""
    app = asgi.create_app(services(frames)[1])

    def expression(tag):
        return exploits(str(tmp_path / tag))[way]

    assert drive_http(app, "GET", "/histogram/t/x",
                      "filter=" + urllib.parse.quote(expression("filter")))[0] == 400
    for route, body in [
            ("/histogram", {"dataset_id": "t", "expression": expression("axis")}),
            ("/histogram", {"dataset_id": "t", "expression": "x",
                            "filter": expression("post_filter")}),
            ("/heatmap", {"dataset_id": "t", "expression_x": "x",
                          "expression_y": expression("axis_y")})]:
        status, reply = drive_http(app, "POST", route, body=json.dumps(body).encode())
        assert status == 400, reply
    messages = [
        call_msg("count", (), {"selection": expression("selection")}),
        call_msg("evaluate", (expression("evaluate"),)),
        call_msg("sum", ("x",), {"binby": [expression("binby")], "shape": 4}),
        call_msg("groupby_agg", ("k", {"s": ["sum", expression("agg")]})),
        call_msg("count", ("v",), state={"virtual_columns": {"v": expression("virtual")}}),
        call_msg("count", (), {"selection": True},
                 state={"selections": {"default": selection_spec(expression("state_sel"))}}),
        call_msg("count", (), state={"selections": {
            "__filter__": selection_spec(expression("state_filter"))}}),
    ]
    for reply in drive_websocket(app, messages):
        assert "not allowed" in reply["error"], reply
    assert not list(tmp_path.iterdir())


def test_a_request_expression_names_only_the_frame(frames, tmp_path):
    """A request's expression names only the frame's columns, variables and
    functions, and its only attribute is ``astype``: the language's own
    expressions still answer."""
    svc = services(frames)[1]
    transport = service.DummyTransport(svc)
    reply = transport.request(call_msg("count", ("v",), state={
        "virtual_columns": {"v": "open"}}))
    assert "'open' does not exist" in reply["error"]
    reply = transport.request(call_msg("count", (), {"selection": "x.astype('float32') > 0"}))
    assert service.decode_result(reply["result"]) == frames[1].count(selection="x > 0")
    reply = transport.request(call_msg("mean", ("r",), {"selection": "k < 5"}, state={
        "virtual_columns": {"r": "sqrt(x ** 2 + y ** 2)"}}))
    same(service.decode_result(reply["result"]),
         frames[1].mean("sqrt(x ** 2 + y ** 2)", selection="k < 5"))


def test_an_expression_reaches_no_private_attribute(frames, tmp_path):
    """Outside the server too, an expression's attribute that starts with
    ``_`` is refused before ``eval`` runs it, on the device scope and on the
    host scope."""
    from vaex_tpu_torch import scopes
    path = str(tmp_path / "opened")
    for way in (0, 1):
        with pytest.raises(ValueError, match="not allowed"):
            frames[1].evaluate(exploits(path)[way])
        with pytest.raises(ValueError, match="not allowed"):
            scopes.HostScope({"x": np.arange(3.0)}, n_rows=3).evaluate(exploits(path)[way])
    assert not list(tmp_path.iterdir())


def test_vaex_tpu_runs_a_request_expression(frames, tmp_path):
    """vaex_tpu's service evaluates a request's expression unchecked: a
    selection reaches Python's builtins through ``x.__init__.__globals__``
    and opens a file (ROADMAP, known problems of the reference).  The port
    refuses it (``test_a_request_expression_cannot_reach_python``)."""
    path = tmp_path / "opened"
    reply = ref_service.DummyTransport(services(frames)[0]).request(
        call_msg("count", (), {"selection": exploits(str(path))[0]}))
    assert "error" not in reply and path.exists()  # vaex_tpu's fault


# ------------------------------------------------------------- the clients


def remote_pair(frames, client_module, service_module, package):
    """A client of ``client_module`` over a service of ``service_module``
    serving the frame of ``package``."""
    frame = frames[1] if package is vaex_tpu_torch else frames[0]
    svc = service_module.Service({"t": frame})
    return client_module.Client(service_module.DummyTransport(svc))["t"]


@pytest.mark.parametrize("direction", ["ref_client_port_service", "port_client_ref_service"])
def test_clients_cross_the_wire(frames, direction):
    """vaex_tpu's client against the port's service and the port's client
    against vaex_tpu's: the wire is the same, so the answers are."""
    if direction == "ref_client_port_service":
        crossed = remote_pair(frames, ref_client, service, vaex_tpu_torch)
    else:
        crossed = remote_pair(frames, client, ref_service, vaex_tpu)
    local = remote_pair(frames, ref_client, ref_service, vaex_tpu)
    for dfr in (crossed, local):
        dfr["r"] = dfr.x * 2 + dfr.y
        dfr.select("y > 0.25")
    flt_c, flt_l = crossed.filter("k < 12"), local.filter("k < 12")
    same(len(local), len(crossed))
    same(local.sum("r"), crossed.sum("r"))
    same(local.count(selection=True), crossed.count(selection=True))
    same(local.mean("x", binby=["k"], limits=[[0, 20]], shape=20, selection=True),
         crossed.mean("x", binby=["k"], limits=[[0, 20]], shape=20, selection=True))
    same(len(flt_l), len(flt_c))
    same(flt_l.minmax("r"), flt_c.minmax("r"))
    same(local.correlation("x", "y"), crossed.correlation("x", "y"))
    same(local.groupby("k", agg={"s": ("sum", "iv"), "c": "count"}),
         crossed.groupby("k", agg={"s": ("sum", "iv"), "c": "count"}))
    same(local.evaluate("r", 5, 9), crossed.evaluate("r", 5, 9))
    same(local.r.tolist()[:3], crossed.r.tolist()[:3])


def test_port_client(frames):
    dfr = remote_pair(frames, client, service, vaex_tpu_torch)
    port = frames[1]
    assert dfr.get_column_names() == port.get_column_names()
    assert dfr.count() == len(port) == N
    same(dfr.sum("iv"), port.sum("iv"))
    dfr["v"] = dfr.x * 2
    same(dfr.sum("v"), 2 * port.sum("x"))
    same((dfr.x + 1).sum(), port.sum("x + 1"))
    same((1 - dfr.y).max(), port.max("1 - y"))
    assert isinstance(dfr.k, client.ExpressionRemote) and str(dfr.k > 3) == "(k > 3)"
    with pytest.raises(RuntimeError, match="not allowed"):
        dfr._rmi("state_set", {})
    with pytest.raises(AttributeError):
        dfr.nosuchcolumn
    with pytest.raises(ValueError):
        client.connect("dummy:")


def test_client_progress(frames):
    frames[1]._tile_rows = 400
    fractions = []
    svc = service.Service({"t": frames[1]})
    dfr = client.Client(service.DummyTransport(svc), on_progress=fractions.append)["t"]
    with vaex_tpu_torch.cache.off():
        same(dfr.sum("x"), frames[1].sum("x"))
    assert fractions and fractions[-1] == 1.0


def test_served_frame_is_not_changed(frames):
    """A call sets the client's state on a copy: the served frame keeps its
    columns and selections, and shares its dataset with the copy."""
    port = frames[1]
    svc = service.Service({"t": port})
    dfr = client.Client(service.DummyTransport(svc))["t"]
    dfr["w"] = "x + 1"
    dfr.select("k > 3")
    dfr.count(selection=True)
    assert "w" not in port.get_column_names() and not port.has_selection()
    assert port.copy().dataset is port.dataset


# ----------------------------------------------------------------- tornado


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture
def tornado_server(frames):
    tornado = pytest.importorskip("tornado")
    pytest.importorskip("websockets")
    from vaex_tpu_torch.server.tornado_server import make_app
    frames[1]._tile_rows = 500
    svc = service.Service({"t": frames[1]}, token="secret")
    port = free_port()
    started = threading.Event()
    holder = {}

    def run():
        asyncio.set_event_loop(asyncio.new_event_loop())
        make_app(svc).listen(port, address="localhost")
        holder["loop"] = tornado.ioloop.IOLoop.current()
        started.set()
        holder["loop"].start()

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    assert started.wait(10)
    yield port, frames[1]
    holder["loop"].add_callback(holder["loop"].stop)
    thread.join(10)


def test_tornado_server(tornado_server):
    """The tornado flavor: the websocket protocol with streamed progress
    and the token, and the REST histogram, on a pool of one worker."""
    import urllib.error
    import urllib.request
    port, frame = tornado_server
    fractions = []
    remote = client.connect(f"ws://localhost:{port}", token="secret",
                            on_progress=fractions.append)
    try:
        with vaex_tpu_torch.cache.off():
            same(remote["t"].sum("x"), frame.sum("x"))
        assert fractions and fractions[-1] == 1.0
        dfr = remote["t"]
        dfr.select("y > 0")
        same(dfr.count(selection=True), frame.count(selection="y > 0"))
    finally:
        remote.close()
    with pytest.raises(RuntimeError, match="token"):
        client.connect(f"ws://localhost:{port}", token="wrong")
    url = f"http://localhost:{port}/histogram/t?expression=y&shape=5&min=-1&max=1&token=secret"
    with urllib.request.urlopen(url) as r:
        payload = json.loads(r.read())
    npt.assert_array_equal(payload["counts"], frame.count(binby=["y"], limits=[[-1, 1]], shape=5))
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(url.replace("secret", "secreT"))
    assert e.value.code == 401


def test_tornado_runs_requests_one_at_a_time(tornado_server, monkeypatch):
    """A REST histogram sent while a websocket call's pass is in flight
    waits for it on the one worker: no two passes of the shared executor
    run at once, and both answers are the frame's."""
    import urllib.request
    port, frame = tornado_server
    lock, running, most, in_flight = threading.Lock(), [0], [0], threading.Event()
    execute_pass = frame.executor._execute_pass

    def one_pass(df, tasks):
        with lock:
            running[0] += 1
            most[0] = max(most[0], running[0])
        in_flight.set()
        try:
            time.sleep(0.2)
            return execute_pass(df, tasks)
        finally:
            with lock:
                running[0] -= 1

    monkeypatch.setattr(frame.executor, "_execute_pass", one_pass)
    answers_ = {}

    def websocket_call():
        remote = client.connect(f"ws://localhost:{port}", token="secret")
        try:
            answers_["sum"] = remote["t"].sum("x")
        finally:
            remote.close()

    with vaex_tpu_torch.cache.off():
        thread = threading.Thread(target=websocket_call)
        thread.start()
        assert in_flight.wait(30)
        url = f"http://localhost:{port}/histogram/t?expression=y&shape=5&min=-1&max=1&token=secret"
        with urllib.request.urlopen(url) as r:
            payload = json.loads(r.read())
        thread.join(60)
        monkeypatch.undo()
        same(answers_["sum"], frame.sum("x"))
        npt.assert_array_equal(payload["counts"],
                               frame.count(binby=["y"], limits=[[-1, 1]], shape=5))
    assert most[0] == 1


def test_tornado_refuses_a_request_expression(tornado_server, tmp_path):
    import urllib.error
    import urllib.request
    port, frame = tornado_server
    path = tmp_path / "opened"
    for query in (f"expression=x&filter={urllib.parse.quote(exploits(str(path))[0])}",
                  f"expression={urllib.parse.quote(exploits(str(path))[1])}"):
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"http://localhost:{port}/histogram/t?{query}&token=secret")
        assert e.value.code == 400
    assert not path.exists()
