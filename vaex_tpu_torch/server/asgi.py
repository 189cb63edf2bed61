"""The ASGI app: the REST flavor of the server (vaex_tpu/server/asgi.py).

A dependency-free ``async def app(scope, receive, send)`` with the routes
of vaex-server's FastAPI app, runnable under any ASGI host (uvicorn when it
is installed: :func:`serve`) or driven in-process:

  GET  /hello, /, /docs, /openapi.json
  GET  /dataset                                 the served frames' names
  GET  /dataset/{dataset_id}                    row count and schema
  GET  /histogram/{dataset_id}/{expression}     ?shape=&min=&max=&filter=
  POST /histogram                               the same as a JSON body
  GET  /heatmap/{dataset_id}/{ex}/{ey}          ?shape_x=&shape_y=&filter=
  POST /heatmap
  WS   /websocket                               the service's JSON protocol

The query string is percent-decoded (``urllib.parse.parse_qsl``), so a
filter such as ``g_mag%20%3C%2015`` reaches the frame as ``g_mag < 15``,
and the token is compared in constant time; vaex_tpu's app does neither.
An expression of a request that is not of the expression language is
refused with 400 (:func:`~.service.check_expression`).  FastAPI users
mount this app; it needs no FastAPI of its own.
"""

from __future__ import annotations

import json
from urllib.parse import parse_qsl

from .service import DummyTransport, ExpressionRefused, Service, token_matches


def _dataset_meta(service, name):
    df = service.dataframes[name]
    schema = {c: str(df.data_type(c).name) for c in df.get_column_names()}
    return {"id": name, "row_count": df.length_original(), "schema": schema}


def openapi_schema(service):
    """The OpenAPI 3 document of the routes, written out so that /docs
    works without FastAPI."""
    p = {}
    p["/dataset"] = {"get": {"summary": "Lists all dataset names",
                             "responses": {"200": {"description": "names"}}}}
    p["/dataset/{dataset_id}"] = {"get": {
        "summary": "Meta information about a dataset (schema etc)",
        "parameters": [{"name": "dataset_id", "in": "path", "required": True,
                        "schema": {"type": "string"}}],
        "responses": {"200": {"description": "meta"}}}}
    hist_params = [
        {"name": "shape", "in": "query", "schema": {"type": "integer", "default": 64}},
        {"name": "min", "in": "query", "schema": {"type": "number"}},
        {"name": "max", "in": "query", "schema": {"type": "number"}},
        {"name": "filter", "in": "query", "schema": {"type": "string"}},
    ]
    p["/histogram/{dataset_id}/{expression}"] = {"get": {
        "summary": "histogram data (1d)", "tags": ["quick"],
        "parameters": [{"name": "dataset_id", "in": "path", "required": True,
                        "schema": {"type": "string"}},
                       {"name": "expression", "in": "path", "required": True,
                        "schema": {"type": "string"}}] + hist_params,
        "responses": {"200": {"description": "HistogramOutput"}}}}
    p["/histogram"] = {"post": {"summary": "histogram data (1d)", "tags": ["quick"],
                                "responses": {"200": {"description": "HistogramOutput"}}}}
    p["/heatmap/{dataset_id}/{expression_x}/{expression_y}"] = {"get": {
        "summary": "heatmap data (2d)", "tags": ["quick"],
        "parameters": [{"name": n, "in": "path", "required": True,
                        "schema": {"type": "string"}}
                       for n in ("dataset_id", "expression_x", "expression_y")],
        "responses": {"200": {"description": "HeatmapOutput"}}}}
    p["/heatmap"] = {"post": {"summary": "heatmap data (2d)", "tags": ["quick"],
                              "responses": {"200": {"description": "HeatmapOutput"}}}}
    return {"openapi": "3.0.2",
            "info": {"title": "vaex_tpu_torch server", "version": "1.0"},
            "tags": [{"name": "quick", "description": "Quick API for common cases"}],
            "paths": p}


_DOCS_HTML = """<!DOCTYPE html><html><head><title>vaex_tpu_torch API docs</title></head>
<body><h1>vaex_tpu_torch server</h1>
<p>OpenAPI schema: <a href="/openapi.json">/openapi.json</a></p></body></html>"""


def create_app(service: Service):
    """Dependency-free ASGI app over a :class:`Service`."""
    transport = DummyTransport(service)

    def check_token(query, headers):
        if service.token is None:
            return True
        presented = query.get("token") or headers.get("x-token")
        return token_matches(presented, service.token)

    async def respond(send, status, body, content_type=b"application/json"):
        if isinstance(body, (dict, list)):
            body = json.dumps(body).encode()
        elif isinstance(body, str):
            body = body.encode()
        await send({"type": "http.response.start", "status": status,
                    "headers": [(b"content-type", content_type),
                                (b"content-length", str(len(body)).encode())]})
        await send({"type": "http.response.body", "body": body})

    async def read_body(receive):
        chunks = []
        while True:
            event = await receive()
            chunks.append(event.get("body", b""))
            if not event.get("more_body"):
                break
        return b"".join(chunks)

    async def handle_http(scope, receive, send):
        path = scope["path"].rstrip("/") or "/"
        method = scope["method"]
        query = dict(parse_qsl((scope.get("query_string") or b"").decode("latin-1")))
        headers = {k.decode().lower(): v.decode()
                   for k, v in scope.get("headers", [])}
        if path not in ("/", "/hello", "/docs", "/openapi.json") and \
                not check_token(query, headers):
            await respond(send, 401, {"detail": "invalid or missing token"})
            return
        try:
            if path == "/hello":
                await respond(send, 200, '"hi"')
            elif path == "/":
                await respond(send, 200, _DOCS_HTML, b"text/html")
            elif path == "/docs":
                await respond(send, 200, _DOCS_HTML, b"text/html")
            elif path == "/openapi.json":
                await respond(send, 200, openapi_schema(service))
            elif path == "/dataset" and method == "GET":
                await respond(send, 200, list(service.dataframes.keys()))
            elif path.startswith("/dataset/") and method == "GET":
                name = path[len("/dataset/"):]
                if name not in service.dataframes:
                    await respond(send, 404, {"detail": f"dataset {name!r} not found"})
                    return
                await respond(send, 200, _dataset_meta(service, name))
            elif path.startswith("/histogram/") and method == "GET":
                name, _, expression = path[len("/histogram/"):].partition("/")
                if name not in service.dataframes:
                    await respond(send, 404, {"detail": f"dataset {name!r} not found"})
                    return
                out = service.histogram(name, expression,
                                        shape=int(query.get("shape", 64)),
                                        vmin=query.get("min"), vmax=query.get("max"),
                                        selection=query.get("filter"))
                await respond(send, 200, out)
            elif path == "/histogram" and method == "POST":
                spec = json.loads(await read_body(receive) or b"{}")
                out = service.histogram(spec["dataset_id"], spec["expression"],
                                        shape=int(spec.get("shape", 64)),
                                        vmin=spec.get("min"), vmax=spec.get("max"),
                                        selection=spec.get("filter"))
                await respond(send, 200, out)
            elif path.startswith("/heatmap/") and method == "GET":
                name, _, rest = path[len("/heatmap/"):].partition("/")
                ex, _, ey = rest.partition("/")
                if name not in service.dataframes:
                    await respond(send, 404, {"detail": f"dataset {name!r} not found"})
                    return
                out = service.heatmap(name, ex, ey,
                                      shape_x=int(query.get("shape_x", 128)),
                                      shape_y=int(query.get("shape_y", 128)),
                                      selection=query.get("filter"))
                await respond(send, 200, out)
            elif path == "/heatmap" and method == "POST":
                spec = json.loads(await read_body(receive) or b"{}")
                out = service.heatmap(spec["dataset_id"], spec["expression_x"],
                                      spec["expression_y"],
                                      shape_x=int(spec.get("shape_x", 128)),
                                      shape_y=int(spec.get("shape_y", 128)),
                                      selection=spec.get("filter"))
                await respond(send, 200, out)
            else:
                await respond(send, 404, {"detail": "not found"})
        except ExpressionRefused as e:
            await respond(send, 400, {"detail": str(e)})
        except KeyError as e:
            await respond(send, 404, {"detail": str(e)})
        except Exception as e:  # noqa: BLE001 - errors cross the wire
            await respond(send, 500, {"detail": str(e)})

    async def handle_websocket(scope, receive, send):
        # the same JSON request / reply protocol as the tornado flavor
        await send({"type": "websocket.accept"})
        while True:
            event = await receive()
            if event["type"] == "websocket.disconnect":
                return
            if event["type"] != "websocket.receive":
                continue  # websocket.connect handshake event
            raw = event.get("text") or (event.get("bytes") or b"").decode()
            msg = json.loads(raw)
            reply = transport.request(msg)
            reply["msg_id"] = msg.get("msg_id")
            await send({"type": "websocket.send", "text": json.dumps(reply)})

    async def app(scope, receive, send):
        if scope["type"] == "http":
            await handle_http(scope, receive, send)
        elif scope["type"] == "websocket" and scope["path"] == "/websocket":
            await handle_websocket(scope, receive, send)
        elif scope["type"] == "lifespan":
            while True:
                event = await receive()
                if event["type"] == "lifespan.startup":
                    await send({"type": "lifespan.startup.complete"})
                elif event["type"] == "lifespan.shutdown":
                    await send({"type": "lifespan.shutdown.complete"})
                    return

    app.service = service
    return app


def serve(dataframes, host="0.0.0.0", port=9000, trusted=False, token=None,
          token_trusted=None):
    """Run the ASGI app under uvicorn, where it is installed."""
    service = Service(dataframes, trusted=trusted, token=token,
                      token_trusted=token_trusted)
    app = create_app(service)
    import uvicorn
    uvicorn.run(app, host=host, port=port)
