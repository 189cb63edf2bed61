"""The tornado flavor of the server: the websocket protocol with streamed
progress, and REST histograms and heatmaps (vaex_tpu/server/tornado_server.py).

Requests, the websocket's and the REST ones alike, run one at a time on a
pool of one worker thread, off the IO loop, which stays free to stream
``{"msg_id": ..., "progress": f}`` frames while a pass runs.  The passes, and the kernels they launch on the card, run on
that worker thread: each kernel wrapper enters its tensor's device itself
and launches on that device's current stream, so nothing depends on state
set on the main thread.
"""

from __future__ import annotations

import concurrent.futures
import json

try:
    import tornado.ioloop
    import tornado.web
    import tornado.websocket
except ImportError:  # pragma: no cover
    tornado = None

from .service import DummyTransport, ExpressionRefused, Service, token_matches


class WebSocketHandler(tornado.websocket.WebSocketHandler if tornado else object):
    """Runs requests on the worker pool; the IO loop sends their progress
    and replies."""

    def initialize(self, transport=None, pool=None):
        self.transport = transport
        self.pool = pool

    def on_message(self, message):
        msg = json.loads(message)
        msg_id = msg.get("msg_id")
        loop = tornado.ioloop.IOLoop.current()

        def on_progress(fraction):
            loop.add_callback(self._send, {"msg_id": msg_id, "progress": fraction})
            return True

        def work():
            reply = self.transport.request(msg, on_progress=on_progress)
            reply["msg_id"] = msg_id
            loop.add_callback(self._send, reply)

        self.pool.submit(work)

    def _send(self, payload):
        try:
            self.write_message(json.dumps(payload))
        except tornado.websocket.WebSocketClosedError:  # client went away
            pass


class _ServiceHandler(tornado.web.RequestHandler if tornado else object):
    """A REST request: its work runs on the worker pool, one request after
    another with the websocket's, never on the IO loop."""

    def initialize(self, service=None, pool=None):
        self.service = service
        self.pool = pool

    def prepare(self):
        # REST endpoints accept the token as a query argument or header
        if getattr(self.service, "token", None) is not None:
            presented = self.get_argument("token", None) or self.request.headers.get("X-Token")
            if not token_matches(presented, self.service.token):
                raise tornado.web.HTTPError(401, "invalid or missing token")

    async def answer(self, work):
        try:
            out = await tornado.ioloop.IOLoop.current().run_in_executor(self.pool, work)
        except ExpressionRefused as e:
            raise tornado.web.HTTPError(400, str(e)) from None
        self.write(json.dumps(out))


class ListHandler(_ServiceHandler):
    async def get(self):
        await self.answer(self.service.list_dataframes)


class HistogramHandler(_ServiceHandler):
    """GET /histogram/<df>?expression=x&shape=64[&min=..&max=..&filter=..]"""

    async def get(self, name):
        expression = self.get_argument("expression")
        shape = int(self.get_argument("shape", "64"))
        vmin = self.get_argument("min", None)
        vmax = self.get_argument("max", None)
        selection = self.get_argument("filter", None)

        def work():
            grid = self.service.histogram(name, expression, shape, vmin, vmax, selection)
            return {"centers": grid["centers"], "counts": grid["values"],
                    "limits": grid["limits"]}

        await self.answer(work)


class HeatmapHandler(_ServiceHandler):
    """GET /heatmap/<df>?expression_x=x&expression_y=y&shape=64
    [&shape_x=..&shape_y=..&filter=..]"""

    async def get(self, name):
        ex = self.get_argument("expression_x")
        ey = self.get_argument("expression_y")
        shape = self.get_argument("shape", "64")
        shape_x = int(self.get_argument("shape_x", shape))
        shape_y = int(self.get_argument("shape_y", shape))
        selection = self.get_argument("filter", None)

        def work():
            grid = self.service.heatmap(name, ex, ey, shape_x, shape_y, selection)
            return {"counts": grid["values"], "limits": grid["limits"]}

        await self.answer(work)


def make_app(service: Service, pool=None):
    transport = DummyTransport(service)
    # one worker: requests run one at a time, one pass after another, while
    # the IO loop keeps streaming progress
    pool = pool or concurrent.futures.ThreadPoolExecutor(max_workers=1)
    rest = {"service": service, "pool": pool}
    return tornado.web.Application([
        (r"/websocket", WebSocketHandler, {"transport": transport, "pool": pool}),
        (r"/dataset", ListHandler, rest),
        (r"/histogram/([^/]+)", HistogramHandler, rest),
        (r"/heatmap/([^/]+)", HeatmapHandler, rest),
    ])


def serve(dataframes, port=9000, trusted=False, token=None, token_trusted=None):
    """Serve ``dataframes`` on ``port`` until the IO loop stops."""
    assert tornado is not None, "tornado required for the server"
    service = Service(dataframes, trusted=trusted, token=token, token_trusted=token_trusted)
    app = make_app(service)
    app.listen(port)
    tornado.ioloop.IOLoop.current().start()
