"""The port's spans and its count of blocking host reads.

A span names a stage of the host's work on a query (the entry, its plan, a
pass, a tile, a kernel wrapper, a wait for the device).  Recording is off
until :func:`start`; then each span that closes appends one record to a
ring of the last ``RING_SPANS`` spans, oldest dropped::

    (seq, name, start_ns, end_ns, parent)

``seq`` grows by one with every span opened, ``parent`` is the ``seq`` of
the span that held it open on the same thread (None for a root), and the
times are ``time.time_ns()``: ``CLOCK_REALTIME``, the clock ``torch.profiler``
stamps its events with (c10's ``getTime``), so a span and a profiler event
compare without an offset.  Device work is asynchronous: a span measures
what the host did, and the ``sync:<site>`` spans of :func:`host_read` what
it waited for.

Off, :func:`span` returns one shared no-op context and allocates nothing;
:func:`host_read` counts in ``host_read.count`` whether recording is on or
off, as the kernel wrappers count their ``launches``.

    seq = tracing.start()
    df.groupby("k", agg={"s": "sum"})
    spans = tracing.since(seq)
    tracing.stop()

The names: ``groupby`` / ``binby`` (the entry, a root), ``plan``,
``assemble``, ``one-sort``; ``pass`` (:class:`.execution.ExecutorLocal`),
``tile``, ``prolog`` (the eager expression work of a tile: its inputs, the
filter, the binners), ``finalize`` (merge, finalize, the cache store);
``launch:<route>`` (a wrapper of :mod:`.ops.grid_plan` or
:mod:`.ops.probe`, from its entry to the return of its kernel's enqueue);
``sync:<site>`` (a blocking read of a device value).
"""

from __future__ import annotations

import collections
import functools
import itertools
import threading
import time

RING_SPANS = 1 << 20

_ring = collections.deque(maxlen=RING_SPANS)
_ids = itertools.count(1)
_last = 0  # the seq of the last span opened
_local = threading.local()
_on = False


class _Off:
    """The no-op span of recording off: one object, shared."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()


class _Span:
    __slots__ = ("name", "seq", "parent", "t0")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        global _last
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else None
        self.seq = _last = next(_ids)
        stack.append(self.seq)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        _local.stack.pop()
        _ring.append((self.seq, self.name, self.t0, t1, self.parent))
        return False


def span(name):
    """A context that records the span ``name`` while recording is on;
    :data:`OFF` otherwise."""
    return _Span(name) if _on else OFF


def launched(fn):
    """``fn`` (a kernel wrapper whose result's first item names the route it
    took) inside a ``launch:<route>`` span."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not _on:
            return fn(*args, **kwargs)
        with _Span("launch") as s:
            out = fn(*args, **kwargs)
            s.name = f"launch:{out[0]}"
        return out
    return wrapper


def host_read(site, reads=1):
    """The context of ``reads`` reads that block the host until the device
    has the value (``int``, ``.tolist()``, ``.cpu()``, a ``nonzero`` whose
    size the host needs, a copy from the host that waits for the stream):
    counted in ``host_read.count`` and, while recording, a ``sync:<site>``
    span; :data:`OFF` otherwise.

        with tracing.host_read("compact"):
            order = torch.nonzero(counts > 0).squeeze(1)
    """
    host_read.count += reads
    return _Span(f"sync:{site}") if _on else OFF


host_read.count = 0


def start():
    """Recording on (a second call changes nothing); returns the ``seq`` of
    the last span opened, for :func:`since`."""
    global _on
    _on = True
    return _last


def stop():
    """Recording off; what was recorded stays in the ring."""
    global _on
    _on = False


def since(seq):
    """The spans of the ring opened after ``seq``, in the order they
    closed."""
    return [s for s in _ring if s[0] > seq]
