"""The streamed pass: host columns carried to the pass device tile by tile,
the copies overlapping the compute (vaex_tpu/execution.py:550-592, 921-960).

A pass whose device stage reads host columns (numpy arrays, memory maps of
a file, arrow or parquet columns) over more than one tile reads them through
a :class:`TileStream` unless ``settings.PREFETCH`` and
``settings.TRANSFER_AHEAD`` are both 0, which select the synchronous copy of
:func:`.column.tile_of` (the plain version of this module).

With ``TRANSFER_AHEAD`` > 0 a producer thread pulls the dataset's
``chunk_iterator`` and, for each tile:

1. takes the next of a ring of ``TRANSFER_AHEAD + 1`` slots of page-locked
   host memory, once the copy that last read that slot has completed (its
   event);
2. copies each column's rows (and mask) into the slot on
   ``settings.NUM_THREADS_IO`` threads (``np.copyto`` releases the GIL),
   narrowing on the way a column whose proof allows it (below);
3. allocates the tile's device tensors on a copy stream of its own, enqueues
   ``copy_(non_blocking=True)`` from the slot, marks the tensors as used on
   the compute stream (``record_stream``: the caching allocator hands their
   memory out again only after the compute stream's work on them), and
   records an event;

and queues the tile (at most ``TRANSFER_AHEAD`` ahead).  The ring is bounded
by bytes, not rows: :func:`ring_tile_rows` clamps the pass's tile so that
its slots hold at most ``settings.STREAM_RING_BYTES`` (the part the
reference's ``TILE_ROWS_MAX`` plays), and the trace records the slots'
bytes (``ring_bytes``).  The pass makes its
compute stream wait on the tile's event before the tile's kernels.  An
exception in the producer raises in the pass; when the pass ends, is
cancelled or raises, the producer stops at its next slot and its thread is
joined.  No path falls back: a page-locked allocation, a stream or a copy
that fails raises.  On the CPU (the tests) the same producer fills plain
slots and the "device copy" is a copy of the slot.  With ``TRANSFER_AHEAD``
0 and ``PREFETCH`` > 0 a thread reads ``PREFETCH`` chunks ahead and the pass
copies each tile itself, through :func:`.column.tile_of`.

Wire narrowing (vaex_tpu/execution.py:445-498) rests on a proof that covers
the raw values: the first complete streamed pass over a column read from a
file (one :func:`.column.keyed` keys) ships it wide and computes on the
device, after each tile's copy, the raw minimum and maximum of an int64 or
uint64 column and whether every value of a float64 column is exactly a
float32; the proof is kept under the column's exact key.  A later pass ships
such an int column as int32 and such a float column as float32 and widens
them on the device before any expression reads them.  Masked and filtered
rows stream as they are, so the proof covers them; a declared category
proves nothing (the reference's narrowing on category metadata wraps a raw
value past 2^31 into a valid bin).
"""

from __future__ import annotations

import concurrent.futures
import queue
import threading
import time

import numpy as np
import torch

from . import array_types, settings
from .column import (LAZY, STRINGS, ColumnHost, ColumnVirtualRange, placed_device,
                     registered_key, tile_of)
from .datatype import DataType, dtype_of, rides_logical, torch_dtype
from .ops.nullable import NA

INT32_MIN, INT32_MAX = -(1 << 31), (1 << 31) - 1
MASK = "mask"  # a slot's buffer of a column's mask is (name, MASK)
# rows below which a column's host copy runs on the calling thread
PARALLEL_COPY_ROWS = 1 << 18
# the least rows of a streamed tile however wide the columns (the ring may
# then pass STREAM_RING_BYTES)
RING_TILE_ROWS_MIN = 1 << 16

# the proofs of the columns streamed so far: the column's exact key ->
# {"min", "max"} of an int column's raw values or {"f32": bool} of a float
# column's (see the module's docstring)
_proofs = {}
_proofs_lock = threading.Lock()


def clear_proofs():
    with _proofs_lock:
        _proofs.clear()


def proof_of(col):
    """The proof kept for a keyed column, or None."""
    known = registered_key(col)
    if known is None:
        return None
    with _proofs_lock:
        return _proofs.get(known[0])


def is_host_column(col):
    """A column whose tile a pass copies from the host: not a tensor, a lazy
    column over tensors, a range made on the device or strings."""
    return placed_device(col) is None and not isinstance(col, STRINGS + (ColumnVirtualRange,))


def stream_mode(n_rows, tile_rows, names):
    """"transfer-ahead", "prefetch" or None (the synchronous copy): a pass
    streams its host columns ``names`` when it has more than one tile."""
    if not names or n_rows <= tile_rows:
        return None
    if settings.TRANSFER_AHEAD > 0:
        return "transfer-ahead"
    if settings.PREFETCH > 0:
        return "prefetch"
    return None


def ring_tile_rows(dataset, names, tile_rows):
    """``tile_rows`` clamped, to a power of two, so that the ring of a
    transfer-ahead stream of the host columns ``names`` (each at its tensor
    dtype, which narrowing only shrinks, with a byte of mask) holds at most
    ``settings.STREAM_RING_BYTES``."""
    row_bytes = sum(torch_dtype(_numpy_dtype(dataset, name)).itemsize + 1 for name in names)
    rows = settings.STREAM_RING_BYTES // ((max(settings.TRANSFER_AHEAD, 1) + 1) * row_bytes)
    if rows >= tile_rows:
        return tile_rows
    return max(1 << (max(rows, 1).bit_length() - 1), RING_TILE_ROWS_MIN)


def _numpy_dtype(dataset, name):
    logical = dataset.logical.get(name)
    return np.dtype(logical) if logical is not None else DataType(dtype_of(dataset[name])).numpy


class _Column:
    """What a stream knows of one column: its tensor dtype, its dtype on the
    wire (narrowed by a proof), the logical dtype its tiles carry, and
    whether this pass builds its proof."""

    def __init__(self, dataset, name):
        col = dataset[name]
        npdt = _numpy_dtype(dataset, name)
        self.name = name
        self.logical = npdt if rides_logical(npdt) else None
        self.tensor = torch_dtype(npdt)
        self.key = registered_key(col)
        proof = proof_of(col)
        integer = self.tensor == torch.int64 and npdt.kind in "iu"
        real = self.tensor == torch.float64
        self.wire = self.tensor
        if proof is not None and integer and INT32_MIN <= proof["min"] and (
                proof["max"] <= INT32_MAX):
            self.wire = torch.int32
        elif proof is not None and real and proof["f32"]:
            self.wire = torch.float32
        # a keyed int64 / uint64 / float64 column without a proof gets one
        self.builds = None if proof is not None or self.key is None else (
            "int" if integer else "f32" if real else None)


def host_part(value):
    """A chunk of a host column as (numpy data, bool mask or None)."""
    if isinstance(value, ColumnHost):
        value = value[:]
    elif isinstance(value, LAZY):
        part = tile_of(value, 0, len(value))
        return (part.data.numpy(), None if part.mask is None else part.mask.numpy())
    elif isinstance(value, torch.Tensor):
        return value.numpy(), None
    data, mask = array_types.data_and_mask(value)
    if data.dtype.kind in "Mm" or data.dtype == np.uint64:
        data = data.view(np.int64)
    return data, mask


class TileStream:
    """The tiles of the host columns ``names`` of ``dataset``, ``tile_rows``
    at a time, as NAs on ``device``: iterate it for ``(i1, i2, {name:
    NA})``, ``close()`` it at the end of the pass (which stops the
    producer), ``commit()`` the proofs after a complete pass."""

    def __init__(self, dataset, names, tile_rows, device, mode):
        self.dataset, self.names, self.T = dataset, list(names), int(tile_rows)
        self.device, self.mode = torch.device(device), mode
        self.columns = {name: _Column(dataset, name) for name in self.names}
        if mode != "transfer-ahead":  # the pass copies each tile as it is
            for col in self.columns.values():
                col.wire = col.tensor
        self.cuda = self.device.type == "cuda"
        self.compute_stream = torch.cuda.current_stream(self.device) if self.cuda else None
        self.copy_stream = torch.cuda.Stream(self.device) if (
            self.cuda and mode == "transfer-ahead") else None
        self.depth = max(settings.TRANSFER_AHEAD if mode == "transfer-ahead"
                         else settings.PREFETCH, 1)
        self.ring_size = self.depth + 1
        self.host_copy_s = 0.0  # the producer's host copies, all tiles
        self.wait_s = 0.0  # the pass's waits for the next tile
        self.wire_bytes = 0
        self.ring_bytes = 0  # the slots' host buffers
        self._stop = threading.Event()
        self._thread = None
        self._proof_state = {}  # name -> device tensors of the proof so far
        self._pool = None

    # -- the pass's side ---------------------------------------------------
    def __iter__(self):
        items = self._transfer_ahead() if self.mode == "transfer-ahead" else (
            (i1, i2, chunks, None) for i1, i2, chunks in self._chunks())
        for i1, i2, columns, event in self._threaded(items):
            if event is not None:
                self.compute_stream.wait_event(event)
            if self.mode != "transfer-ahead":  # the synchronous copy of each chunk
                parts = {name: tile_of(chunk, 0, i2 - i1, self.device)
                         for name, chunk in columns.items()}
                columns = {name: (part.data, part.mask) for name, part in parts.items()}
            tiles = {}
            for name, (data, mask) in columns.items():
                col = self.columns[name]
                self._prove(col, data)
                if data.dtype != col.tensor:
                    data = data.to(col.tensor)  # widen before any expression reads it
                tiles[name] = NA(data, mask, col.logical)
            yield i1, i2, tiles

    def _threaded(self, items):
        """``items`` pulled on a producer thread, at most ``depth`` ahead;
        the producer's exception raises here."""
        q = queue.Queue(maxsize=self.depth)
        end = object()

        def put(item):
            while not self._stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for item in items:
                    if not put(item):
                        return
                put(end)
            except BaseException as e:  # noqa: BLE001 - raised again in the pass
                put(e)
        self._thread = threading.Thread(target=produce, name="vaex-tpu-torch-stream",
                                        daemon=True)
        self._thread.start()
        while True:
            t0 = time.perf_counter()
            item = q.get()
            self.wait_s += time.perf_counter() - t0
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    def close(self):
        """Stop the producer at its next slot and wait for its thread."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def _prove(self, col, data):
        """Fold one tile's raw values into the column's proof, on the
        device, without a copy to the host."""
        if col.builds is None or data.numel() == 0:
            return
        state = self._proof_state.get(col.name)
        if col.builds == "int":
            lo, hi = torch.aminmax(data)
            self._proof_state[col.name] = (lo, hi) if state is None else (
                torch.minimum(state[0], lo), torch.maximum(state[1], hi))
        else:
            exact = ((data == data.to(torch.float32).to(torch.float64)) | torch.isnan(data)).all()
            self._proof_state[col.name] = exact if state is None else state & exact

    def commit(self):
        """Keep the proofs of a complete pass under the columns' keys."""
        found = {}
        for name, col in self.columns.items():
            if col.builds is None:
                continue
            state = self._proof_state.get(name)
            if col.builds == "int":
                found[col.key[0]] = ({"min": 0, "max": 0} if state is None else
                                     {"min": int(state[0].item()), "max": int(state[1].item())})
            else:
                found[col.key[0]] = {"f32": True if state is None else bool(state.item())}
        with _proofs_lock:
            _proofs.update(found)

    def trace(self):
        return {"mode": self.mode, "ring": self.ring_size if self.mode == "transfer-ahead"
                else 0, "pinned": self.cuda and self.mode == "transfer-ahead",
                "host_copy_s": self.host_copy_s, "wait_s": self.wait_s,
                "wire_bytes": self.wire_bytes, "ring_bytes": self.ring_bytes,
                "wire": {n: str(c.wire).replace("torch.", "") for n, c in self.columns.items()},
                "proving": sorted(n for n, c in self.columns.items() if c.builds)}

    # -- the producer's side ----------------------------------------------
    def _chunks(self):
        return self.dataset.chunk_iterator(self.names, self.T)

    def _transfer_ahead(self):
        """The producer's loop (see the module's docstring)."""
        copy_stream, compute_stream = self.copy_stream, self.compute_stream
        ring = [_Slot() for _ in range(self.ring_size)]
        if settings.NUM_THREADS_IO > 1:
            self._pool = concurrent.futures.ThreadPoolExecutor(settings.NUM_THREADS_IO,
                                                              "vaex-tpu-torch-io")
        for k, (i1, i2, chunks) in enumerate(self._chunks()):
            if self._stop.is_set():
                return
            slot = ring[k % self.ring_size]
            slot.wait()  # the copy that last read this slot has completed
            n = i2 - i1
            t0 = time.perf_counter()
            parts = {name: host_part(chunks[name]) for name in self.names}
            jobs = []
            for name, (data, mask) in parts.items():
                col = self.columns[name]
                jobs += self._copy_jobs(slot.buffer(name, col.wire, self.T, self.cuda)[:n], data)
                if mask is not None:
                    jobs += self._copy_jobs(
                        slot.buffer((name, MASK), torch.bool, self.T, self.cuda)[:n], mask)
            if self._pool is not None and len(jobs) > 1:
                list(self._pool.map(_run, jobs))
            else:
                for job in jobs:
                    _run(job)
            self.host_copy_s += time.perf_counter() - t0
            self.ring_bytes = sum(s.nbytes for s in ring)
            columns = {}
            if self.cuda:
                with torch.cuda.stream(copy_stream):
                    for name, (_, mask) in parts.items():
                        columns[name] = tuple(
                            None if src is None else _to_device(src, self.device, compute_stream)
                            for src in (slot.tensors[name][:n], None if mask is None else
                                        slot.tensors[(name, MASK)][:n]))
                    event = torch.cuda.Event()
                    event.record(copy_stream)
                slot.event = event
            else:
                event = None
                for name, (_, mask) in parts.items():
                    columns[name] = (slot.tensors[name][:n].clone(), None if mask is None else
                                     slot.tensors[(name, MASK)][:n].clone())
            self.wire_bytes += sum(t.numel() * t.element_size() for pair in columns.values()
                                   for t in pair if t is not None)
            yield i1, i2, columns, event

    def _copy_jobs(self, dst, src):
        """The host copy of ``src`` into the slot tensor ``dst`` (casting,
        which narrows a proven column), in parts for the IO threads."""
        dst = dst.numpy()
        n = len(src)
        if n < PARALLEL_COPY_ROWS or self._pool is None:
            return [(dst, src)]
        step = -(-n // settings.NUM_THREADS_IO)
        return [(dst[a:a + step], src[a:a + step]) for a in range(0, n, step)]


def _run(job):
    dst, src = job
    np.copyto(dst, src, casting="unsafe")


def _to_device(src, device, compute_stream):
    """An async copy of a page-locked slot on the current (copy) stream, its
    memory marked as used by the compute stream."""
    out = torch.empty(src.shape, dtype=src.dtype, device=device)
    out.copy_(src, non_blocking=True)
    out.record_stream(compute_stream)
    return out


class _Slot:
    """One slot of the ring: a host buffer per column (and mask), page-locked
    on a CUDA pass, and the event of the copy that last read it."""

    def __init__(self):
        self.tensors = {}
        self.event = None

    @property
    def nbytes(self):
        return sum(t.numel() * t.element_size() for t in self.tensors.values())

    def wait(self):
        if self.event is not None:
            self.event.synchronize()
            self.event = None

    def buffer(self, name, dtype, rows, pinned):
        t = self.tensors.get(name)
        if t is None or t.dtype != dtype:
            t = self.tensors[name] = torch.empty(rows, dtype=dtype, pin_memory=pinned)
        return t
