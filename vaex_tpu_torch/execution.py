"""The pass executor: an eager tile loop over the columns a pass needs.

One pass collects the queued tasks of a DataFrame, picks the pass device
(the device of its columns held in tensors; when every column is a host
array, the device the frame was staged to or, for a frame no one staged,
``settings.DEVICE``), walks the rows in tiles of ``TILE_ROWS``, and calls
every task's ``update`` once per tile.  A tile of a tensor column is a view,
so a device-resident table is read in place; a tile of a masked, indexed or
concatenated column (:mod:`.column`) is read on its device, its data and
mask as two tensors (an indexed column with one gather, a concatenated one
across the parts the tile spans); a tile of a host array is copied to the
pass device.  So a host frame's query runs on the card unless
the caller stages it elsewhere (``to_device("cpu")``) or sets
``settings.DEVICE``; without a card torch raises.  Torch runs eagerly: each
tile's expression evaluation and binning are separate kernels, then the
grid kernel runs.

A filtered DataFrame's filter is evaluated once per tile into
``TileContext.row_valid`` (masked rows count as False); every task drops the
rows it marks False.  The variables an expression names (sets, arrays) are
resolved once per pass (:func:`.scopes.resolve_variables`); a virtual
column is read through its expression, so a pass loads only the physical
columns under it and evaluates it once per tile however many expressions
name it.

The host stage (vaex_tpu/execution.py:200-248, 502-545, 590-612): the
expressions of a pass that :func:`.scopes.expression_is_device` sends to
the host (string functions, strings that are not staged as codes, the
temporal operations numpy computes) are evaluated per tile on the host,
over host arrays of the columns they read, and copied to the pass device as
tile inputs (:func:`.scopes.ship`; strings as dictionary codes).  A host
filter becomes ``row_valid`` like any other.  The pass device stays the
device of the tensor columns: a staged string column's codes never leave
it.  ``trace_log`` records each pass's host-stage expressions and the host
time they took.

Before it reads a row, a pass looks its cacheable tasks up in the result
cache (:mod:`.cache`, vaex_tpu/execution.py:184-195) by the task's
fingerprint and the frame's exact key, and stores what it computes; a pass
whose tasks the cache served all reads nothing and counts no pass.  After
each tile it emits ``signal_progress`` with the fraction of the rows done;
a callback that returns ``False`` cancels the pass: ``signal_cancel``
fires, its tasks reject with :class:`UserAbort`, and the executor takes
the next queued pass.  ``signal_begin`` and ``signal_end`` frame a pass
(vaex_tpu/execution.py:48-130).

A pass whose device stage reads host columns (arrays, memory maps of a
file, arrow and parquet columns) over more than one tile reads them through
:class:`.stream.TileStream`: a producer thread copies each tile into
page-locked slots and on to the device on a copy stream of its own, ahead of
the compute, narrowing the columns a proof allows; the pass's tile is
clamped so that the slots hold at most ``settings.STREAM_RING_BYTES``.
``PREFETCH = TRANSFER_AHEAD = 0`` selects the synchronous copy of each tile.
``trace_log`` records the stream (its mode, the dtype of each column on the
wire, the slots' bytes, its host copy time and the pass's waits for it).

An executor with a mesh (:mod:`.parallel`, vaex_tpu/execution.py:798-848)
shards the rows contiguously: shard d owns rows ``[d * rpd, (d + 1) *
rpd)`` of this process's rows and walks its own tiles of ``tile / shards``
rows (the tile rounded to the mesh, vaex_tpu/execution.py:250-253) on its
own device, where a tensor column is a view when the shard's device is the
column's own and else a copy of the shard's rows, kept for the next pass
under the column's exact key.  Host columns are copied tile by tile,
synchronously.  Each task keeps one state per shard, and at the end of the
pass each task's ``merge`` combines them with the collectives of
:mod:`.parallel.collectives` (vaex_tpu/tasks.py:458-476, taken once a pass
rather than once a tile).  Row ids stay global, so ``first`` and the
row-writing tasks see the rows where they are.  ``trace_log`` records the
shards and their rows under ``mesh``; the result cache keys a sharded
pass's results by the mesh.

Not ported yet (ROADMAP queue A): the whole-pass loop.
"""

from __future__ import annotations

import logging
import time

import torch

from . import cache, settings
from .column import column_key, column_to, placed_device, slice_column, tile_of
from .stream import TileStream, is_host_column, ring_tile_rows, stream_mode
from .datatype import rides_logical
from .ops.nullable import NA, DictNA
from .scopes import (DeviceScope, HostScope, column_names, expression_is_device, host_chunk,
                     resolve_variables, ship, variable_names)
from .tasks import TaskAggregations
from .utils import Signal, trace

logger = logging.getLogger("vaex_tpu_torch.execution")


class UserAbort(Exception):
    """A progress callback cancelled the pass."""


class TileContext:
    """Everything a task's ``update`` can ask for about one tile."""

    def __init__(self, scope: DeviceScope, n_rows, device, row_valid=None, i1=0, base=0):
        self.scope = scope
        self.n_rows = n_rows
        self.i1 = i1  # the tile's first row in the pass
        self.base = base  # the first row of the tile's shard (0 on one device)
        self.device = device
        # bool [n_rows], False for the rows the frame's filter drops; None
        # when every row counts
        self.row_valid = row_valid

    def expr(self, expression) -> NA:
        """The expression over the tile's rows; a constant one broadcast to
        them."""
        value = self.scope.evaluate(str(expression))
        if value.data.dim() == 0:
            value = NA(value.data.to(self.device).expand(self.n_rows),
                       None if value.mask is None else value.mask.to(self.device).expand(
                           self.n_rows), value.logical)
        return value

    def boolean(self, expression):
        """A boolean expression as a bool tensor, False where it is missing."""
        value = self.expr(expression)
        valid = value.data.to(torch.bool)
        return valid if value.mask is None else valid & ~value.mask

    def selection_valid(self, selection):
        """The rows that pass the filter and ``selection`` (a boolean
        expression or None); None when every row does."""
        if selection is None:
            return self.row_valid
        valid = self.boolean(selection)
        return valid if self.row_valid is None else valid & self.row_valid


class Executor:
    """Task queue; aggregations sharing a binner stack merge into one task."""

    def __init__(self):
        self.tasks = []
        self.passes = 0
        self.trace_log = []
        self.signal_begin = Signal("begin")
        self.signal_progress = Signal("progress")
        self.signal_end = Signal("end")
        self.signal_cancel = Signal("cancel")

    def schedule(self, task):
        self.tasks.append(task)
        return task

    def schedule_aggregation(self, df, binners, op, selection=None):
        """Queue ``op`` on the pending aggregation task of ``df`` with the
        same binners and selection, or on a new one."""
        binners = tuple(binners)
        for task in self.tasks:
            if (isinstance(task, TaskAggregations) and task.df is df
                    and task.binners == binners and task.selection == selection
                    and not task.done):
                return task.add_subtask(op)
        task = TaskAggregations(df, binners, selection)
        sub = task.add_subtask(op)
        self.schedule(task)
        return sub

    def _pop_tasks(self):
        """All pending tasks of one DataFrame."""
        df = self.tasks[0].df
        picked = [t for t in self.tasks if t.df is df]
        self.tasks = [t for t in self.tasks if t.df is not df]
        return df, picked


class ExecutorLocal(Executor):
    def __init__(self, mesh=None):
        super().__init__()
        self.mesh = mesh
        # (column key, device, rows) -> the shard's rows copied to a shard's
        # device, kept from one pass to the next
        self._shard_copies = {}

    @property
    def sharded(self):
        """The mesh when passes run sharded over it (two shards or more)."""
        return self.mesh if self.mesh is not None and self.mesh.size > 1 else None

    def execute(self):
        while self.tasks:
            df, tasks = self._pop_tasks()
            try:
                with trace(f"pass[{','.join(t.name for t in tasks)}]"):
                    self._execute_pass(df, tasks)
            except Exception as e:
                for task in tasks:
                    if not task.done:
                        task.reject(e)
                raise

    def _execute_pass(self, df, tasks):
        t_start = time.perf_counter()
        self.signal_begin.emit()
        mesh = self.sharded
        tasks = _from_cache(df, tasks, mesh)
        if not tasks:
            self.signal_end.emit()
            return
        self.passes += 1
        dataset = df.dataset_for_execution()
        filter_expression = df.filter_expression
        expressions = [expr for task in tasks for expr in task.expressions]
        if filter_expression is not None:
            expressions.append(filter_expression)
        n_total = dataset.row_count
        T = df._tile_rows or settings.TILE_ROWS
        stream = None
        if mesh is None:
            inputs = pass_inputs(df, dataset, expressions)
            device = inputs.device
            host = [name for name in inputs.names if is_host_column(dataset[name])]
            if host and settings.TRANSFER_AHEAD > 0:  # the ring of page-locked slots fits its bytes
                T = ring_tile_rows(dataset, host, T)
            mode = stream_mode(n_total, T, host)
            stream = TileStream(dataset, host, T, device, mode) if mode else None
            walks = [(inputs, 0, n_total, T)]
        else:
            device = mesh.first
            inputs = pass_inputs(df, dataset, expressions, device)
            walks = shard_walks(self, df, dataset, inputs, mesh, T)
        tiles = iter(stream) if stream else None
        shard_states, n_tiles, done = [], 0, 0
        try:
            for shard_inputs, r1, r2, t in walks:
                states = [task.initial_state(shard_inputs.device, r2 - r1) for task in tasks]
                for i1 in range(r1, max(r2, r1 + 1), t):
                    i2 = min(i1 + t, r2)
                    streamed = None
                    if tiles is not None:
                        j1, j2, streamed = next(tiles)
                        if (j1, j2) != (i1, i2):
                            raise RuntimeError(f"the stream gave rows {(j1, j2)} for {(i1, i2)}")
                    ctx = shard_inputs.context(df, dataset, i1, i2, streamed)
                    ctx.base = r1
                    if filter_expression is not None:
                        ctx.row_valid = ctx.boolean(filter_expression)
                    states = [task.update(s, ctx) for task, s in zip(tasks, states)]
                    n_tiles += 1
                    done += i2 - i1
                    progress = done / n_total if n_total else 1.0
                    if any(r is False for r in self.signal_progress.emit(progress)):
                        self.signal_cancel.emit()
                        for task in tasks:
                            task.reject(UserAbort("user aborted"))
                        return
                shard_states.append(states)
        finally:
            if stream is not None:
                stream.close()
        if stream is not None:
            stream.commit()
        if mesh is None:
            states = shard_states[0]
        else:
            states = [task.merge([s[k] for s in shard_states], mesh)
                      for k, task in enumerate(tasks)]
        for task, state in zip(tasks, states):
            task.finalize(state)
            if getattr(task, "_cache_key", None) is not None:
                cache.store(task._cache_key, task.result)
        self.trace_log.append({
            "pass": self.passes,
            "wall_s": time.perf_counter() - t_start,  # host enqueue time
            "rows": n_total,
            "tile_rows": walks[0][3],
            "tiles": n_tiles,
            "device": str(device),
            "tasks": [t.name for t in tasks],
            # per aggregation task, the kernel each kind of aggregator took, e.g.
            # {"additive": "b3", "scatter": "shared", "moments": "b5", "extremes": "b3x"}
            "strategies": [t.strategy for t in tasks if isinstance(t, TaskAggregations)],
            # the route the pass's set probes took ("b6", "b6-wide"), None
            # when it probed no set
            "probe": "+".join(sorted({v.route for w in walks
                                      for v in [*w[0].variables.values(), *tasks]
                                      if getattr(v, "route", None)})) or None,
            # the expressions of the host stage, and its host time over all tiles
            "host_stage": inputs.host_expressions,
            "host_s": sum({id(w[0]): w[0].host_s for w in walks}.values()),
            # the streamed host columns (:mod:`.stream`), None for a pass
            # that copied its tiles synchronously or read none
            "stream": None if stream is None else stream.trace(),
            # the shards of a sharded pass: their devices, each one's rows,
            # and the process's place in the mesh's group; None on one device
            "mesh": None if mesh is None else {
                "shards": [str(d) for d in mesh.devices],
                "rows_per_shard": [r2 - r1 for _, r1, r2, _ in walks],
                "rank": mesh.rank, "world": mesh.world,
                "copied_columns": sorted({k[0] for k in self._shard_copies}),
            },
        })
        if len(self.trace_log) > 1000:
            del self.trace_log[:500]
        self.signal_end.emit()


def shard_walks(executor, df, dataset, inputs, mesh, tile_rows):
    """Per shard of ``mesh``: (``inputs`` on the shard's device, its first
    row, its end, its tile's rows), the tile of ``tile_rows`` rounded to the
    mesh and cut into shard tiles (vaex_tpu/execution.py:250-253).  A
    column on another device is copied to the shard's once and kept in
    ``executor`` (an :class:`ExecutorLocal`) for its next walk."""
    kept = getattr(executor, "_shard_copies", {})
    copies = {}
    T = -(-tile_rows // mesh.size) * mesh.size
    walks = [(inputs.on(df, dataset, d, r1, r2, kept, copies), r1, r2, T // mesh.size)
             for d, (r1, r2) in zip(mesh.devices, mesh.row_ranges(dataset.row_count))]
    if hasattr(executor, "_shard_copies"):
        executor._shard_copies = copies
    return walks


def _from_cache(df, tasks, mesh=None):
    """The tasks the result cache cannot serve; it fulfills the others.
    Each cacheable task that misses keeps its key for the store; a sharded
    pass's key holds its mesh.  Over a mesh of several processes a task is
    served only where every process holds it: a pass that one process runs
    merges with every process."""
    cacheable = [t for t in tasks if t.cacheable]
    if not cacheable or not cache.is_on():
        return tasks
    frame, content = df._cache_key([e for t in cacheable for e in t.expressions])
    if frame is None:  # a card tensor: no exact key, nothing kept
        return tasks
    keys, hits = {}, {}
    for task in cacheable:
        parts = (task.fingerprint(), frame) + (() if mesh is None else (mesh.key(),))
        keys[task] = cache.key(*parts, content=content)
        hits[task] = cache.lookup(keys[task])
    if mesh is not None and mesh.group is not None:
        from .parallel import collectives
        held = torch.tensor([hits[t] is not None for t in cacheable])
        held = collectives.reduce([held], "min", mesh).tolist()
        hits = {t: hit if ok else None for (t, hit), ok in zip(hits.items(), held)}
    remaining = []
    for task in tasks:
        if task.cacheable:
            if hits[task] is not None:
                task.fulfill(hits[task])
                continue
            task._cache_key = keys[task]
        remaining.append(task)
    return remaining


class PassInputs:
    """What a pass reads: the sorted names of the columns its device stage
    loads, the expressions of its host stage and the columns they read, its
    device and its variables resolved there."""

    def __init__(self, names, host_expressions, host_names, device, variables, copies=None):
        self.names = names
        self.host_expressions = host_expressions
        self.host_names = host_names
        self.device = device
        self.variables = variables
        self.host_s = 0.0  # host time of the host stage, all tiles
        # name -> (a copy of a shard's rows on the shard's device, its first row)
        self.copies = copies or {}

    def on(self, df, dataset, device, r1, r2, kept, copies):
        """These inputs for the shard of rows [r1, r2) on ``device``: its
        variables resolved there, and each tensor column that lies on
        another device copied there once, taken from ``kept`` (the last
        pass's copies) where its exact key is there, and recorded in
        ``copies``."""
        shard = {}
        for name in self.names:
            col = dataset[name]
            home = placed_device(col)
            if home is None or home == device:
                continue
            exact = column_key(col)[0]
            if exact is None:  # no exact key (a card tensor): copied anew each pass
                shard[name] = (column_to(slice_column(col, r1, r2), device), r1)
                continue
            key = (name, exact, str(device), r1, r2)
            if key not in kept:
                kept[key] = column_to(slice_column(col, r1, r2), device)
            copies[key] = kept[key]
            shard[name] = (copies[key], r1)
        if device == self.device and not shard:
            return self
        variables = (self.variables if device == self.device else
                     resolve_variables(df.variables, sorted(self.variables), device))
        return PassInputs(self.names, self.host_expressions, self.host_names, device,
                          variables, shard)

    def context(self, df, dataset, i1, i2, streamed=None) -> TileContext:
        """Rows [i1, i2): the device columns' tiles on the pass device (those
        in ``streamed`` as a :class:`.stream.TileStream` gave them) and the
        host stage's results copied there."""
        streamed = streamed or {}
        tile = {name: streamed[name] if name in streamed else
                _tile(dataset, name, i1, i2, self.device, self.copies.get(name))
                for name in self.names}
        scope = DeviceScope(tile, self.variables, df.virtual_columns)
        if self.host_expressions:
            t0 = time.perf_counter()
            host = HostScope({name: host_chunk(dataset, name, i1, i2) for name in self.host_names},
                             df.variables, df.virtual_columns, i2 - i1, df._function_impls)
            for expression in self.host_expressions:
                scope.values[expression] = ship(host.evaluate_raw(expression), self.device,
                                                i2 - i1)
            self.host_s += time.perf_counter() - t0
        return TileContext(scope, i2 - i1, self.device, i1=i1)


def pass_inputs(df, dataset, expressions, device=None) -> PassInputs:
    """What a pass of ``df`` over ``expressions`` reads
    (:class:`PassInputs`) on ``device`` (the columns' own when None); each
    expression is in one stage."""
    names, used_variables, host_names, host_expressions = set(), set(), set(), []
    for expr in dict.fromkeys(map(str, expressions)):
        leaves = column_names(expr, df.variables, df.virtual_columns)
        if expression_is_device(df, expr):
            names |= leaves
            used_variables |= variable_names(expr, df.variables, df.virtual_columns)
        else:
            host_expressions.append(expr)
            host_names |= leaves
    missing = (names | host_names) - set(dataset)
    if missing:
        raise NameError(f"column(s) {sorted(missing)} do not exist")
    device = device or _pass_device(dataset, sorted(names | host_names))
    return PassInputs(sorted(names), host_expressions, sorted(host_names), device,
                      resolve_variables(df.variables, sorted(used_variables), device))


def _pass_device(dataset, names):
    """The device of the pass's columns held in tensors (the dataset's, when
    the pass reads none); when all its columns are host arrays, the device
    the dataset was placed on, else ``settings.DEVICE``."""
    devices = {placed_device(dataset[n]) for n in names} - {None}
    if not devices:
        devices = {placed_device(c) for c in dataset.values()} - {None}
    if len(devices) > 1:
        raise ValueError(f"a pass reads columns on several devices: {sorted(map(str, devices))}")
    if devices:
        return devices.pop()
    return dataset.device or torch.device(settings.DEVICE)


def _tile(dataset, name, i1, i2, device, copy=None) -> NA:
    """Rows [i1, i2) of a column as an NA on ``device`` (read from ``copy``,
    a shard's rows and its first row, where given); a datetime, timedelta
    or uint64 column as its int64 tensor with its dtype."""
    if copy is not None:
        part = tile_of(copy[0], i1 - copy[1], i2 - copy[1], device)
    else:
        part = tile_of(dataset[name], i1, i2, device)
    if isinstance(part, DictNA):
        return part
    logical = dataset.logical.get(name)
    return NA(part.data, part.mask, logical if rides_logical(logical) else None)
