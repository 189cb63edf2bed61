"""The pass executor: an eager tile loop over the columns a pass needs.

One pass collects the queued tasks of a DataFrame, picks the pass device
(the device of its tensor columns; when every column is a host array, the
device the frame was staged to or, for a frame no one staged,
``settings.DEVICE``), walks the rows in tiles of ``TILE_ROWS``, and calls
every task's ``update`` once per tile.  A tile of a tensor column is a view,
so a device-resident table is read in place; a tile of a host array is
copied to the pass device.  So a host frame's query runs on the card unless
the caller stages it elsewhere (``to_device("cpu")``) or sets
``settings.DEVICE``; without a card torch raises.  Torch runs eagerly: each
tile's expression evaluation and binning are separate kernels, then the
grid kernel runs.

A filtered DataFrame's filter is evaluated once per tile into
``TileContext.row_valid`` (masked rows count as False); every task drops the
rows it marks False.  The variables an expression names (sets, arrays) are
resolved once per pass (:func:`.scopes.resolve_variables`).

Not ported yet (ROADMAP queue A): the whole-pass loop, the host stage for
string expressions, named selections, the mesh, the result cache.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import array_types, settings
from .ops.nullable import NA
from .scopes import DeviceScope, column_names, resolve_variables, variable_names
from .tasks import TaskAggregations
from .utils import trace


class TileContext:
    """Everything a task's ``update`` can ask for about one tile."""

    def __init__(self, scope: DeviceScope, n_rows, device, row_valid=None):
        self.scope = scope
        self.n_rows = n_rows
        self.device = device
        # bool [n_rows], False for the rows the frame's filter drops; None
        # when every row counts
        self.row_valid = row_valid

    def expr(self, expression) -> NA:
        return self.scope.evaluate(str(expression))

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
        self.passes += 1
        t_start = time.perf_counter()
        dataset = df.dataset_for_execution()
        filter_expression = df.filter_expression
        expressions = [expr for task in tasks for expr in task.expressions]
        if filter_expression is not None:
            expressions.append(filter_expression)
        names, device, variables = pass_inputs(df, dataset, expressions)
        n_total = dataset.row_count
        T = df._tile_rows or settings.TILE_ROWS
        states = [t.initial_state(device) for t in tasks]
        n_tiles = 0
        for i1 in range(0, max(n_total, 1), T):
            i2 = min(i1 + T, n_total)
            tile = {name: _tile(dataset[name], i1, i2, device) for name in names}
            ctx = TileContext(DeviceScope(tile, variables), i2 - i1, device)
            if filter_expression is not None:
                ctx.row_valid = ctx.boolean(filter_expression)
            states = [t.update(s, ctx) for t, s in zip(tasks, states)]
            n_tiles += 1
        for task, state in zip(tasks, states):
            task.finalize(state)
        self.trace_log.append({
            "pass": self.passes,
            "wall_s": time.perf_counter() - t_start,  # host enqueue time
            "rows": n_total,
            "tile_rows": T,
            "tiles": n_tiles,
            "device": str(device),
            "tasks": [t.name for t in tasks],
            # per aggregation task, the kernel each kind of aggregator took, e.g.
            # {"additive": "b3", "scatter": "shared", "moments": "b5", "extremes": "b3x"}
            "strategies": [t.strategy for t in tasks if isinstance(t, TaskAggregations)],
            # the route the pass's set probes took ("b6", "b6-wide"), None
            # when it probed no set
            "probe": "+".join(sorted({v.route for v in variables.values()
                                      if getattr(v, "route", None)})) or None,
        })
        if len(self.trace_log) > 1000:
            del self.trace_log[:500]


def pass_inputs(df, dataset, expressions):
    """What a pass of ``df`` over ``expressions`` reads: the sorted names of
    its columns, its device, and its variables resolved on that device."""
    names, used_variables = set(), set()
    for expr in expressions:
        names |= column_names(expr, df.variables)
        used_variables |= variable_names(expr, df.variables)
    missing = names - set(dataset)
    if missing:
        raise NameError(f"column(s) {sorted(missing)} do not exist")
    names = sorted(names)
    device = _pass_device(dataset, names)
    return names, device, resolve_variables(df.variables, sorted(used_variables), device)


def _pass_device(dataset, names):
    """The device of the pass's tensor columns (the dataset's, when the pass
    reads none); when all its columns are host arrays, the device the
    dataset was placed on, else ``settings.DEVICE``."""
    devices = {dataset[n].device for n in names if isinstance(dataset[n], torch.Tensor)}
    if not devices:
        devices = {c.device for c in dataset.values() if isinstance(c, torch.Tensor)}
    if len(devices) > 1:
        raise ValueError(f"a pass reads columns on several devices: {sorted(map(str, devices))}")
    if devices:
        return devices.pop()
    return dataset.device or torch.device(settings.DEVICE)


def _tile(col, i1, i2, device) -> NA:
    """Rows [i1, i2) of a column as an NA on ``device``."""
    part = col[i1:i2]
    if isinstance(part, torch.Tensor):
        return NA(part.to(device))
    data, mask = array_types.data_and_mask(part)
    return NA(array_types.to_tensor(data, device),
              None if mask is None else torch.as_tensor(np.asarray(mask)).to(device))
