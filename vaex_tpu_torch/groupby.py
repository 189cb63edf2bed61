"""GroupBy over categorical keys.

The port of the zero-pass plan of ``vaex_tpu/groupby.py``: a
:class:`GrouperCategory` bins each key with its category metadata, one
aggregation pass fills the grids, and ``_assemble`` builds the result
frame.  One key keeps every category, empty ones included.  Several keys
take the cartesian grid of their categories and drop the combinations no
row has, which an extra ``count("*")`` grid tells, as vaex_tpu does while
the product of the cardinalities is at most ``COMBINE_MIN_PRODUCT``.  Past
that vaex_tpu fuses the keys into one set-based ``GrouperCombined``; that,
the set-based groupers of non-category keys and BinBy are not ported yet
(ROADMAP queue A6).
"""

from __future__ import annotations

import collections.abc

import numpy as np
import torch

from . import agg as agg_module
from .agg import AggregatorDescriptor
from .expression import Expression
from .ops.binners import BinnerOrdinal
from .utils import trace

GROUPERS_PENDING = "not ported yet (ROADMAP queue A6)"
# vaex_tpu/groupby.py:_should_combine: several keys whose cardinalities
# multiply past this take GrouperCombined instead of the cartesian grid
COMBINE_MIN_PRODUCT = 1_000_000


class GrouperCategory:
    """Zero-pass grouper using category metadata."""

    def __init__(self, expression, df, sort=False, ascending=True):
        if isinstance(expression, Expression):
            expression = expression.expression
        self.df = df
        self.expression = str(expression)
        self.sort = sort
        self.ascending = ascending
        self.N = df.category_count(self.expression)
        self.min_value = df.category_offset(self.expression)
        self.bin_values = df.category_labels(self.expression, aslist=False)
        self.bin_values_raw = self.bin_values  # in code order, as the grid
        self.binner = BinnerOrdinal(self.expression, self.min_value, self.N)
        self.sort_indices = None
        if sort:
            order = np.argsort(self.bin_values, kind="stable")
            if not ascending:
                order = order[::-1]
            if not np.array_equal(order, np.arange(self.N)):
                self.sort_indices = order
                self.bin_values = self.bin_values[order]


class GroupBy:
    """df.groupby over one or more categorical keys."""

    def __init__(self, df, by, sort=False, ascending=True):
        self.df = df.copy()
        self.sort = sort
        by = list(by) if isinstance(by, (list, tuple)) else [by]
        self.by_names = [b.expression if isinstance(b, Expression) else str(b) for b in by]
        self.ascending = (list(ascending) if isinstance(ascending, (list, tuple))
                          else [ascending] * len(by))
        for name in self.by_names:
            if not self.df.is_category(name):
                raise NotImplementedError(
                    f"groupby over the non-category key {name!r} is {GROUPERS_PENDING}")
        self.groupers = [GrouperCategory(name, self.df, sort=sort, ascending=asc)
                         for name, asc in zip(self.by_names, self.ascending)]
        product = int(np.prod([max(g.N, 1) for g in self.groupers], dtype=np.float64))
        if len(self.groupers) > 1 and product > COMBINE_MIN_PRODUCT:
            raise NotImplementedError(
                f"groupby over {len(self.groupers)} keys with {product} combinations "
                f"(> {COMBINE_MIN_PRODUCT}) needs the set-based GrouperCombined, which is "
                f"{GROUPERS_PENDING}")
        self.binners = tuple(g.binner for g in self.groupers)

    def _parse_actions(self, actions):
        """(output name, descriptor) pairs, named as vaex_tpu names them."""
        out = []
        if isinstance(actions, collections.abc.Mapping):
            items = list(actions.items())
        elif isinstance(actions, (list, tuple)):
            items = [(None, a) for a in actions]
        else:
            items = [(None, actions)]
        for name, spec in items:
            multiple = isinstance(spec, (list, tuple))
            for s in (spec if multiple else [spec]):
                if isinstance(s, str) and s == "count":
                    out.append((name or "count", agg_module.count("*")))
                    continue
                if isinstance(s, str):
                    if s not in agg_module.aggregates:
                        raise NotImplementedError(
                            f"aggregator {s!r} is {agg_module.PENDING}")
                    s = agg_module.aggregates[s]
                if isinstance(s, AggregatorDescriptor):
                    if name is None or multiple:
                        out.append((s.pretty_name(name if multiple else None), s))
                    else:
                        out.append((name, s))
                elif callable(s):
                    columns = ([name] if name is not None else
                               [c for c in self.df.get_column_names()
                                if c not in self.by_names and not c.startswith("__")])
                    for column in columns:
                        desc = s(column)
                        out.append((desc.pretty_name() if (multiple or name is None)
                                    else name, desc))
                else:
                    raise NotImplementedError(f"aggregator {s!r} is {agg_module.PENDING}")
        return out

    def agg(self, actions):
        parsed = self._parse_actions(actions)
        ndim = len(self.binners)
        promises = []
        for name, desc in parsed:
            [p] = desc.add_tasks(self.df, self.binners)
            promises.append((name, desc, p))
        # several keys: the count grid tells which combinations some row has
        counts = next((p for _, desc, p in promises if _is_count_star(desc)), None)
        if ndim > 1 and counts is None:
            [counts] = agg_module.count("*").add_tasks(self.df, self.binners)
        with trace("groupby agg pass (execute)"):
            self.df.execute()
        grids = {name: agg_module.extract_central(p.get(), ndim) for name, _, p in promises}
        with trace("groupby assemble"):
            if ndim == 1:
                return self._assemble_one(grids)
            return self._assemble_cartesian(
                grids, agg_module.extract_central(counts.get(), ndim))

    def _assemble_one(self, grids):
        from . import from_dict
        g = self.groupers[0]
        columns = {self.by_names[0]: g.bin_values}
        order = None
        if g.sort_indices is not None:
            order = torch.as_tensor(np.ascontiguousarray(g.sort_indices))
        for name, grid in grids.items():
            columns[name] = grid if order is None else grid[order.to(grid.device)]
        return from_dict(columns)

    def _assemble_cartesian(self, grids, counts):
        """The observed cells of the cartesian grid, in row-major order of the
        category codes, then sorted by the keys when ``sort``
        (vaex_tpu/groupby.py:963-982).  Unlike vaex_tpu, which sorts them
        ascending whatever ``ascending`` says, each key sorts in its own
        direction."""
        from . import from_dict
        keep = torch.nonzero(counts.reshape(-1) > 0).squeeze(1)
        cells = np.unravel_index(keep.cpu().numpy(), tuple(counts.shape))
        columns = {name: g.bin_values_raw[codes]
                   for name, g, codes in zip(self.by_names, self.groupers, cells)}
        for name, grid in grids.items():
            columns[name] = grid.reshape(-1)[keep.to(grid.device)]
        df = from_dict(columns)
        return df.sort(self.by_names, ascending=self.ascending) if self.sort else df


def _is_count_star(desc):
    return desc.name == "count" and desc.expression in (None, "*")
