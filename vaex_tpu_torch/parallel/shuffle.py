"""The all-to-all groupby (vaex_tpu/parallel/shuffle.py).

Past ``groupby.SHUFFLE_MIN_G`` groups a sharded groupby stops giving every
shard the whole grid: each shard packs its rows into one bucket per owner,
shard ``s`` owning the group codes ``[s * gper, (s + 1) * gper)``, the
buckets are exchanged with one all-to-all (:func:`.collectives.all_to_all`)
and each owner adds its rows into its ``gper`` bins through the port's grid
plan (:mod:`..ops.grid_plan`: B1 / B2 / B3 / B3x over the owner's codes
after subtracting its offset), so the hand-written kernels carry the
owner's work.  The packing (a stable sort by owner, each row's rank in its
bucket) is torch calls, as the reference's are XLA sorts.

Capacity: a bucket holds ``cap = max(64, slack * n_local // S)`` rows
(``n_local`` the rows of a shard, ``S`` the shards); the rows past it are
counted as dropped before anything is sent, and the caller retries with
more slack.  Rows whose code lies outside ``[0, G)`` go to no one.

Across processes (a mesh whose group has ``world > 1``) each process packs
its own rows; a shard's place is its global index ``rank * len(devices) +
d``, the capacity and the dropped rows count every process's rows, so that
all retry alike, and every owner's grid is gathered to every process.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import collectives
from .. import agg
from ..agg import RESCUE_SCALE, VAR_TERMS, cancelled, cell_shift, variance
from ..ops.grid_plan import grid_extremes, grid_sums, moment_sums

NU_VALUE, NU_NAN, NU_NULL, NU_NONE = 0, 1, 2, 3  # aux codes of a nunique channel


def shard_rows(values, mesh):
    """A tensor (or numpy array) of this process's rows split into the
    mesh's contiguous shards, each on its shard's device."""
    t = values if isinstance(values, torch.Tensor) else torch.as_tensor(np.asarray(values))
    return [t[r1:r2].to(device) for device, (r1, r2) in
            zip(mesh.devices, mesh.row_ranges(t.shape[0]))]


def capacity(mesh, n_rows, slack):
    """(rows per shard, bucket capacity) for ``n_rows`` rows in all."""
    n_local = -(-n_rows // mesh.size)
    return n_local, max(64, (slack * n_local) // mesh.size)


class Packing:
    """One shard's rows in bucket order: ``order`` sorts them by owner
    (stably), ``dest`` is each sorted row's slot in the [S * cap] send
    buffer (``S * cap``: not sent), ``overflow`` the rows past ``cap``."""

    def __init__(self, owner, S, cap):
        sorted_owner, self.order = torch.sort(owner, stable=True)
        sizes = torch.bincount(sorted_owner, minlength=S + 1)
        start = torch.cumsum(sizes, 0) - sizes
        rank = torch.arange(owner.shape[0], device=owner.device) - start[sorted_owner]
        sent = sorted_owner < S
        self.overflow = int((sent & (rank >= cap)).sum())
        self.dest = torch.where(sent & (rank < cap), sorted_owner * cap + rank, S * cap)
        self.S, self.cap = S, cap

    def send(self, values, fill):
        """[S, cap] buffer of ``values`` (in the shard's row order), ``fill``
        in the slots no row takes."""
        buf = torch.full((self.S * self.cap + 1,), fill, dtype=values.dtype,
                         device=values.device)
        buf[self.dest] = values[self.order]
        return buf[:-1].view(self.S, self.cap)


def exchange(mesh, packings, channels):
    """``channels``: per channel (per local shard a tensor, its fill); each
    packed by the shard's :class:`Packing` and sent through one all-to-all.
    Returns per channel the per local shard [S * cap] received rows."""
    out = []
    for parts, fill in channels:
        sends = [p.send(t, fill) for p, t in zip(packings, parts)]
        out.append([r.reshape(-1) for r in collectives.all_to_all(sends, mesh)])
    return out


def owner_of(codes, G, gper, S):
    """Each row's owner shard, S for a code outside [0, G)."""
    valid = (codes >= 0) & (codes < G)
    return torch.where(valid, torch.div(codes, gper, rounding_mode="floor").clamp(max=S - 1),
                       S)


def owner_variance(idx, x, shift, G, valid=None):
    """(strategy, counts, var) of an owner's rows of a var channel per local
    bin: x float64, NaN where a row does not count, or an int base's int64
    words (a uint64 base's order image: :func:`..tasks.moment_data`), which
    count where ``valid`` (None: every row); ``shift`` the frame's, an
    int64 word for an int base.  An int base with rows that do not count is
    shifted in int64 before its cast, as a tile's prolog shifts one
    (:func:`..tasks.moment_prolog`).  The sums less the frame's shift;
    where a cell lost its digits (:func:`..agg.cancelled`) or a sum is not
    finite, the sums again less each cell's own mean (the owner holds every
    row of its cells), and where a sum was not finite also over x *
    RESCUE_SCALE, taken where the plain sums are not finite; further passes
    follow :func:`..agg.settle`.  The decision is the owner's alone: no
    collective follows it, and every owner gathers its var alike.
    ``owner_variance.retaken`` counts the owners that took cells again."""
    from ..tasks import moment_prolog
    integer = x.dtype == torch.int64
    missing = None if valid is None else ~valid

    def moments(s, scale=1.0):
        if integer:
            base, s = moment_prolog(x, missing, s, idx)
        else:
            base, s = (x, s) if scale == 1.0 else (x * scale, s * scale)
        return moment_sums(idx, [base], VAR_TERMS, G, shift=[s])

    name, counts, sums = moments(shift)
    n = counts[0].to(torch.float64)
    var = variance(sums[1], sums[0], n)
    over = ~torch.isfinite(sums).all(0)
    flag = cancelled(sums[1], sums[0], n, integer) | over
    any_flag, any_over = torch.stack([flag.any(), over.any()]).tolist()  # one host read
    if not any_flag:
        return name, counts[0], var
    owner_variance.retaken += 1
    table, k = cell_shift(shift, sums[0], n, integer), 1
    while True:
        _, _, again = moments(table)
        retaken, scaled = variance(again[1], again[0], n), None
        if any_over:
            _, _, tiny = moments(table, RESCUE_SCALE)
            retaken = torch.where(torch.isfinite(again).all(0), retaken,
                                  variance(tiny[1], tiny[0], n) / RESCUE_SCALE / RESCUE_SCALE)
            scaled = tiny[0], tiny[1]
        var, going_on = agg.settle(k, flag, var, retaken,
                                   {"x": (table, (again[0], again[1], n), integer, scaled)},
                                   lambda moved: bool(moved.any()))
        if going_on is None:
            return name, counts[0], var
        flag, table, k = going_on[0], going_on[1]["x"], k + 1


owner_variance.retaken = 0


def shuffle_grids(mesh, codes, G, slack=4, int_cols=(), float_cols=(), ext_cols=(),
                  ext_modes=(), bases=(), base_shifts=None, base_valid=None, nu_cols=()):
    """Every kind of per-group aggregation in one all-to-all
    (vaex_tpu/parallel/shuffle.py:100-229): per local shard ``codes`` (int64,
    a code outside [0, G) drops the row), ``int_cols`` (int64, summed:
    exact mod 2^64), ``float_cols`` (float64, summed), ``ext_cols`` (min or
    max by ``ext_modes``; a row that must not count holds the mode's
    identity), ``bases`` (moment bases of a var: float64, NaN where a row
    does not count, or an int base's int64 words, ``base_valid`` giving
    the rows that count where some do not, None where all do or for a
    float base; ``base_shifts`` each one's shift, None: none, see
    :func:`owner_variance`) and ``nu_cols`` ((int64 bits, int32 aux): distinct bits
    among the rows of aux 0; aux 1 NaN, 2 missing, 3 not counted; their
    presence rides ``int_cols``).  Each of these is a list over channels of
    lists over local shards.

    Returns (None, dropped rows) when a bucket overflowed, else (a dict of
    [G] results on ``mesh.first``: "count", "int" [k, G], "float" [k, G],
    "ext" list, "moments" list of (counts, var), "nu" list; and 0), and the
    trace of the exchange."""
    S = mesh.size
    n_rows = collectives.total([c.shape[0] for c in codes], mesh)
    n_local, cap = capacity(mesh, n_rows, slack)
    gper = -(-G // S)
    packings = [Packing(owner_of(c, G, gper, S), S, cap) for c in codes]
    dropped = collectives.total([p.overflow for p in packings], mesh)
    base_valid = list(base_valid or [None] * len(bases))
    valid_cols = [v for v in base_valid if v is not None]
    row_bytes = (8 + 8 * (len(int_cols) + len(float_cols) + len(bases)) + len(valid_cols)
                 + 12 * len(nu_cols)
                 + sum(parts[0].element_size() for parts in ext_cols))
    trace = {"shuffle": True, "G": int(G), "devices": S, "world": mesh.world, "rows": n_rows,
             "rows_per_device": n_local, "slack": slack, "capacity": cap,
             "row_bytes": row_bytes, "alltoall_bytes_per_device": S * cap * row_bytes,
             "dropped": dropped}
    if dropped:
        trace["shuffle"] = "overflow"
        return None, dropped, trace
    from ..ops.grid_extreme import identity
    channels = [(codes, -1)] + [(c, 0) for c in int_cols] + [(c, 0.0) for c in float_cols]
    channels += [(c, identity(c[0].dtype, m)) for c, m in zip(ext_cols, ext_modes)]
    channels += [(c, 0 if c[0].dtype == torch.int64 else float("nan")) for c in bases]
    channels += [(v, False) for v in valid_cols]
    for bits, aux in nu_cols:
        channels += [(bits, 0), (aux, NU_NONE)]
    t0 = time.perf_counter()  # host clock: the exchange's and the gather's walls
    received = exchange(mesh, packings, channels)
    trace["exchange_s"] = time.perf_counter() - t0
    k = 1 + len(int_cols) + len(float_cols)
    e = k + len(ext_cols)
    m = e + len(bases)
    received_valid = iter(received[m:m + len(valid_cols)])
    valid_of = [None if v is None else next(received_valid) for v in base_valid]
    m += len(valid_cols)
    per_shard, strategies = [], {}
    for d in range(len(mesh.devices)):
        g = mesh.rank * len(mesh.devices) + d
        local = received[0][d] - g * gper
        idx = torch.where((local >= 0) & (local < gper), local, -1).to(torch.int32)
        name, ints, floats = grid_sums(idx, [r[d] for r in received[1:1 + len(int_cols)]],
                                       [r[d] for r in received[1 + len(int_cols):k]],
                                       gper, True)
        strategies["additive"] = name
        out = {"count": ints[0], "int": list(ints[1:]), "float": list(floats)}
        if ext_cols:
            name, grids = grid_extremes(idx, [r[d] for r in received[k:e]], list(ext_modes),
                                        [None] * len(ext_cols), gper)
            strategies["extremes"] = name
            out["ext"] = list(grids)
        out["moments"] = []
        for r, shift, v in zip(received[e:e + len(bases)], base_shifts or [None] * len(bases),
                               valid_of):
            name, counts, var = owner_variance(idx, r[d], shift, gper,
                                               None if v is None else v[d])
            strategies["moments"] = name
            out["moments"].append((counts, var))
        out["nu"] = [_distinct(idx, received[j][d], received[j + 1][d], gper)
                     for j in range(m, len(received), 2)]
        per_shard.append(out)
    trace["strategies"] = strategies

    t0 = time.perf_counter()

    def joined(pick):
        return torch.cat(collectives.gather([pick(o) for o in per_shard], mesh))[:G]
    result = {"count": joined(lambda o: o["count"]),
              "int": [joined(lambda o, i=i: o["int"][i]) for i in range(len(int_cols))],
              "float": [joined(lambda o, i=i: o["float"][i]) for i in range(len(float_cols))],
              "ext": [joined(lambda o, i=i: o["ext"][i]) for i in range(len(ext_cols))],
              "moments": [tuple(joined(lambda o, i=i, j=j: o["moments"][i][j]) for j in (0, 1))
                          for i in range(len(bases))],
              "nu": [joined(lambda o, i=i: o["nu"][i]) for i in range(len(nu_cols))]}
    trace["gather_s"] = time.perf_counter() - t0
    return result, 0, trace


def _distinct(idx, bits, aux, G):
    """Per bin the distinct ``bits`` among the rows of aux 0: a stable sort
    by bits, then by bin, and the first row of each (bin, bits) run."""
    keep = (idx >= 0) & (aux == NU_VALUE)
    cells, bits = idx[keep].to(torch.int64), bits[keep]
    bits, order = torch.sort(bits, stable=True)
    cells, order2 = torch.sort(cells[order], stable=True)
    bits = bits[order2]
    first = torch.ones(cells.shape, dtype=torch.bool, device=cells.device)
    first[1:] = (cells[1:] != cells[:-1]) | (bits[1:] != bits[:-1])
    return torch.bincount(cells[first], minlength=G)


def _split(values, mesh):
    return values if isinstance(values, (list, tuple)) else shard_rows(values, mesh)


def shuffle_additive_grids(mesh, codes, cols, G, slack=4):
    """codes [N] (rows with a code outside [0, G) are dropped), cols [N, A]
    float64, this process's rows (or per local shard lists) -> ([G, A]
    float64 on ``mesh.first``, dropped rows); each shard owns the codes
    ``[s * gper, (s + 1) * gper)`` (vaex_tpu/parallel/shuffle.py:35-98)."""
    codes = [c.to(torch.int64) for c in _split(codes, mesh)]
    cols = [c.to(torch.float64) for c in _split(cols, mesh)]
    A = cols[0].shape[1]
    out, dropped, _ = shuffle_grids(mesh, codes, G, slack,
                                    float_cols=[[c[:, a].contiguous() for c in cols]
                                                for a in range(A)])
    if out is None:
        return None, dropped
    grid = torch.stack(out["float"], dim=1) if A else torch.zeros((G, 0), dtype=torch.float64)
    return grid, 0


def shuffle_segment_grids(mesh, codes, add_cols, ext_cols, nu_cols, G, slack=4):
    """Sums, extremes and distinct counts in ONE all-to-all
    (vaex_tpu/parallel/shuffle.py:100-229): ``add_cols`` [N, Aa] float64,
    ``ext_cols`` [(values [N], "min" | "max")], ``nu_cols`` [(bits [N]
    int64, aux [N] int32)].  Returns (sums [G, Aa], extremes, distinct
    counts, dropped rows), None for the first three when a bucket
    overflowed."""
    codes = [c.to(torch.int64) for c in _split(codes, mesh)]
    add = [c.to(torch.float64) for c in _split(add_cols, mesh)]
    Aa = add[0].shape[1]
    out, dropped, _ = shuffle_grids(
        mesh, codes, G, slack, float_cols=[[c[:, a].contiguous() for c in add]
                                           for a in range(Aa)],
        ext_cols=[_split(v, mesh) for v, _ in ext_cols], ext_modes=[m for _, m in ext_cols],
        nu_cols=[(_split(b, mesh), [a.to(torch.int32) for a in _split(x, mesh)])
                 for b, x in nu_cols])
    if out is None:
        return None, None, None, dropped
    sums = (torch.stack(out["float"], dim=1) if Aa
            else torch.zeros((G, 0), dtype=torch.float64, device=mesh.first))
    return sums, out["ext"], out["nu"], 0


def shuffle_groupby(df, key_ordinal_expression, value_columns, G, mesh, slack=4, max_retries=3):
    """{"count": [G] counts, column: [G] float64 sums} as numpy
    (vaex_tpu/parallel/shuffle.py:232): the groupby's own all-to-all
    (:func:`..groupby._run_shuffle_plan`, its retries with twice the slack)
    over sums of ``value_columns``; raises where the retries leave a
    bucket overflowing, as the reference does."""
    from ..agg import sum as agg_sum
    from ..groupby import _run_shuffle_plan
    plan = [(str(c), "sum", agg_sum(str(c))) for c in value_columns]
    out = _run_shuffle_plan(df, key_ordinal_expression, plan, G, mesh, slack, max_retries)
    if out is None:
        raise RuntimeError(f"shuffle overflow after {max_retries} slack doublings "
                           f"(extreme key skew): {df.executor.trace_log[-1]}")
    grids, counts = out
    result = {"count": counts.cpu().numpy()}
    for name, grid in grids.items():
        result[name] = grid.to(torch.float64).cpu().numpy()
    return result


def shard_values(df, expressions, mesh):
    """Per local shard of the frame's rows (the mesh's contiguous ranges of
    the dataset, of a filtered frame the rows its filter keeps) each
    expression's NA on the shard's device: the shard's tiles read and
    evaluated there, as the sharded pass reads them
    (:func:`..execution.shard_walks`)."""
    from ..execution import pass_inputs, shard_walks
    from ..settings import TILE_ROWS
    dataset = df.dataset_for_execution()
    expressions = list(dict.fromkeys(map(str, expressions)))
    wanted = expressions + ([df.filter_expression] if df.filtered else [])
    inputs = pass_inputs(df, dataset, wanted, mesh.first)
    out = []
    for shard_inputs, r1, r2, t in shard_walks(df.executor, df, dataset, inputs, mesh,
                                               df._tile_rows or TILE_ROWS):
        tiles = {e: [] for e in expressions}
        for i1 in range(r1, max(r2, r1 + 1), t):
            ctx = shard_inputs.context(df, dataset, i1, min(i1 + t, r2))
            keep = ctx.boolean(df.filter_expression) if df.filtered else None
            for e in expressions:
                tiles[e].append(_kept(ctx.expr(e), keep))
        out.append({e: _concat(parts) for e, parts in tiles.items()})
    return out


def _kept(x, keep):
    """The rows of an NA that ``keep`` (a bool tensor, or None: all) keeps."""
    from ..ops.nullable import NA, DictNA
    if keep is None:
        return x
    mask = None if x.mask is None else x.mask[keep]
    return (DictNA(x.data[keep], mask, x.labels) if isinstance(x, DictNA)
            else NA(x.data[keep], mask, x.logical))


def _concat(parts):
    """One shard's tiles of an expression as one NA; strings over one
    dictionary (a host stage encodes each tile over its own)."""
    from ..column import ColumnDictionary, merged_dictionary
    from ..ops.nullable import NA, DictNA
    first = parts[0]
    if len(parts) == 1:
        return first
    masks = None if all(p.mask is None for p in parts) else torch.cat(
        [torch.zeros(p.data.shape, dtype=torch.bool, device=p.data.device) if p.mask is None
         else p.mask for p in parts])
    if not isinstance(first, DictNA):
        return NA(torch.cat([p.data for p in parts]), masks, first.logical)
    if all(p.labels is first.labels or p.labels.equals(first.labels) for p in parts):
        return DictNA(torch.cat([p.data for p in parts]), masks, first.labels)
    merged = merged_dictionary([ColumnDictionary(p.data, p.labels) for p in parts])
    return DictNA(merged.codes, masks, merged.labels)
