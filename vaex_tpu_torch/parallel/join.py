"""The hash-partitioned join over a mesh (vaex_tpu/parallel/join.py).

Both sides are partitioned by a hash of the key (:func:`_mix64`, the
murmur finalizer) with one all-to-all each, so that every owner shard holds
one hash range of the keys: it builds a :class:`~..ops.setops.SortedIndex`
of its right rows and probes its left rows against it with kernel B6
(where the reference uses ``jnp.searchsorted``), and the matches travel
back to the left rows' home shards with a third all-to-all.  Within a key
the lowest right row wins; duplicate right keys are counted per owner
(they all land on one); NaN never matches.  The keys stay on their devices.

Across processes (a mesh whose group has ``world > 1``) each process sends
its own rows, and a right row's place is its row in the union of every
process's right rows in rank order.  The right rows' values live in their
own process, so they ride the exchanges as payload (:func:`column_wire`):
to the owner beside the key, and back beside the match, so that each left
row ends with its right values in its own process.  A string column rides
as codes into the labels of every process merged (:func:`unified_codes`).
"""

from __future__ import annotations

import time

import torch

from . import collectives
from .shuffle import Packing, capacity, shard_rows

_INT64_MAX = (1 << 63) - 1


def _wrap(c):
    """An unsigned 64-bit constant as the int64 of the same bits."""
    return c - (1 << 64) if c > _INT64_MAX else c


_M1, _M2 = _wrap(0xFF51AFD7ED558CCD), _wrap(0xC4CEB9FE1A85EC53)


def _shr(k, n):
    """The logical right shift of int64 bits."""
    return (k >> n) & ((1 << (64 - n)) - 1)


def _mix64(k):
    """murmur3's 64-bit finalizer (vaex_tpu/parallel/join.py:32) on int64
    bits: multiplications wrap as uint64's do."""
    k = k ^ _shr(k, 33)
    k = k * _M1
    k = k ^ _shr(k, 33)
    k = k * _M2
    return k ^ _shr(k, 33)


def _key_bits(keys, dtype):
    """The 64 bits hashed for a key in the common ``dtype`` of both sides: a
    float's (-0.0 as 0.0, which it equals), an int's int64."""
    if dtype.is_floating_point:
        k = keys.to(torch.float64)
        return torch.where(k == 0, 0.0, k).view(torch.int64)
    return keys.to(torch.int64)


def _owner(bits, valid, S):
    """uint64(bits) mod S, S where the row is not valid."""
    half = _shr(bits, 1)  # u // 2, non-negative
    owner = ((half % S) * 2 + (bits & 1)) % S
    return torch.where(valid, owner, S)


def _pack(owner, S, cap):
    """A :class:`.shuffle.Packing` of the owners and each row's slot in the
    send buffer, in row order (``S * cap``: not sent)."""
    packing = Packing(owner, S, cap)
    dest = torch.empty_like(packing.dest)
    dest[packing.order] = packing.dest
    return packing, dest


def _valid(keys):
    return ~torch.isnan(keys) if keys.is_floating_point() else torch.ones(
        keys.shape, dtype=torch.bool, device=keys.device)


def shuffle_join_lookup(mesh, left_keys, right_keys, slack=4):
    """(per left row the first right row, -1 where none: int64 on
    ``mesh.first``; the rows past a bucket's capacity; the duplicate right
    keys; the trace) for this process's keys (tensors, or per local shard
    lists); the right rows count across the processes in rank order.
    Nothing is exchanged when a bucket overflows: the lookup is then
    None."""
    return _shuffle_join(mesh, left_keys, right_keys, slack)[:4]


def _shuffle_join(mesh, left_keys, right_keys, slack=4, payload=()):
    """:func:`shuffle_join_lookup`, and per ``payload`` channel (per local
    shard the right rows' values, the fill of an empty slot) the value of
    each left row's right row, in the left rows' order on ``mesh.first``
    (the fill where none): five results."""
    lks = left_keys if isinstance(left_keys, (list, tuple)) else shard_rows(left_keys, mesh)
    rks = right_keys if isinstance(right_keys, (list, tuple)) else shard_rows(right_keys, mesh)
    dtype = torch.promote_types(lks[0].dtype, rks[0].dtype)
    S = mesh.size
    n_left = collectives.total([k.shape[0] for k in lks], mesh)
    n_right = collectives.total([k.shape[0] for k in rks], mesh)
    _, cap_l = capacity(mesh, n_left, slack)
    _, cap_r = capacity(mesh, n_right, slack)
    # the global row of each right row: the rows of the processes before
    # this one, then the local shards in order
    sizes = [k.shape[0] for k in rks]
    before = sum(int(t) for t in collectives.gather(
        [torch.tensor([sum(sizes)], dtype=torch.int64, device=mesh.first)], mesh)[:mesh.rank])
    starts = [before + sum(sizes[:d]) for d in range(len(rks))]
    lvalid = [_valid(k) for k in lks]
    rvalid = [_valid(k) for k in rks]
    rpacks = [_pack(_owner(_mix64(_key_bits(k, dtype)), v, S), S, cap_r)
              for k, v in zip(rks, rvalid)]
    lpacks = [_pack(_owner(_mix64(_key_bits(k, dtype)), v, S), S, cap_l)
              for k, v in zip(lks, lvalid)]
    overflow = collectives.total([p.overflow for p, _ in rpacks + lpacks], mesh)
    payload_bytes = sum(parts[0].element_size() for parts, _ in payload)
    trace = {"join": "mesh", "devices": S, "world": mesh.world, "slack": slack,
             "left_rows": n_left, "right_rows": n_right, "left_capacity": cap_l,
             "right_capacity": cap_r, "overflow": overflow, "payload_bytes": payload_bytes,
             "alltoall_bytes_per_device": S * (cap_r * (16 + payload_bytes)
                                               + cap_l * (16 + payload_bytes))}
    if overflow:
        return None, overflow, 0, trace, None
    t0 = time.perf_counter()  # host clock: the exchanges' wall, the probes' among them
    rows = [torch.arange(s, s + k.shape[0], dtype=torch.int64, device=k.device)
            for s, k in zip(starts, rks)]
    rk_recv = collectives.all_to_all([p.send(k.to(dtype), 0) for (p, _), k in zip(rpacks, rks)],
                                     mesh)
    rr_recv = collectives.all_to_all([p.send(r, -1) for (p, _), r in zip(rpacks, rows)], mesh)
    lk_recv = collectives.all_to_all([p.send(k.to(dtype), 0) for (p, _), k in zip(lpacks, lks)],
                                     mesh)
    pay_recv = [collectives.all_to_all([p.send(v, fill) for (p, _), v in zip(rpacks, parts)],
                                       mesh) for parts, fill in payload]
    from ..ops.nullable import NA
    from ..ops.setops import SortedIndex
    matches, dups, routes = [], [], set()
    fetched = [[] for _ in payload]
    for d in range(len(mesh.devices)):
        keys, owned = rk_recv[d].reshape(-1), rr_recv[d].reshape(-1)
        # the received rows come in source order, each source's in row
        # order: the index's stable sort puts the lowest right row first
        index = SortedIndex(keys, owned < 0)
        dups.append(int((owned >= 0).sum()) - index.n_keys)
        probe = lk_recv[d].reshape(-1)
        ordinals = index.ordinals(NA(probe))
        if index.n_keys:
            routes.add(index.route(probe.device))
        at = index.rows_of(ordinals).to(torch.int64)
        match = torch.where(at >= 0, owned[at.clamp(min=0)], -1)
        matches.append(match.view(S, cap_l))
        for out, recv in zip(fetched, pay_recv):  # the matched right row's values
            out.append(recv[d].reshape(-1)[at.clamp(min=0)].view(S, cap_l))
    back = collectives.all_to_all(matches, mesh)
    lookups = []
    for (_, dest), valid, recv in zip(lpacks, lvalid, back):
        flat = torch.cat([recv.reshape(-1), recv.new_full((1,), -1)])
        lookups.append(torch.where(valid, flat[dest], -1))
    values = []
    for out, (_, fill) in zip(fetched, payload):
        parts = []
        for (_, dest), recv in zip(lpacks, collectives.all_to_all(out, mesh)):
            flat = torch.cat([recv.reshape(-1), recv.new_full((1,), fill)])
            parts.append(flat[dest].to(mesh.first))
        values.append(torch.cat(parts))
    trace["probe"] = "+".join(sorted(routes)) or None
    trace["duplicates"] = collectives.total(dups, mesh)
    trace["exchange_s"] = time.perf_counter() - t0
    lookup = torch.cat([t.to(mesh.first) for t in lookups])
    return lookup, 0, trace["duplicates"], trace, values


def lookup_retried(mesh, left_keys, right_keys, log, slack=4, payload=()):
    """:func:`shuffle_join_lookup` at ``slack``, and once more at four times
    it where a bucket overflowed (vaex_tpu/join.py:134-160); each attempt's
    trace goes to ``log``.  Returns (lookup, overflow, duplicates, the
    ``payload`` values) of the last attempt."""
    lookup, overflow, dups, trace, values = _shuffle_join(mesh, left_keys, right_keys, slack,
                                                          payload)
    log.append(trace)
    if overflow:
        lookup, overflow, dups, trace, values = _shuffle_join(mesh, left_keys, right_keys,
                                                              4 * slack, payload)
        log.append(trace)
    return lookup, overflow, dups, values


def shuffle_join(left_df, right_df, left_on, right_on, mesh, slack=4):
    """(lookup, has duplicate right keys) over the mesh
    (vaex_tpu/parallel/join.py:153-164): the keys of each shard and the
    retry of the frame's mesh join (:func:`lookup_retried`); raises where
    that still overflows."""
    from .shuffle import shard_values
    lk = [v[str(left_on)].data for v in shard_values(left_df, [left_on], mesh)]
    rk = [v[str(right_on)].data for v in shard_values(right_df, [right_on], mesh)]
    lookup, overflow, dups, _ = lookup_retried(mesh, lk, rk, left_df.executor.trace_log, slack)
    if overflow:
        raise RuntimeError(f"shuffle join overflow at slack {4 * slack}: {overflow} rows "
                           f"(extreme key skew); use the single-device join")
    return lookup, dups > 0


def unified_codes(parts, mesh):
    """Per local shard a string column's :class:`~..ops.nullable.DictNA` as
    int32 codes into one dictionary of every shard's labels of every process
    (sorted, as :func:`..column.merged_dictionary` merges them), its null
    rows the code ``len(labels)``; and those labels, the same in every
    process."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.compute as pc
    mine = [p.labels.cast(pa.string()) for p in parts]
    every = pa.concat_arrays([labels for shards in collectives.objects(mine, mesh)
                              for labels in shards]).drop_null()
    labels = pc.unique(every)
    labels = pc.take(labels, pc.array_sort_indices(labels))
    out = []
    for p, own in zip(parts, mine):
        places = np.asarray(pc.index_in(own, value_set=labels).fill_null(len(labels)), np.int32)
        table = torch.from_numpy(np.append(places, np.int32(len(labels)))).to(p.data.device)
        codes = table.index_select(0, p.data.to(torch.int64).clamp(0, len(own)))
        out.append(codes if p.mask is None else codes.masked_fill(p.mask, len(labels)))
    return out, labels


def column_wire(parts, mesh):
    """A right column's rows (per local shard an NA or a DictNA) as the
    channels that carry them across the processes, [(per local shard a
    tensor, the fill of an empty slot)], and ``make``: the column of the
    channels' values that came back (one tensor a channel), a tensor, a
    :class:`~..column.ColumnMasked` or a :class:`~..column.ColumnDictionary`.
    A mask rides where any process's rows have one."""
    from ..column import ColumnDictionary, ColumnMasked
    from ..ops.nullable import DictNA
    if isinstance(parts[0], DictNA):
        codes, labels = unified_codes(parts, mesh)
        return [(codes, len(labels))], lambda v: ColumnDictionary(v[0], labels)
    channels = [([p.data for p in parts], 0)]
    if not collectives.total([p.mask is not None for p in parts], mesh):
        return channels, lambda v: v[0]
    channels.append(([torch.zeros(p.data.shape, dtype=torch.bool, device=p.data.device)
                      if p.mask is None else p.mask for p in parts], True))
    return channels, lambda v: ColumnMasked(v[0], v[1])
