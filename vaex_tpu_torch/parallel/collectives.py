"""Collectives over a mesh's shards: the counterparts of ``jax.lax.psum`` /
``pmin`` / ``pmax`` / ``all_gather`` / ``all_to_all`` inside ``shard_map``
(vaex_tpu/agg.py, vaex_tpu/parallel/shuffle.py).

Each takes one tensor per shard of this process, on its shard's device.
Within the process a reduction folds the shards in shard order on the
mesh's first device, so that a sharded float result is the same bit for bit
from run to run; the all-to-all is D x D slice copies.  Where the mesh
has a process group (a world of one too) the collectives go on through
``torch.distributed`` (``all_reduce`` SUM / MIN / MAX, ``all_gather``,
``all_to_all_single``, ``all_gather_object``): NCCL carries CUDA shards
between cards.  Two processes that share one card cannot both join NCCL
(it refuses a second rank on one GPU) and take gloo, whose own support of
CUDA tensors differs from collective to collective and from one torch to
the next; so under a gloo group a CUDA tensor always crosses through
page-locked host memory (:func:`_wire`), the host copy being gloo's
transport.  A shard's place in the global order is ``rank * len(devices)
+ d``.
"""

from __future__ import annotations

import torch

_FOLD = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum,
         "or": torch.logical_or}


def _dist():
    import torch.distributed as dist
    return dist


def _wire(t, mesh):
    """``t`` as the group's backend carries it: under gloo a CUDA tensor's
    copy in page-locked host memory, else ``t`` itself (contiguous)."""
    t = t.contiguous()
    if t.device.type != "cuda" or _dist().get_backend(mesh.group) != "gloo":
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def reduce(parts, op, mesh):
    """``op`` ("sum", "min", "max" or "or") over the shards' tensors of one
    shape, folded in shard order; one tensor on ``mesh.first``.  An int64
    sum wraps mod 2^64, as on one device."""
    fold = _FOLD[op]
    acc = parts[0].to(mesh.first)
    for part in parts[1:]:
        acc = fold(acc, part.to(mesh.first))
    if mesh.group is None:
        return acc
    dist = _dist()
    wire = _wire(acc.to(torch.uint8) if acc.dtype == torch.bool else acc.clone(), mesh)
    reduce_op = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
                 "max": dist.ReduceOp.MAX, "or": dist.ReduceOp.MAX}[op]
    dist.all_reduce(wire, op=reduce_op, group=mesh.group)
    return wire.to(device=acc.device, dtype=acc.dtype)


def total(values, mesh):
    """The sum of one Python int per shard of this process over every shard
    of the mesh."""
    if mesh.group is None:
        return sum(int(v) for v in values)
    parts = [torch.tensor(int(v), dtype=torch.int64) for v in values]
    return int(reduce(parts, "sum", mesh))


def extreme(values, op, mesh):
    """The min or max (``op``) of one Python int per shard over every shard."""
    parts = [torch.tensor(int(v), dtype=torch.int64) for v in values]
    return int(reduce(parts, op, mesh).cpu())


def broadcast(t, mesh):
    """Rank 0's tensor ``t`` on every process of the mesh, on
    ``mesh.first`` (``t`` itself without a group)."""
    if mesh.group is None:
        return t
    dist = _dist()
    wire = _wire(t.to(mesh.first).clone(), mesh)
    dist.broadcast(wire, src=dist.get_global_rank(mesh.group, 0), group=mesh.group)
    return wire.to(mesh.first)


def gather(parts, mesh):
    """Every shard's tensor (first dimensions may differ) on ``mesh.first``,
    in the global shard order."""
    local = [p.to(mesh.first) for p in parts]
    if mesh.group is None:
        return local
    dist = _dist()
    rows = [[None] * len(local) for _ in range(mesh.world)]
    for i, t in enumerate(local):
        wire = t.to(torch.uint8) if t.dtype == torch.bool else t
        size = _wire(torch.tensor([wire.shape[0]], dtype=torch.int64, device=wire.device), mesh)
        sizes = [torch.empty_like(size) for _ in range(mesh.world)]
        dist.all_gather(sizes, size, group=mesh.group)
        sizes = [int(s) for s in sizes]
        padded = wire.new_zeros((max(sizes),) + tuple(wire.shape[1:]))
        padded[:wire.shape[0]] = wire
        padded = _wire(padded, mesh)
        bufs = [torch.empty_like(padded) for _ in range(mesh.world)]
        dist.all_gather(bufs, padded, group=mesh.group)
        for r in range(mesh.world):
            rows[r][i] = bufs[r][:sizes[r]].to(device=t.device, dtype=t.dtype)
    return [t for row in rows for t in row]


def objects(obj, mesh):
    """One Python object of this process from every process, in rank order
    (the process's shards already merged into it)."""
    if mesh.group is None:
        return [obj]
    out = [None] * mesh.world
    _dist().all_gather_object(out, obj, group=mesh.group)
    return out


def all_to_all(sends, mesh):
    """The exchange of ``jax.lax.all_to_all(x, axis, 0, 0)``: ``sends[d]``
    is shard d's [S, cap, ...] send buffer on its device (S the mesh's
    shards, row s bound for shard s); returns ``recvs[d]``, [S, cap, ...]
    on shard d's device, row s what shard s sent it."""
    local = len(mesh.devices)
    if mesh.group is None:
        recvs = []
        for d, device in enumerate(mesh.devices):
            buf = torch.empty((local,) + tuple(sends[0].shape[1:]), dtype=sends[0].dtype,
                              device=device)
            for s in range(local):
                buf[s].copy_(sends[s][d], non_blocking=True)
            recvs.append(buf)
        return recvs
    # across processes: [local src, world, local dst, cap, ...] regrouped by
    # the destination's rank, one all_to_all_single, then split by local dst
    rest = tuple(sends[0].shape[1:])
    stacked = torch.stack([s.to(mesh.first) for s in sends])
    stacked = stacked.reshape((local, mesh.world, local) + rest).transpose(0, 1)
    boolean = stacked.dtype == torch.bool
    wire = _wire(stacked.to(torch.uint8) if boolean else stacked, mesh)
    out = torch.empty(wire.shape, dtype=wire.dtype, device=wire.device,
                      pin_memory=wire.is_pinned())
    _dist().all_to_all_single(out, wire, group=mesh.group)
    out = out.to(mesh.first)
    if boolean:
        out = out.to(torch.bool)
    # out: [world (source rank), local src, local dst, cap, ...]
    return [out[:, :, j].reshape((mesh.size,) + rest).to(device)
            for j, device in enumerate(mesh.devices)]
