"""The mesh and the distributed executor (vaex_tpu/parallel/mesh.py).

A :class:`Mesh` is an ordered tuple of ``torch.device``, one per shard of
the rows, and optionally a ``torch.distributed`` process group: each
process of the group drives its own shards over its own rows, and the
merges continue across the processes in the order of their ranks.  Devices
may repeat: ``data_mesh(4, devices=["cuda:0"] * 4)`` is four shards on one
card, ``["cpu"] * 4`` four on the CPU (the counterpart of XLA's forced
host device count).
"""

from __future__ import annotations

import torch


class Mesh:
    """Shards in order: ``devices`` (this process's, one a shard) and the
    process ``group`` (None: this process alone).  ``size`` counts the
    shards of every process, ``rank`` and ``world`` are the group's."""

    def __init__(self, devices, group=None):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.group = group
        if group is not None:
            import torch.distributed as dist
            self.rank, self.world = dist.get_rank(group), dist.get_world_size(group)
        else:
            self.rank, self.world = 0, 1

    @property
    def size(self):
        return len(self.devices) * self.world

    @property
    def first(self):
        """The device the merges of this process's shards run on."""
        return self.devices[0]

    def key(self):
        """What of the mesh decides a sharded result: its devices, in order,
        and its place in the group."""
        return tuple(str(d) for d in self.devices), self.rank, self.world

    def row_ranges(self, n):
        """Each shard's rows [r1, r2) of ``n``: contiguous,
        ``ceil(n / shards)`` each, the last ones shorter or empty
        (vaex_tpu/execution.py:798-830)."""
        d = len(self.devices)
        per = -(-n // d)
        return [(min(i * per, n), min((i + 1) * per, n)) for i in range(d)]

    def __repr__(self):
        group = "" if self.group is None else f", rank {self.rank} of {self.world}"
        return f"Mesh({[str(d) for d in self.devices]}{group})"


def data_mesh(n_devices=None, axis_name="d", devices=None, group=None) -> Mesh:
    """A mesh over ``devices`` (every visible CUDA device when None: there
    must be one), the first ``n_devices`` of them.  ``group`` defaults to
    the default process group once :func:`initialize_multihost` ran, as
    vaex_tpu's mesh spans ``jax.devices()`` of every process.  The mesh has
    one axis, whatever ``axis_name`` calls it."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("data_mesh() takes the visible CUDA devices and there is none; "
                               "pass devices=, e.g. ['cpu'] * 4")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"a mesh of {n_devices} devices over {len(devices)}")
        devices = devices[:n_devices]
    if group is None:
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            group = dist.group.WORLD
    return Mesh(devices, group)


def distributed_executor(n_devices=None, devices=None, group=None):
    """An executor whose every pass runs sharded over
    ``data_mesh(n_devices, devices, group)``; a mesh of one shard gives a
    plain one."""
    from ..execution import ExecutorLocal
    mesh = data_mesh(n_devices, devices=devices, group=group)
    if mesh.size == 1:
        return ExecutorLocal()
    return ExecutorLocal(mesh=mesh)


def initialize_multihost(coordinator_address=None, num_processes=None, process_id=None):
    """Join the default process group: ``coordinator_address`` as
    ``host:port`` (``tcp://``) or any init method torch takes
    (``file://...``), the environment's (``env://``) when None.  NCCL when
    the process has a card, gloo else."""
    import torch.distributed as dist
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator_address is None:
        init = "env://"
    elif "://" in coordinator_address:
        init = coordinator_address
    else:
        init = f"tcp://{coordinator_address}"
    kwargs = {}
    if num_processes is not None:
        kwargs.update(world_size=int(num_processes), rank=int(process_id))
    dist.init_process_group(backend, init_method=init, **kwargs)
    return dist.group.WORLD
