"""Multi-device execution (vaex_tpu/parallel): a process drives a mesh of
shards, each a device that owns a contiguous range of its rows.

* :mod:`.mesh`: :class:`Mesh`, :func:`data_mesh`,
  :func:`distributed_executor` and :func:`initialize_multihost`;
* :mod:`.collectives`: the merges and the all-to-all over a mesh's shards,
  within the process and on through ``torch.distributed`` across processes;
* :mod:`.shuffle`: the all-to-all groupby, each shard owning a range of
  the groups;
* :mod:`.join`: the hash-partitioned join;
* :mod:`.dryrun`: :func:`dryrun_multichip`, every plan on a small frame.

A pass over a frame whose executor holds a mesh walks each shard's rows on
that shard's device and merges the tasks' states at its end
(:mod:`..execution`); the frame's user sees no shard.  A mesh whose process
group has several processes spans every process's shards: each process
holds its own rows, the merges, the all-to-all groupby, the fused exchange
and the join cross the processes, and each process ends with the answer
over every process's rows (a join: its own left rows against them all).
"""

from .mesh import Mesh, data_mesh, distributed_executor, initialize_multihost  # noqa: F401
