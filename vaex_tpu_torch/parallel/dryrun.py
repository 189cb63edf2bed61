"""A dry run of every multi-device plan on a small frame (the counterpart of
``dryrun_multichip`` in vaex_tpu's ``__graft_entry__.py``).

    python -c "from vaex_tpu_torch.parallel.dryrun import dryrun_multichip; \\
               dryrun_multichip(4, devices=['cpu'] * 4)"

runs a filter, a virtual column and five aggregates, a binned count, the
mesh join and :func:`.shuffle.shuffle_groupby` over a mesh of
``n_devices`` shards and raises on a wrong answer.
"""

from __future__ import annotations

import numpy as np


def dryrun_multichip(n_devices, devices=None):
    """The plans over ``data_mesh(n_devices, devices)``; returns the trace
    entries of their passes."""
    import vaex_tpu_torch as vt
    from ..execution import ExecutorLocal
    from .mesh import data_mesh
    from .shuffle import shuffle_groupby

    mesh = data_mesh(n_devices, devices=devices)
    if mesh.size != n_devices:
        raise RuntimeError(f"need {n_devices} shards, have {mesh.size}")
    n = 64 * n_devices
    x = np.arange(n, dtype="f8")
    g = (np.arange(n) % 5).astype("i8")
    df = vt.from_arrays(x=x, g=g).to_device(mesh.first)
    df.executor = ExecutorLocal(mesh=mesh)
    df._tile_rows = 16 * n_devices

    # the whole pass: a filter, a virtual column and five aggregates by g
    df["v"] = df.x * 2 + 1
    dff = df.filter("x >= 8")
    dfg = dff.groupby("g", agg={"c": "count", "s": vt.agg.sum("v"), "m": vt.agg.mean("v"),
                                "mn": vt.agg.min("x"), "mx": vt.agg.max("x")}, sort=True)
    keep = x >= 8
    if int(np.sum(dfg["c"].values)) != int(keep.sum()):
        raise AssertionError("sharded groupby count")
    np.testing.assert_allclose(np.sum(dfg["s"].values), (x[keep] * 2 + 1).sum())
    np.testing.assert_array_equal(dfg["mn"].values, [x[keep & (g == k)].min() for k in range(5)])
    np.testing.assert_array_equal(dfg["mx"].values, [x[keep & (g == k)].max() for k in range(5)])

    # a binned count over the mesh
    counts = np.asarray(dff.count(binby=["x"], limits=[[0, n]], shape=8))
    if int(counts.sum()) != int(keep.sum()):
        raise AssertionError("sharded binned count")

    # the hash-partitioned join
    right = vt.from_arrays(g=np.arange(5, dtype="i8"),
                           label=np.arange(5, dtype="f8") * 10).to_device(mesh.first)
    joined = df.join(right, on="g", rprefix="r_", mesh=mesh)
    np.testing.assert_allclose(np.asarray(joined.evaluate("label")), g * 10.0)
    if df.executor.trace_log[-1].get("join") != "mesh":
        raise AssertionError(f"the join took {df.executor.trace_log[-1]}")

    # the all-to-all groupby: each shard owns a range of the groups
    out = shuffle_groupby(df, "g", ["x"], 5, mesh)
    np.testing.assert_allclose(out["x"], np.bincount(g, weights=x))
    np.testing.assert_array_equal(out["count"], np.bincount(g))
    return [e for e in df.executor.trace_log if e.get("mesh") or e.get("join")
            or e.get("shuffle")]
