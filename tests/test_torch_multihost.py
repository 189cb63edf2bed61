"""Two processes of the port on gloo (``initialize_multihost`` over a
``file://`` store), each driving two CPU shards over its half of the rows:
the counterpart of tests/test_multihost.py.  A grid summed over the global
mesh of four shards, the all-to-all across the processes, and a frame's
passes (groupby, first, a set, a string set, a map-reduce) whose merges
cross the processes, each held to the single-process answer.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import numpy.testing as npt
import pytest

from torch_port_helpers import ATOL, RTOL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = textwrap.dedent("""
    import json, os, sys
    import numpy as np
    import torch
    sys.path.insert(0, {repo!r})
    import vaex_tpu_torch as vt
    from vaex_tpu_torch.parallel import collectives, data_mesh, distributed_executor
    from vaex_tpu_torch.parallel import initialize_multihost
    from vaex_tpu_torch.parallel.shuffle import shuffle_additive_grids

    pid, store = int(sys.argv[1]), sys.argv[2]
    initialize_multihost(coordinator_address="file://" + store, num_processes=2, process_id=pid)
    mesh = data_mesh(devices=["cpu"] * 2)
    assert (mesh.size, mesh.rank, mesh.world) == (4, pid, 2), mesh
    data = dict(np.load({inputs!r}, allow_pickle=True))
    half = slice(pid * 512, (pid + 1) * 512)
    out = {{}}

    # the reference's contract: each shard's grid, summed over the global mesh
    keys, vals = torch.as_tensor(data["keys"][half]), torch.as_tensor(data["vals"][half])
    parts = [torch.bincount(keys[r1:r2], vals[r1:r2], minlength=8)
             for r1, r2 in mesh.row_ranges(512)]
    out["grid"] = collectives.reduce(parts, "sum", mesh).tolist()
    # the all-to-all across the processes: each of the four shards owns 2 codes
    grid, dropped = shuffle_additive_grids(mesh, keys, vals[:, None], 8)
    out["shuffled"] = grid[:, 0].tolist()

    # a frame of this process's rows whose passes merge across the processes
    df = vt.from_arrays(k=data["k"][half], x=data["x"][half], tt=data["tt"][half],
                        s=data["s"][half]).to_device("cpu")
    df.executor = distributed_executor(devices=["cpu"] * 2)
    df._tile_rows = 64
    g = df.groupby("k", agg={{"s": vt.agg.sum("x"), "c": "count", "mn": vt.agg.min("x")}},
                   sort=True)
    out["groupby"] = {{c: g[c].values.tolist() for c in ("k", "s", "c", "mn")}}
    out["first"] = float(df.first("x", "tt"))
    out["unique"] = [int(v) for v in df.unique("k")]
    out["strings"] = sorted(df.unique("s"))
    out["tiles"] = df.map_reduce(lambda x: [len(x)], lambda a, b: a + b, ["x"])
    out["mesh"] = df.executor.trace_log[-1]["mesh"]
    print("RESULT " + json.dumps(out), flush=True)
    # leave the group together, then end without the interpreter's teardown:
    # gloo's threads torn down at exit can abort a process whose work is done
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    os._exit(0)
""")


def _inputs():
    rng = np.random.default_rng(0)
    return {"keys": rng.integers(0, 8, 1024), "vals": rng.random(1024),
            "k": rng.integers(0, 30, 1024) * 5, "x": rng.normal(0, 1, 1024),
            "tt": rng.integers(0, 4, 1024),
            "s": np.array(["a", "bb", "c", "dd", "e"], dtype=object)[rng.integers(0, 5, 1024)]}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multihost")
    np.savez(tmp / "inputs.npz", **_inputs())
    script = tmp / "worker.py"
    script.write_text(WORKER.format(repo=REPO, inputs=str(tmp / "inputs.npz")))
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, str(script), str(i), str(tmp / "store")],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=150)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    got = []
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out[-3000:]}"
        got.append(json.loads(out.split("RESULT ", 1)[1].splitlines()[0]))
    return got


def test_a_grid_summed_over_the_global_mesh(results):
    data = _inputs()
    want = np.bincount(data["keys"], weights=data["vals"], minlength=8)
    for r in results:
        npt.assert_allclose(r["grid"], want, rtol=1e-12)


def test_the_all_to_all_crosses_the_processes(results):
    data = _inputs()
    want = np.bincount(data["keys"], weights=data["vals"], minlength=8)
    for r in results:
        npt.assert_allclose(r["shuffled"], want, rtol=1e-12)


def test_a_groupby_merges_across_the_processes(results):
    import pandas as pd
    data = _inputs()
    oracle = pd.DataFrame({"k": data["k"], "x": data["x"]}).groupby("k").agg(
        s=("x", "sum"), c=("x", "size"), mn=("x", "min"))
    for r in results:
        g = r["groupby"]
        npt.assert_array_equal(g["k"], oracle.index.to_numpy())
        npt.assert_array_equal(g["c"], oracle["c"].to_numpy())
        npt.assert_array_equal(g["mn"], oracle["mn"].to_numpy())
        npt.assert_allclose(g["s"], oracle["s"].to_numpy(), rtol=1e-12, atol=1e-12)
        assert r["mesh"]["world"] == 2 and len(r["mesh"]["shards"]) == 2


def test_first_sets_and_map_reduce_across_the_processes(results):
    data = _inputs()
    i = int(np.flatnonzero(data["tt"] == data["tt"].min())[0])
    for r in results:
        assert r["first"] == data["x"][i]  # the earliest row of the smallest order, globally
        assert r["unique"] == sorted(set(data["k"].tolist()))
        assert r["strings"] == ["a", "bb", "c", "dd", "e"]
        assert r["tiles"] == [16] * 64  # every tile of 64 / 4 rows of every shard, in order


# ------------------------------------------- the exchange plans across processes
# Each process holds a random half of every table's rows.  The all-to-all
# groupby, the fused one-sort exchange and the join run over the global mesh
# of four CPU shards (sixteen a process for the skewed join, whose buckets
# then overflow at slack 16); every answer is held to vaex_tpu's
# single-device one over the whole tables (a join: over this process's left
# rows against every process's right rows, in rank order).
PLANS = textwrap.dedent("""
    import os, pickle, sys
    os.environ["VAEX_TPU_TORCH_SHUFFLE_MIN_G"] = "16"
    import torch
    sys.path.insert(0, {repo!r})
    import vaex_tpu_torch as vt
    from vaex_tpu_torch.parallel import distributed_executor, initialize_multihost

    pid, store, result = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    initialize_multihost("file://" + store, 2, pid)
    with open({inputs!r}, "rb") as f:
        data = pickle.load(f)
    a = vt.agg

    def frame(table, shards=2):
        keep = data[table + "_part"] == pid
        df = vt.from_arrays(**{{k: v[keep] for k, v in data[table].items()}}).to_device("cpu")
        df.executor = distributed_executor(devices=["cpu"] * shards)
        df._tile_rows = 256
        return df

    out = {{}}

    def run(name, df, query, traced=None):
        log = (traced or df).executor.trace_log
        start = len(log)
        try:
            res = query(df)
        except ValueError as e:
            out[name] = {{"raised": str(e)}}
            return None
        out[name] = {{"columns": {{n: res.evaluate(n) for n in res.get_column_names()}},
                     "trace": [e for e in log[start:] if any(
                         k in e for k in ("shuffle", "join", "fused_mesh_groupby", "mesh"))]}}
        return res

    g = frame("g")
    run("g1", g, lambda df: df.groupby("k", agg={{
        "s": a.sum("x"), "c": "count", "m": a.mean("x"), "mn": a.min("x"), "mx": a.max("v"),
        "sd": a.std("x"), "nu": a.nunique("v")}}, sort=True))
    run("g2", g, lambda df: df.groupby(["k", "k2"], agg={{"s": a.sum("x"), "c": "count",
                                                         "mx": a.max("x")}}, sort=True))
    run("fused", g, lambda df: df.groupby(["k1", "k3"], agg={{
        "s": a.sum("x"), "c": "count", "mx": a.max("v"), "sd": a.std("x")}}, sort=True))
    run("wide", g, lambda df: df.groupby("w", agg={{"c": "count", "s": a.sum("v")}}, sort=True))

    # a result one process holds in its cache and the other not: both run
    # the pass, whose merge needs them both
    g.unique("k2")
    if pid == 1:
        vt.cache.clear()
    out["cached unique"] = sorted(int(v) for v in g.unique("k2"))

    left, right = frame("l"), frame("r")
    run("left", left, lambda df: df.join(right, on="k", rsuffix="_r"))
    inner = run("inner", left, lambda df: df.join(right, on="k", how="inner", lsuffix="_l",
                                                  rsuffix="_r"))
    run("right", left, lambda df: df.join(right, left_on="ku", right_on="k", how="right",
                                          lsuffix="_l"), traced=right)
    run("nan key", left, lambda df: df.join(right, on="kf", rsuffix="_r"))
    run("masked key", left, lambda df: df.join(right, left_on="km", right_on="k",
                                               rsuffix="_r"))
    run("duplicates", left, lambda df: df.join(right, left_on="k", right_on="kd",
                                               rsuffix="_r", allow_duplication=True))
    run("duplicates refused", left, lambda df: df.join(right, left_on="k", right_on="kd",
                                                       rsuffix="_r"))
    run("string key", left, lambda df: df.join(right, left_on="ls", right_on="s",
                                               rsuffix="_r", allow_duplication=True))
    run("skew", frame("l", shards=16), lambda df: df.join(right, left_on="kk", right_on="k",
                                                          rsuffix="_r"))
    run("joined groupby", inner, lambda df: df.groupby("b", agg={{"k": "sum", "n": "count"}},
                                                       sort=True))
    with open(result, "wb") as f:
        pickle.dump(out, f)
    print("DONE", flush=True)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    os._exit(0)
""")


def _plan_inputs():
    rng = np.random.default_rng(22)
    n, nl, nr = 4000, 3000, 600
    x = rng.normal(0, 10, n)
    x[::37] = np.nan
    w = rng.integers(0, 50, n).astype("i8")
    g = {"k": rng.integers(0, 300, n).astype("i8") * 3, "k2": rng.integers(0, 20, n).astype("i8"),
         "k1": rng.integers(0, 3000, n).astype("i8"), "k3": rng.integers(0, 3000, n).astype("i8"),
         "x": x, "v": rng.integers(1, 6, n).astype("i8"), "w": w}
    g_part = rng.integers(0, 2, n)
    # rank 0's rows of w span past DENSE_RANGE_MAX, rank 1's do not: both
    # must skip the dense pre-pass alike
    w[np.flatnonzero(g_part == 0)[:3]] = 10_000_000
    kf_left = rng.integers(0, 700, nl).astype("f8")
    kf_left[::11] = np.nan
    left = {"k": rng.integers(0, 700, nl).astype("i8"), "a": rng.normal(0, 1, nl),
            "kf": kf_left,
            "km": np.ma.MaskedArray(rng.integers(0, 700, nl).astype("i8"), rng.random(nl) < 0.1),
            "ls": np.array([f"s{v}" for v in rng.integers(0, 40, nl)], dtype=object),
            "kk": np.full(nl, 7, dtype="i8"), "ku": rng.permutation(nl).astype("i8")}
    kf_right = rng.permutation(nr).astype("f8")
    kf_right[::13] = np.nan
    s = np.array([f"s{v}" for v in rng.integers(0, 30, nr)], dtype=object)
    s[::17] = None
    d = (np.datetime64("2020-01-01T00:00:00", "ns")
         + rng.integers(0, 10 ** 15, nr).astype("timedelta64[ns]"))
    d[::19] = np.datetime64("NaT")
    right = {"k": rng.permutation(nr).astype("i8"), "a": rng.normal(5, 1, nr),
             "b": rng.integers(0, 10, nr).astype("i8"), "kf": kf_right,
             "kd": rng.integers(0, 400, nr).astype("i8"), "s": s, "d": d,
             "u": rng.integers(0, 2 ** 63, nr).astype(np.uint64) + np.uint64(2 ** 63)}
    return {"g": g, "g_part": g_part, "l": left, "l_part": rng.integers(0, 2, nl),
            "r": right, "r_part": rng.integers(0, 2, nr)}


@pytest.fixture(scope="module")
def plans(tmp_path_factory):
    import pickle
    tmp = tmp_path_factory.mktemp("plans")
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(_plan_inputs(), f)
    script = tmp / "plans.py"
    script.write_text(PLANS.format(repo=REPO, inputs=str(tmp / "inputs.pkl")))
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, str(script), str(i), str(tmp / "store"),
                               str(tmp / f"result{i}.pkl")],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=150)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    got = []
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and "DONE" in out, f"process {i} failed:\n{out[-3000:]}"
        with open(tmp / f"result{i}.pkl", "rb") as f:
            got.append(pickle.load(f))
    return got


def _rows(table, part, rank):
    keep = part == rank
    return {k: v[keep] for k, v in table.items()}


def _union(table, part):
    """The rows of every process, in rank order."""
    return {k: (np.ma.concatenate if np.ma.isMaskedArray(v) else np.concatenate)(
        [v[part == r] for r in range(2)]) for k, v in table.items()}


def _same_columns(got, ref):
    """A port result (name -> evaluated column) against a vaex_tpu frame:
    the same names in order; strings, masks, ints, keys and datetimes
    exactly, floats within the helpers' contract."""
    assert list(got) == ref.get_column_names()
    for name, g in got.items():
        w = ref.evaluate(name)
        if hasattr(w, "to_pylist"):
            assert g.to_pylist() == w.to_pylist(), name
            continue
        npt.assert_array_equal(np.ma.getmaskarray(g), np.ma.getmaskarray(w), err_msg=name)
        g, w = np.ma.filled(g, 0), np.ma.filled(w, 0)
        assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
        if g.dtype.kind == "f":
            npt.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=name)
        else:
            npt.assert_array_equal(g, w, err_msg=name)


def _routes(entry, key):
    return [e for e in entry["trace"] if key in e]


GROUPBYS = {
    "g1": lambda vt: ("k", {"s": vt.agg.sum("x"), "c": "count", "m": vt.agg.mean("x"),
                            "mn": vt.agg.min("x"), "mx": vt.agg.max("v"), "sd": vt.agg.std("x"),
                            "nu": vt.agg.nunique("v")}),
    "g2": lambda vt: (["k", "k2"], {"s": vt.agg.sum("x"), "c": "count", "mx": vt.agg.max("x")}),
    "fused": lambda vt: (["k1", "k3"], {"s": vt.agg.sum("x"), "c": "count",
                                        "mx": vt.agg.max("v"), "sd": vt.agg.std("x")}),
    "wide": lambda vt: ("w", {"c": "count", "s": vt.agg.sum("v")}),
}


@pytest.mark.parametrize("name", list(GROUPBYS))
def test_a_groupby_exchange_across_the_processes(plans, name):
    """The all-to-all groupby (one key, two cartesian keys: sum, count,
    mean, min, max, std, nunique) and the fused one-sort exchange (two raw
    int keys) with world 2; a raw key whose rows in one process alone span
    past DENSE_RANGE_MAX; each equal to vaex_tpu over the whole table."""
    import vaex_tpu
    by, agg = GROUPBYS[name](vaex_tpu)
    ref = vaex_tpu.from_arrays(**_plan_inputs()["g"]).groupby(by, agg=agg, sort=True)
    for entry in plans:
        _same_columns(entry[name]["columns"], ref)
        if name in ("g1", "g2"):
            shuffles = _routes(entry[name], "shuffle")
            assert shuffles and all(e["shuffle"] is True and e["world"] == 2 for e in shuffles)
        if name in ("fused", "wide"):
            fused = _routes(entry[name], "fused_mesh_groupby")
            assert fused and all(e["fused_mesh_groupby"] is True and e["world"] == 2
                                 for e in fused)


JOINS = {
    "left": dict(on="k", rsuffix="_r"),
    "inner": dict(on="k", how="inner", lsuffix="_l", rsuffix="_r"),
    "right": dict(left_on="ku", right_on="k", how="right", lsuffix="_l"),
    "nan key": dict(on="kf", rsuffix="_r"),
    "masked key": dict(left_on="km", right_on="k", rsuffix="_r"),
    "duplicates": dict(left_on="k", right_on="kd", rsuffix="_r", allow_duplication=True),
    "string key": dict(left_on="ls", right_on="s", rsuffix="_r", allow_duplication=True),
    "skew": dict(left_on="kk", right_on="k", rsuffix="_r"),
}
BROADCAST = {"masked key": "masked key", "duplicates": "duplicate right keys",
             "string key": "string key", "skew": "skew"}


@pytest.mark.parametrize("name", list(JOINS))
def test_a_join_across_the_processes(plans, name):
    """In process r the join of its left rows against every process's right
    rows (in rank order) equals vaex_tpu's single-device join of the same:
    the hash route (world 2) for left, inner, right and a float key with
    NaN, with a datetime, a uint64 and a dictionary string column among the
    right ones; the broadcast route for a masked key, duplicate right keys
    under allow_duplication, a string key and a skew past slack 16."""
    import vaex_tpu
    data = _plan_inputs()
    for rank, entry in enumerate(plans):
        # how="right" swaps the frames: this process's right rows are the
        # left ones, against every process's left rows
        own, every = (("r", "l") if JOINS[name].get("how") == "right" else ("l", "r"))
        mine = vaex_tpu.from_arrays(**_rows(data[own], data[own + "_part"], rank))
        union = vaex_tpu.from_arrays(**_union(data[every], data[every + "_part"]))
        left, right = (union, mine) if own == "r" else (mine, union)
        assert "raised" not in entry[name], entry[name]
        _same_columns(entry[name]["columns"], left.join(right, **JOINS[name]))
        joins = _routes(entry[name], "join")
        assert joins and all(e["world"] == 2 for e in joins)
        if name in BROADCAST:
            assert {"join": "broadcast", "reason": BROADCAST[name], "world": 2} in joins
        else:
            assert [e["join"] for e in joins] == ["mesh"] and joins[0]["overflow"] == 0


def test_a_result_cached_in_one_process_alone_runs_the_pass_in_both(plans):
    """One process cleared its result cache, the other still holds a set:
    both run the set's pass, whose merge crosses the processes, and both
    answer the set of every row."""
    k2 = _plan_inputs()["g"]["k2"]
    for entry in plans:
        assert entry["cached unique"] == sorted(set(k2.tolist()))


def test_duplicate_right_keys_without_allow_duplication_raise_in_every_process(plans):
    for entry in plans:
        assert "allow_duplication" in entry["duplicates refused"]["raised"]


def test_a_groupby_over_a_joined_frame_merges_across_the_processes(plans):
    """A groupby by a right column over each process's inner join: its pass
    merges the two processes' rows, and equals vaex_tpu's over the union of
    both processes' joined rows."""
    import vaex_tpu
    data = _plan_inputs()
    right = vaex_tpu.from_arrays(**_union(data["r"], data["r_part"]))
    left = vaex_tpu.from_arrays(**_union(data["l"], data["l_part"]))
    ref = left.join(right, **JOINS["inner"]).groupby("b", agg={"k": "sum", "n": "count"},
                                                      sort=True)
    for entry in plans:
        _same_columns(entry["joined groupby"]["columns"], ref)
        passes = _routes(entry["joined groupby"], "mesh")
        assert passes and all(e["mesh"]["world"] == 2 for e in passes if e["mesh"])
