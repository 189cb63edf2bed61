"""The port's API against vaex_tpu's: names, signatures and keyword
arguments.

The walk: every module of vaex_tpu (those this machine cannot import, the
compiled ``_hostkern``, skipped), each public name it defines (the package
itself also what it re-exports) and each public attribute of each public
class it defines, one case each.  The port's module of the same name must
have the name, and a callable's every named parameter in vaex_tpu must be a
named parameter of the port's.  What the port does not port on purpose is
in ``NOT_PORTED``: a key names a module, a name, a class attribute or a
parameter, ``"agg.OpSum(dtype_out)"``, and covers what the subclasses of
that class inherit of it; an entry the port has after all, or that no case
reads, fails.

The differential tests feed the same seeded frame to both packages and hold
the calls that pass vaex_tpu's keyword arguments to vaex_tpu's answers
(ints exact, floats to ``RTOL`` / ``ATOL``); each call also equals the port's
call without the argument.  ``DataType``'s predicates and conversions are
held to vaex_tpu's over every kind of column.  Where vaex_tpu is wrong the
tests named ``test_the_reference_...`` pin it (ROADMAP, known problems of
the reference).
"""

import importlib
import inspect
import pkgutil

import numpy as np
import numpy.testing as npt
import pytest
import torch

import vaex_tpu
import vaex_tpu_torch
from torch_port_helpers import ATOL, RTOL, same_frames
from vaex_tpu.delayed import Promise as ReferencePromise
from vaex_tpu_torch.delayed import Promise

# -- why each missing piece is not ported ------------------------------------
HOSTKERN = "Do not port: hostkern.py and csrc/hostkern.cpp (host kernels beside a TPU)"
PRESPLIT = "Do not port: the f64 presplit memo ((hi, lo) f32 pairs for a chip without f64)"
LIMBS = "Do not port: the 8-bit limbs of OpSum.kernel_channels and fused_groupby's LIMB_BITS"
X64 = "Do not port: settings.X64, COMPILE_CACHE and the XLA compile-cache setup"
CAP_LADDER = ("Do not port: the set build's static-shape machinery (the cap ladder, "
              "SetCapOverflow, TaskSetCreateDevice, PartitionOverflow)")
DENSE_RANK = "Do not port: the dense_rank hint of BinnerOrdinal"
TILE_ROWS = "Do not port: TILE_ROWS_MIN / TILE_ROWS_MAX"
FASTAPI = "Do not port: server/asgi.py create_fastapi_app, which checks no token"
TAP = "Do not port: io/votable.py tap_query, which needs a network"
PALLAS = ("TPU design: vaex_tpu/ops/pallas_*.py, the Pallas kernels; their Hopper "
          "counterparts are vaex_tpu_torch/ops/grid_*.py and probe.py (ROADMAP queue B)")
GRIDAGG = ("TPU design: vaex_tpu/ops/gridagg.py, the XLA and Pallas routes of the channel "
           "grids; the port's router is vaex_tpu_torch/ops/grid_plan.py")
OP_PROTOCOL = ("TPU design: vaex_tpu/agg.py:30-60, an operation's traced step (update, "
               "merge over a mesh axis, its fingerprint in the compiled program's key)")
KERNEL_CHANNELS = ("TPU design: vaex_tpu/agg.py:101-305, the channels an operation feeds "
                   "the Pallas kernels and their apply_* finishers")
TASK_PROTOCOL = ("TPU design: vaex_tpu/tasks.py:24-69, a task's traced step with a host "
                 "fallback (process, see_all, scan_safe, finalize of the step's outputs)")
STRATEGY = ("TPU design: vaex_tpu/tasks.py:134-146, the TPU's strategy cut-offs; the port's "
            "are measured on the H100 (vaex_tpu_torch/ops/grid_plan.py)")
TRACED_SCOPE = ("TPU design: vaex_tpu/scopes.py:106-230 and execution.py:52-100, the scopes "
                "and tile context of a traced step over a frame")
JAX_PYTREE = "TPU design: vaex_tpu/ops/nullable.py:41-50, NA as a jax pytree"
WHOLE_PASS = ("TPU design: vaex_tpu/dataset.py:121-131 and execution.py, a whole pass "
              "compiled into one fori_loop over device-resident columns")
F32_SHUFFLE = ("TPU design: vaex_tpu/parallel/shuffle.py:116, channels summed exactly in "
               "f32 on a chip without f64; the port's all-to-all sums f64")

NOT_PORTED = {
    # modules
    "hostkern": HOSTKERN,
    "ops.gridagg": GRIDAGG,
    "ops.pallas_gridagg": PALLAS,
    "ops.pallas_partition": PALLAS,
    "ops.pallas_probe": PALLAS,
    # names
    "settings.X64": X64,
    "settings.COMPILE_CACHE": X64,
    "settings.TILE_ROWS_MIN": TILE_ROWS,
    "settings.TILE_ROWS_MAX": TILE_ROWS,
    "fused_groupby.LIMB_BITS": LIMBS,
    "tasks.SetCapOverflow": CAP_LADDER,
    "tasks.PartitionOverflow": CAP_LADDER,
    "tasks.TaskSetCreateDevice": CAP_LADDER,
    "tasks.TaskFilterFill": TASK_PROTOCOL,
    "tasks.TaskEvaluate": TASK_PROTOCOL,
    "server.asgi.create_fastapi_app": FASTAPI,
    "io.votable.tap_query": TAP,
    # an operation's and a task's traced step
    **{f"agg.AggOperation{part}": OP_PROTOCOL for part in (
        "(selection)", "(dtype_out)", ".fingerprint", ".selection_expressions", ".update",
        ".merge(state)", ".merge(delta)", ".merge(axis_name)")},
    **{f"agg.{op}.fingerprint": OP_PROTOCOL for op in (
        "OpMax", "OpMin", "OpNUniquePresence", "OpNUniqueSorted", "OpPercentile",
        "OpPercentileExact", "OpSum", "OpSumMoment", "OpTopK")},
    **{f"agg.{op}.update": OP_PROTOCOL for op in (
        "OpCount", "OpFirst", "OpMax", "OpMin", "OpNUniquePresence", "OpPercentile", "OpSum",
        "OpSumMoment")},
    **{f"agg.{op}.update(flat_idx)": OP_PROTOCOL for op in (
        "OpNUniqueSorted", "OpPercentileExact", "OpTopK")},
    **{f"agg.{op}.merge({arg})": OP_PROTOCOL for op in (
        "OpFirst", "OpMax", "OpMin", "OpNUniquePresence", "OpNUniqueSorted",
        "OpPercentileExact", "OpTopK") for arg in ("state", "delta", "axis_name")},
    **{f"agg.{op}.host_finalize": OP_PROTOCOL for op in (
        "OpNUniquePresence", "OpNUniqueSorted", "OpTopK")},
    "agg.OpNUniquePresence(expressions)": OP_PROTOCOL,
    "agg.OpNUniquePresence(dropna)": OP_PROTOCOL,
    "agg.OpNUniqueSorted(expressions)": OP_PROTOCOL,
    "agg.OpNUniqueSorted(row_bound)": OP_PROTOCOL,
    "agg.OpNUniqueSorted(dropna)": OP_PROTOCOL,
    "agg.OpPercentileExact.initial_state(n_slots)": OP_PROTOCOL,
    "agg.OpPercentileExact.needs_pass_geometry": OP_PROTOCOL,
    "agg.OpPercentileExact.whole_tile": OP_PROTOCOL,
    **{f"tasks.Task{part}": TASK_PROTOCOL for part in (
        "(pre_filter)", ".device", ".finalize(outputs)", ".get_result", ".preferred_tile_rows",
        ".process", ".scan_safe", ".see_all")},
    **{f"tasks.TaskAggregations.{name}": TASK_PROTOCOL for name in (
        "finalize(outputs)", "host_finalize", "preferred_tile_rows", "scan_safe",
        "update_spmd")},
    **{f"tasks.{task}.{name}": TASK_PROTOCOL for task in ("TaskMapReduce", "TaskSetCreate")
       for name in ("device", "get_result", "process")},
    "tasks.TaskSetCreate(pre_filter)": TASK_PROTOCOL,
    **{f"tasks.TaskAggregations.{name}": STRATEGY for name in (
        "DENSE_RANK_MAX_ROWS", "FUSED_ADDITIVE_MAX_G", "FUSED_EXTREME_MAX_G", "SORT_MAX_G",
        "WHOLE_TILE_MIN_G")},
    # the channels of the Pallas kernels
    **{f"agg.{op}.{name}": KERNEL_CHANNELS for op in ("OpCount", "OpSum", "OpSumMoment")
       for name in ("additive_column", "apply_additive", "kernel_channels")},
    "agg.OpSum.additive_columns_exact": KERNEL_CHANNELS,
    "agg.OpSum.apply_additive_exact": KERNEL_CHANNELS,
    "agg.OpSum.value_bound": KERNEL_CHANNELS,
    "agg.OpSum.LIMB_BITS": LIMBS,
    "agg.OpSum.LIMB_COUNT": LIMBS,
    "agg.OpSumMoment.precise_additive": PRESPLIT,
    **{f"agg.{op}.{name}": KERNEL_CHANNELS for op in ("OpMin", "OpMax") for name in (
        "apply_extreme", "apply_partition_extreme", "extreme_column", "extreme_mode",
        "partition_extreme_column", "value_bound")},
    # the traced step's scopes, the whole-pass loop, presplit, jax
    "scopes.HostScope(df)": TRACED_SCOPE,
    "scopes.HostScope(i1)": TRACED_SCOPE,
    "scopes.HostScope(i2)": TRACED_SCOPE,
    "scopes.DeviceScope(df)": TRACED_SCOPE,
    "scopes.DeviceScope(aux_sets)": TRACED_SCOPE,
    "execution.TileContext(padding_valid)": TRACED_SCOPE,
    "execution.TileContext(filter_valid)": TRACED_SCOPE,
    "execution.TileContext(local_offset)": TRACED_SCOPE,
    "execution.TileContext.bool_expr": TRACED_SCOPE,
    "execution.ExecutorLocal.WHOLE_PASS_CHUNK_TILES": WHOLE_PASS,
    "dataset.Dataset.device_columns": WHOLE_PASS,
    "dataset.DatasetSliced.device_columns": WHOLE_PASS,
    "ops.nullable.NA(presplit)": PRESPLIT,
    "ops.nullable.NA.presplit": PRESPLIT,
    "ops.nullable.NA.tree_flatten": JAX_PYTREE,
    "ops.nullable.NA.tree_unflatten": JAX_PYTREE,
    "ops.binners.BinnerOrdinal(raw_expression)": DENSE_RANK,
    "ops.binners.BinnerOrdinal(dense_rank)": DENSE_RANK,
    "parallel.shuffle.shuffle_segment_grids(precise_add)": F32_SHUFFLE,
}


# -- the walk ---------------------------------------------------------------
def _reference_modules():
    """(the name below the package, the module) of vaex_tpu and each of its
    modules that imports here."""
    modules = [("", vaex_tpu)]
    for info in sorted(pkgutil.walk_packages(vaex_tpu.__path__, "vaex_tpu."),
                       key=lambda info: info.name):
        try:
            module = importlib.import_module(info.name)
        except ImportError:  # the compiled _hostkern of the TPU host
            continue
        modules.append((info.name[len("vaex_tpu."):], module))
    return modules


def _defined(module, value):
    """Whether a module's ``value`` is its own: a class or function made
    there (the package: anywhere in it), or a value that is not typing's."""
    if inspect.ismodule(value):
        return False
    if inspect.isclass(value) or inspect.isroutine(value):
        owner = getattr(value, "__module__", None) or ""
        if module is vaex_tpu:
            return owner.startswith("vaex_tpu")
        return owner == module.__name__
    return type(value).__module__ != "typing"


def _qualified(cls):
    return f"{cls.__module__[len('vaex_tpu.'):]}.{cls.__qualname__}"


def _owner_names(cls, name):
    """The qualified names, ``<module>.<Class>``, of ``cls`` and of the
    vaex_tpu class it has ``name`` from; empty where no vaex_tpu class
    defines it."""
    owner = next((c for c in cls.__mro__
                  if c.__module__.startswith("vaex_tpu.") and name in vars(c)), None)
    return [] if owner is None else list(dict.fromkeys([_qualified(cls), _qualified(owner)]))


def _cases():
    """The modules, the names and the class attributes of the walk, each a
    tuple with its qualified name as the case's id."""
    modules, names, attrs = [], [], []
    for rel, module in _reference_modules():
        modules.append(pytest.param(rel, id=rel or "vaex_tpu"))
        if rel in NOT_PORTED:
            continue
        prefix = f"{rel}." if rel else ""
        for name, value in sorted(vars(module).items()):
            if name.startswith("_") or not _defined(module, value):
                continue
            names.append(pytest.param(rel, name, id=prefix + name))
            if (inspect.isclass(value) and value.__module__ == module.__name__
                    and prefix + name not in NOT_PORTED):
                for attr in sorted(dir(value)):
                    if not attr.startswith("_") and _owner_names(value, attr):
                        attrs.append(pytest.param(rel, name, attr,
                                                  id=f"{prefix}{name}.{attr}"))
    return modules, names, attrs


def _module(package, rel):
    return importlib.import_module(package.__name__ + (f".{rel}" if rel else ""))


_MISSING = object()


def _static(owner, name):
    """``owner``'s ``name`` without running a property; a module's
    ``__getattr__`` (a name made when first asked for) is asked."""
    if inspect.ismodule(owner):
        return getattr(owner, name, _MISSING)
    return inspect.getattr_static(owner, name, _MISSING)


def _parameters(value):
    """The named parameters of a callable (a class: its constructor's), or
    None where it has no signature; private ones (``_m``) are left out."""
    if isinstance(value, (staticmethod, classmethod)):
        value = value.__func__
    if isinstance(value, property) or not callable(value):
        return None
    try:
        signature = inspect.signature(value)
    except (TypeError, ValueError):
        return None
    return [p.name for p in signature.parameters.values()
            if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD) and not p.name.startswith("_")]


def _entry(keys, used):
    """The first of ``keys`` that NOT_PORTED holds (recorded in ``used``),
    or None."""
    key = next((key for key in keys if key in NOT_PORTED), None)
    if key is not None:
        used.add(key)
    return key


def _check(qualified, reference, port, owners, used, param_owners=None):
    """Assert ``port`` has what ``reference`` has, or that NOT_PORTED says
    why it does not (``owners``: the qualified names an entry may use, the
    reference's own first, then those of the classes it inherits from;
    ``param_owners`` those of its arguments, ``owners`` by default)."""
    key = _entry(owners, used)
    if port is _MISSING:
        assert key is not None, f"vaex_tpu_torch lacks {qualified}"
        return
    assert key is None, f"NOT_PORTED[{key!r}], but vaex_tpu_torch has {qualified}"
    want, got = _parameters(reference), _parameters(port)
    if want is None or got is None:
        return
    for name in want:
        param_key = _entry([f"{owner}({name})" for owner in param_owners or owners], used)
        if name in got:
            assert param_key is None, (
                f"NOT_PORTED[{param_key!r}], but vaex_tpu_torch's {qualified} takes {name}")
        else:
            assert param_key is not None, f"vaex_tpu_torch's {qualified} lacks the argument {name}"


def _check_module(rel, used):
    if _entry([rel], used) is None:
        _module(vaex_tpu_torch, rel)
        return
    with pytest.raises(ImportError):
        _module(vaex_tpu_torch, rel)


def _check_name(rel, name, used):
    qualified = f"{rel}.{name}" if rel else name
    reference = getattr(_module(vaex_tpu, rel), name)
    # a constructor's arguments also by the class it has them from
    owners = _owner_names(reference, "__init__") if inspect.isclass(reference) else []
    _check(qualified, reference, _static(_module(vaex_tpu_torch, rel), name), [qualified],
           used, [qualified] + owners)


def _check_attr(rel, cls_name, attr, used):
    prefix = f"{rel}." if rel else ""
    port_cls = _static(_module(vaex_tpu_torch, rel), cls_name)
    if port_cls is _MISSING:  # the class's own case says why
        assert _entry([prefix + cls_name], used) is not None
        return
    cls = getattr(_module(vaex_tpu, rel), cls_name)
    _check(f"{prefix}{cls_name}.{attr}", inspect.getattr_static(cls, attr),
           _static(port_cls, attr), [f"{owner}.{attr}" for owner in _owner_names(cls, attr)],
           used)


MODULES, NAMES, ATTRS = _cases()


@pytest.mark.parametrize("rel", MODULES)
def test_the_port_has_the_module(rel):
    _check_module(rel, set())


@pytest.mark.parametrize("rel, name", NAMES)
def test_the_port_has_the_name(rel, name):
    _check_name(rel, name, set())


@pytest.mark.parametrize("rel, cls_name, attr", ATTRS)
def test_the_port_has_the_attribute(rel, cls_name, attr):
    _check_attr(rel, cls_name, attr, set())


def test_every_not_ported_entry_is_read():
    """An entry that no case reads names nothing of vaex_tpu any more."""
    used = set()
    for case in MODULES:
        _check_module(*case.values, used)
    for case in NAMES:
        _check_name(*case.values, used)
    for case in ATTRS:
        _check_attr(*case.values, used)
    assert not sorted(set(NOT_PORTED) - used)


# -- vaex_tpu's keyword arguments, call by call ------------------------------
N_ROWS = 1000
K = 8


def _frames(tile_rows):
    rng = np.random.default_rng(23)
    arrays = {"k": rng.integers(0, K, N_ROWS).astype(np.int64),
              "x": rng.normal(0, 10, N_ROWS),
              "y": rng.normal(0, 1, N_ROWS) + 0.01 * np.arange(N_ROWS),
              "iv": rng.integers(-1000, 1000, N_ROWS).astype(np.int64)}
    arrays["w"] = arrays["k"] * 10_000_019  # a key past the dense range
    return same_frames(arrays, tile_rows=tile_rows)


def _executed(promise, df):
    """A delayed result after ``df.execute()``: the promise's value."""
    df.execute()
    return promise.get()


# name -> (the call with vaex_tpu's arguments, the same call without them)
CALLS = {
    "count_array_type": (lambda df: df.count("x", array_type="numpy"),
                         lambda df: df.count("x")),
    "sum_binby_array_type": (
        lambda df: df.sum("x", binby="k", limits=[0, K], shape=K, array_type="numpy"),
        lambda df: df.sum("x", binby="k", limits=[0, K], shape=K)),
    "mean_progress": (lambda df: df.mean("x", binby="k", limits=[0, K], shape=K,
                                         progress=False),
                      lambda df: df.mean("x", binby="k", limits=[0, K], shape=K)),
    "minmax_progress": (lambda df: df.minmax("x", progress=False), lambda df: df.minmax("x")),
    "covar_progress": (lambda df: df.covar("x", "y", progress=False),
                       lambda df: df.covar("x", "y")),
    "correlation_progress": (lambda df: df.correlation("x", "y", progress=False),
                             lambda df: df.correlation("x", "y")),
    "groupby_delay_execute": (
        lambda df: _executed(df.groupby("k", agg="count", delay=True), df),
        lambda df: df.groupby("k", agg="count")),
    "groupby_copy_progress": (
        lambda df: df.groupby("k", agg="count", copy=False, progress=False),
        lambda df: df.groupby("k", agg="count")),
    "groupby_agg_delay": (lambda df: df.groupby("k").agg("count", delay=True).get(),
                          lambda df: df.groupby("k").agg("count")),
    "binby_delay_progress": (
        lambda df: np.asarray(df.binby("k", agg="count", delay=False, progress=None)),
        lambda df: np.asarray(df.binby("k", agg="count"))),
    "binby_agg_merge": (lambda df: np.asarray(df.binby("k").agg("count", merge=False)),
                        lambda df: np.asarray(df.binby("k").agg("count"))),
    "limits_square_shape": (lambda df: df.limits("x", "minmax", square=False, shape=10),
                            lambda df: df.limits("x", "minmax")),
    "limits_percentage_square_delay": (
        lambda df: df.limits_percentage("x", 90, square=False, delay=False),
        lambda df: df.limits_percentage("x", 90)),
    "median_approx_percentage": (lambda df: df.median_approx("x", percentage=50),
                                 lambda df: df.median_approx("x")),
    "percentile_approx_delay_progress": (
        lambda df: df.percentile_approx("x", 50, delay=False, progress=None),
        lambda df: df.percentile_approx("x", 50)),
    "unique_delay_axis_progress": (
        lambda df: sorted(df.unique("k", delay=False, axis=None, progress=None)),
        lambda df: sorted(df.unique("k"))),
    "take_filtered_dropfilter": (
        lambda df: df[df.x > 0].take([0, 1, 2], filtered=False, dropfilter=True),
        None),
    "sort_kind": (lambda df: df.sort("x", kind="quicksort"), lambda df: df.sort("x")),
    "drop_check": (lambda df: df.drop("x", check=True), lambda df: df.drop("x")),
    "concat_resolver": (lambda df: df.concat(df, resolver="flexible"),
                        lambda df: df.concat(df)),
    "data_type_arguments": (
        lambda df: df.data_type("x", array_type=None, internal=False, axis=0, expand=True).name,
        lambda df: df.data_type("x").name),
    "isin_use_hashmap": (lambda df: df.k.isin([1, 2], use_hashmap=True).tolist(),
                         lambda df: df.k.isin([1, 2]).tolist()),
    "value_counts_progress_axis": (
        lambda df: df.k.value_counts(progress=False, axis=None).to_dict(),
        lambda df: df.k.value_counts().to_dict()),
    "variables_ourself_expand": (
        lambda df: sorted(df["x + k"].variables(ourself=False, expand_virtual=True)),
        lambda df: sorted(df["x + k"].variables())),
    "data_type_is_float": (lambda df: df.data_type("x").is_float, None),
    "groupby_expression": (lambda df: df.groupby("k").groupby_expression, None),
}


def _assert_same(got, want):
    """Frames column by column, numbers and arrays ints exactly and floats
    to the contract, anything else equal."""
    if isinstance(want, (vaex_tpu.DataFrame, vaex_tpu_torch.DataFrame)):
        assert isinstance(got, vaex_tpu_torch.DataFrame)
        assert got.get_column_names() == want.get_column_names()
        assert len(got) == len(want)
        for name in want.get_column_names():
            _assert_same(np.asarray(got[name].tolist()), np.asarray(want[name].tolist()))
    elif isinstance(want, (np.ndarray, np.generic, float, int)) and not isinstance(want, bool):
        got, want = np.asarray(got), np.asarray(want)
        assert got.shape == want.shape
        if want.dtype.kind == "f" or got.dtype.kind == "f":
            npt.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        else:
            npt.assert_array_equal(got, want)
    elif isinstance(want, (list, tuple)) and want and isinstance(want[0], float):
        npt.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    else:
        assert got == want


@pytest.mark.parametrize("tile_rows", [256, None], ids=["tiles256", "whole"])
@pytest.mark.parametrize("name", sorted(CALLS))
def test_the_call_equals_the_reference(name, tile_rows):
    """The call with vaex_tpu's keyword arguments: the port's answer equals
    vaex_tpu's, and the port's call without the arguments."""
    ref, port = _frames(tile_rows)
    with_arguments, without = CALLS[name]
    got = with_arguments(port)
    _assert_same(got, with_arguments(ref))
    if without is not None:
        _assert_same(got, without(port))


def test_take_of_the_unfiltered_rows_keeps_the_filter():
    """``take(filtered=False)`` on a filtered frame takes among all its rows,
    and the filter then keeps those of them it keeps."""
    ref, port = _frames(None)
    x = np.asarray(port.x.tolist())
    got = port[port.x > 0].take([0, 1, 2, 3, 4], filtered=False)
    _assert_same(got, ref[ref.x > 0].take([0, 1, 2, 3, 4], filtered=False))
    npt.assert_array_equal(got.x.tolist(), x[:5][x[:5] > 0])
    npt.assert_array_equal(port[port.x > 0].take([0, 1]).x.tolist(), x[x > 0][:2])


def test_dataset_take_of_masked_indices(monkeypatch):
    """``Dataset.take(indices, masked=True)``: the masked entries of a numpy
    masked index are missing rows, as in vaex_tpu; so is
    ``ColumnIndexed.index``'s."""
    from vaex_tpu_torch import column, settings
    monkeypatch.setattr(settings, "DEVICE", "cpu")
    rng = np.random.default_rng(5)
    arrays = {"x": rng.normal(0, 1, 40), "i": rng.integers(0, 9, 40).astype(np.int64)}
    index = np.ma.MaskedArray([3, 0, 39, 7, 7, 1], [False, True, False, False, False, True])
    ref = vaex_tpu.from_dataset(vaex_tpu.dataset.DatasetArrays(arrays).take(index, masked=True))
    port = vaex_tpu_torch.from_dataset(
        vaex_tpu_torch.dataset.DatasetArrays(arrays).take(index, masked=True))
    for name in arrays:
        assert port[name].tolist() == ref[name].tolist()
        assert port[name].tolist()[1] is None
    taken = column.ColumnIndexed.index(arrays["x"], index, masked=True)
    want = vaex_tpu.column.ColumnIndexed.index(arrays["x"], index, masked=True).to_numpy()
    npt.assert_array_equal(np.ma.getmaskarray(taken.to_numpy()), np.ma.getmaskarray(want))
    npt.assert_array_equal(np.ma.filled(taken.to_numpy(), 0), np.ma.filled(want, 0))


def test_groupby_copy_false_groups_the_frame_itself():
    ref, port = _frames(256)
    grouped = port.groupby("k", copy=False)
    assert grouped.df is port and port.groupby("k").df is not port
    assert grouped.groupby_expression == ref.groupby("k").groupby_expression == ["k"]
    _assert_same(grouped.agg("count"), ref.groupby("k", copy=False).agg("count"))


# each site of ``delay=``: the call with delay=True, on either package
DELAYED = {
    "count": lambda df: df.count("x", binby="k", limits=[0, K], shape=K, delay=True),
    "first": lambda df: df.first("x", "y", delay=True),
    "std": lambda df: df.std("x", delay=True),
    "minmax": lambda df: df.minmax("x", delay=True),
    "covar": lambda df: df.covar("x", "y", delay=True),
    "correlation": lambda df: df.correlation("x", "y", delay=True),
    "limits": lambda df: df.limits("x", "minmax", delay=True),
    "limits_percentage": lambda df: df.limits_percentage("x", 90, delay=True),
    "percentile_approx": lambda df: df.percentile_approx("x", [10, 50], delay=True),
    "median_approx": lambda df: df.median_approx("x", delay=True),
    "unique": lambda df: df.unique("k", delay=True),
    "groupby": lambda df: df.groupby("k", agg={"x": "sum", "y": "mean"}, delay=True),
    "groupby_agg": lambda df: df.groupby("k").agg("count", delay=True),
    "binby": lambda df: df.binby("k", agg="count", delay=True),
    "binby_agg": lambda df: df.binby("k").agg("count", delay=True),
}
# where vaex_tpu gives the value itself under delay=True
VALUE_UNDER_DELAY = ("limits_percentage", "percentile_approx", "median_approx", "unique",
                     "binby", "binby_agg")


def _delayed_value(result, df):
    """A delayed call's value: a promise's after ``df.execute()``, or the
    value itself where the call gave one."""
    if isinstance(result, (ReferencePromise, Promise)):
        df.execute()
        result = result.get()
    return np.asarray(result) if hasattr(result, "dims") else result


@pytest.mark.parametrize("name", sorted(DELAYED))
def test_delay_gives_a_promise_of_the_reference_value(name):
    ref, port = _frames(256)
    got = DELAYED[name](port)
    assert isinstance(got, Promise)
    _assert_same(_delayed_value(got, port), _delayed_value(DELAYED[name](ref), ref))


@pytest.mark.parametrize("name", VALUE_UNDER_DELAY)
def test_the_reference_returns_the_value_under_delay(name):
    """vaex_tpu's ``delay=True`` gives the value itself at these sites
    (vaex_tpu/dataframe.py:947-1030, 1415-1440, 1757; groupby.py:1059); its
    groupby gives a promise (groupby.py:912-920), as the port does
    everywhere (ROADMAP, known problems of the reference)."""
    ref, _ = _frames(None)
    assert not isinstance(DELAYED[name](ref), ReferencePromise)
    assert isinstance(DELAYED["groupby"](ref), ReferencePromise)


def test_delay_on_the_one_sort_route():
    """A key past the dense range takes the one-sort plan; its delayed
    result is a promise of vaex_tpu's frame."""
    ref, port = _frames(None)
    with vaex_tpu_torch.cache.off():
        got = port.groupby("w", agg={"x": "sum", "y": "mean"}, sort=True, delay=True)
    assert isinstance(got, Promise)
    assert port.executor.trace_log[-1]["groupby"] == "one-sort"
    want = ref.groupby("w", agg={"x": "sum", "y": "mean"}, sort=True, delay=True)
    _assert_same(got.get(), _delayed_value(want, ref))


def test_delay_on_the_shuffle_route(monkeypatch):
    """Over a mesh of CPU shards past ``SHUFFLE_MIN_G`` groups the groupby
    exchanges its rows; its delayed result is a promise of vaex_tpu's
    single-device frame."""
    from vaex_tpu_torch import groupby
    from vaex_tpu_torch.parallel import distributed_executor
    monkeypatch.setattr(groupby, "SHUFFLE_MIN_G", 4)
    ref, port = _frames(None)
    port.executor = distributed_executor(3, devices=["cpu"] * 3)
    with vaex_tpu_torch.cache.off():
        got = port.groupby("k", agg={"x": "sum", "y": "mean"}, sort=True, delay=True)
    assert any(entry.get("shuffle") is True for entry in port.executor.trace_log)
    assert isinstance(got, Promise)
    want = ref.groupby("k", agg={"x": "sum", "y": "mean"}, sort=True)
    _assert_same(got.get(), want)


def test_selection_false_is_no_selection():
    """vaex_tpu's default ``selection=False`` gives what no selection gives."""
    ref, port = _frames(256)
    for call in (lambda df, **kw: df.sum("x", binby="k", limits=[0, K], shape=K, **kw),
                 lambda df, **kw: df.minmax("x", **kw),
                 lambda df, **kw: df.percentile_approx("x", 50, **kw),
                 lambda df, **kw: df.limits_percentage("x", 90, **kw)):
        got = call(port, selection=False)
        _assert_same(got, call(port))
        _assert_same(got, call(ref, selection=False))


# -- DataType ----------------------------------------------------------------
def _typed_arrays():
    """One column of each kind: numpy's int8, uint16, int64, float32,
    float64, bool, datetime64[ns], timedelta64[s] and str; arrow's
    dictionary, binary, list and struct."""
    import pyarrow as pa
    n = 6
    rng = np.random.default_rng(9)
    return {
        "i8": rng.integers(-100, 100, n).astype(np.int8),
        "u16": rng.integers(0, 60000, n).astype(np.uint16),
        "i64": rng.integers(-10 ** 12, 10 ** 12, n).astype(np.int64),
        "f32": rng.normal(0, 1, n).astype(np.float32),
        "f64": rng.normal(0, 1, n),
        "b": rng.random(n) < 0.5,
        "dt": np.datetime64("2024-01-01", "ns") + rng.integers(0, 10 ** 12, n).astype("m8[ns]"),
        "td": rng.integers(-10 ** 6, 10 ** 6, n).astype("m8[s]"),
        "s": np.array([f"s{i % 3}" for i in range(n)]),
        "dict": pa.array([f"d{i % 2}" for i in range(n)]).dictionary_encode(),
        "bin": pa.array([bytes([i]) * 2 for i in range(n)], type=pa.binary()),
        "list": pa.array([[i, i + 1] for i in range(n)]),
        "struct": pa.array([{"a": i, "b": float(i)} for i in range(n)]),
    }


PREDICATES = ("is_numpy", "is_primitive", "is_datetime", "is_timedelta", "is_float",
              "is_integer", "is_signed", "is_bool", "is_list", "is_struct", "is_string")
CONVERSIONS = ("arrow", "device", "index_type")
NESTED = ("list", "struct")  # where vaex_tpu's numpy-kind predicates raise


def _data_types(column):
    arrays = _typed_arrays()
    ref = vaex_tpu.from_arrays(**arrays)
    port = vaex_tpu_torch.from_arrays(**arrays)
    return ref.data_type(column), port.data_type(column)


@pytest.mark.parametrize("column", sorted(_typed_arrays()))
@pytest.mark.parametrize("name", PREDICATES + CONVERSIONS)
def test_data_type_answers_as_the_reference(name, column):
    """Each predicate and conversion of ``df.data_type(column)`` equals
    vaex_tpu's; where vaex_tpu raises (numpy's kind of a list or struct)
    the port answers False."""
    want_type, got_type = _data_types(column)
    got = getattr(got_type, name)
    if column in NESTED and name in ("is_float", "is_integer", "is_signed", "is_bool"):
        assert got is False
        return
    if column in NESTED and name == "device":
        assert got == np.dtype(object)
        return
    want = getattr(want_type, name)
    if name == "index_type":
        assert got is got_type and want is want_type
    elif name == "device":
        assert np.dtype(got) == np.dtype(want)
    else:
        assert got == want, (got, want)


@pytest.mark.parametrize("column", NESTED)
def test_the_reference_raises_for_the_kind_of_a_list_or_struct(column):
    """vaex_tpu's is_float / is_integer / is_signed / is_bool and device ask
    for the numpy dtype of a list or struct type, which raises TypeError
    (vaex_tpu/datatype.py:86-100, 121-140; ROADMAP, known problems of the
    reference); the port answers False, and object for the device dtype."""
    want_type, got_type = _data_types(column)
    for name in ("is_float", "is_integer", "is_signed", "is_bool", "device"):
        with pytest.raises(TypeError):
            getattr(want_type, name)
        got = getattr(got_type, name)
        assert got == np.dtype(object) if name == "device" else got is False
