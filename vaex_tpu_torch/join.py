"""The join: a sort-and-probe join whose probe runs on the pass device.

The counterpart of ``vaex_tpu/join.py:27-131``, with its plan:

* a pass over the right frame builds a :class:`~.ops.setops.SortedIndex` of
  its key on the device (a stable sort, the unique runs);
* a pass over the left frame probes its key against the index tile by tile
  with kernel B6 and writes the first right row of each left row into one
  lookup tensor, which stays on the device (-1: no match);
* duplicate right keys need ``allow_duplication``: the left rows they
  repeat are appended at the end (``dataset.concat(dataset.take(extra))``);
* the result is lazy: ``left.dataset.merged(right.dataset.take(lookup))``,
  the unmatched rows masked; nothing is copied.

Left row order is kept; ``how`` is "left", "inner" or "right" (the swapped
left).  A name both frames have is renamed only with a prefix or suffix,
and the shared key collapses to the left column.  The right frame's
virtual columns and variables come along.  A string key joins through the
set of the right key's strings: both keys become their ordinals in it
(``_ordinal_values``, strings probed once per label), the index holds the
right ordinals and the probe the left ones; a null key matches nothing.

``mesh=`` (by default the left executor's mesh, when its passes run
sharded) takes the hash-partitioned lookup of :mod:`.parallel.join`
(vaex_tpu/join.py:134-160): a numeric key without missing values, whose
right rows hold no duplicate key.  A string or masked key, a skew that slack
16 does not absorb, and duplicate right keys with ``allow_duplication``
take the path above; duplicate right keys without it raise, as there.
``trace_log`` records which.

Over a mesh of several processes each process holds its own rows of both
frames, and joins its left rows against the union, in rank order, of
every process's right rows (:func:`_across_processes`).  The hash route's
exchanges carry the right columns to the owners and the matched values
back, so that the right columns become tensors in the left rows' order.
Where one process alone would take the path above, every process gathers
the whole right frame (``collectives.gather``, the strings' labels merged
through ``collectives.objects``) and takes that path over it; ``trace_log``
records ``{"join": "broadcast", "reason": ...}``.
"""

from __future__ import annotations

import torch

from . import expresso


def join(left, right, on=None, left_on=None, right_on=None, lprefix="", rprefix="",
         lsuffix="", rsuffix="", how="left", allow_duplication=False, inplace=False,
         mesh=None):
    if how == "right":
        return join(right, left, on=on, left_on=right_on, right_on=left_on,
                    lprefix=rprefix, rprefix=lprefix, lsuffix=rsuffix, rsuffix=lsuffix,
                    how="left", allow_duplication=allow_duplication, mesh=mesh)
    if how not in ("left", "inner"):
        raise ValueError(f"how={how!r} not supported (left/right/inner)")
    left_on = str(left_on or on)
    right_on = str(right_on or on)
    if left_on == "None" or right_on == "None":
        raise ValueError("specify on= or left_on=/right_on=")
    strings = [df.data_type(key).is_text for df, key in ((left, left_on), (right, right_on))]
    if strings[0] != strings[1]:
        raise TypeError(f"a join of a key of strings and one of numbers ({left_on!r}, "
                        f"{right_on!r})")

    left = left.extract()
    right = right.extract()
    args = (left_on, right_on, how, allow_duplication)

    lookup = None
    if mesh is not None and mesh.size > 1 and mesh.world > 1:
        right, lookup = _across_processes(left, right, left_on, right_on, mesh,
                                          allow_duplication, strings[0])
    elif mesh is not None and mesh.size > 1 and not strings[0]:
        lookup = _mesh_lookup(left, right, left_on, right_on, mesh, allow_duplication)
    if lookup is not None:
        extra_left = lookup.new_empty(0)
    else:
        if strings[0]:
            index, left_key = _string_index(left, left_on, right, right_on)
        else:
            index, left_key = right._index(right_on), left_on
        if index.has_duplicates and not allow_duplication:
            raise ValueError("joining with duplicate keys on the right requires "
                             "allow_duplication=True")
        lookup, extra_left, extra_right = left._map_index(left_key, index, index.has_duplicates)
    if extra_left.shape[0]:
        left_ds = left.dataset.concat(left.dataset.take(
            extra_left, origin=("join-extra", left.dataset, right.dataset, args)))
        left = left._rebind_dataset(left_ds)
        lookup = torch.cat([lookup, extra_right.to(lookup.device)])

    unmatched = lookup < 0
    masked_any = bool(unmatched.any())
    if how == "inner" and masked_any:
        keep = torch.nonzero(~unmatched).squeeze(1)
        left = left._rebind_dataset(left.dataset.take(
            keep, origin=("join-inner", left.dataset, right.dataset, args)))
        lookup = lookup.index_select(0, keep)
        masked_any = False
    mask = None
    if masked_any:
        lookup = lookup.masked_fill(unmatched, 0)
        mask = unmatched

    # a staged string column's codes tensor: its taken column holds the codes
    codes = {meta["codes_column"] for meta in right._categories.values()
             if meta.get("codes_column") in right.dataset}
    # only clashing names are renamed (vaex_tpu/join.py:87-101)
    left_names = left.get_column_names(hidden=True)
    right_names = [n for n in right.get_column_names(hidden=True) if n not in codes]
    renaming = {}
    for name in right_names:
        if name not in left_names or (name == right_on and name == left_on):
            continue
        if not (lprefix or lsuffix or rprefix or rsuffix):
            raise NameError(f"column {name!r} exists in both; use l/r prefix/suffix")
        new_name = rprefix + name + rsuffix
        if new_name != name:
            renaming[name] = new_name
    skip = set()
    if right_on == left_on and right_on in right_names and left_on in left_names:
        skip.add(right_on)  # the shared key collapses to the left column

    right_physical = [n for n in right_names if n not in right.virtual_columns]
    right_ds = right.dataset.project(*[n for n in right_physical if n not in skip])
    if renaming:
        right_ds = right_ds.renamed({k: v for k, v in renaming.items() if k in right_ds})
    right_taken = right_ds.take(lookup, mask, origin=(
        "join-lookup", left.dataset, right.dataset, args))

    result = left._rebind_dataset(left.dataset.merged(right_taken))
    for name in right_names:
        if name in right.virtual_columns and name not in skip:
            expression = expresso.translate(right.virtual_columns[name],
                                            lambda n: renaming.get(n))
            result.virtual_columns[renaming.get(name, name)] = expression
    result.column_names = left.column_names + [
        renaming.get(n, n) for n in right_names
        if n not in skip and renaming.get(n, n) not in left.column_names]
    for k, v in right.variables.items():
        result.variables.setdefault(k, v)
    return result


def _mesh_lookup(left, right, left_on, right_on, mesh, allow_duplication):
    """The lookup of the hash-partitioned join over ``mesh`` (the right
    rows' dtype: int32 below 2^31), or None where the local path takes the
    join: a masked key, a skew past slack 16, duplicate right keys with
    ``allow_duplication`` (vaex_tpu/join.py:134-160).  ``trace_log`` of
    the left executor records the route."""
    from .parallel.join import lookup_retried
    from .parallel.shuffle import shard_values
    log = left.executor.trace_log
    lvals = [v[left_on] for v in shard_values(left, [left_on], mesh)]
    rvals = [v[right_on] for v in shard_values(right, [right_on], mesh)]
    if any(x.mask is not None and bool(x.mask.any()) for x in lvals + rvals):
        log.append({"join": "local", "reason": "masked key"})
        return None
    lookup, overflow, dups, _ = lookup_retried(mesh, [x.data for x in lvals],
                                               [x.data for x in rvals], log)
    if overflow:
        log.append({"join": "local", "reason": "skew"})
        return None
    if dups:
        if not allow_duplication:
            raise ValueError("joining with duplicate keys on the right requires "
                             "allow_duplication=True")
        log.append({"join": "local", "reason": "duplicate right keys"})
        return None
    return lookup.to(torch.int32) if right.dataset.row_count < 2 ** 31 else lookup


def _across_processes(left, right, left_on, right_on, mesh, allow_duplication, string_key):
    """(the right frame the join's tail takes rows of, the lookup into it)
    over a mesh of several processes.  The hash route: a frame of the right
    columns' values fetched for this process's left rows, in their order,
    and the lookup of each matched row to itself (-1: none).  Else, with a
    string or masked key in any process, a skew past slack 16 or duplicate
    right keys under ``allow_duplication``: the whole right frame gathered
    to every process and no lookup, so that the local path runs over it.
    Duplicate right keys without ``allow_duplication`` raise."""
    from .parallel import collectives
    from .parallel.join import column_wire, lookup_retried
    from .parallel.shuffle import shard_values
    log = left.executor.trace_log
    codes = {meta.get("codes_column") for meta in right._categories.values()} & set(right.dataset)
    physical = [n for n in right.get_column_names(hidden=True)
                if n not in codes and n not in right.virtual_columns]
    rvals = shard_values(right, [right_on] + physical, mesh)
    reason = "string key" if string_key else None
    if reason is None:
        lvals = [v[left_on] for v in shard_values(left, [left_on], mesh)]
        keys = lvals + [v[right_on] for v in rvals]
        if collectives.total([x.mask is not None and bool(x.mask.any()) for x in keys], mesh):
            reason = "masked key"
    if reason is None:
        # the shared key collapses to the left column: its right values stay
        shared = right_on == left_on and left_on in left.get_column_names(hidden=True)
        names = [n for n in physical if not (shared and n == right_on)]
        wires = [column_wire([v[n] for v in rvals], mesh) for n in names]
        lookup, overflow, dups, values = lookup_retried(
            mesh, [x.data for x in lvals], [v[right_on].data for v in rvals], log,
            payload=[channel for channels, _ in wires for channel in channels])
        if overflow:
            reason = "skew"
        elif dups and not allow_duplication:
            raise ValueError("joining with duplicate keys on the right requires "
                             "allow_duplication=True")
        elif dups:
            reason = "duplicate right keys"
        else:
            columns, at = {}, 0
            for name, (channels, make) in zip(names, wires):
                columns[name] = make(values[at:at + len(channels)])
                at += len(channels)
            rows = torch.arange(lookup.shape[0], device=lookup.device)
            lookup = torch.where(lookup >= 0, rows, -1)
            if lookup.shape[0] < 2 ** 31:
                lookup = lookup.to(torch.int32)
            return _right_frame(right, columns, rvals, mesh, codes), lookup
    log.append({"join": "broadcast", "reason": reason, "world": mesh.world})
    columns = {}
    for name in physical:
        channels, make = column_wire([v[name] for v in rvals], mesh)
        columns[name] = make([torch.cat(collectives.gather(parts, mesh))
                              for parts, _ in channels])
    return _right_frame(right, columns, rvals, mesh, codes), None


def _right_frame(right, columns, values, mesh, codes):
    """``right`` over the tensors ``columns`` on ``mesh.first``: its virtual
    columns and variables kept, a staged string's codes column and category
    dropped (its codes index the merged labels now), a plain executor."""
    from .dataset import DatasetArrays
    from .execution import ExecutorLocal
    logical = {n: values[0][n].logical for n in columns
               if getattr(values[0][n], "logical", None) is not None}
    out = right._rebind_dataset(DatasetArrays(columns, logical, mesh.first), keep_filter=False)
    out.column_names = [n for n in right.column_names if n not in codes]
    out._categories = {k: m for k, m in right._categories.items()
                       if m.get("codes_column") not in codes}
    out.executor = ExecutorLocal()
    return out


def _string_index(left, left_on, right, right_on):
    """(the index of the right key's ordinals in the set of its strings,
    the left key's ordinal expression): the right rows without a string
    (null) hold no key."""
    from .ops.setops import SortedIndex
    oset = right._set(right_on)
    right_key = f"_ordinal_values({right_on}, {right.add_variable('join_set', oset, unique=True)})"
    left_key = f"_ordinal_values({left_on}, {left.add_variable('join_set', oset, unique=True)})"
    ordinals = right._evaluate_tile(right_key, 0, right.dataset.row_count)
    data = ordinals.data.to(torch.int64)
    return SortedIndex(data, data >= oset.n_keys), left_key
