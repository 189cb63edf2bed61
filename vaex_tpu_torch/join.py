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
``mesh=`` waits for multi-device execution (ROADMAP queue A12).
"""

from __future__ import annotations

import torch

from . import expresso


def join(left, right, on=None, left_on=None, right_on=None, lprefix="", rprefix="",
         lsuffix="", rsuffix="", how="left", allow_duplication=False, inplace=False,
         mesh=None):
    if mesh is not None:
        raise NotImplementedError("a join over a mesh is not ported yet (ROADMAP queue A12)")
    if how == "right":
        return join(right, left, on=on, left_on=right_on, right_on=left_on,
                    lprefix=rprefix, rprefix=lprefix, lsuffix=rsuffix, rsuffix=lsuffix,
                    how="left", allow_duplication=allow_duplication)
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
