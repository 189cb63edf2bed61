"""The comparison that decides ``correct``: the program's answers against
the plain reference's.

An answer on either side is a dict of output columns.  The program's come
from a call's ``got``; the reference's carry each column's kind and scale
(``reference/plain.py``).  The program's rows are put in the order of their
keys, the reference's order, before they are compared.  :func:`judge`
folds every compared cell into a few numbers, each named by its column's
kind and held against the limit of that name (``limits/<workload>.json``):
``mismatches`` counts the cells of ``exact`` columns that differ; any other
kind is the largest |got - want| / scale of its cells (absolute where the
column has no scale).
"""

from __future__ import annotations

import torch


def lex_order(keys):
    """The permutation that sorts rows by their keys, the first most
    significant."""
    order = torch.arange(keys[0].numel(), device=keys[0].device)
    for k in reversed(keys):
        order = order[torch.argsort(k[order], stable=True)]
    return order


def fold(numbers, name, value):
    if name == "mismatches":
        numbers[name] = numbers.get(name, 0) + int(value)
    else:
        numbers[name] = max(numbers.get(name, 0.0), float(value))


def judge(got, want, key_names, numbers):
    """Folds one answer's comparison into ``numbers``."""
    fold(numbers, "mismatches", 0)
    n_want = {int(v[1].numel()) for v in want.values()}
    if sorted(got) != sorted(want):
        fold(numbers, "mismatches", 1 + max(n_want))
        return
    n_got = {int(v.numel()) for v in got.values()}
    if n_want != n_got or len(n_got) != 1:
        fold(numbers, "mismatches", 1 + max(n_want | n_got))
        return
    device = next(iter(want.values()))[1].device
    got = {k: v.to(device) for k, v in got.items()}
    if key_names:
        order = lex_order([got[k] for k in key_names])
        got = {k: v[order] for k, v in got.items()}
    for name, (kind, value, scale) in want.items():
        g, w = got[name].reshape(-1), value.reshape(-1)
        if kind == "exact":
            if g.is_floating_point() or w.is_floating_point():
                g, w = g.to(torch.float64), w.to(torch.float64)
                same = (g == w) | (torch.isnan(g) & torch.isnan(w))
            else:
                same = g == w
            fold(numbers, "mismatches", int((~same).sum()))
            continue
        g, w = g.to(torch.float64), w.to(torch.float64)
        err = (g - w).abs()
        if scale is not None:
            err = err / scale.reshape(-1).to(torch.float64)
        err = torch.where(g == w, 0.0, err)  # 0 / 0 where both are exactly 0
        both_nan = torch.isnan(g) & torch.isnan(w)
        err = torch.where(both_nan, 0.0, torch.where(torch.isnan(err), torch.inf, err))
        fold(numbers, kind, err.max() if err.numel() else 0.0)


def verdict(numbers, limits):
    """({name: [number, limit]} of the numbers compared, each number
    within its limit); a number with no limit is not within."""
    checks = {name: [numbers[name], limits.get(name)] for name in sorted(numbers)}
    within = all(limit is not None and value <= limit for value, limit in checks.values())
    return checks, within
