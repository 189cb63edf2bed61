"""The general table maker: a configuration's tables, drawn on the device
from the seed.

A configuration file (``configs/<config>.json``) lists its tables in
order, each with its ``rows`` and its ``columns`` in order.  A column names
its ``kind``, a module ``columns/<kind>.py`` whose
``make(spec, rows, gen, device, made)`` draws it (``made`` holds the
columns drawn before it, for a kind that draws from another column), and
its ``dtype``.  Everything is drawn from one ``torch.Generator`` on the
device, seeded with the seed, in file order, so the same seed gives the
same tables.
"""

from __future__ import annotations

import torch

from portbench import byname


def make(config, seed, device, root=byname.ROOT):
    """{table: {column: tensor}} of ``config``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    made = {}
    for name, table in config["tables"].items():
        rows, cols = int(table["rows"]), made.setdefault(name, {})
        for col, spec in table["columns"].items():
            kind = byname.module("columns", spec["kind"], root)
            cols[col] = kind.make(spec, rows, gen, device, made)
    return made


def rows(config):
    """{table: rows}."""
    return {name: int(table["rows"]) for name, table in config["tables"].items()}
