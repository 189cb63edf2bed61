"""The benchmark's parts, found by name: ``<folder>/<name>.py`` and
``<folder>/<name>.json`` under ``portbench/`` of a checkout.

A configuration's column kinds (``columns/``), a mix's calls (``calls/``)
and their plain versions (``reference/``), its loop (``loops/``) and each
metric (``metrics/``) are modules of their own, so that a later cell adds
a kind, a call, a loop or a metric as a new file and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_loaded = {}


def path(folder, name, root=ROOT, ext=".py"):
    found = os.path.join(root, "portbench", folder, f"{name}{ext}")
    if not os.path.isfile(found):
        raise ValueError(f"no portbench/{folder}/{name}{ext}: {folder} {name!r} is not defined")
    return found


def module(folder, name, root=ROOT):
    """The module ``<folder>/<name>.py``, loaded once."""
    found = path(folder, name, root)
    if found not in _loaded:
        spec = importlib.util.spec_from_file_location(f"portbench_{folder}_{name}", found)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _loaded[found] = mod
    return _loaded[found]


def data(folder, name, root=ROOT):
    """The JSON object of ``<folder>/<name>.json``."""
    with open(path(folder, name, root, ".json")) as f:
        return json.load(f)
