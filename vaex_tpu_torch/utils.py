"""Small shared helpers: fingerprints, name mangling.

Fingerprints are stable content hashes of (nested) Python values, numpy
arrays and torch tensors, used to identify datasets and frames.
"""

from __future__ import annotations

import hashlib
import itertools
import keyword
import os
import re

import numpy as np
import torch


def _tokenize_into(h, obj):
    if obj is None or isinstance(obj, (bool, int, float, str, bytes, complex)):
        h.update(repr(obj).encode())
    elif isinstance(obj, (list, tuple)):
        h.update(b"(")
        for o in obj:
            _tokenize_into(h, o)
            h.update(b",")
        h.update(b")")
    elif isinstance(obj, dict):
        h.update(b"{")
        for k in sorted(obj, key=repr):
            _tokenize_into(h, k)
            h.update(b":")
            _tokenize_into(h, obj[k])
        h.update(b"}")
    elif isinstance(obj, (set, frozenset)):
        _tokenize_into(h, sorted(obj, key=repr))
    elif isinstance(obj, np.dtype):
        h.update(obj.str.encode())
    elif isinstance(obj, torch.Tensor):
        # the bytes are hashed on the host: callers hash samples, not columns
        _tokenize_into(h, obj.detach().cpu().numpy())
    elif isinstance(obj, np.ndarray):
        h.update(obj.dtype.str.encode())
        h.update(str(obj.shape).encode())
        if obj.dtype == object:
            h.update(repr(obj.tolist()).encode())
        else:
            h.update(np.ascontiguousarray(obj).tobytes())
    elif hasattr(obj, "fingerprint"):
        fp = obj.fingerprint() if callable(obj.fingerprint) else obj.fingerprint
        h.update(str(fp).encode())
    else:
        h.update(repr(obj).encode())


def fingerprint(*args, **kwargs) -> str:
    """Stable content hash of arbitrary (nested) Python values."""
    h = hashlib.sha256()
    _tokenize_into(h, args)
    if kwargs:
        _tokenize_into(h, kwargs)
    return h.hexdigest()


def hash_array_data(ar) -> str:
    """Content hash of one column's raw data (numpy, masked or tensor)."""
    h = hashlib.sha256()
    if isinstance(ar, np.ma.MaskedArray):
        h.update(b"masked")
        _tokenize_into(h, np.ma.getmaskarray(ar))
        ar = ar.data
    _tokenize_into(h, ar)
    return h.hexdigest()


_tokens = itertools.count(1)
_pinned = {}  # id -> (object, token) of the objects that take no attribute


def identity(obj) -> int:
    """A number that names ``obj`` while it lives and no other object ever
    (an ``id`` is reused once its object dies): kept on the object where it
    takes an attribute (tensors, functions, sets), else beside the object,
    which stays alive with it."""
    attrs = getattr(obj, "__dict__", None)
    if isinstance(attrs, dict):
        if "_vaex_identity" not in attrs:
            try:
                obj._vaex_identity = next(_tokens)
            except (AttributeError, TypeError):
                attrs = None
        if attrs is not None:
            return obj._vaex_identity
    pinned = _pinned.get(id(obj))
    if pinned is None or pinned[0] is not obj:
        pinned = _pinned[id(obj)] = (obj, next(_tokens))
    return pinned[1]


def tensor_key(t):
    """(an exact key of a tensor's values, True), or (None, False) where it
    has none.  A CPU tensor is keyed by a hash of all its bytes, as a host
    array is: a write through ``.numpy()``, ``.data`` or an array that
    shares its memory bumps no version counter, so its identity and version
    are no exact key.  A card tensor has none (see :mod:`.cache`: its
    results are not kept)."""
    if t.device.type != "cpu":
        return None, False
    data = t.detach().contiguous().reshape(-1).view(torch.uint8).numpy()
    return ("tensor", hash_array_data(data), str(t.dtype), tuple(t.shape)), True


class Signal:
    """A list of callbacks that ``emit`` calls in order, returning their
    results (vaex_tpu/utils.py:107)."""

    def __init__(self, name=""):
        self.name = name
        self.callbacks = []

    def connect(self, f):
        self.callbacks.append(f)
        return f

    def disconnect(self, f):
        self.callbacks.remove(f)

    def emit(self, *args, **kwargs):
        return [cb(*args, **kwargs) for cb in self.callbacks]


_identifier_re = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def valid_expression_name(name: str) -> bool:
    return bool(_identifier_re.match(name)) and not keyword.iskeyword(name)


def find_valid_name(name, used=()):
    """Mangle a column name into a valid Python identifier not in ``used``."""
    name = str(name)
    if not valid_expression_name(name):
        translated = re.sub(r"[^a-zA-Z0-9_]", "_", name)
        if not translated or not _identifier_re.match(translated):
            translated = "_" + translated
        name = translated
    base = name
    i = 1
    while name in used:
        name = f"{base}_{i}"
        i += 1
    return name


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    """``a`` rounded up to a multiple of ``b``."""
    return ceil_div(a, b) * b
