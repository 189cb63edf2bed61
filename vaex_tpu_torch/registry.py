"""Function registry for the expression engine.

Every name callable inside an expression string lives in
``expression_namespace``: functions of :class:`vaex_tpu_torch.ops.nullable.NA`
values, evaluated eagerly on a tile's tensors.  ``register_function`` also
installs the function as a method on :class:`vaex_tpu_torch.expression.Expression`
(``df.x.sqrt()`` is ``sqrt(x)``), except where the class defines a method of
that name itself (``clip``, ``where``, ``fillna`` ...).
The host namespace of ``vaex_tpu`` (string and datetime functions) is not
ported yet.
"""

from __future__ import annotations

expression_namespace = {}  # name -> impl (NA args -> NA)

_expression_methods = []  # installed once the Expression class exists


def register_function(name=None, on_expression=True, device=None):
    """Register ``device`` (or the decorated function) under ``name``."""

    def wrapper(f=None):
        fname = name or f.__name__
        expression_namespace[fname] = device if device is not None else f
        if on_expression:
            _expression_methods.append(fname)
            _try_install(fname)
        return f if f is not None else device

    return wrapper


def has_function(name: str) -> bool:
    return name in expression_namespace


def _try_install(name):
    from . import expression as _expr_mod
    Expression = getattr(_expr_mod, "Expression", None)
    if Expression is None:  # expression.py installs the pending ones itself
        return
    own = Expression.__dict__.get(name)
    if own is not None and not getattr(own, "registered", False):
        return

    def method(self, *args, **kwargs):
        return self._call_function(name, *args, **kwargs)
    method.__name__ = name
    method.registered = True
    setattr(Expression, name, method)


def install_all_on_expression():
    """Called once by expression.py after the Expression class exists."""
    for name in _expression_methods:
        _try_install(name)
