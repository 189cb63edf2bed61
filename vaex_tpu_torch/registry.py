"""Function registry for the expression engine (vaex_tpu/registry.py:9-76).

Every name callable inside an expression string lives in one or both of two
namespaces:

* ``expression_namespace``: *device* implementations, functions of
  :class:`vaex_tpu_torch.ops.nullable.NA` values evaluated eagerly on a
  tile's tensors;
* ``expression_namespace_host``: *host* implementations, numpy / pyarrow /
  pandas functions of host arrays.  A name only this one has (``str_*``,
  ``dt_*``, ``td_*``, ``format``, ``to_string``) makes an expression run in
  the host stage of a pass (:mod:`vaex_tpu_torch.scopes`), whose result
  is copied to the pass device.

``register_function`` also installs the function as a method on
:class:`vaex_tpu_torch.expression.Expression` (``df.x.sqrt()`` is
``sqrt(x)``), under a scope accessor for a scoped one (``df.s.str.upper()``
is ``str_upper(s)``, ``df.t.dt.hour`` is ``dt_hour(t)``), except where the
class defines a method of that name itself (``clip``, ``where``,
``fillna`` ...).
"""

from __future__ import annotations

expression_namespace = {}  # name -> device impl (NA args -> NA)
expression_namespace_host = {}  # name -> host impl (host arrays -> host array)

# accessor -> the prefix of its functions' names
scopes = {"str": "str_", "str_pandas": "str_", "dt": "dt_", "td": "td_"}

_expression_methods = []  # installed once the Expression class exists


def register_function(scope=None, as_property=False, name=None, on_expression=True,
                      device=None, host=None, df_accessor=None):
    """Register ``device`` (or the decorated function) and / or ``host``
    under ``name``, prefixed by its scope's prefix.  ``df_accessor``
    changes nothing, as in vaex_tpu (vaex_tpu/registry.py:37-38)."""
    prefix = scopes.get(scope, "") if scope else ""

    def wrapper(f=None):
        fname = name or f.__name__
        full_name = fname if fname.startswith(prefix) else prefix + fname
        dev = device if device is not None else f
        if dev is not None:
            expression_namespace[full_name] = dev
        if host is not None:
            expression_namespace_host[full_name] = host
        if on_expression:
            entry = (scope, fname[len(prefix):] if scope and fname.startswith(prefix)
                     else fname, full_name, as_property)
            _expression_methods.append(entry)
            _try_install(*entry)
        return f if f is not None else dev

    return wrapper


def has_function(name: str) -> bool:
    return name in expression_namespace or name in expression_namespace_host


def is_device_function(name: str) -> bool:
    return name in expression_namespace


def function_names():
    """Every registered name, device and host."""
    return set(expression_namespace) | set(expression_namespace_host)


def _try_install(scope, short_name, full_name, as_property):
    from . import expression as _expr_mod
    Expression = getattr(_expr_mod, "Expression", None)
    if Expression is None:  # expression.py installs the pending ones itself
        return

    def method(self, *args, **kwargs):
        return self._call_function(full_name, *args, **kwargs)
    method.__name__ = short_name
    method.registered = True
    if scope:
        accessor = _expr_mod.get_scope_accessor(scope)
        setattr(accessor, short_name,
                property(lambda acc: method(acc.expression)) if as_property else
                (lambda acc, *a, **kw: method(acc.expression, *a, **kw)))
        return
    own = Expression.__dict__.get(short_name)
    if own is not None and not getattr(own, "registered", False):
        return
    setattr(Expression, short_name, property(method) if as_property else method)


def install_all_on_expression():
    """Called once by expression.py after the Expression class exists."""
    for entry in _expression_methods:
        _try_install(*entry)
