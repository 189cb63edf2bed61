"""Arrow struct columns: ``struct_get`` / ``struct_project`` and the
``expr.struct`` accessor (vaex_tpu/struct.py).

Struct columns stay arrow data on the host: both functions are host-only,
so an expression that calls them runs in the host stage of a pass, and a
numeric field it reads is copied to the pass device from there.
"""

from __future__ import annotations

import numpy as np

from .registry import register_function


def _struct_get_host(x, field):
    if hasattr(x, "combine_chunks"):  # a pyarrow ChunkedArray
        x = x.combine_chunks()
    if isinstance(field, (int, np.integer)):
        return x.field(int(field))
    return x.field(str(field))


register_function(name="struct_get", host=_struct_get_host)(None)


def _struct_project_host(x, fields):
    import pyarrow as pa
    if isinstance(x, pa.ChunkedArray):
        x = x.combine_chunks()
    arrays = [x.field(str(f)) for f in fields]
    return pa.StructArray.from_arrays(arrays, names=[str(f) for f in fields])


register_function(name="struct_project", host=_struct_project_host)(None)


class StructOperations:
    """``expr.struct`` accessor."""

    def __init__(self, expression):
        self.expression = expression

    def get(self, field):
        from .expression import Expression
        df = self.expression.df
        lit = repr(field) if isinstance(field, str) else int(field)
        return Expression(df, f"struct_get({self.expression.expression}, {lit})")

    def __getitem__(self, field):
        return self.get(field)

    def project(self, fields):
        from .expression import Expression
        df = self.expression.df
        lits = "[" + ", ".join(repr(str(f)) for f in fields) + "]"
        return Expression(df, f"struct_project({self.expression.expression}, {lits})")

    def keys(self):
        dt = self.expression.dtype
        return [f.name for f in dt.internal]

    def values(self):
        return [self.get(name) for name in self.keys()]

    def items(self):
        return list(zip(self.keys(), self.values()))

    def __len__(self):
        return len(self.keys())


def install():
    from .expression import Expression
    Expression.struct = property(lambda self: StructOperations(self))


install()
