"""Expression-string AST tools: validate, print, rename, dependency analysis.

Re-design of the reference's ``vaex/expresso.py`` (636 LoC): expressions are
strings in a whitelisted Python subset, parsed with the stdlib ``ast`` module.
In this engine the expression is ``eval``'d once per tile over torch tensors
(see :mod:`vaex_tpu_torch.scopes`).  Copied from ``vaex_tpu``; the
server holds a request's expressions to :func:`validate_expression` with
``attributes``.
"""

from __future__ import annotations

import ast
import difflib

valid_binary_operators = (
    ast.Add, ast.Sub, ast.Mult, ast.Div, ast.FloorDiv, ast.Mod, ast.Pow,
    ast.BitAnd, ast.BitOr, ast.BitXor, ast.LShift, ast.RShift, ast.MatMult,
)
valid_compare_operators = (ast.Lt, ast.LtE, ast.Gt, ast.GtE, ast.Eq, ast.NotEq,
                           ast.In, ast.NotIn, ast.Is, ast.IsNot)
valid_unary_operators = (ast.USub, ast.UAdd, ast.Invert, ast.Not)
valid_bool_operators = (ast.And, ast.Or)

_valid_nodes = (
    ast.Expression, ast.BinOp, ast.UnaryOp, ast.BoolOp, ast.Compare, ast.Call,
    ast.Name, ast.Constant, ast.Attribute, ast.Subscript, ast.Slice, ast.Index,
    ast.Tuple, ast.List, ast.Dict, ast.Load, ast.Store, ast.keyword, ast.IfExp,
) + valid_binary_operators + valid_compare_operators + valid_unary_operators + valid_bool_operators


def refuse_nodes(tree, expr, attributes=None):
    """Raise ValueError on a node of ``tree`` (parsed from ``expr``) outside
    the language, or, where ``attributes`` is given, on an attribute whose
    name is not in it."""
    for node in ast.walk(tree):
        if not isinstance(node, _valid_nodes):
            raise ValueError(f"invalid node {type(node).__name__!r} in expression {expr!r}")
        if attributes is not None and isinstance(node, ast.Attribute) \
                and node.attr not in attributes:
            raise ValueError(f"attribute {node.attr!r} is not allowed in expression {expr!r}")


def validate_expression(expr: str, variable_set, function_set=(), names=None, attributes=None):
    """Raise on syntax errors, unknown nodes or unknown names, and, where
    ``attributes`` is given, on an attribute not among them.

    Reference: expresso.py:33-149.
    """
    names = names if names is not None else []
    tree = ast.parse(expr, mode="eval")
    refuse_nodes(tree, expr, attributes)
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            func = node.func
            fname = None
            if isinstance(func, ast.Name):
                fname = func.id
            elif isinstance(func, ast.Attribute):
                fname = func.attr
            if fname is not None and fname not in function_set and fname not in variable_set:
                matches = difflib.get_close_matches(fname, list(function_set))
                msg = f"unknown function {fname!r}"
                if matches:
                    msg += f", did you mean {matches[0]!r}?"
                raise NameError(msg)
        elif isinstance(node, ast.Name):
            if node.id not in variable_set and node.id not in function_set:
                matches = difflib.get_close_matches(node.id, list(variable_set))
                msg = f"column or variable {node.id!r} does not exist"
                if matches:
                    msg += f", did you mean {matches[0]!r}?"
                raise NameError(msg)
            names.append(node.id)
    return names


def parse_expression(expr: str) -> ast.expr:
    return ast.parse(expr, mode="eval").body


def node_to_string(node) -> str:
    """AST -> canonical string (reference: expresso.py:328-444 ExpressionString)."""
    return ast.unparse(node)


def collect_names(expr: str):
    """All Name nodes (column/variable dependencies), excluding called function names."""
    tree = ast.parse(expr, mode="eval")
    names = []

    class V(ast.NodeVisitor):
        def visit_Call(self, node):
            for arg in node.args:
                self.visit(arg)
            for kw in node.keywords:
                self.visit(kw.value)
            # the function name itself is not a data dependency, but a called
            # attribute's value is (e.g. df.x.abs())
            if not isinstance(node.func, (ast.Name,)):
                self.visit(node.func)

        def visit_Name(self, node):
            names.append(node.id)

    V().visit(tree)
    return names


def translate(expr: str, translator) -> str:
    """Rename Name nodes via translator(name) -> new name or None (reference: expresso.py:491-538)."""
    tree = ast.parse(expr, mode="eval")

    class T(ast.NodeTransformer):
        def visit_Call(self, node):
            node.args = [self.visit(a) for a in node.args]
            node.keywords = [ast.keyword(arg=k.arg, value=self.visit(k.value)) for k in node.keywords]
            if not isinstance(node.func, ast.Name):
                node.func = self.visit(node.func)
            return node

        def visit_Name(self, node):
            new = translator(node.id)
            if new is not None and new != node.id:
                return ast.copy_location(ast.Name(id=new, ctx=node.ctx), node)
            return node

    new_tree = T().visit(tree)
    return ast.unparse(new_tree)


def substitute(expr: str, replacements: dict) -> str:
    """Replace Name nodes with whole sub-expressions (virtual-column expansion)."""
    tree = ast.parse(expr, mode="eval")

    class S(ast.NodeTransformer):
        def visit_Call(self, node):
            node.args = [self.visit(a) for a in node.args]
            node.keywords = [ast.keyword(arg=k.arg, value=self.visit(k.value)) for k in node.keywords]
            if not isinstance(node.func, ast.Name):
                node.func = self.visit(node.func)
            return node

        def visit_Name(self, node):
            if node.id in replacements:
                sub = ast.parse(replacements[node.id], mode="eval").body
                # wrap in parens implicitly by returning the subtree
                return ast.copy_location(sub, node)
            return node

    new_tree = S().visit(tree)
    return ast.unparse(new_tree)


# -- symbolic differentiation (reference: expresso.py:255-325 Derivative) ----

_DERIVS = {
    "sin": lambda a: f"cos({a})",
    "cos": lambda a: f"-sin({a})",
    "tan": lambda a: f"(1/cos({a})**2)",
    "exp": lambda a: f"exp({a})",
    "log": lambda a: f"(1/({a}))",
    "log10": lambda a: f"(1/(({a})*log(10)))",
    "sqrt": lambda a: f"(1/(2*sqrt({a})))",
    "arcsin": lambda a: f"(1/sqrt(1-({a})**2))",
    "arccos": lambda a: f"(-1/sqrt(1-({a})**2))",
    "arctan": lambda a: f"(1/(1+({a})**2))",
}


def derivative(expr: str, var: str, simplify=True) -> str:
    """d(expr)/d(var) as an expression string.

    Used by error/uncertainty propagation (reference: dataframe.py:3418
    ``propagate_uncertainties`` and expression.py:649 ``Expression.derivative``).
    """
    node = parse_expression(expr)
    out = _derive(node, var)
    return _simplify(out) if simplify else out


def _derive(node, var) -> str:
    if isinstance(node, ast.Name):
        return "1" if node.id == var else "0"
    if isinstance(node, ast.Constant):
        return "0"
    if isinstance(node, ast.UnaryOp):
        inner = _derive(node.operand, var)
        if isinstance(node.op, ast.USub):
            return f"-({inner})"
        if isinstance(node.op, ast.UAdd):
            return f"({inner})"
        raise ValueError(f"cannot differentiate unary op {ast.dump(node.op)}")
    if isinstance(node, ast.BinOp):
        a, b = node_to_string(node.left), node_to_string(node.right)
        da, db = _derive(node.left, var), _derive(node.right, var)
        if isinstance(node.op, ast.Add):
            return f"({da}) + ({db})"
        if isinstance(node.op, ast.Sub):
            return f"({da}) - ({db})"
        if isinstance(node.op, ast.Mult):
            return f"({da}) * ({b}) + ({a}) * ({db})"
        if isinstance(node.op, ast.Div):
            return f"(({da}) * ({b}) - ({a}) * ({db})) / ({b})**2"
        if isinstance(node.op, ast.Pow):
            if db.strip() == "0":  # a**const
                return f"({b}) * ({a})**(({b})-1) * ({da})"
            return f"({a})**({b}) * (({db}) * log({a}) + ({b}) * ({da}) / ({a}))"
        raise ValueError(f"cannot differentiate binary op {ast.dump(node.op)}")
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
        fname = node.func.id
        if fname not in _DERIVS or len(node.args) != 1:
            raise ValueError(f"cannot differentiate call to {fname!r}")
        a = node_to_string(node.args[0])
        da = _derive(node.args[0], var)
        return f"{_DERIVS[fname](a)} * ({da})"
    raise ValueError(f"cannot differentiate node {ast.dump(node)}")


def _simplify(expr: str) -> str:
    """Constant-fold trivial 0/1 algebra (reference: expresso.py:446-488)."""

    class Simplify(ast.NodeTransformer):
        def visit_BinOp(self, node):
            node = self.generic_visit(node)

            def is_num(n, v):
                return isinstance(n, ast.Constant) and n.value == v

            # constant folding: (3 - 1) -> 2
            if (isinstance(node.left, ast.Constant) and isinstance(node.right, ast.Constant)
                    and isinstance(node.left.value, (int, float))
                    and isinstance(node.right.value, (int, float))):
                import operator
                ops = {ast.Add: operator.add, ast.Sub: operator.sub,
                       ast.Mult: operator.mul, ast.Pow: operator.pow}
                op = ops.get(type(node.op))
                if op is not None:
                    try:
                        return ast.Constant(op(node.left.value, node.right.value))
                    except Exception:
                        pass

            if isinstance(node.op, ast.Mult):
                if is_num(node.left, 0) or is_num(node.right, 0):
                    return ast.Constant(0)
                if is_num(node.left, 1):
                    return node.right
                if is_num(node.right, 1):
                    return node.left
            if isinstance(node.op, ast.Add):
                if is_num(node.left, 0):
                    return node.right
                if is_num(node.right, 0):
                    return node.left
            if isinstance(node.op, ast.Sub):
                if is_num(node.right, 0):
                    return node.left
            if isinstance(node.op, ast.Pow):
                if is_num(node.right, 1):
                    return node.left
                if is_num(node.right, 0):
                    return ast.Constant(1)
            return node

        def visit_UnaryOp(self, node):
            node = self.generic_visit(node)
            if isinstance(node.op, ast.USub) and isinstance(node.operand, ast.Constant) \
                    and node.operand.value == 0:
                return ast.Constant(0)
            return node

    tree = ast.parse(expr, mode="eval")
    prev = None
    while prev != ast.dump(tree):
        prev = ast.dump(tree)
        tree = ast.fix_missing_locations(Simplify().visit(tree))
    return ast.unparse(tree)
