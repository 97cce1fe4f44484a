"""Small shared AST helpers for lint rules (one place, not re-grown
per rule the way the four original test walkers each did)."""

from __future__ import annotations

import ast

__all__ = ["enclosing_map", "root_name", "call_name"]


def enclosing_map(tree):
    """lineno -> innermost enclosing function qualname (span-based)."""
    spans = []

    def visit(node, qual):
        for child in ast.iter_child_nodes(node):
            q = qual
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                q = f"{qual}.{child.name}" if qual else child.name
                if not isinstance(child, ast.ClassDef):
                    spans.append((child.lineno, child.end_lineno, q))
            visit(child, q)

    visit(tree, "")

    def lookup(lineno):
        best = None
        for a, b, q in spans:
            if a <= lineno <= (b or a):
                if best is None or a >= best[0]:
                    best = (a, q)
        return best[1] if best else ""

    return lookup


def root_name(expr) -> str | None:
    """Leftmost Name a value/call chain hangs off: jnp.max(x).item()
    -> 'jnp'; np.asarray(v) -> 'np'; foo -> 'foo'."""
    while True:
        if isinstance(expr, ast.Name):
            return expr.id
        if isinstance(expr, ast.Attribute):
            expr = expr.value
        elif isinstance(expr, ast.Call):
            expr = expr.func
        elif isinstance(expr, ast.Subscript):
            expr = expr.value
        else:
            return None


def call_name(call: ast.Call) -> str | None:
    """Terminal name of the callee: SQLError(...) / errors.SQLError(...)
    both -> 'SQLError'."""
    fn = call.func
    if isinstance(fn, ast.Name):
        return fn.id
    if isinstance(fn, ast.Attribute):
        return fn.attr
    return None
