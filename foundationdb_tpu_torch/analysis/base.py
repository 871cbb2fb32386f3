"""Shared AST plumbing for flowlint rules."""

import ast
from collections import namedtuple

# rule: "FL001"… | path: module-relative ("server/batcher.py") |
# line: 1-based | message: stable text (baseline keys use it, so it must
# not embed line numbers — entries survive unrelated edits above them)
Finding = namedtuple("Finding", ["rule", "path", "line", "message"])


def dotted_name(node):
    """``a.b.c`` for a Name/Attribute chain, else None (calls,
    subscripts, literals in the chain defeat static naming)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def terminal_name(func):
    """The last component of a call target: ``self.x.foo()`` → "foo",
    ``bar()`` → "bar"."""
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def build_parents(tree):
    """child node → parent node, for ancestor walks."""
    parents = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    return parents


def ancestors(node, parents):
    while node in parents:
        node = parents[node]
        yield node


def functions(tree):
    """Every (Async)FunctionDef in the module, nested included."""
    return [
        n for n in ast.walk(tree)
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    ]


def statements_in(func):
    """The function's statements (nested blocks flattened), in source
    order, excluding statements of functions nested inside it."""
    nested = set()
    for n in ast.walk(func):
        if n is not func and isinstance(
            n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
        ):
            for sub in ast.walk(n):
                nested.add(sub)
    stmts = [
        n for n in ast.walk(func)
        if isinstance(n, ast.stmt) and n is not func and n not in nested
    ]
    stmts.sort(key=lambda n: (n.lineno, n.col_offset))
    return stmts


def mentions_name(node, root):
    """Whether ``root`` (a bare name) is referenced anywhere in node."""
    return any(
        isinstance(n, ast.Name) and n.id == root for n in ast.walk(node)
    )


def calls_in(node):
    return [n for n in ast.walk(node) if isinstance(n, ast.Call)]


def constant_ge(node, threshold):
    return isinstance(node, ast.Constant) and isinstance(
        node.value, (int, float)
    ) and node.value >= threshold
