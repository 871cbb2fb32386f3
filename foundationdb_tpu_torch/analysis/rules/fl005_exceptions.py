"""FL005 — exception hygiene: drain/transport loops must not eat
errors silently.

Ref rationale: FoundationDB's long-lived server actors wrap their loops
in handlers that TraceEvent(SevError) and re-throw or degrade loudly
(see the ``loop choose`` + ``TraceEvent(SevError, ...)`` pattern across
fdbserver/*.actor.cpp); the trace files ARE the forensics when a role
misbehaves. A Python ``except Exception: pass`` inside a batcher drain
loop or an RPC serve loop converts a recurring failure into silence —
the process looks alive while every request quietly dies.

The rule (modules under ``server/`` and ``rpc/``): a blanket handler —
bare ``except:``, ``except Exception``, or ``except BaseException``
(alone or in a tuple) — that sits lexically inside a ``for``/``while``
loop must either re-raise or emit an error-severity ``TraceEvent``
(``severity=SEV_ERROR`` / ``severity>=40`` / the fluent ``.error(exc)``
form). Typed handlers (``except ConnectionLost:``) are exempt: naming
the exception is the author proving they expected it.
"""

import ast

from foundationdb_tpu_torch.analysis.base import (
    Finding,
    ancestors,
    build_parents,
    constant_ge,
    terminal_name,
)

RULE = "FL005"
TITLE = "exception hygiene: loops must re-raise or SEV_ERROR-trace"

SCOPES = ("server/", "rpc/")
BLANKET = {"Exception", "BaseException"}
SEV_ERROR = 40


def applies(relpath):
    return relpath.startswith(SCOPES)


def _is_blanket(handler):
    if handler.type is None:
        return True
    types = handler.type.elts if isinstance(
        handler.type, ast.Tuple
    ) else [handler.type]
    return any(
        isinstance(t, ast.Name) and t.id in BLANKET for t in types
    )


def _sev_error_trace(body):
    """An error-severity TraceEvent (or fluent .error(...)) in body."""
    for node in (n for s in body for n in ast.walk(s)):
        if not isinstance(node, ast.Call):
            continue
        t = terminal_name(node.func)
        if t == "error" and isinstance(node.func, ast.Attribute):
            return True  # TraceEvent(...).error(exc) escalates to 40
        if t != "TraceEvent":
            continue
        for kw in node.keywords:
            if kw.arg != "severity":
                continue
            v = kw.value
            if constant_ge(v, SEV_ERROR):
                return True
            if isinstance(v, ast.Name) and v.id == "SEV_ERROR":
                return True
            if isinstance(v, ast.Attribute) and v.attr == "SEV_ERROR":
                return True
    return False


def _reraises(body):
    return any(
        isinstance(n, ast.Raise)
        for s in body for n in ast.walk(s)
    )


def check(tree, relpath):
    parents = build_parents(tree)
    for node in ast.walk(tree):
        if not isinstance(node, ast.ExceptHandler) or not _is_blanket(
            node
        ):
            continue
        in_loop = False
        for anc in ancestors(node, parents):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                break  # lexical scope ends at the enclosing function
            if isinstance(anc, (ast.For, ast.While)):
                in_loop = True
                break
        if not in_loop:
            continue
        if _reraises(node.body) or _sev_error_trace(node.body):
            continue
        label = "bare except" if node.type is None else \
            f"except {ast.unparse(node.type)}"
        yield Finding(
            RULE, relpath, node.lineno,
            f"blanket `{label}` inside a loop swallows errors — "
            "re-raise or emit TraceEvent(severity=SEV_ERROR) with the "
            "exception type",
        )
