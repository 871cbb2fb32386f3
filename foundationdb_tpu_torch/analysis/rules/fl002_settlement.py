"""FL002 — future settlement: an acquired future must be settled or
handed off on every exception path.

Ref rationale: the actor compiler statically guarantees a Promise is
either fulfilled or broken when its holder dies (flow/flow.h — a
dropped Promise sends broken_promise to every waiter). Our
``CommitFuture`` / ``ResolveHandle`` — and the async read path's
``FutureValue`` / ``FutureRange`` (txn/futures.py) — have no such
backstop: a future
constructed and then orphaned by an exception leaves a client blocked
forever, and an unconsumed pipeline group leaves the fleet's
VersionGates waiting on a turn no one will take. The batcher's contract —
"every failure path settles all in-flight futures and consumes owed
gate turns" — becomes machine-checked here.

The rule: at each *acquisition site* (a ``CommitFuture(...)`` or
``ResolveHandle(...)`` construction, a ``resolve_many(..., lazy=True)``
dispatch, or a ``commit_batches_begin(...)`` call) bound to a name, the
statements between the acquisition and the first statement that
*settles* the future (``.set`` / ``.set_result`` / ``.set_exception`` /
``.wait``) or *hands it off* (any statement that mentions the bound
name: a return, an argument position, a container append — ownership
transfers with the reference) must not contain a call that can raise,
unless the region is protected by an enclosing ``try`` whose handlers
or ``finally`` settle/hand off the future. An acquisition whose result
is discarded outright is always a finding.

Known-total builtins (``len``, ``isinstance``, ``time.perf_counter``,
…) and calls inside ``raise`` statements do not count as risky.
"""

import ast

from foundationdb_tpu_torch.analysis.base import (
    Finding,
    ancestors,
    build_parents,
    dotted_name,
    functions,
    mentions_name,
    statements_in,
    terminal_name,
)

RULE = "FL002"
TITLE = ("future-settlement: settle CommitFuture/ResolveHandle/"
         "FutureValue/FutureRange on every path")

ACQ_CONSTRUCTORS = {
    "CommitFuture", "ResolveHandle", "FutureValue", "FutureRange",
}
ACQ_METHODS = {"commit_batches_begin"}
SETTLE_ATTRS = {"set", "set_result", "set_exception", "wait", "cancel"}
SAFE_NAME_CALLS = {
    "len", "isinstance", "issubclass", "getattr", "hasattr", "min",
    "max", "sum", "abs", "list", "tuple", "dict", "set", "frozenset",
    "range", "zip", "enumerate", "sorted", "reversed", "repr", "str",
    "bytes", "int", "float", "bool", "id", "type", "format", "round",
}
SAFE_DOTTED_CALLS = {"time.perf_counter", "time.monotonic"}


def applies(relpath):
    return True


def _is_acquisition(call):
    t = terminal_name(call.func)
    if t in ACQ_CONSTRUCTORS or t in ACQ_METHODS:
        return True
    if t == "resolve_many":
        return any(
            kw.arg == "lazy"
            and isinstance(kw.value, ast.Constant) and kw.value.value
            for kw in call.keywords
        )
    return False


def _settles(stmt, token):
    """A ``token.set(...)``-style resolution anywhere in stmt."""
    for call in ast.walk(stmt):
        if not isinstance(call, ast.Call):
            continue
        f = call.func
        if isinstance(f, ast.Attribute) and f.attr in SETTLE_ATTRS:
            recv = dotted_name(f.value)
            if recv is not None and (
                recv == token or recv.startswith(token + ".")
            ):
                return True
    return False


def _risky_calls(stmt):
    """Calls in stmt that may raise: everything except the known-total
    allowlist and calls that only occur inside ``raise`` expressions."""
    in_raise = set()
    for node in ast.walk(stmt):
        if isinstance(node, ast.Raise):
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call):
                    in_raise.add(sub)
    out = []
    for call in ast.walk(stmt):
        if not isinstance(call, ast.Call) or call in in_raise:
            continue
        d = dotted_name(call.func)
        if d in SAFE_DOTTED_CALLS:
            continue
        if isinstance(call.func, ast.Name) and \
                call.func.id in SAFE_NAME_CALLS:
            continue
        out.append(call)
    return out


def _protected(stmt, parents, func, root):
    """stmt sits inside a try (within func) whose except/finally
    settles or hands off the future's root name."""
    for anc in ancestors(stmt, parents):
        if anc is func:
            return False
        if not isinstance(anc, ast.Try):
            continue
        guard_blocks = [h.body for h in anc.handlers]
        if anc.finalbody:
            guard_blocks.append(anc.finalbody)
        for block in guard_blocks:
            for s in block:
                if mentions_name(s, root):
                    return True
    return False


def check(tree, relpath):
    parents = build_parents(tree)
    for func in functions(tree):
        stmts = statements_in(func)
        for idx, stmt in enumerate(stmts):
            acq = None
            token = None
            if isinstance(stmt, ast.Assign) and isinstance(
                stmt.value, ast.Call
            ) and _is_acquisition(stmt.value):
                acq = stmt.value
                token = dotted_name(stmt.targets[0])
            elif isinstance(stmt, ast.Expr) and isinstance(
                stmt.value, ast.Call
            ) and _is_acquisition(stmt.value):
                yield Finding(
                    RULE, relpath, stmt.lineno,
                    f"{terminal_name(stmt.value.func)}(...) result is "
                    "discarded — the future can never be settled",
                )
                continue
            if acq is None or token is None:
                continue
            root = token.split(".")[0]
            finding = None
            handed_off = False
            for later in stmts[idx + 1:]:
                if _settles(later, token) or mentions_name(later, root):
                    handed_off = True
                    break
                risky = _risky_calls(later)
                if risky and not _protected(
                    later, parents, func, root
                ):
                    finding = Finding(
                        RULE, relpath, later.lineno,
                        f"call may raise while {token!r} (acquired via "
                        f"{terminal_name(acq.func)}) is unsettled — "
                        "settle it in an except/finally or hand it off "
                        "first",
                    )
                    break
            if finding is not None:
                yield finding
            elif not handed_off and not _protected(
                stmt, parents, func, root
            ):
                yield Finding(
                    RULE, relpath, stmt.lineno,
                    f"{token!r} (acquired via "
                    f"{terminal_name(acq.func)}) is never settled or "
                    "handed off on this path",
                )
