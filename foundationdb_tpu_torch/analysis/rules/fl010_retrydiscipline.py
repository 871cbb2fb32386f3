"""FL010: retry/backoff discipline — FDBError retry loops must decide,
back off through the seam, and never blind-resubmit 1021.

Ref rationale: the reference's retry protocol is ONE function —
``Transaction::onError`` — and everything about it is deliberate: it
consults the error predicate (retryable? maybe-committed?), it backs
off through the client's jittered schedule, and ``commit_unknown_
result`` (1021) is only safe to resubmit because idempotency ids let
the proxy dedupe the second apply. A hand-rolled Python retry loop can
silently drop all three properties; this rule checks them on the
shared ProgramModel.

A *retry loop* is a ``while`` loop (or ``for ... in range(...)``
attempt loop) containing an ``except FDBError`` handler — alone or in
a tuple — that can reach the next iteration (some path falls through
or ``continue``s). Loops over collections (``for fut in pending:``)
are per-item dispatch, not retries of one operation, and are exempt.
Three checks per retry handler:

* **Decide retryability.** The handler must consult
  ``.is_retryable``/``.is_maybe_committed``, compare ``.code``, or
  route through ``on_error`` (the sanctioned gate). A handler that
  instead PROPAGATES the exception object (``out[i] = e``,
  ``fut.set_exception(e)``) is exempt — the error isn't swallowed,
  it's delivered.
* **1021 is not a plain resubmit.** If the loop commits (a
  ``commit``/``commit_batch`` call) and the handler can loop again,
  the handler must treat ``commit_unknown_result`` explicitly (a 1021
  / ``is_maybe_committed`` branch), use ``on_error``, or have an
  idempotency id in scope in the enclosing function — otherwise a
  maybe-committed transaction is resubmitted blind: the silent
  double-apply the reference's IdempotencyId machinery exists to
  prevent.
* **Back off through the seam — inter-procedurally.** FL001
  flags a loop that grows a delay multiplicatively and
  ``time.sleep``-s it in the SAME function. This rule promotes the
  heuristic across calls, rooted at the loop (thread entries and all
  other functions alike): a retry loop that grows a delay and passes
  it to a tree callee that sleeps it — or calls a helper that grows
  and sleeps its own delay parameter — is the same hand-rolled
  backoff, split across a call boundary. Route it through
  ``utils.backoff.Backoff`` (jittered off the seeded
  ``"backoff-jitter"`` stream; resets on success).

``analysis/`` is exempt (it reasons about errors, it never retries
them); ``utils/backoff.py`` is the seam itself.
"""

import ast

from foundationdb_tpu_torch.analysis.base import Finding, dotted_name
from foundationdb_tpu_torch.analysis.rules.fl001_determinism import (
    _dotted_refs,
    _grown_delay_names,
)

RULE = "FL010"
TITLE = "retry discipline: decide, back off through the seam, guard 1021"
PROGRAM = True

EXEMPT_DIRS = ("analysis/",)
EXEMPT_FILES = frozenset({"utils/backoff.py"})

COMMIT_CALLS = frozenset({"commit", "commit_batch"})


def applies(relpath):
    return True


def _exempt(relpath):
    return relpath.startswith(EXEMPT_DIRS) or relpath in EXEMPT_FILES


def _catches_fdberror(handler):
    if handler.type is None:
        return False  # FL005's territory
    types = handler.type.elts if isinstance(handler.type, ast.Tuple) \
        else [handler.type]
    for t in types:
        name = dotted_name(t)
        if name is not None and name.rsplit(".", 1)[-1] == "FDBError":
            return True
    return False


def _is_retry_loop(loop):
    if isinstance(loop, ast.While):
        return True
    if isinstance(loop, ast.For) and isinstance(loop.iter, ast.Call):
        fn = loop.iter.func
        return isinstance(fn, ast.Name) and fn.id == "range"
    return False


def _outcome(stmts):
    """(may_fall_through, may_continue) for a statement sequence —
    whether control can run off the end, and whether a ``continue``
    (to the enclosing loop) is reachable. Conservative: try/loop
    bodies are assumed able to fall through."""
    may_continue = False
    for st in stmts:
        if isinstance(st, ast.Continue):
            return False, True
        if isinstance(st, (ast.Break, ast.Return, ast.Raise)):
            return False, may_continue
        if isinstance(st, ast.If):
            f1, c1 = _outcome(st.body)
            f2, c2 = _outcome(st.orelse)
            may_continue = may_continue or c1 or c2
            if not (f1 or f2):
                return False, may_continue
    return True, may_continue


def _can_reach_next_iteration(handler):
    fall, cont = _outcome(handler.body)
    return fall or cont


def _walk_no_defs(node):
    """Walk a statement body, not descending into nested defs."""
    stack = list(node) if isinstance(node, list) else [node]
    while stack:
        n = stack.pop()
        yield n
        for child in ast.iter_child_nodes(n):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda, ast.ClassDef)):
                continue
            stack.append(child)


def _handler_parents(handler):
    parents = {}
    for st in handler.body:
        for n in ast.walk(st):
            for child in ast.iter_child_nodes(n):
                parents[child] = n
    return parents


def _discriminates(handler):
    """The handler decides retryability: predicate properties, a .code
    comparison, a maybe-committed membership test, or on_error."""
    for n in _walk_no_defs(handler.body):
        if isinstance(n, ast.Attribute) and n.attr in (
                "is_retryable", "is_maybe_committed"):
            return True
        if isinstance(n, ast.Compare):
            for sub in ast.walk(n):
                if isinstance(sub, ast.Attribute) and sub.attr == "code":
                    return True
                if isinstance(sub, ast.Name) and sub.id in (
                        "RETRYABLE", "MAYBE_COMMITTED"):
                    return True
        if isinstance(n, ast.Call):
            fn = n.func
            t = fn.attr if isinstance(fn, ast.Attribute) else (
                fn.id if isinstance(fn, ast.Name) else None)
            if t == "on_error":
                return True
    return False


def _propagates(handler):
    """The bound exception object escapes as a VALUE (stored, passed,
    returned) rather than being interrogated — delivery, not a
    swallow. Attribute reads (e.code) don't count."""
    if handler.name is None:
        return False
    parents = _handler_parents(handler)
    for n in _walk_no_defs(handler.body):
        if isinstance(n, ast.Name) and n.id == handler.name and \
                isinstance(n.ctx, ast.Load):
            p = parents.get(n)
            if not isinstance(p, ast.Attribute):
                return True
    return False


def _mentions_1021(handler):
    for n in _walk_no_defs(handler.body):
        if isinstance(n, ast.Constant) and n.value == 1021:
            return True
        if isinstance(n, ast.Constant) and \
                n.value == "commit_unknown_result":
            return True
        if isinstance(n, ast.Attribute) and \
                n.attr == "is_maybe_committed":
            return True
        if isinstance(n, ast.Name) and n.id == "MAYBE_COMMITTED":
            return True
        if isinstance(n, ast.Call):
            fn = n.func
            t = fn.attr if isinstance(fn, ast.Attribute) else (
                fn.id if isinstance(fn, ast.Name) else None)
            if t == "on_error":
                return True
    return False


def _loop_commits(loop):
    for n in _walk_no_defs(loop.body):
        if isinstance(n, ast.Call):
            fn = n.func
            t = fn.attr if isinstance(fn, ast.Attribute) else (
                fn.id if isinstance(fn, ast.Name) else None)
            if t in COMMIT_CALLS:
                return True
    return False


def _idempotency_in_scope(func):
    """Any idempotency token in the enclosing function: an attribute /
    name / option call / string mentioning it is the author recording
    that resubmits dedupe server-side."""
    for n in ast.walk(func):
        if isinstance(n, ast.Attribute) and "idempoten" in n.attr:
            return True
        if isinstance(n, ast.Name) and "idempoten" in n.id:
            return True
        if isinstance(n, ast.Constant) and isinstance(n.value, str) \
                and "idempoten" in n.value:
            return True
    return False


# ── inter-procedural backoff summaries ──
class _FnSummary:
    __slots__ = ("params", "sleep_params", "grown")

    def __init__(self, node):
        a = node.args
        self.params = [p.arg for p in
                       a.posonlyargs + a.args + a.kwonlyargs]
        self.grown = _grown_delay_names(node)
        self.sleep_params = set()
        pset = set(self.params)
        for n in _walk_no_defs(node.body):
            if isinstance(n, ast.Call) and n.args and \
                    dotted_name(n.func) == "time.sleep":
                self.sleep_params |= _dotted_refs(n.args[0]) & pset


def _iter_functions(model):
    for fm in model.files.values():
        if fm.tree is None or _exempt(fm.relpath):
            continue
        for cm in fm.classes.values():
            for node in cm.methods.values():
                yield fm, cm, node
        for node in fm.module_funcs.values():
            yield fm, None, node


def _resolve_call(model, fm, cm, call):
    """(label, funcnode) for a call resolvable to ONE tree function:
    bare same-file / globally-unique names, self.m through the class,
    mod.f through an import binding. Ambiguity resolves nowhere."""
    fn = call.func
    if isinstance(fn, ast.Name):
        if fn.id in fm.module_funcs:
            return fn.id, fm.module_funcs[fn.id]
        hits = model.func_index.get(fn.id, [])
        if len(hits) == 1:
            return fn.id, hits[0][1]
        return None
    if not isinstance(fn, ast.Attribute):
        return None
    base = fn.value
    if isinstance(base, ast.Name) and base.id == "self" and \
            cm is not None:
        hit = model.lookup_method(cm, fn.attr)
        if hit is not None:
            return f"self.{fn.attr}", hit[1]
        return None
    if isinstance(base, ast.Name) and base.id in fm.import_files:
        rp = fm.import_files[base.id]
        f2 = model.files.get(rp) if rp else None
        if f2 is not None and fn.attr in f2.module_funcs:
            return f"{base.id}.{fn.attr}", f2.module_funcs[fn.attr]
    return None


def _map_args(call, summary, is_method):
    """[(param_name, arg_expr)] pairing this call's arguments with the
    callee's parameters."""
    params = summary.params[1:] if is_method and summary.params else \
        summary.params
    out = []
    for i, arg in enumerate(call.args):
        if isinstance(arg, ast.Starred):
            break
        if i < len(params):
            out.append((params[i], arg))
    for kw in call.keywords:
        if kw.arg is not None and kw.arg in summary.params:
            out.append((kw.arg, kw.value))
    return out


def check_model(model):
    summaries = {}
    for fm, cm, node in _iter_functions(model):
        summaries[node] = _FnSummary(node)

    for fm, cm, func in _iter_functions(model):
        relpath = fm.relpath
        # handlers belong to their nearest enclosing loop, lexically,
        # within this function (nested defs iterate on their own)
        for loop in _walk_no_defs(func.body):
            if not isinstance(loop, (ast.While, ast.For)) or \
                    not _is_retry_loop(loop):
                continue
            handlers = [
                n for n in _walk_no_defs(loop.body)
                if isinstance(n, ast.ExceptHandler)
                and _catches_fdberror(n)
            ]
            retrying = [h for h in handlers
                        if _can_reach_next_iteration(h)]
            if not retrying:
                continue
            for h in retrying:
                if not _discriminates(h) and not _propagates(h):
                    yield Finding(
                        RULE, relpath, h.lineno,
                        "FDBError retry loop swallows the error "
                        "without deciding retryability — consult "
                        "e.is_retryable / compare e.code (or route "
                        "through Transaction.on_error); a "
                        "non-retryable code looping here spins "
                        "forever")
                if _loop_commits(loop) and not _mentions_1021(h) and \
                        not _propagates(h) and \
                        not _idempotency_in_scope(func):
                    yield Finding(
                        RULE, relpath, h.lineno,
                        "commit retry loop resubmits on "
                        "commit_unknown_result (1021) with no "
                        "idempotency id in scope — a maybe-committed "
                        "transaction applied twice is silent data "
                        "corruption; branch on e.code == 1021 / "
                        "e.is_maybe_committed, use on_error, or set "
                        "an idempotency id")
            # inter-procedural manual backoff: delay grown here, slept
            # in a callee (or grown AND slept by the callee)
            grown = _grown_delay_names(loop)
            for n in _walk_no_defs(loop.body):
                if not isinstance(n, ast.Call):
                    continue
                hit = _resolve_call(model, fm, cm, n)
                if hit is None:
                    continue
                label, callee = hit
                summary = summaries.get(callee)
                if summary is None or not summary.sleep_params:
                    continue
                is_method = label.startswith("self.")
                for param, argexpr in _map_args(n, summary, is_method):
                    if param not in summary.sleep_params:
                        continue
                    if _dotted_refs(argexpr) & grown:
                        yield Finding(
                            RULE, relpath, n.lineno,
                            f"manual backoff across a call: the retry "
                            f"delay grown in this loop is slept by "
                            f"'{label}' — route it through "
                            f"utils.backoff.Backoff (jittered off the "
                            f"seeded 'backoff-jitter' stream)")
                        break
                    if param in summary.grown:
                        yield Finding(
                            RULE, relpath, n.lineno,
                            f"manual backoff across a call: '{label}' "
                            f"grows and sleeps its delay parameter "
                            f"'{param}' for this retry loop — route "
                            f"it through utils.backoff.Backoff")
                        break


def check(tree, relpath):  # pragma: no cover - program rule
    return iter(())
