"""FL003 — lock discipline: no blocking call inside a ``with <lock>``
body.

Ref rationale: flow actors never block a thread while holding shared
state — waits are actor suspensions, and the actor compiler makes a
blocking syscall under a "lock" (there are none) unrepresentable. In
the thread-mode pipeline, a blocking call under a mutex is a latent
convoy or deadlock: the commit mutex held across a socket send, a
``ResolveHandle`` sync, or another object's condition wait serializes
the fleet behind the slowest peer (and wedges it outright if the waited
event needs the same lock to fire).

The rule: inside the body of a ``with`` whose context expression names
a lock (its last path component contains ``lock``, ``mu``, ``mutex``,
``cond``, or ``cv``), flag:

- ``.wait()`` / ``.wait_for()`` / ``.result()`` / ``.join()`` /
  ``.acquire()`` on any object OTHER than the with-subject itself —
  ``with cond: cond.wait_for(...)`` is the sanctioned condition-variable
  idiom (the wait releases the lock it holds); waiting on a *different*
  object does not release this one.
- socket ops: ``.recv()`` / ``.accept()`` / ``.sendall()`` / ``.send()``
  / ``.connect()``.
- ``time.sleep(...)``.
- ``resolve_many(...)`` without ``lazy=True`` — a synchronous device
  round trip under a host lock.

Locks that exist precisely to serialize a blocking operation (the
transport's per-socket send lock) carry an inline
``# flowlint: disable=FL003`` with the reason.
"""

import ast

from foundationdb_tpu_torch.analysis.base import (
    Finding,
    dotted_name,
    terminal_name,
)

RULE = "FL003"
TITLE = "lock discipline: no blocking calls under a held lock"

LOCK_MARKERS = {"lock", "rlock", "mutex", "mu", "cond", "cv", "wake"}
BLOCKING_ATTRS = {
    "wait", "wait_for", "result", "join", "acquire",
    "recv", "recv_into", "accept", "sendall", "send", "connect",
}


def applies(relpath):
    return True


def _lock_subjects(with_node):
    """Dotted names of with-items that look like locks."""
    subjects = []
    for item in with_node.items:
        d = dotted_name(item.context_expr)
        if d is None:
            continue
        last = d.split(".")[-1].lower()
        tokens = [t for t in last.split("_") if t]
        if any(t in LOCK_MARKERS for t in tokens) or any(
            last.endswith(m) for m in ("lock", "cond", "mutex")
        ):
            subjects.append(d)
            if item.optional_vars is not None:
                alias = dotted_name(item.optional_vars)
                if alias:
                    subjects.append(alias)
    return subjects


def check(tree, relpath):
    for node in ast.walk(tree):
        if not isinstance(node, ast.With):
            continue
        subjects = _lock_subjects(node)
        if not subjects:
            continue
        for call in (
            c for s in node.body for c in ast.walk(s)
            if isinstance(c, ast.Call)
        ):
            d = dotted_name(call.func)
            if d == "time.sleep":
                yield Finding(
                    RULE, relpath, call.lineno,
                    f"time.sleep under held lock "
                    f"{' / '.join(subjects)}",
                )
                continue
            t = terminal_name(call.func)
            if t == "resolve_many":
                lazy = any(
                    kw.arg == "lazy" and isinstance(
                        kw.value, ast.Constant
                    ) and kw.value.value
                    for kw in call.keywords
                )
                if not lazy:
                    yield Finding(
                        RULE, relpath, call.lineno,
                        "synchronous resolve_many (no lazy=True) under "
                        f"held lock {' / '.join(subjects)} — a device "
                        "round trip while holding host state",
                    )
                continue
            if not isinstance(call.func, ast.Attribute) \
                    or t not in BLOCKING_ATTRS:
                continue
            recv = dotted_name(call.func.value)
            if recv is not None and recv in subjects:
                continue  # with cond: cond.wait_for(...) — sanctioned
            yield Finding(
                RULE, relpath, call.lineno,
                f"blocking .{t}() on "
                f"{recv or 'a computed object'} inside `with "
                f"{' / '.join(subjects)}` — the wait does not release "
                "this lock",
            )
