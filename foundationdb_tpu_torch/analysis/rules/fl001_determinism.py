"""FL001 — sim-determinism: no ambient entropy or wall clock in
cluster-visible code.

Ref rationale: FoundationDB's deterministic simulation only holds
because every observable source of nondeterminism flows through
``deterministicRandom()`` / ``g_network->now()`` (flow/IRandom.h,
fdbrpc/sim2.actor.cpp), which the simulator seeds. A single stray
``time.time()`` or ``random.random()`` makes a failing seed
unreplayable — the 3am repro the whole methodology exists to avoid.

Flagged calls (outside ``sim/``, ``analysis/``, and the sanctioned seam
``core/deterministic.py``):

- ``time.time()`` / ``time.time_ns()`` — wall clock; take an injected
  clock (``core.deterministic.now`` or a ``clock=`` parameter).
- ``datetime.now()`` / ``datetime.utcnow()`` — same.
- ``os.urandom()`` / ``uuid.uuid4()`` / ``secrets.*`` — OS entropy; use
  ``core.deterministic.token_bytes``/``rng``. Genuinely cryptographic
  sites (auth nonces) stay on ``os.urandom`` with an inline
  ``# flowlint: disable=FL001`` and a stated reason.
- module-level ``random.*`` — the shared global stream cannot be seeded
  per-cluster; draw from ``core.deterministic.rng(name)``.
- ``random.Random()`` with no seed argument — OS-entropy seeded.
- ``from random import …`` — aliases module-level draws past the rule.

``time.monotonic`` / ``perf_counter`` / ``sleep`` are NOT flagged: they
feed timeouts and metrics, not cluster-visible state.

Manual-backoff extension: a loop that ``time.sleep``-s a delay it
grows by multiplication IS flagged — that's a hand-rolled retry
backoff bypassing ``utils/backoff.py``'s seam, so its schedule is
unjittered (retrying fleets re-arrive in lockstep) and off the seeded
``"backoff-jitter"`` stream (same-seed sims diverge). Route it
through :class:`~foundationdb_tpu_torch.utils.backoff.Backoff`.
"""

import ast

from foundationdb_tpu_torch.analysis.base import Finding, dotted_name

RULE = "FL001"
TITLE = "sim-determinism: inject clocks and RNGs in cluster-visible code"

BANNED_CALLS = {
    "time.time": "wall clock",
    "time.time_ns": "wall clock",
    "datetime.now": "wall clock",
    "datetime.utcnow": "wall clock",
    "datetime.datetime.now": "wall clock",
    "datetime.datetime.utcnow": "wall clock",
    "os.urandom": "OS entropy",
    "uuid.uuid4": "OS entropy",
    "uuid.uuid1": "OS entropy + wall clock",
    "secrets.token_bytes": "OS entropy",
    "secrets.token_hex": "OS entropy",
    "secrets.randbits": "OS entropy",
}

EXEMPT_DIRS = ("sim/", "analysis/")
# deterministic.py: the clock/RNG seam. backoff.py: the backoff seam —
# its sleep() IS the sanctioned grown-delay sleep the extension hunts.
EXEMPT_FILES = {"core/deterministic.py", "utils/backoff.py"}


def applies(relpath):
    return (
        not relpath.startswith(EXEMPT_DIRS)
        and relpath not in EXEMPT_FILES
    )


def _dotted_refs(expr):
    """Every statically-nameable Name/Attribute chain inside expr."""
    out = set()
    for n in ast.walk(expr):
        if isinstance(n, (ast.Name, ast.Attribute)):
            d = dotted_name(n)
            if d is not None:
                out.add(d)
    return out


def _grown_delay_names(loop):
    """Names a loop body grows multiplicatively: ``d *= 2`` or
    ``d = min(cap, d * 2)`` — the hand-rolled backoff schedule."""
    grown = set()
    for node in ast.walk(loop):
        if isinstance(node, ast.AugAssign) and isinstance(
            node.op, (ast.Mult, ast.Pow)
        ):
            d = dotted_name(node.target)
            if d is not None:
                grown.add(d)
        elif isinstance(node, ast.Assign) and len(node.targets) == 1:
            d = dotted_name(node.targets[0])
            if d is None:
                continue
            has_mult = any(
                isinstance(b, ast.BinOp)
                and isinstance(b.op, (ast.Mult, ast.Pow))
                for b in ast.walk(node.value)
            )
            if has_mult and d in _dotted_refs(node.value):
                grown.add(d)
    return grown


def _manual_backoff_findings(tree, relpath):
    for loop in ast.walk(tree):
        if not isinstance(loop, (ast.While, ast.For)):
            continue
        grown = _grown_delay_names(loop)
        if not grown:
            continue
        for node in ast.walk(loop):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            if dotted_name(node.func) != "time.sleep":
                continue
            slept = _dotted_refs(node.args[0])
            hit = sorted(slept & grown)
            if hit:
                yield Finding(
                    RULE, relpath, node.lineno,
                    f"manual backoff: loop sleeps '{hit[0]}' and grows "
                    "it multiplicatively — route retry delays through "
                    "utils.backoff.Backoff (jittered off the seeded "
                    "'backoff-jitter' stream; resets on success)",
                )


def check(tree, relpath):
    yield from _manual_backoff_findings(tree, relpath)
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module == "random":
            yield Finding(
                RULE, relpath, node.lineno,
                "from-import of random aliases the global stream past "
                "the determinism seam; import core.deterministic and "
                "draw from a named stream",
            )
            continue
        if not isinstance(node, ast.Call):
            continue
        d = dotted_name(node.func)
        if d is None:
            continue
        if d in BANNED_CALLS:
            yield Finding(
                RULE, relpath, node.lineno,
                f"{d}() is {BANNED_CALLS[d]} — cluster-visible code "
                "must use the injected clock/RNG "
                "(core.deterministic) so a sim seed replays",
            )
        elif d in ("random.Random", "random.SystemRandom"):
            if not node.args and not node.keywords:
                yield Finding(
                    RULE, relpath, node.lineno,
                    f"unseeded {d}() draws from OS entropy — use "
                    "core.deterministic.rng(name) or pass a seed",
                )
        elif d.startswith("random."):
            yield Finding(
                RULE, relpath, node.lineno,
                f"module-level {d}() uses the unseedable global "
                "stream — draw from core.deterministic.rng(name)",
            )
