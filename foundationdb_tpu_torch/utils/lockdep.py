"""Runtime lockdep witness — dynamic lock-order validation.

Ref parity: the Linux kernel's lockdep validator, applied to the role
flow's single-threaded actor model plays in the reference: FDB needs no
lock-order discipline because flow serializes everything onto one
loop; this port multithreads, so the discipline is checked instead.
This module records every ACTUAL acquisition-order edge, from running
code (the static half, the flowlint lock-order rule, is not ported).

Design, mirroring lockdep proper:

* **Classes, not instances.** Edges are keyed by the lock's declared
  name (``"Cluster._recovery_mu"``), so one witness covers every
  instance of a class — the same reduction that keeps lockdep's graph
  finite.
* **Adjacency, not closure.** On acquire, one edge is recorded:
  top-of-stack -> new (re-held names are skipped). Transitive order
  shows as a path, exactly like the static graph's edges.
* **Freeze after convergence.** After ``_FREEZE_AFTER`` consecutive
  acquisitions discover no new edge, per-acquire bookkeeping stops
  entirely — the wrappers check one module flag and forward straight
  to the inner primitive. A steady-state workload pays one global
  read per lock operation.
* **Deterministic witness.** :func:`witness_doc` is canonical (sorted,
  no timestamps, no ids): two same-seed sim runs emit byte-identical
  documents.

Disabled (the default), the factories return plain ``threading``
primitives — zero wrapper cost. Enable with :func:`enable` or the
``FDB_TPU_LOCKDEP=1`` environment variable.
"""

import json
import os
import threading

__all__ = [
    "lock", "rlock", "condition", "enable", "disable", "enabled",
    "reset", "edge_set", "cycle_count", "cycles", "witness_doc",
    "acquisition_count",
]

_FREEZE_AFTER = 10_000

_enabled = os.environ.get("FDB_TPU_LOCKDEP", "") not in ("", "0")

# witness state — _graph_mu guards mutation; reads of _edges ride the
# GIL (dict membership is atomic) for the fast path
_graph_mu = threading.Lock()
_edges = {}    # (a, b) -> True
_cycles = []   # [(a, ..., a)] acquisition paths that closed a cycle
_acquisitions = 0
_quiet_streak = 0   # acquisitions since the last new edge
_frozen = False
_epoch = 0          # bumped by reset(): invalidates every held stack

_tls = threading.local()


def _held():
    # freezing mid-stack skips the matching release notes, so a stack
    # can go stale; reset() bumps the epoch and every thread drops its
    # stale stack lazily on next use (TLS is unreachable cross-thread)
    if getattr(_tls, "epoch", -1) != _epoch:
        _tls.epoch = _epoch
        _tls.stack = []
    return _tls.stack


def enabled():
    return _enabled


def enable():
    """Turn the witness on for locks created FROM NOW ON (existing
    plain primitives stay plain — enable before building the cluster)."""
    global _enabled
    _enabled = True


def disable():
    global _enabled
    _enabled = False


def reset():
    """Drop all recorded state (tests; between bench arms)."""
    global _acquisitions, _quiet_streak, _frozen, _epoch
    with _graph_mu:
        _edges.clear()
        del _cycles[:]
        _acquisitions = 0
        _quiet_streak = 0
        _frozen = False
        _epoch += 1


def _find_path(src, dst):
    """A path src -> ... -> dst through recorded edges, or None."""
    # tiny graphs: plain BFS under _graph_mu
    prev = {src: None}
    frontier = [src]
    while frontier:
        nxt = []
        for node in frontier:
            for (a, b) in _edges:
                if a == node and b not in prev:
                    prev[b] = node
                    if b == dst:
                        path = [b]
                        while path[-1] is not None:
                            p = prev[path[-1]]
                            if p is None:
                                break
                            path.append(p)
                        return list(reversed(path))
                    nxt.append(b)
        frontier = nxt
    return None


def _note_acquire(name):
    """Record top-of-stack -> name, detect cycles, then push."""
    global _acquisitions, _quiet_streak, _frozen
    _acquisitions += 1
    st = _held()
    if name in st:
        # reentrant (RLock) or sibling instance of a held class: no
        # self-edges — matches the static walk dropping re-held ids
        st.append(name)
        return
    top = st[-1] if st else None
    if top is None:
        # nothing held: no edge to record, but the streak still counts
        # — convergence means "no new edge lately", and unnested
        # acquires are most of a steady-state workload
        _quiet_streak += 1
        if _quiet_streak >= _FREEZE_AFTER:
            _frozen = True
        st.append(name)
        return
    key = (top, name)
    if key in _edges:  # GIL-safe fast path: dict hit, no mutex
        _quiet_streak += 1
        if _quiet_streak >= _FREEZE_AFTER:
            _frozen = True
        st.append(name)
        return
    with _graph_mu:
        if key not in _edges:
            # would the reverse order already be reachable? then this
            # acquisition closes a potential-deadlock cycle
            back = _find_path(name, top)
            _edges[key] = True
            _quiet_streak = 0
            if back is not None:
                _cycles.append(tuple(back + [name]))
    st.append(name)


def _note_release(name):
    st = _held()
    # defensive scan: release order need not mirror acquire order
    for i in range(len(st) - 1, -1, -1):
        if st[i] == name:
            del st[i]
            return


class _DepLock:
    """Instrumented Lock/RLock: records acquisition order per thread.

    Delegates ``_release_save`` / ``_acquire_restore`` / ``_is_owned``
    so a ``threading.Condition`` built over it (via :func:`condition`)
    waits correctly.
    """

    __slots__ = ("_inner", "name", "_acq", "_rel")

    def __init__(self, inner, name):
        self._inner = inner
        self.name = name
        # pre-bound inner methods: the frozen fast path is one global
        # read + one C call, no attribute chain
        self._acq = inner.acquire
        self._rel = inner.release

    def acquire(self, blocking=True, timeout=-1):
        got = self._acq(blocking, timeout)
        if got and not _frozen:
            _note_acquire(self.name)
        return got

    def release(self):
        self._rel()
        if not _frozen:
            _note_release(self.name)

    def __enter__(self):
        self._acq()
        if not _frozen:
            _note_acquire(self.name)
        return self

    def __exit__(self, t, v, tb):
        self._rel()
        if not _frozen:
            _note_release(self.name)
        return False

    def locked(self):
        return self._inner.locked()

    # Condition plumbing: wait() releases and re-acquires through these
    def _release_save(self):
        state = self._inner._release_save() if hasattr(
            self._inner, "_release_save") else self._inner.release()
        if not _frozen:
            _note_release(self.name)
        return state

    def _acquire_restore(self, state):
        if hasattr(self._inner, "_acquire_restore"):
            self._inner._acquire_restore(state)
        else:
            self._inner.acquire()
        if not _frozen:
            _note_acquire(self.name)

    def _is_owned(self):
        if hasattr(self._inner, "_is_owned"):
            return self._inner._is_owned()
        # plain Lock heuristic, as threading.Condition does it
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    def __repr__(self):
        return f"<DepLock {self.name} {self._inner!r}>"


def lock(name):
    """A named mutex: ``threading.Lock`` when the witness is off, an
    instrumented wrapper when on. ``name`` is the lock's CLASS identity
    ("Owner._attr") — it must match the static model's derived id."""
    if not _enabled:
        return threading.Lock()
    return _DepLock(threading.Lock(), name)


def rlock(name):
    if not _enabled:
        return threading.RLock()
    return _DepLock(threading.RLock(), name)


def condition(name, lock=None):
    """A condition over ``lock`` (or a fresh mutex named ``name``).
    Passing the owner's mutex ALIASES the condition to it — same node
    in the witness graph, matching the static model's Condition
    aliasing."""
    if not _enabled:
        return threading.Condition(lock)
    if lock is None:
        lock = _DepLock(threading.Lock(), name)
    return threading.Condition(lock)


def acquisition_count():
    return _acquisitions


def edge_set():
    """Frozen set of (a, b) acquisition-order edges observed so far."""
    with _graph_mu:
        return frozenset(_edges)


def cycle_count():
    with _graph_mu:
        return len(_cycles)


def cycles():
    with _graph_mu:
        return list(_cycles)


def witness_doc():
    """Canonical JSON witness: sorted edges + cycles, no timestamps —
    two same-seed runs produce byte-identical documents."""
    with _graph_mu:
        doc = {
            "edges": sorted([list(e) for e in _edges]),
            "cycles": sorted([list(c) for c in _cycles]),
        }
    return json.dumps(doc, sort_keys=True, separators=(",", ":"))
