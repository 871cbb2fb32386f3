"""The plain reference of the resolver configurations: FoundationDB's
resolver semantics, exact, over the rank runs of ``traffic.Pool``.

A transaction whose read version is below its batch's window start is
``TOO_OLD``. Otherwise it conflicts iff one of its reads meets a write
committed after its read version: a write of an earlier batch with a
newer commit version, or a write of an earlier committed transaction of
its own batch. Strict serializability at the resolver asks that no
transaction the resolver commits conflicts.

:class:`Judge` holds a run's statuses to that. It reads the program's
statuses only to judge them: the history it checks against is the set
of writes the run committed, so each verdict is judged on its own. A
resolver may abort more than the exact rule does (the port's hash slots
and coarse buckets are conservative by design), so false conflicts are
counted against a limit, while a commit that conflicts, or a status
that is not one of the three, is a fault.

:func:`decide` is the reference put in the program's place: greedy
acceptance in transaction order, exact, or with its version offsets cut
to ``version_bits`` (the control). Plain numpy; nothing of the program
is imported.
"""

import numpy as np

COMMITTED, CONFLICT, TOO_OLD = 0, 1, 2


def _run_ranks(lo, hi, max_span):
    """[m, max_span] ranks of each run [lo, hi) and which are inside."""
    idx = lo[:, None] + np.arange(max_span)[None, :]
    return idx, idx < hi[:, None]


class _Runs:
    """One batch's reads or writes as flat runs with their txn index."""

    def __init__(self, lo, hi, n_keys, max_span):
        T, k = lo.shape
        self.txn = np.repeat(np.arange(T), k)
        idx, inside = _run_ranks(lo.reshape(-1).astype(np.int64),
                                 hi.reshape(-1).astype(np.int64), max_span)
        self.idx = np.minimum(idx, n_keys - 1)
        self.inside = inside


def _intra(reads, writes, accepted, first_writer):
    """bool[T]: which transactions read a key that an earlier ``accepted``
    transaction of the batch writes; and the ranks those write.
    ``first_writer`` is scratch of n_keys entries, all T, left so."""
    T = len(accepted)
    keep = writes.inside & accepted[writes.txn][:, None]
    ranks = writes.idx[keep]
    owners = np.broadcast_to(writes.txn[:, None], keep.shape)[keep]
    np.minimum.at(first_writer, ranks, owners)
    earliest = np.where(reads.inside, first_writer[reads.idx], T).min(1)
    hit = np.zeros(T, dtype=bool)
    np.logical_or.at(hit, reads.txn, earliest < reads.txn)
    first_writer[ranks] = T
    return hit, ranks


class Judge:
    """Replays a run's batches in commit order and classifies every
    verdict. Feed :meth:`batch` each dispatched batch, then read
    :meth:`numbers`."""

    def __init__(self, pool, versions, n_keys):
        self.pool = pool
        self.versions = versions
        self.n_keys = n_keys
        self.last_write = np.zeros(n_keys, dtype=np.int64)  # 0: never
        self.first_writer = np.full(n_keys, pool.txns, dtype=np.int64)
        self.txns = 0
        self.unsound = 0
        self.false_conflicts = 0
        self.bad = 0
        self.committed = 0

    def conflicts(self, row, rv, committed):
        """bool[T]: the exact rule, against the history and the
        ``committed`` transactions of this batch; and the ranks those
        transactions write."""
        p = self.pool
        reads = _Runs(p.read_lo[row], p.read_hi[row], self.n_keys,
                      p.max_span)
        newest = np.where(reads.inside, self.last_write[reads.idx], 0).max(1)
        hit = np.zeros(p.txns, dtype=bool)
        np.logical_or.at(hit, reads.txn, newest > rv[reads.txn])
        writes = _Runs(p.write_lo[row], p.write_hi[row], self.n_keys,
                       p.max_span)
        intra, ranks = _intra(reads, writes, committed, self.first_writer)
        return hit | intra, ranks

    def batch(self, i, statuses):
        """Judge batch ``i`` of the run (pool row ``i % n_batches``)
        against its ``statuses``; None stands for statuses that never
        came."""
        p = self.pool
        T = p.txns
        row = i % p.n_batches
        rv = self.versions.read_versions(i, p.lags[row])
        too_old = rv < self.versions.window_start(i)
        self.txns += T
        if statuses is None or len(statuses) != T:
            self.bad += T
            return
        s = np.asarray(statuses)
        committed = (s == COMMITTED) & ~too_old
        hit, ranks = self.conflicts(row, rv, committed)
        live = ~too_old
        self.bad += int((too_old & (s != TOO_OLD)).sum())
        self.bad += int((live & (s != COMMITTED) & (s != CONFLICT)).sum())
        self.unsound += int((committed & hit).sum())
        self.false_conflicts += int((live & (s == CONFLICT) & ~hit).sum())
        self.committed += int(committed.sum())
        self.last_write[ranks] = self.versions.commit(i)

    def numbers(self):
        return {
            "txns": self.txns,
            "committed": self.committed,
            "unsound_commits": self.unsound,
            "bad_statuses": self.bad,
            "false_conflict_pct": (100.0 * self.false_conflicts
                                   / max(self.txns, 1)),
        }


def decide(pool, versions, n_keys, batches, version_bits=None):
    """The reference's own statuses for ``batches`` (run indices, in
    commit order): exact, or with version offsets from the first commit
    version kept in ``version_bits`` bits. Greedy acceptance in order is
    the fixpoint of a <- a0 and not (a meets an earlier accepted write),
    iterated from a0."""
    T = pool.txns
    last_write = np.zeros(n_keys, dtype=np.int64)
    first_writer = np.full(n_keys, T, dtype=np.int64)
    base = versions.first
    mask = None if version_bits is None else (1 << version_bits) - 1
    out = []
    for i in batches:
        row = i % pool.n_batches
        rv = versions.read_versions(i, pool.lags[row])
        too_old = rv < versions.window_start(i)
        reads = _Runs(pool.read_lo[row], pool.read_hi[row], n_keys,
                      pool.max_span)
        writes = _Runs(pool.write_lo[row], pool.write_hi[row], n_keys,
                       pool.max_span)
        seen = np.where(reads.inside, last_write[reads.idx], 0)
        rvq = rv[reads.txn][:, None]
        if mask is not None:
            newer = seen != 0
            seen = (seen - base) & mask
            rvq = (rvq - base) & mask
            stale = newer & (seen > rvq)
        else:
            stale = seen > rvq
        hist = np.zeros(T, dtype=bool)
        np.logical_or.at(hist, reads.txn, stale.any(1))
        a0 = ~hist & ~too_old
        accepted = a0
        while True:
            intra, ranks = _intra(reads, writes, accepted, first_writer)
            nxt = a0 & ~intra
            if np.array_equal(nxt, accepted):
                break
            accepted = nxt
        last_write[ranks] = versions.commit(i)
        statuses = np.where(too_old, TOO_OLD,
                            np.where(accepted, COMMITTED, CONFLICT))
        out.append(statuses.astype(np.int8))
    return out
