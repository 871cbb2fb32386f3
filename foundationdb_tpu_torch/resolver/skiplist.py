"""Host ConflictSet — exact MVCC conflict detection on byte keys.

Semantics-parity twin of ConflictSet::detectConflicts +
Resolver::resolveBatch (ref: fdbserver/SkipList.cpp,
fdbserver/Resolver.actor.cpp): keeps committed write ranges of the MVCC
window; a txn commits iff its read ranges miss every write range newer
than its read version, where earlier *accepted* txns of the same batch
count as committed at the batch's commit version.

It serves ``resolver_backend="cpu"``. The device step is conservative
(hash collisions, coarse summaries) and so may abort more than this set;
it never commits a txn this set aborts.
"""

from dataclasses import dataclass, field

from foundationdb_tpu_torch.core.status import COMMITTED, CONFLICT, TOO_OLD


@dataclass
class TxnRequest:
    """One transaction's resolve payload.

    Ref: CommitTransactionRef in fdbclient/CommitTransaction.h
    (read_conflict_ranges, write_conflict_ranges, read_snapshot version).
    """

    read_version: int
    point_reads: list = field(default_factory=list)  # [bytes]
    point_writes: list = field(default_factory=list)  # [bytes]
    range_reads: list = field(default_factory=list)  # [(begin, end)]
    range_writes: list = field(default_factory=list)  # [(begin, end)]

    def read_ranges(self):
        for k in self.point_reads:
            yield k, k + b"\x00"
        yield from self.range_reads

    def write_ranges(self):
        for k in self.point_writes:
            yield k, k + b"\x00"
        yield from self.range_writes


class CpuConflictSet:
    """Exact interval-list conflict set over byte keys."""

    def __init__(self):
        self.window_start = 0
        self._entries = []  # list of (begin, end, version), unsorted
        self._ops_since_prune = 0

    def _conflicts(self, ranges, read_version, extra):
        for rb, re_ in ranges:
            for wb, we, wv in self._entries:
                if wv > read_version and rb < we and wb < re_:
                    return True
            for wb, we, wv in extra:
                if wv > read_version and rb < we and wb < re_:
                    return True
        return False

    def resolve(self, txns, commit_version, new_window_start=None):
        """Resolve a batch in arrival order; returns list of statuses."""
        statuses = []
        batch_writes = []
        for txn in txns:
            if txn.read_version < self.window_start:
                statuses.append(TOO_OLD)
                continue
            if self._conflicts(txn.read_ranges(), txn.read_version, batch_writes):
                statuses.append(CONFLICT)
                continue
            statuses.append(COMMITTED)
            for wb, we in txn.write_ranges():
                batch_writes.append((wb, we, commit_version))
        self._entries.extend(batch_writes)
        if new_window_start is not None:
            self.set_oldest_version(new_window_start)
        return statuses

    def conflicting_ranges(self, txn):
        """The subset of ``txn``'s read ranges that overlap a write newer
        than its read version; called right after the resolve that
        rejected it, so the batch's accepted writes count too."""
        out = []
        for rb, re_ in txn.read_ranges():
            for wb, we, wv in self._entries:
                if wv > txn.read_version and rb < we and wb < re_:
                    out.append((rb, re_))
                    break
        return out

    def set_oldest_version(self, version):
        """Advance the MVCC window (monotone); prune entries no read can
        see anymore."""
        self.window_start = max(self.window_start, version)
        self._ops_since_prune += 1
        if self._ops_since_prune >= 64:
            self._ops_since_prune = 0
            self._entries = [e for e in self._entries if e[2] > version]

    def __len__(self):
        return len(self._entries)
