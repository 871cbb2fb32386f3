"""Change feeds: versioned streams of mutations over a key range.

Ref parity: FoundationDB's change feeds (fdbclient/DatabaseContext.h
getChangeFeedStream / fdbserver/storageserver.actor.cpp changeFeed
machinery): a feed is registered over a key range; every committed
mutation intersecting the range is appended to the feed's version-
ordered stream; consumers read (begin_version, end_version] windows and
pop what they have durably consumed. The reference persists feeds on
storage servers; here the registry lives beside the commit pipeline
(every committed batch flows through exactly once, in version order) —
in-memory with bounded retention, the same place our tlog sits on the
durability spectrum. The cluster owns one registry and hands it to
every commit proxy, so the members of a fleet share it.

Reading below a feed's popped/trimmed frontier raises
``transaction_too_old`` (1007): the data is gone for the same reason an
old read version is — it left the retained window.
"""

from collections import deque

from foundationdb_tpu_torch.core.errors import err
from foundationdb_tpu_torch.core.mutations import Op
from foundationdb_tpu_torch.utils import lockdep


class _Feed:
    __slots__ = ("begin", "end", "entries", "pop_version", "dropped")

    def __init__(self, begin, end, retention):
        self.begin = begin
        self.end = end
        self.entries = deque(maxlen=retention)  # [(version, [Mutation])]
        self.pop_version = 0  # everything <= this is consumed/trimmed
        self.dropped = 0


class ChangeFeedRegistry:
    """All feeds of one cluster. note_commit is on the commit path —
    it takes the lock only when feeds exist."""

    def __init__(self, retention=10_000):
        self.retention = retention
        self._feeds = {}
        self._mu = lockdep.lock("ChangeFeedRegistry._mu")

    def __len__(self):
        return len(self._feeds)

    def register(self, feed_id, begin, end):
        if begin >= end:
            raise err("inverted_range")
        with self._mu:
            if feed_id in self._feeds:
                raise err("client_invalid_operation")
            self._feeds[feed_id] = _Feed(begin, end, self.retention)

    def deregister(self, feed_id):
        with self._mu:
            self._feeds.pop(feed_id, None)

    def list(self):
        with self._mu:
            return {
                fid: {"begin": f.begin, "end": f.end,
                      "pop_version": f.pop_version,
                      "entries": len(f.entries)}
                for fid, f in self._feeds.items()
            }

    def note_commit(self, version, mutations):
        """Append this commit's in-range mutations to every feed.
        Called once per committed batch, in version order."""
        if not self._feeds or not mutations:
            return
        with self._mu:
            for f in self._feeds.values():
                hits = []
                for m in mutations:
                    if m.op is Op.CLEAR_RANGE:
                        if m.key < f.end and f.begin < m.param:
                            hits.append(m)
                    elif f.begin <= m.key < f.end:
                        hits.append(m)
                if hits:
                    if len(f.entries) == f.entries.maxlen:
                        # retention cap: the oldest window trims away and
                        # readers below it get 1007, never silent gaps
                        oldest = f.entries[0][0]
                        f.pop_version = max(f.pop_version, oldest)
                        f.dropped += 1
                    f.entries.append((version, hits))

    def read(self, feed_id, begin_version, end_version=None, limit=0):
        """Entries with begin_version < version <= end_version, in
        order. Reading from below the popped/trimmed frontier raises
        1007 — the stream there no longer exists."""
        with self._mu:
            f = self._feeds.get(feed_id)
            if f is None:
                raise err("client_invalid_operation")
            if begin_version < f.pop_version:
                raise err("transaction_too_old")
            out = []
            for v, muts in f.entries:
                if v <= begin_version:
                    continue
                if end_version is not None and v > end_version:
                    break
                out.append((v, list(muts)))
                if limit and len(out) >= limit:
                    break
            return out

    def pop(self, feed_id, version):
        """Consumer checkpoint: entries <= version can be discarded."""
        with self._mu:
            f = self._feeds.get(feed_id)
            if f is None:
                raise err("client_invalid_operation")
            f.pop_version = max(f.pop_version, version)
            while f.entries and f.entries[0][0] <= f.pop_version:
                f.entries.popleft()
