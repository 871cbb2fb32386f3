"""The storage server's single-version engine, in memory.

Ref parity: fdbserver/IKeyValueStore.h and KeyValueStoreMemory.actor.cpp.
The storage server (server/storage.py) keeps the MVCC window as an
in-memory overlay and folds versions leaving the window down into this
engine, which holds the state as of the *durable version*;
``commit(version)`` records that version. The on-disk engines, the
write-ahead log and recovery are not ported yet.
"""

from foundationdb_tpu_torch.utils.sorteddict import SortedDict


class KeyValueStoreMemory:
    """Ordered in-RAM map at one version."""

    def __init__(self):
        self._data = SortedDict()
        self._version = 0

    # ── reads ──
    def get(self, key):
        return self._data.get(key)

    def get_range(self, begin, end, limit=0, reverse=False):
        out = []
        for kv in self.iter_range(begin, end, reverse=reverse):
            out.append(kv)
            if limit and len(out) >= limit:
                break
        return out

    def iter_range(self, begin, end, reverse=False):
        """Lazy ordered (key, value) iteration over [begin, end)."""
        data = self._data
        for k in data.irange(begin, end, inclusive=(True, False),
                             reverse=reverse):
            yield k, data[k]

    def stored_version(self):
        return self._version

    def __len__(self):
        return len(self._data)

    # ── writes ──
    def set(self, key, value):
        self._data[key] = value

    def clear_range(self, begin, end):
        for k in list(self._data.irange(begin, end, inclusive=(True, False))):
            del self._data[k]

    def commit(self, version):
        self._version = version
