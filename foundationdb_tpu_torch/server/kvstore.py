"""Storage engines beneath the storage server, in memory or on disk.

Ref parity: fdbserver/IKeyValueStore.h and its implementations —
KeyValueStoreMemory.actor.cpp (in-RAM tree + operation log for
durability), KeyValueStoreSQLite.actor.cpp (B-tree file, the FoundationDB
``ssd`` engine) and VersionedBTree.actor.cpp (Redwood). The storage
server (server/storage.py) keeps the MVCC window as an in-memory overlay
and flushes versions leaving the window down into one of these engines,
advancing its *durable version* behind the *latest version*.

Single-version engines store the state as of the durable version;
``commit(version)`` makes everything written so far durable and records
the version, which ``stored_version()`` returns after a restart. The
versioned engines (``versioned = True``) keep per-key version chains, so
the storage server's read window extends into them. ``open_engine``
builds one by name.
"""

import os
import pickle
import sqlite3
import struct

from foundationdb_tpu_torch.server.tlog import _frame, read_frames
from foundationdb_tpu_torch.utils.sorteddict import SortedDict

_META_VERSION_KEY = b"\xff\xff/kvstore_version"


def _sorted(mapping):
    """A SortedDict holding ``mapping``."""
    out = SortedDict()
    for k in sorted(mapping):
        out[k] = mapping[k]
    return out


def _as_dict(sd):
    return {k: sd[k] for k in sd.irange()}


class WalEngineBase:
    """Durability shared by the in-RAM engines: a length+CRC-framed
    operation log with periodic snapshot compaction, recovered with a
    torn tail tolerated (ref: the DiskQueue + snapshot pattern of the
    reference's memory engines). Subclasses implement ``_apply_record``
    (replay one op) and ``_snapshot_state`` / ``_load_snapshot``."""

    def __init__(self, path=None, fsync=False, snapshot_every_ops=50_000):
        self._version = 0
        self.path = path
        self.fsync = fsync
        self._ops_since_snapshot = 0
        self._snapshot_every = snapshot_every_ops
        self._wal = None
        if path is not None:
            self._recover()
            self._wal = open(self._wal_path, "ab")

    @property
    def _snap_path(self):
        return self.path + ".snap"

    @property
    def _wal_path(self):
        return self.path + ".oplog"

    def _log(self, op):
        if self._wal is None:
            return
        self._wal.write(_frame(op))
        self._ops_since_snapshot += 1

    def commit(self, version):
        self._commit_version(version)
        self._log(("v", version, None))
        if self._wal is not None:
            self._wal.flush()
            if self.fsync:
                os.fsync(self._wal.fileno())
            if self._ops_since_snapshot >= self._snapshot_every:
                self.compact()

    def _commit_version(self, version):
        self._version = version

    def compact(self):
        """Snapshot the whole state and truncate the op log, so that
        recovery replays a bounded log."""
        if self.path is None:
            return
        tmp = self._snap_path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(self._snapshot_state(), f, protocol=4)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._snap_path)
        if self._wal is not None:
            self._wal.close()
        self._wal = open(self._wal_path, "wb")
        self._ops_since_snapshot = 0

    def _recover(self):
        if os.path.exists(self._snap_path):
            with open(self._snap_path, "rb") as f:
                self._load_snapshot(pickle.load(f))
        for kind, a, b in read_frames(self._wal_path):
            if kind == "v":
                self._commit_version(a)
            else:
                self._apply_record(kind, a, b)
        self._ops_since_snapshot = 0

    def close(self):
        if self._wal is not None:
            self._wal.flush()
            self._wal.close()
            self._wal = None


class KeyValueStoreMemory(WalEngineBase):
    """Ordered in-RAM map at one version, durable through a snapshot and
    an operation log when given a path (ref: KeyValueStoreMemory)."""

    def __init__(self, path=None, fsync=False, snapshot_every_ops=50_000):
        self._data = SortedDict()
        super().__init__(path, fsync, snapshot_every_ops)

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
        self._log(("s", key, value))

    def clear_range(self, begin, end):
        self._clear(begin, end)
        self._log(("c", begin, end))

    def _clear(self, begin, end):
        for k in list(self._data.irange(begin, end, inclusive=(True, False))):
            del self._data[k]

    # ── WalEngineBase hooks ──
    def _snapshot_state(self):
        return (self._version, _as_dict(self._data))

    def _load_snapshot(self, state):
        self._version, data = state
        self._data = _sorted(data)

    def _apply_record(self, kind, a, b):
        if kind == "s":
            self._data[a] = b
        elif kind == "c":
            self._clear(a, b)


class KeyValueStoreSQLite:
    """B-tree file engine on the stdlib sqlite3 (ref: KeyValueStoreSQLite,
    the ``ssd`` engine — the reference embeds the same B-tree)."""

    def __init__(self, path, fsync=False):
        self.path = path
        # the batcher thread flushes into an engine the client thread
        # opened; the storage server's lock serializes every access
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.execute(
            f"PRAGMA synchronous={'FULL' if fsync else 'NORMAL'}")
        self._conn.execute("CREATE TABLE IF NOT EXISTS kv "
                           "(k BLOB PRIMARY KEY, v BLOB) WITHOUT ROWID")
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS meta (k BLOB PRIMARY KEY, v BLOB)")

    def get(self, key):
        row = self._conn.execute("SELECT v FROM kv WHERE k = ?",
                                 (key,)).fetchone()
        return None if row is None else bytes(row[0])

    def get_range(self, begin, end, limit=0, reverse=False):
        q = "SELECT k, v FROM kv WHERE k >= ? AND k < ? ORDER BY k"
        if reverse:
            q += " DESC"
        if limit:
            q += f" LIMIT {int(limit)}"
        return [(bytes(k), bytes(v))
                for k, v in self._conn.execute(q, (begin, end)).fetchall()]

    def iter_range(self, begin, end, reverse=False):
        q = "SELECT k, v FROM kv WHERE k >= ?"
        args = [begin]
        if end is not None:
            q += " AND k < ?"
            args.append(end)
        q += " ORDER BY k DESC" if reverse else " ORDER BY k"
        for k, v in self._conn.execute(q, args):  # a lazy cursor
            yield bytes(k), bytes(v)

    def stored_version(self):
        row = self._conn.execute("SELECT v FROM meta WHERE k = ?",
                                 (_META_VERSION_KEY,)).fetchone()
        return 0 if row is None else struct.unpack(">q", row[0])[0]

    def __len__(self):
        return self._conn.execute("SELECT COUNT(*) FROM kv").fetchone()[0]

    def set(self, key, value):
        self._conn.execute("INSERT OR REPLACE INTO kv VALUES (?, ?)",
                           (key, value))

    def clear_range(self, begin, end):
        if end is None:
            self._conn.execute("DELETE FROM kv WHERE k >= ?", (begin,))
        else:
            self._conn.execute("DELETE FROM kv WHERE k >= ? AND k < ?",
                               (begin, end))

    def commit(self, version):
        self._conn.execute("INSERT OR REPLACE INTO meta VALUES (?, ?)",
                           (_META_VERSION_KEY, struct.pack(">q", version)))
        self._conn.commit()

    def compact(self):
        self._conn.execute("PRAGMA wal_checkpoint(TRUNCATE)")

    def close(self):
        self._conn.commit()
        self._conn.close()


def open_engine(kind, path=None, **kw):
    """An engine by name: "memory", "versioned", "redwood" (the versioned
    engine on disk) or "sqlite" (the ``ssd`` engine)."""
    if kind == "memory":
        return KeyValueStoreMemory(path, **kw)
    if kind == "versioned":
        return KeyValueStoreVersioned(path, **kw)
    if kind == "redwood":
        if path is None:
            raise ValueError("redwood engine requires a path")
        return KeyValueStoreVersionedDisk(path, **kw)
    if kind == "sqlite":
        if path is None:
            raise ValueError("sqlite engine requires a path")
        return KeyValueStoreSQLite(path, **kw)
    raise ValueError(f"unknown storage engine {kind!r}")


class KeyValueStoreVersioned(WalEngineBase):
    """Versioned store in RAM, the Redwood role (ref:
    VersionedBTree.actor.cpp): per-key version chains in an ordered map,
    durable through the op log and snapshots, with ``prune()`` dropping
    history that left the retention window.

    The storage server sees ``versioned = True`` and (a) flushes every
    overlay version down instead of folding to the newest, (b) serves
    reads below the durable version from ``get_at`` / ``iter_range_at``,
    and (c) moves its read floor only with ``advance_window``."""

    versioned = True

    def __init__(self, path=None, fsync=False, snapshot_every_ops=50_000):
        # key -> [(version, value or None)] ascending; None = tombstone
        self._chains = SortedDict()
        self._oldest = 0  # oldest version with full history retained
        # keys prune() must visit: a chain longer than one entry, or a
        # lone tombstone (prune stays O(prunable), not O(keys))
        self._prunable = set()
        super().__init__(path, fsync, snapshot_every_ops)

    # ── versioned reads ──
    @staticmethod
    def _at(chain, version):
        """Newest value at or below ``version`` (None = absent)."""
        val = None
        for v, x in chain:
            if v <= version:
                val = x
            else:
                break
        return val

    def get_at(self, key, version):
        chain = self._chains.get(key)
        return self._at(chain, version) if chain else None

    def iter_range_at(self, begin, end, version, reverse=False):
        for k in self._chains.irange(begin, end, inclusive=(True, False),
                                     reverse=reverse):
            val = self._at(self._chains[k], version)
            if val is not None:
                yield k, val

    def iter_chains(self, begin, end):
        """Full (key, version chain) pairs in [begin, end)."""
        for k in list(self._chains.irange(begin, end,
                                          inclusive=(True, False))):
            yield k, list(self._chains[k])

    # ── the single-version view (the durable version) ──
    def get(self, key):
        return self.get_at(key, self._version)

    def iter_range(self, begin, end, reverse=False):
        yield from self.iter_range_at(begin, end, self._version,
                                      reverse=reverse)

    def get_range(self, begin, end, limit=0, reverse=False):
        out = []
        for kv in self.iter_range(begin, end, reverse=reverse):
            out.append(kv)
            if limit and len(out) >= limit:
                break
        return out

    def stored_version(self):
        return self._version

    @property
    def oldest_retained(self):
        return self._oldest

    def __len__(self):
        return sum(1 for _ in self.iter_range(b"", None))

    # ── writes ──
    def set_versioned(self, key, version, value):
        """Record ``value`` (None = tombstone) for key at version;
        versions of a key arrive ascending (flush order)."""
        self._apply_set_versioned(key, version, value)
        self._log(("sv", key, (version, value)))

    def _apply_set_versioned(self, key, version, value):
        chain = self._chains.get(key)
        if chain is None:
            chain = self._chains[key] = []
        if chain and chain[-1][0] == version:
            chain[-1] = (version, value)
        else:
            chain.append((version, value))
        if len(chain) > 1 or value is None:
            self._prunable.add(key)

    def set(self, key, value):
        # single-version writes record at the durable version
        self.set_versioned(key, self._version, value)

    def clear_range(self, begin, end):
        for k in list(self._chains.irange(begin, end,
                                          inclusive=(True, False))):
            if self._at(self._chains[k], self._version) is not None:
                self.set_versioned(k, self._version, None)

    def erase_range(self, begin, end):
        """Physically delete every chain in [begin, end), history and
        all (not a clear, which is a tombstone write at a version)."""
        self._apply_erase(begin, end)
        self._log(("e", begin, end))

    def _apply_erase(self, begin, end):
        for k in list(self._chains.irange(begin, end,
                                          inclusive=(True, False))):
            del self._chains[k]
            self._prunable.discard(k)

    def prune(self, before_version):
        """Drop history below ``before_version``: each chain keeps its
        newest entry at or below it (the base an admissible read needs)
        and everything newer."""
        if before_version <= self._oldest:
            return
        self._apply_prune(before_version)
        self._log(("p", before_version, None))

    def _apply_prune(self, before_version):
        for k in list(self._prunable):
            chain = self._chains.get(k)
            if chain is None:
                self._prunable.discard(k)
                continue
            base_idx = -1
            for i, (v, _) in enumerate(chain):
                if v <= before_version:
                    base_idx = i
                else:
                    break
            if base_idx > 0:
                del chain[:base_idx]
            if len(chain) == 1:
                if chain[0][0] <= before_version and chain[0][1] is None:
                    # a tombstone base below the horizon drops entirely
                    del self._chains[k]
                    self._prunable.discard(k)
                elif chain[0][1] is not None:
                    self._prunable.discard(k)
        self._oldest = before_version

    # ── WalEngineBase hooks ──
    def _commit_version(self, version):
        self._version = max(self._version, version)

    def _snapshot_state(self):
        return (self._version, self._oldest, _as_dict(self._chains))

    def _load_snapshot(self, state):
        self._version, self._oldest, chains = state
        self._chains = _sorted({k: list(c) for k, c in chains.items()})
        self._prunable = {k for k, c in chains.items()
                          if len(c) > 1 or c[-1][1] is None}

    def _apply_record(self, kind, a, b):
        if kind == "sv":
            version, value = b
            self._apply_set_versioned(a, version, value)
        elif kind == "e":
            self._apply_erase(a, b)
        elif kind == "p":
            self._apply_prune(a)


class KeyValueStoreVersionedDisk:
    """The versioned store on disk, the Redwood role at Redwood scale:
    sqlite rows keyed ``(key, version)`` (``WITHOUT ROWID``, so a version
    chain is contiguous in the B-tree), a NULL value as the tombstone,
    visibility by an indexed newest-at-or-below probe, ``prune()`` by SQL
    deletes. Memory is the sqlite page cache, not the data size.
    Everything since the last ``commit(version)`` rolls back atomically
    with sqlite's WAL, so recovery resumes from the durable version."""

    versioned = True

    CACHE_KB = 4096  # page cache: index pages fit, the data need not

    def __init__(self, path, fsync=False):
        self.path = path
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.execute(
            f"PRAGMA synchronous={'FULL' if fsync else 'NORMAL'}")
        self._conn.execute(f"PRAGMA cache_size=-{self.CACHE_KB}")
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS kvv ("
            " k BLOB NOT NULL, v INTEGER NOT NULL, val BLOB,"
            " PRIMARY KEY (k, v)) WITHOUT ROWID")
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS meta (k BLOB PRIMARY KEY, v BLOB)")
        self._version = self._meta_int(b"version", 0)
        self._oldest = self._meta_int(b"oldest", 0)
        # keys written since the last prune; the first prune after open
        # sweeps the whole table (history from before a crash)
        self._prunable = set()
        self._full_prune_pending = True

    def _meta_int(self, key, default):
        row = self._conn.execute("SELECT v FROM meta WHERE k = ?",
                                 (key,)).fetchone()
        return default if row is None else struct.unpack(">q", row[0])[0]

    def _meta_set(self, key, value):
        self._conn.execute("INSERT OR REPLACE INTO meta VALUES (?, ?)",
                           (key, struct.pack(">q", value)))

    @staticmethod
    def _range_clause(q, begin, end):
        """``q`` with the [begin, end) bounds on k (end None: open)."""
        args = [begin]
        q += " WHERE k >= ?"
        if end is not None:
            q += " AND k < ?"
            args.append(end)
        return q, args

    # ── versioned reads ──
    def get_at(self, key, version):
        row = self._conn.execute(
            "SELECT val FROM kvv WHERE k = ? AND v <= ?"
            " ORDER BY v DESC LIMIT 1", (key, version)).fetchone()
        if row is None or row[0] is None:
            return None
        return bytes(row[0])

    def iter_range_at(self, begin, end, version, reverse=False):
        # a bare column beside MAX: sqlite takes ``val`` from the max-v
        # row of each group, one index-ordered pass
        q, args = self._range_clause("SELECT k, val, MAX(v) FROM kvv",
                                     begin, end)
        q += " AND v <= ? GROUP BY k ORDER BY k"
        args.append(version)
        if reverse:
            q += " DESC"
        for k, val, _ in self._conn.execute(q, args):
            if val is not None:
                yield bytes(k), bytes(val)

    def iter_chains(self, begin, end):
        """Full (key, version chain) pairs in [begin, end)."""
        chain_key, chain = None, []
        q, args = self._range_clause("SELECT k, v, val FROM kvv", begin, end)
        for k, v, val in self._conn.execute(q + " ORDER BY k, v", args):
            k = bytes(k)
            if k != chain_key:
                if chain:
                    yield chain_key, chain
                chain_key, chain = k, []
            chain.append((v, None if val is None else bytes(val)))
        if chain:
            yield chain_key, chain

    # ── the single-version view (the durable version) ──
    def get(self, key):
        return self.get_at(key, self._version)

    def iter_range(self, begin, end, reverse=False):
        yield from self.iter_range_at(begin, end, self._version,
                                      reverse=reverse)

    def get_range(self, begin, end, limit=0, reverse=False):
        out = []
        for kv in self.iter_range(begin, end, reverse=reverse):
            out.append(kv)
            if limit and len(out) >= limit:
                break
        return out

    def stored_version(self):
        return self._version

    @property
    def oldest_retained(self):
        return self._oldest

    def __len__(self):
        return sum(1 for _ in self.iter_range(b"", None))

    # ── writes ──
    def set_versioned(self, key, version, value):
        """Record ``value`` (None = tombstone) for key at version."""
        self._conn.execute("INSERT OR REPLACE INTO kvv VALUES (?, ?, ?)",
                           (key, version, value))
        self._prunable.add(key)

    def set(self, key, value):
        self.set_versioned(key, self._version, value)

    def clear_range(self, begin, end):
        # tombstone every key live at the durable version
        q, args = self._range_clause("SELECT k, val, MAX(v) FROM kvv",
                                     begin, end)
        args.append(self._version)
        rows = self._conn.execute(q + " AND v <= ? GROUP BY k",
                                  args).fetchall()
        for k, val, _ in rows:
            if val is not None:
                self.set_versioned(bytes(k), self._version, None)

    def erase_range(self, begin, end):
        """Physically delete every chain in [begin, end)."""
        q, args = self._range_clause("DELETE FROM kvv", begin, end)
        self._conn.execute(q, args)

    def prune(self, before_version):
        """Drop history below the horizon: each chain keeps its newest
        entry at or below it and everything newer; a lone tombstone
        base below it drops entirely. Steady state visits the chains
        written since the last prune; the first prune after open sweeps
        the table."""
        if before_version <= self._oldest and not self._full_prune_pending:
            return
        if self._full_prune_pending:
            self._prune_sql(before_version, None)
            self._prunable = self._shrinkable(None)
            self._full_prune_pending = False
        elif self._prunable:
            # keep the keys that can still shrink under a later horizon
            keys = list(self._prunable)
            self._prunable = set()
            for i in range(0, len(keys), 500):
                chunk = keys[i:i + 500]
                self._prune_sql(before_version, chunk)
                self._prunable |= self._shrinkable(chunk)
        self._oldest = max(self._oldest, before_version)
        self._meta_set(b"oldest", self._oldest)

    def _shrinkable(self, keys):
        scope = "" if keys is None else \
            f" WHERE k IN ({','.join('?' * len(keys))})"
        q = ("SELECT k FROM kvv" + scope +
             " GROUP BY k HAVING COUNT(*) > 1 OR SUM(val IS NULL) > 0")
        return {bytes(r[0]) for r in self._conn.execute(q, list(keys or []))}

    def _prune_sql(self, before_version, keys):
        scope = "" if keys is None else \
            f" AND k IN ({','.join('?' * len(keys))})"
        args = [] if keys is None else list(keys)
        # rows strictly below their chain's base at the horizon
        self._conn.execute(
            "DELETE FROM kvv WHERE v < ?" + scope +
            " AND v < (SELECT MAX(v) FROM kvv b WHERE b.k = kvv.k"
            "          AND b.v <= ?)",
            [before_version] + args + [before_version])
        # lone tombstone bases below the horizon
        self._conn.execute(
            "DELETE FROM kvv WHERE v <= ? AND val IS NULL" + scope +
            " AND NOT EXISTS (SELECT 1 FROM kvv b WHERE b.k = kvv.k"
            "                 AND b.v > kvv.v)",
            [before_version] + args)

    # ── durability ──
    def commit(self, version):
        self._version = max(self._version, version)
        self._meta_set(b"version", self._version)
        self._conn.commit()

    def compact(self):
        self._conn.execute("PRAGMA wal_checkpoint(TRUNCATE)")

    def close(self):
        self._conn.commit()
        self._conn.close()
