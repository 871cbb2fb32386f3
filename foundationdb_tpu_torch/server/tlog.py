"""Transaction log: the ordered durable record of committed mutations.

Ref parity: fdbserver/TLogServer.actor.cpp — commit proxies push
version-ordered mutation batches; storage servers peek from their durable
version and pop what they have made durable. Durability is an optional
append-only file WAL of length+CRC-framed pickled records, fsynced per
push when asked (the reference fsyncs a DiskQueue).

``TLogSystem`` is the replicated tier (ref: TagPartitionedLogSystem):
k TLog replicas, a push acked once a quorum logged it, peeks merged
across live replicas, and recovery the union of the surviving WALs, so
losing a minority of logs loses no acked commit.

Tags (ref: the per-tag streams of TLogServer): a push may carry the
proxy's split of the batch by destination storage, ``{tag: [mutation]}``,
and ``peek(v, tag=t)`` then serves that storage's stream, every version
present (possibly empty) so cursors advance. The split lives in memory;
the WAL keeps the untagged batch, so a record recovered from the WAL
serves its full batch to every tag — conservative, never lossy.
"""

import bisect
import os
import pickle
import struct
import threading
import zlib


class TLogDown(Exception):
    """This log replica is dead."""


def _frame(record):
    """One WAL record: >II (length, crc32) then the pickle."""
    payload = pickle.dumps(record, protocol=4)
    return struct.pack(">II", len(payload), zlib.crc32(payload)) + payload


def read_frames(path):
    """The intact records of a framed file, stopping at a torn or
    corrupt tail (a crash mid-append)."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except FileNotFoundError:
        return
    off = 0
    while off + 8 <= len(data):
        ln, crc = struct.unpack_from(">II", data, off)
        if off + 8 + ln > len(data):
            return  # torn tail
        payload = data[off + 8: off + 8 + ln]
        if zlib.crc32(payload) != crc:
            return
        yield pickle.loads(payload)
        off += 8 + ln


class TLog:
    def __init__(self, wal_path=None, fsync=False):
        self._log = []  # [(version, mutations)] in version order
        self._tags = {}  # version -> {tag: [mutations]} (memory only)
        self._first_version = 0
        self.wal_path = wal_path
        self.fsync = fsync
        self.alive = True
        self.pushes = 0
        self.mutations = 0
        self._wal = open(wal_path, "ab") if wal_path else None
        self._pop_holds = {}  # name -> version: keep records > version
        self._holds_mu = threading.Lock()
        # placement tag: the cluster stamps its primary region's id, the
        # region replicator its satellite replicas' remote id (None: no
        # regions configured)
        self.region = None
        # peekers park here instead of polling last_version
        self._data_cond = threading.Condition()

    def _wal_append(self, record):
        """A durable append (one framing for pushes and abort markers:
        recovery depends on them agreeing)."""
        if self._wal is None:
            return
        self._wal.write(_frame(record))
        self._wal.flush()
        if self.fsync:
            os.fsync(self._wal.fileno())

    def push(self, version, mutations, tags=None):
        """Append one batch; ``tags`` is its {tag: [mutations]} split by
        destination storage, or None (untagged)."""
        if not self.alive:
            raise TLogDown()
        if self._log and version <= self._log[-1][0]:
            raise ValueError("tlog push out of order")
        self._log.append((version, mutations))
        if tags is not None:
            self._tags[version] = tags
        self._wal_append((version, mutations))
        self.pushes += 1
        self.mutations += len(mutations)
        with self._data_cond:
            self._data_cond.notify_all()

    def wait_for_version(self, version, timeout):
        """Park until a record at or after ``version`` exists (or the
        timeout). Death and close wake waiters at once."""
        with self._data_cond:
            return self._data_cond.wait_for(
                lambda: self.last_version >= version or not self.alive,
                timeout=timeout)

    def kill(self):
        """Process death: parked waiters see the dead log now."""
        self.alive = False
        with self._data_cond:
            self._data_cond.notify_all()

    def rollback(self, version):
        """Undo a just-pushed tail record that missed its replication
        quorum: drop it from the live log and append an abort marker so
        that WAL recovery drops it too (else it would come back at
        recovery after later commits were applied without it)."""
        if not self.alive:
            raise TLogDown()
        if self._log and self._log[-1][0] == version:
            self._log.pop()
            self._tags.pop(version, None)
            self._wal_append(("abort", version))

    def peek(self, from_version, tag=None):
        """All records with version > from_version, in order; with
        ``tag``, each record carries only that tag's mutations (a record
        pushed untagged, as a recovered one, its whole batch)."""
        if not self.alive:
            raise TLogDown()
        # one snapshot: pop() swaps the list on the commit thread
        log = self._log
        recs = log[bisect.bisect_right(log, from_version,
                                       key=lambda r: r[0]):]
        if tag is None:
            return recs
        tags = self._tags
        return [(v, tags[v].get(tag, []) if v in tags else m)
                for v, m in recs]

    def hold_pop(self, name, version):
        """Register a peek cursor: records newer than ``version`` survive
        pop until the holder advances or releases."""
        with self._holds_mu:
            self._pop_holds[name] = version

    def release_pop(self, name):
        with self._holds_mu:
            self._pop_holds.pop(name, None)

    def pop(self, up_to_version):
        """Discard records <= up_to_version (durable downstream), clamped
        so no registered cursor loses unread records."""
        with self._holds_mu:
            holds = list(self._pop_holds.values())
        if holds:
            up_to_version = min(up_to_version, *holds)
        self._log = [(v, m) for v, m in self._log if v > up_to_version]
        if self._tags:
            self._tags = {v: t for v, t in self._tags.items()
                          if v > up_to_version}
        self._first_version = max(self._first_version, up_to_version)

    @property
    def last_version(self):
        return self._log[-1][0] if self._log else self._first_version

    def status(self):
        return {"alive": self.alive, "region": self.region,
                "retained_records": len(self._log),
                "last_version": self.last_version, "pushes": self.pushes,
                "mutations": self.mutations}

    def close(self):
        self.alive = False
        with self._data_cond:
            self._data_cond.notify_all()
        if self._wal is not None:
            self._wal.close()
            self._wal = None

    @staticmethod
    def recover(wal_path):
        """Replay a WAL file → [(version, mutations)], tolerating a torn
        tail (ref: DiskQueue recovery)."""
        out = []
        for rec in read_frames(wal_path):
            if rec[0] == "abort":
                # the marker undoes the PRECEDING record of that version
                # only: a later re-grant of the number is a valid record
                for i in range(len(out) - 1, -1, -1):
                    if out[i][0] == rec[1]:
                        del out[i]
                        break
            else:
                out.append(rec)
        return out


class TLogSystem:
    """k replicated TLogs with quorum-acked pushes, behind the one-TLog
    interface (ref: TagPartitionedLogSystem). With a majority quorum
    (the default), any surviving majority holds every acked commit."""

    def __init__(self, n=3, wal_path=None, fsync=False, quorum=None):
        self.n = n
        self.quorum = quorum if quorum is not None else n // 2 + 1
        self.wal_path = wal_path  # base path; replica i appends .i
        self.logs = [TLog(wal_path=p, fsync=fsync)
                     for p in (self.replica_paths(wal_path, n) if wal_path
                               else [None] * n)]
        self._data_cond = threading.Condition()

    @staticmethod
    def replica_paths(wal_path, n):
        return [f"{wal_path}.{i}" for i in range(n)]

    # ── replica lifecycle ──
    def kill(self, i):
        self.logs[i].kill()
        with self._data_cond:
            self._data_cond.notify_all()

    def revive(self, i):
        """A rebooted replica rejoins caught up from a live peer. Without
        a live donor it stays dead and returns None: rejoining with a gap
        would make merged peeks lose acked records."""
        log = self.logs[i]
        donor = next((d for d in self.logs if d.alive and d is not log),
                     None)
        if donor is None:
            return None
        log.alive = True
        log._log = []
        log._tags = {}
        log._first_version = donor._first_version
        for v, m in donor.peek(0):
            log.push(v, m, tags=donor._tags.get(v))
        return log

    @property
    def live_count(self):
        return sum(1 for log in self.logs if log.alive)

    # ── the one-TLog interface ──
    @property
    def _first_version(self):
        if self.live_count == 0:
            raise TLogDown("no live tlog replicas")
        return min(log._first_version for log in self.logs if log.alive)

    @_first_version.setter
    def _first_version(self, v):
        for log in self.logs:
            log._first_version = v

    def push(self, version, mutations, tags=None):
        """Replicate to every live log; durable at ``quorum`` acks.
        Raises TLogDown when a quorum is unreachable, after rolling the
        partial replicas back (abort-marked in their WALs); the proxy
        answers commit_unknown_result."""
        accepted = []
        for log in self.logs:
            try:
                log.push(version, mutations, tags=tags)
                accepted.append(log)
            except TLogDown:
                continue
        if len(accepted) < self.quorum:
            for log in accepted:  # best-effort undo of the partial push
                try:
                    log.rollback(version)
                except TLogDown:
                    pass
            raise TLogDown(
                f"{len(accepted)}/{self.n} tlogs acked (need {self.quorum})")
        with self._data_cond:
            self._data_cond.notify_all()

    def wait_for_version(self, version, timeout):
        with self._data_cond:
            return self._data_cond.wait_for(
                lambda: self.live_count == 0 or self.last_version >= version,
                timeout=timeout)

    def peek(self, from_version, tag=None):
        """The union of the live replicas' records (an acked record is
        on at least a quorum of them), of ``tag`` only if given."""
        merged = {}
        for log in self.logs:
            if log.alive:
                for v, m in log.peek(from_version, tag=tag):
                    merged.setdefault(v, m)
        return sorted(merged.items(), key=lambda r: r[0])

    def hold_pop(self, name, version):
        for log in self.logs:
            log.hold_pop(name, version)

    def release_pop(self, name):
        for log in self.logs:
            log.release_pop(name)

    def pop(self, up_to_version):
        for log in self.logs:
            if log.alive:
                log.pop(up_to_version)

    @property
    def alive(self):
        """A quorum of replicas is live (pushes can be acked)."""
        return self.live_count >= self.quorum

    @property
    def last_version(self):
        if self.live_count == 0:
            raise TLogDown("no live tlog replicas")
        return max(log.last_version for log in self.logs if log.alive)

    def status(self):
        return {"alive": self.alive, "replicas": [log.status()
                                                   for log in self.logs]}

    def close(self):
        for log in self.logs:
            log.close()
        with self._data_cond:
            self._data_cond.notify_all()

    @classmethod
    def recover(cls, wal_path, n):
        """Union the replica WALs → [(version, mutations)]. A record on
        only a minority was never acked (its client saw 1021), so
        including it is the legal outcome."""
        merged = {}
        for path in cls.replica_paths(wal_path, n):
            for v, m in TLog.recover(path):
                merged.setdefault(v, m)
        return sorted(merged.items(), key=lambda r: r[0])
