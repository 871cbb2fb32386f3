r"""Continuous consistency scan: the cluster audits its own data.

Ref parity: fdbserver/ConsistencyScan.actor.cpp — the reference runs a
dedicated, rate-limited ConsistencyScan role that walks the shard map
forever in bounded batches, reading every replica of every shard at a
pinned version and comparing exactly, persisting its cursor in the
system keyspace so rounds resume across recoveries. (The one-shot
ConsistencyCheck workload — ``server/consistency.py`` here — shares the
same comparison core; this module owns that core so there is exactly
one code path that decides "do these replicas agree".)

Jiffy's snapshot-batched traversal (PAPERS.md) is the scan shape: each
batch reads at ONE pinned read version via the storage shard-copy
surface (``read_range`` — the same heatmap-exempt path data
distribution's fetchKeys uses; the storage sampler never fires on it,
so scanning cannot pollute workload heat), writers are never blocked,
and the pin only lives for a single bounded batch so the MVCC window
stays small.

Four properties the scanner guarantees:

* **No false positives from movement.** A batch that observes replica
  divergence re-reads ONCE against the LIVE shard map at a fresh
  pinned version before declaring corruption — a concurrent
  split/move/recruitment leaves a replica legitimately mid-copy at the
  first pinned version, and the re-read sees the settled truth.
  Availability problems (dead/unreadable replicas mid-recovery) are
  never counted as inconsistencies at all — they retry on a later
  batch.
* **Recovery-proof progress.** The cursor + round count persist in
  ``\xff/consistencyScan/`` through the normal commit pipeline (the
  ``persist_shard_map`` idiom: tlog-durable, recovered like user
  data), and the stats live in the cluster-owned
  ("consistency_scan", 0) registry — a txn-system recovery or a full
  restart resumes the round instead of rewinding it.
* **Deterministic cadence.** ``maybe_scan()`` rides the injected clock
  with jitter from the named "consistency-scan" stream under a
  single-driver protocol: thread-mode clusters drive it from a daemon
  loop, other pipelines pump it on their own schedule — never both.
* **Bounded cost.** ``consistency_scan_batch_keys`` bounds one batch,
  ``scan_rate_bytes_per_s`` defers the next batch until the last one's
  bytes have drained, and ``set_enabled(False)`` is the module kill
  switch; the status doc stays readable when disabled.
"""

import collections
import threading

from foundationdb_tpu_torch.core import deterministic
from foundationdb_tpu_torch.utils.trace import SEV_ERROR, SEV_WARN, TraceEvent

SYSTEM_END = b"\xff\xff"  # past user + system keys (engine meta excluded)

# scan position rows: plain system keyspace (replicated everywhere,
# tlog-durable, WAL-recovered) — NOT the virtual \xff\xff space
CURSOR_KEY = b"\xff/consistencyScan/cursor"
ROUND_KEY = b"\xff/consistencyScan/round"

_enabled = True
_enabled_mu = threading.Lock()


def set_enabled(on):
    """Process-wide scanner kill switch (``Cluster.set_consistency_scan``
    flips it). The scan document stays readable either way."""
    global _enabled
    with _enabled_mu:
        _enabled = bool(on)


def enabled():
    return _enabled


# ── the one batch-compare code path ──────────────────────────────────
# (errors ⊇ divergence: availability problems — dead or unreadable
# replicas — appear only in errors; divergence holds the strings where
# two readable replicas actually disagreed about the data)
BatchResult = collections.namedtuple(
    "BatchResult", "errors divergence keys bytes next_key"
)


def _read_replica(cluster, shard_idx, sid, begin, end, version, limit,
                  errors):
    s = cluster.storages[sid]
    try:
        return s.read_range(begin, end, version, limit=limit)
    except Exception as e:
        # the error lands in the report AND the trace stream: a check's
        # caller may summarize away the detail
        TraceEvent("ConsistencyCheckReadError",
                   severity=SEV_ERROR).detail(
            shard=shard_idx, storage=sid, version=version,
            etype=type(e).__name__, error=str(e)[:200]).log()
        errors.append(
            f"shard {shard_idx} replica {sid} unreadable at "
            f"v{version}: {e}"
        )
        return None


def compare_shard_batch(cluster, shard_idx, begin, end, team, version,
                        limit=None):
    """Read [begin, end) at the pinned ``version`` from every live
    replica in ``team`` and compare exactly — the single comparison
    core shared by the continuous scanner and the one-shot
    ``consistency_check``.

    The first cleanly-readable replica is the reference: its rows pin
    the batch's key window, and when ``limit`` truncates the read,
    every OTHER replica is compared over exactly [begin, last_ref_key)
    — never a limit-truncated tail of its own — so batch boundaries
    can't fabricate missing/extra keys. ``next_key`` is where the next
    batch resumes (None when the reference covered the whole range).
    """
    errors, divergence = [], []
    n_storages = len(cluster.storages)
    live = [sid for sid in team
            if 0 <= sid < n_storages and cluster.storages[sid].alive]
    if not live:
        errors.append(
            f"shard {shard_idx} [{begin!r}, {end!r}) has no live replica"
        )
        return BatchResult(errors, divergence, 0, 0, None)
    ref_sid = ref_rows = None
    rest = []
    for sid in live:
        if ref_sid is not None:
            rest.append(sid)
            continue
        rows = _read_replica(cluster, shard_idx, sid, begin, end,
                             version, limit, errors)
        if rows is not None:
            ref_sid, ref_rows = sid, rows
    if ref_sid is None:
        return BatchResult(errors, divergence, 0, 0, None)
    if limit is not None and len(ref_rows) >= limit:
        batch_end = ref_rows[-1][0] + b"\x00"
        next_key = batch_end
    else:
        batch_end, next_key = end, None
    keys = len(ref_rows)
    nbytes = sum(len(k) + len(v) for k, v in ref_rows)
    for sid in rest:
        rows = _read_replica(cluster, shard_idx, sid, begin, batch_end,
                             version, None, errors)
        if rows is None:
            continue
        nbytes += sum(len(k) + len(v) for k, v in rows)
        if rows == ref_rows:
            continue
        ref_map, got_map = dict(ref_rows), dict(rows)
        missing = sorted(set(ref_map) - set(got_map))[:3]
        extra = sorted(set(got_map) - set(ref_map))[:3]
        diff = sorted(
            k for k in set(ref_map) & set(got_map)
            if ref_map[k] != got_map[k]
        )[:3]
        msg = (
            f"shard {shard_idx} [{begin!r}, {batch_end!r}) replicas "
            f"{ref_sid} vs {sid} diverge at v{version}: "
            f"missing={missing} extra={extra} differing={diff}"
        )
        errors.append(msg)
        divergence.append(msg)
    return BatchResult(errors, divergence, keys, nbytes, next_key)


class ConsistencyScanner:
    """Cluster-owned background replica auditor. Pull-based like the
    LatencyProber: ``maybe_scan()`` fires at most one bounded batch per
    knob interval off the injected clock; thread-mode clusters drive it
    from a daemon loop, sims/tests call it from their own schedule."""

    MAX_ERROR_SAMPLE = 8  # confirmed-inconsistency strings retained

    def __init__(self, cluster):
        self.cluster = cluster
        reg = cluster._role_registry("consistency_scan")
        self._m_rounds = reg.counter("scan_rounds")
        self._m_batches = reg.counter("scan_batches")
        self._m_keys = reg.counter("scan_keys")
        self._m_bytes = reg.counter("scan_bytes")
        self._m_inconsistencies = reg.counter("scan_inconsistencies")
        # divergences the live-map re-read dismissed: each one is a
        # concurrent split/move that would have been a false positive
        self._m_reread_saves = reg.counter("scan_reread_saves")
        self._m_round_ms = reg.gauge("scan_last_round_ms")
        # jittered cadence off the named deterministic stream: same-seed
        # runs draw the same batches at the same steps
        self._rng = deterministic.rng("consistency-scan")
        self._next_due = None
        self._cursor = b""
        self._round_started = None
        self._started_at = deterministic.now()
        self._last_round_at = None
        self.last_error = None
        self.errors = []  # bounded confirmed-inconsistency sample
        self._stop = threading.Event()
        self._thread = None

    # ── persistence (recovery-proof cursor) ──────────────────────────
    def restore_cursor(self):
        """Re-load the persisted scan position after recovery/restart
        (the registry counters survive recovery by themselves; a full
        restart rebuilds them, so the round count persists too)."""
        s0 = self.cluster.storages[0]
        row = s0.get(CURSOR_KEY, s0.version)
        if row is not None:
            self._cursor = row
        row = s0.get(ROUND_KEY, s0.version)
        if row is not None:
            try:
                behind = int(row) - self._m_rounds.value
            except ValueError:
                behind = 0
            if behind > 0:
                self._m_rounds.inc(behind)

    def _persist_cursor(self):
        """Write cursor + round count to \\xff/consistencyScan/ through
        the normal commit pipeline (the persist_shard_map idiom).
        Best-effort: a failed system commit leaves the previous
        position; the next batch retries."""
        from foundationdb_tpu_torch.core.mutations import Mutation, Op
        from foundationdb_tpu_torch.core.commit import CommitRequest

        req = CommitRequest(
            read_version=self.cluster.sequencer.committed_version,
            mutations=[
                Mutation(Op.SET, CURSOR_KEY, self._cursor),
                Mutation(Op.SET, ROUND_KEY,
                         b"%d" % self._m_rounds.value),
            ],
            read_conflict_ranges=[], write_conflict_ranges=[],
        )
        try:
            result = self.cluster.commit_proxy.commit(req)
        except Exception:
            return False
        return not isinstance(result, Exception)

    # ── cadence ──────────────────────────────────────────────────────
    def maybe_scan(self):
        """Run one bounded batch if the interval elapsed; returns True
        iff a batch ran. The rate budget stretches the next due time so
        sustained read throughput stays under scan_rate_bytes_per_s."""
        if not enabled() or not self.cluster.knobs.consistency_scan_enabled:
            return False
        interval = self.cluster.knobs.consistency_scan_interval_s
        now = deterministic.now()
        if self._next_due is None:
            # first call arms the schedule with a jittered offset so a
            # fleet of scanners never thunders in step
            self._next_due = now + interval * self._rng.random()
            return False
        if now < self._next_due:
            return False
        self._next_due = now + interval * (0.5 + self._rng.random())
        batch_bytes = self.scan_step()
        rate = self.cluster.knobs.scan_rate_bytes_per_s
        if rate > 0 and batch_bytes:
            self._next_due = max(self._next_due,
                                 now + batch_bytes / rate)
        return True

    # ── one batch ────────────────────────────────────────────────────
    def scan_step(self):
        """One bounded batch at one pinned version: compare the owning
        team's replicas over the cursor's shard, re-read divergence
        against the live map, advance + persist the cursor. Returns the
        bytes read (rate accounting); never raises — a scan must never
        take the cluster down, and failures mid-recovery simply retry
        on a later fire."""
        cluster = self.cluster
        try:
            if self._round_started is None:
                self._round_started = deterministic.now()
            version = cluster.sequencer.committed_version
            smap = cluster.dd.map
            cursor = self._cursor
            i = smap.shard_index(cursor)
            shard_begin, shard_end = smap.shard_range(i)
            end = SYSTEM_END if shard_end is None else shard_end
            begin = max(cursor, shard_begin)
            res = compare_shard_batch(
                cluster, i, begin, end, smap.teams[i], version,
                limit=cluster.knobs.consistency_scan_batch_keys,
            )
            self._m_batches.inc()
            self._m_keys.inc(res.keys)
            self._m_bytes.inc(res.bytes)
            confirmed = []
            if res.divergence:
                confirmed = self._recheck(begin, res.next_key or end)
            if confirmed:
                self._m_inconsistencies.inc(len(confirmed))
                self.errors = (self.errors
                               + confirmed)[-self.MAX_ERROR_SAMPLE:]
                for msg in confirmed:
                    TraceEvent("ConsistencyScanCorruption",
                               severity=SEV_ERROR).detail(
                        error=msg[:300]).log()
            if res.next_key is not None:
                new_cursor = res.next_key
            elif shard_end is None:
                new_cursor = None  # past the last shard
            else:
                new_cursor = shard_end
            if new_cursor is None or new_cursor >= SYSTEM_END:
                self._finish_round()
            else:
                self._cursor = new_cursor
            self._persist_cursor()
            self.last_error = None
            return res.bytes
        except Exception as e:
            self.last_error = f"{type(e).__name__}: {str(e)[:200]}"
            TraceEvent("ConsistencyScanStepError",
                       severity=SEV_WARN).detail(
                etype=type(e).__name__, error=str(e)[:200]).log()
            return 0

    def _recheck(self, begin, end):
        """The false-positive guard: re-read [begin, end) ONCE against
        the LIVE shard map at a fresh pinned version before declaring
        corruption. A concurrent split/move leaves a replica
        legitimately mid-copy at the first pinned version; real
        corruption survives the re-read. Unconfirmable (unreadable
        mid-recovery) divergence is dismissed too — the range rescans
        on a later round."""
        cluster = self.cluster
        try:
            version = cluster.sequencer.committed_version
            smap = cluster.dd.map
            confirmed = []
            for j in smap.shards_overlapping(begin, end):
                b, e = smap.shard_range(j)
                e = SYSTEM_END if e is None else e
                res = compare_shard_batch(
                    cluster, j, max(b, begin), min(e, end),
                    smap.teams[j], version,
                )
                confirmed.extend(res.divergence)
            if not confirmed:
                self._m_reread_saves.inc()
            return confirmed
        except Exception:
            self._m_reread_saves.inc()
            return []

    def _finish_round(self):
        now = deterministic.now()
        started = (self._round_started
                   if self._round_started is not None else now)
        self._m_round_ms.set(round((now - started) * 1000, 3))
        self._m_rounds.inc()
        self._round_started = None
        self._last_round_at = now
        self._cursor = b""

    # ── background driver (thread-mode clusters only) ────────────────
    def start(self):
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="consistency-scan", daemon=True
        )
        self._thread.start()

    def _loop(self):
        interval = self.cluster.knobs.consistency_scan_interval_s
        while not self._stop.wait(interval):
            try:
                self.maybe_scan()
            except Exception as e:
                # the scanner must never take the cluster down — but a
                # broken scan is forensics-worthy, not silence
                TraceEvent("ConsistencyScanLoopError",
                           severity=SEV_ERROR).detail(error=repr(e))
                self.last_error = repr(e)

    def stop(self):
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5)

    # ── reporting ────────────────────────────────────────────────────
    def status(self):
        """The ``cluster.consistency_scan`` document — JSON-safe and
        byte-identical across same-seed sims (cursor as hex, every
        stamp off the injected clock)."""
        smap = self.cluster.dd.map
        cursor = self._cursor
        progress = (
            round(smap.shard_index(cursor) * 100.0 / max(1, len(smap)), 2)
            if cursor else 0.0
        )
        # age of the last COMPLETED round (seconds, injected clock);
        # before any round completes, age since the scanner was built —
        # either way a stalled scanner's age grows and the doctor's
        # --scan-max-round-age-s SLO catches it
        now = deterministic.now()
        base = (self._last_round_at
                if self._last_round_at is not None else self._started_at)
        return {
            "enabled": enabled()
            and bool(self.cluster.knobs.consistency_scan_enabled),
            "round": self._m_rounds.value,
            "progress_pct": progress,
            "cursor": cursor.hex(),
            "batches": self._m_batches.value,
            "keys_scanned": self._m_keys.value,
            "bytes_scanned": self._m_bytes.value,
            "last_round_ms": self._m_round_ms.value,
            "round_age_s": round(now - base, 6),
            "inconsistencies": self._m_inconsistencies.value,
            "reread_saves": self._m_reread_saves.value,
            "last_error": self.last_error,
            "errors": list(self.errors),
        }
