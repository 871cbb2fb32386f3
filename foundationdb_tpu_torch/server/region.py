r"""Multi-region replication: region config, satellite log, failover.

Ref parity: the reference's region configuration (region blocks in
fdbclient/DatabaseConfiguration.cpp, satellite tlog recruitment in
masterserver/ClusterRecovery) and the fdbdr replication shape. Two
layers live here:

* ``RegionConfig`` — the parsed/validated ``configure regions=<json>``
  block (primary/remote region ids, satellite replica count, sync vs
  async satellite mode). The canonical JSON persists beside the
  replication factor in the ``\xff/conf/regions`` system row, so WAL
  recovery restores the region configuration like any other config.
* ``RegionReplicator`` — the CLUSTER-OWNED replication subsystem
  ``configure regions=...`` attaches: it owns the satellite log (a
  region-tagged ``TLog``/``TLogSystem`` with its own WAL), seeds it
  with a base snapshot, and keeps it caught up CONTINUOUSLY — no
  operator pump. In **sync** satellite mode the commit path calls
  ``sync_push`` before acknowledging each commit, so a regional
  disaster loses zero acked transactions; in **async** mode commits
  never wait on the WAN and the streamer drains the backlog on its own
  cadence (the lag is measured in versions AND milliseconds). The
  streamer runs as a daemon thread in a thread-pipeline cluster
  (``start()``); otherwise the caller drives ``maybe_stream()`` (off
  the injected clock of core/deterministic.py and its "region-stream"
  stream) or ``stream_now()``. A pop-hold on
  the primary log pins records until they replicate, so the satellite
  never gaps; a primary that recovered with a fresh log floor past our
  frontier marks the link ``broken`` loudly instead of tearing.
* **Automatic failover** rides ``Cluster.detect_and_recruit``: when
  every primary-region process is dead the cluster promotes the remote
  region IN PLACE through the ordinary recovery machinery
  (``Cluster._region_failover`` — generation CAS, satellite-log replay
  into fresh storages, fenced resolvers, new frontend) and the
  transition lands in the RecoveryTimeline under a ``region_failover``
  trigger. Note for full-process restarts: after a failover the
  cluster's durable log IS the satellite WAL.

``SecondaryRegion`` is the original operator-driven DR bolt-on, kept
as a thin manual wrapper over the same seed/drain helpers: ``pump()``
by hand, ``failover()`` into a brand-new cluster. The cluster-owned
subsystem above supersedes it for anything configured through
``configure regions=...``.
"""

import os
import threading

from foundationdb_tpu_torch.core import deterministic
from foundationdb_tpu_torch.core.errors import err
from foundationdb_tpu_torch.core.mutations import Mutation, Op
from foundationdb_tpu_torch.server.tlog import TLog, TLogDown, TLogSystem
from foundationdb_tpu_torch.utils import lockdep
from foundationdb_tpu_torch.utils.backoff import Backoff
from foundationdb_tpu_torch.utils.trace import (
    SEV_ERROR,
    SEV_WARN_ALWAYS,
    TraceEvent,
)

HOLD_NAME = "dr-secondary"


class RegionConfig:
    """Parsed ``configure regions=<json>`` block (ref: the region array
    of DatabaseConfiguration). Immutable; compares by value."""

    MODES = ("sync", "async")

    def __init__(self, primary, remote, satellites=1,
                 satellite_mode="async"):
        self.primary = str(primary)
        self.remote = str(remote)
        self.satellites = int(satellites)
        self.satellite_mode = str(satellite_mode)

    @classmethod
    def parse(cls, spec):
        """dict | JSON str/bytes → RegionConfig, validating every field
        (fdbcli hands the raw value through; a typo must fail the
        configure, not half-apply)."""
        import json

        if isinstance(spec, (bytes, bytearray)):
            spec = spec.decode()
        if isinstance(spec, str):
            try:
                spec = json.loads(spec)
            except ValueError:
                raise err("invalid_option_value")
        if isinstance(spec, cls):
            return spec
        if not isinstance(spec, dict):
            raise err("invalid_option_value")
        primary = spec.get("primary")
        remote = spec.get("remote")
        if not primary or not remote or primary == remote:
            raise err("invalid_option_value")
        try:
            satellites = int(spec.get("satellites", 1))
        except (TypeError, ValueError):
            raise err("invalid_option_value")
        if satellites < 1:
            raise err("invalid_option_value")
        mode = spec.get("satellite_mode", "async")
        if mode not in cls.MODES:
            raise err("invalid_option_value")
        unknown = set(spec) - {"primary", "remote", "satellites",
                               "satellite_mode"}
        if unknown:
            raise err("invalid_option_value")
        return cls(primary, remote, satellites, mode)

    def to_json(self):
        import json

        return json.dumps(
            {"primary": self.primary, "remote": self.remote,
             "satellites": self.satellites,
             "satellite_mode": self.satellite_mode},
            sort_keys=True,
        )

    def __eq__(self, other):
        return (isinstance(other, RegionConfig)
                and self.to_json() == other.to_json())

    def __ne__(self, other):
        return not self.__eq__(other)

    def __repr__(self):
        return f"RegionConfig({self.to_json()})"


# ── shared seed/drain machinery ──────────────────────────────────────
def seed_snapshot(primary_cluster, satellite_log, hold_name):
    """Base snapshot into the satellite log; returns the replication
    frontier (the snapshot's read version). A log-only satellite
    attached to a primary with prior history (a recovered log's floor
    is its recovery version) cannot reconstruct that history from the
    log — replication starts with a full copy, then tails (ref: fdbdr's
    initial range copy before mutation streaming). The snapshot rides
    as ONE synthetic log record at its read version; promotion replays
    it like any other record. The scan runs through the SYSTEM keyspace
    (end b"\\xff\\xff", matching storage_owned_ranges'
    everywhere-replicated treatment of [\\xff, \\xff\\xff)): the tailed
    log replicates system mutations, so the seed must carry the
    pre-attach system state too — tenant map/modes/quotas, lock uid,
    shard map — or the promoted cluster would hold data its own
    metadata has never heard of."""
    db = primary_cluster.database()
    tr = db.create_transaction()
    v = tr.get_read_version()
    muts = []
    begin = b""
    while True:
        rows = tr.get_range(begin, b"\xff\xff", limit=1000, snapshot=True)
        muts.extend(Mutation(Op.SET, k, val) for k, val in rows)
        if len(rows) < 1000:
            break
        begin = rows[-1][0] + b"\x00"
    if v > 0:
        satellite_log.push(v, muts)
    primary_cluster.tlog.hold_pop(hold_name, v)
    return v


def drain_log(primary_tlog, satellite_log, position, hold_name,
              up_to=None):
    """Copy primary records past ``position`` into the satellite, in
    version order, advancing the pop-hold as the frontier moves.
    Returns (records_copied, new_position, broken):

    * GAP check first: a primary that crashed and recovered comes back
      with a fresh log (floor = its recovery version) and our pop-hold
      gone — versions in (position, floor] are unobtainable, and
      silently tailing past them would promote a TORN database at
      failover. ``broken=True`` marks it loudly; the operator (or a
      restore-time re-seed) re-establishes replication.
    * ``up_to`` bounds the drain (sync mode copies through the commit
      being acknowledged and no further).
    * A dead primary log tier is retryable: (0, position, False).
    """
    try:
        if primary_tlog._first_version > position:
            TraceEvent("RegionReplicationGap", severity=SEV_ERROR).detail(
                frontier=position,
                primary_floor=primary_tlog._first_version,
            ).log()
            return 0, position, True
        records = primary_tlog.peek(position)
    except TLogDown:
        return 0, position, False
    n = 0
    for version, muts in records:
        if version <= position:
            continue
        if up_to is not None and version > up_to:
            break
        satellite_log.push(version, muts)
        position = version
        n += 1
    if n:
        primary_tlog.hold_pop(hold_name, position)
    return n, position, False


class RegionReplicator:
    """The cluster-owned replication subsystem behind ``configure
    regions=...``: satellite log ownership, the continuous streamer,
    sync-mode commit gating, and failover bookkeeping. See the module
    docstring for the full shape."""

    HOLD = "region-satellite"

    def __init__(self, cluster, config, wal_path=None):
        self.cluster = cluster
        self.config = config
        self.active = config.primary  # flips to remote on failover
        self.wal_path = wal_path
        if wal_path:
            os.makedirs(os.path.dirname(wal_path) or ".", exist_ok=True)
            # fresh attach/restore truncates stale satellite WALs: the
            # seed below re-establishes the full base, and stale
            # records merging under a recovered log would resurrect a
            # previous attachment's history
            for p in ([wal_path] if config.satellites == 1 else
                      TLogSystem.replica_paths(wal_path, config.satellites)):
                open(p, "wb").close()
        if config.satellites > 1:
            self.satellite = TLogSystem(config.satellites,
                                        wal_path=wal_path)
        else:
            self.satellite = TLog(wal_path=wal_path)
        for log in self._satellite_logs():
            log.region = config.remote
        self.position = 0
        self.partitioned = False
        self.broken = False
        self.dropped = False
        self.sync_misses = 0  # sync-mode commits acked WITHOUT the satellite
        self.failovers = 0
        self.failed_attempts = 0  # failover rounds lost to coordination
        self.last_failover_ms = 0.0
        # streamer state is shared between the commit path (sync_push
        # from the proxy's ordered finalize), the streamer (the caller's
        # schedule or the daemon loop below), and WAN fault injection —
        # one lock serializes the frontier
        self._mu = lockdep.lock("RegionReplicator._mu")
        # jittered cadence off the named deterministic stream: seeded
        # runs stream at the same times, real fleets de-align
        self._rng = deterministic.rng("region-stream")
        # one streamer at a time: the daemon loop in thread mode, the
        # caller's schedule otherwise
        # flowlint: shared(single-driver protocol: thread mode streams ONLY from the region-streamer daemon, sims ONLY from their scheduler — never both, one writer at a time)
        self._next_due = None
        self._caught_up_at = deterministic.now()
        self._stop = threading.Event()
        self._thread = None
        # pin the primary log from the start: records must survive
        # until the satellite has them (ref: satellite tlogs holding
        # the primary's mutation stream)
        cluster.tlog.hold_pop(self.HOLD, 0)
        self.position = seed_snapshot(cluster, self.satellite, self.HOLD)
        TraceEvent("RegionConfigured").detail(
            primary=config.primary, remote=config.remote,
            satellites=config.satellites, mode=config.satellite_mode,
            seed_version=self.position).log()

    def _satellite_logs(self):
        if isinstance(self.satellite, TLogSystem):
            return self.satellite.logs
        return [self.satellite]

    @property
    def replicating(self):
        """True while this subsystem is shipping primary → satellite
        (failover or drop ends the stream; the promoted region then
        OWNS the satellite log)."""
        return self.active == self.config.primary and not self.dropped

    # ── commit-path gating (sync satellite mode) ─────────────────────
    def sync_push(self, version, mutations):
        """Called by the commit proxy AFTER the primary log accepted
        the batch and BEFORE the commit is acknowledged (sync satellite
        mode only): drain the primary log through this version into the
        satellite, so every acked commit is already in the remote
        region. Backfills any gap left by a healed partition using the
        pinned primary records. Returns True iff the satellite holds
        this commit; a False (WAN partitioned / satellite dead) still
        ACKS the commit — the cluster degrades to async rather than
        stalling commits on the WAN — counted in ``sync_misses`` and
        surfaced by the doctor as degraded."""
        if self.config.satellite_mode != "sync" or not self.replicating:
            return False
        with self._mu:
            if self.partitioned or self.broken:
                self.sync_misses += 1
                return False
            try:
                _, self.position, self.broken = drain_log(
                    self.cluster.tlog, self.satellite, self.position,
                    self.HOLD, up_to=version,
                )
            except (TLogDown, ValueError):
                self.sync_misses += 1
                return False
            if self.broken or self.position < version:
                self.sync_misses += 1
                return False
            self._caught_up_at = deterministic.now()
            return True

    # ── continuous streamer ──────────────────────────────────────────
    def maybe_stream(self):
        """Drain once if the knob interval elapsed (pull-based); returns
        records copied. A caller's schedule calls this; thread-mode
        clusters call it from the daemon loop below."""
        if not self.replicating:
            return 0
        interval = self.cluster.knobs.region_stream_interval_s
        now = deterministic.now()
        if self._next_due is None:
            # first call arms the schedule with a jittered offset so a
            # fleet of streamers never thunders in step
            self._next_due = now + interval * self._rng.random()
            return 0
        if now < self._next_due:
            return 0
        self._next_due = now + interval * (0.5 + self._rng.random())
        return self.stream_now()

    def stream_now(self):
        """One unconditional drain round; returns records copied."""
        if not self.replicating:
            return 0
        with self._mu:
            if self.partitioned or self.broken:
                return 0
            n, self.position, self.broken = drain_log(
                self.cluster.tlog, self.satellite, self.position,
                self.HOLD,
            )
            if not self.broken and self.lag_versions() == 0:
                self._caught_up_at = deterministic.now()
            return n

    # ── lag measurement ──────────────────────────────────────────────
    def lag_versions(self):
        """How far behind the primary's committed frontier the
        satellite is — the bounded data loss a failover right now would
        accept (0 once promoted: the remote region IS the frontier)."""
        if not self.replicating:
            return 0
        return max(
            0, self.cluster.sequencer.committed_version - self.position
        )

    def lag_ms(self):
        """Replication lag in injected-clock milliseconds: how long the
        satellite has been behind (0 while caught up)."""
        if self.lag_versions() == 0:
            return 0.0
        return round(
            max(0.0, deterministic.now() - self._caught_up_at) * 1000, 3
        )

    # ── WAN fault / lifecycle ────────────────────────────────────────
    def partition(self):
        """The WAN fails: streaming (and sync-mode gating) become
        no-ops and the lag grows; the primary keeps committing."""
        self.partitioned = True
        TraceEvent("RegionPartitioned", severity=SEV_WARN_ALWAYS).detail(
            frontier=self.position).log()

    def heal(self):
        self.partitioned = False

    def drop(self):
        """Detach: release the log pin (otherwise the primary's log
        grows forever against a dead satellite) and stop the streamer."""
        self.dropped = True
        self.stop()
        try:
            self.cluster.tlog.release_pop(self.HOLD)
        except TLogDown:
            pass

    def close(self):
        """Stop the streamer and close the satellite log, unless a
        failover promoted it: then it is the cluster's log, which the
        cluster closes (the reference closes it here too, so that
        ``configure(regions="off")`` after a failover leaves its cluster
        without a log)."""
        self.stop()
        if self.active == self.config.primary:
            self.satellite.close()

    # ── failover bookkeeping (Cluster._region_failover drives it) ────
    def should_failover(self, cluster):
        """Primary-region loss: every primary process dead at once —
        sequencer, commit proxy, and the whole storage tier (a regional
        disaster). Partial failures stay on the
        ordinary recovery/recruitment path."""
        return (
            self.replicating
            and not self.broken
            and not cluster.sequencer.alive
            and not cluster._commit_target().alive
            and not any(s.alive for s in cluster.storages)
        )

    def promote_log(self):
        """Hand the satellite log to the promoted cluster: it becomes
        THE log (full history retained for storage replay; future
        commits append to it, so the satellite WAL is now the durable
        log). Streaming ends — the remote region is active."""
        self.active = self.config.remote
        self.stop()
        return self.satellite

    def note_failover(self, duration_ms):
        self.failovers += 1
        self.last_failover_ms = round(duration_ms, 3)
        TraceEvent("RegionFailover").detail(
            promoted=self.active, frontier=self.position,
            failover_ms=self.last_failover_ms).log()

    def note_failed_attempt(self, error):
        self.failed_attempts += 1
        TraceEvent("RegionFailoverFailed", severity=SEV_WARN_ALWAYS).detail(
            attempt=self.failed_attempts, error=repr(error)).log()

    # ── background streamer (thread-mode clusters only) ──────────────
    def start(self):
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="region-streamer", daemon=True
        )
        self._thread.start()

    def _loop(self):
        interval = self.cluster.knobs.region_stream_interval_s
        # heal-retry: a drain that keeps failing (WAN flapping, satellite
        # log mid-restart) widens the retry spacing instead of hammering
        # at the stream cadence; one clean round snaps it back
        retry = Backoff(initial_s=interval, max_s=max(interval * 8, 1.0))
        wait_s = interval
        while not self._stop.wait(wait_s):
            try:
                self.maybe_stream()
                retry.reset()
                wait_s = interval
            except Exception as e:
                # the streamer must never take the cluster down — but a
                # broken drain is forensics-worthy, not silence
                TraceEvent("RegionStreamError", severity=SEV_ERROR) \
                    .detail(error=repr(e)).log()
                wait_s = retry.delay()

    def stop(self):
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5)

    # ── reporting (cluster.regions status + cluster.health) ──────────
    def status(self):
        """The ``cluster.regions`` document (pure read)."""
        cfg = self.config
        return {
            "configured": True,
            "primary": cfg.primary,
            "remote": cfg.remote,
            "active": self.active,
            "satellite_mode": cfg.satellite_mode,
            "satellites": cfg.satellites,
            "connected": not self.partitioned and not self.broken,
            "broken": self.broken,
            "replication_lag_versions": self.lag_versions(),
            "replication_lag_ms": self.lag_ms(),
            "sync_misses": self.sync_misses,
            "failovers": self.failovers,
            "failed_failover_attempts": self.failed_attempts,
            "last_failover_ms": self.last_failover_ms,
        }


class SecondaryRegion:
    """The original operator-pumped DR shape, kept for manual
    deployments: ``pump()`` by hand (or an operator loop), explicit
    ``partition()``/``heal()``, and ``failover()`` promoting into a
    brand-NEW cluster recovered from the satellite WAL. The cluster-
    owned ``RegionReplicator`` above supersedes this for anything
    attached through ``configure regions=...`` — continuous streaming,
    sync-mode commit gating, in-place automatic failover."""

    def __init__(self, primary_cluster, wal_path):
        self.primary = primary_cluster
        self.wal_path = wal_path
        os.makedirs(os.path.dirname(wal_path) or ".", exist_ok=True)
        self.tlog = TLog(wal_path=wal_path)
        self.position = 0  # replication frontier (last version applied)
        self.partitioned = False
        self.broken = False  # continuity gap detected (see drain_log)
        self._dropped = False
        # pin the primary log from the start: records must survive until
        # the satellite has them (ref: satellite tlogs holding the
        # primary's mutation stream)
        self.primary.tlog.hold_pop(HOLD_NAME, self.position)
        self.position = seed_snapshot(self.primary, self.tlog, HOLD_NAME)

    # ── replication (pumped) ──
    def pump(self):
        """Pull everything the primary has committed past our frontier.
        Returns the number of records replicated this round."""
        if self.partitioned or self._dropped or self.broken:
            return 0
        n, self.position, broken = drain_log(
            self.primary.tlog, self.tlog, self.position, HOLD_NAME
        )
        if broken:
            self.broken = True
        return n

    def lag_versions(self):
        """How far behind the primary's committed frontier we are — the
        bounded data loss a failover right now would accept."""
        return max(
            0, self.primary.sequencer.committed_version - self.position
        )

    # ── WAN fault / lifecycle ──
    def partition(self):
        self.partitioned = True
        TraceEvent("RegionPartitioned", severity=SEV_WARN_ALWAYS).detail(
            frontier=self.position).log()

    def heal(self):
        self.partitioned = False

    def reattach(self, new_primary):
        """Point at a new primary incarnation (crash/recovery swapped
        the cluster object). Gap detection on the next pump decides
        whether continuity survived — a satellite that was fully caught
        up resumes cleanly; one that was behind marks itself broken."""
        self.primary = new_primary
        if not self._dropped:
            self.primary.tlog.hold_pop(HOLD_NAME, self.position)

    def drop(self):
        """Primary abandons DR: release the log pin (otherwise the
        primary's log grows forever against a dead satellite)."""
        self._dropped = True
        try:
            self.primary.tlog.release_pop(HOLD_NAME)
        except TLogDown:
            pass

    # ── failover ──
    def failover(self, **cluster_kwargs):
        """Promote this region to a full cluster (ref: forced region
        failover). Recovery replays the satellite WAL — the promoted
        database is exactly the primary's state at the replication
        frontier; the lag at disaster time is the accepted loss.
        Returns the promoted Cluster; ``cluster_kwargs`` go to it (it
        runs on the card unless they say ``device="cpu"``)."""
        from foundationdb_tpu_torch.server.cluster import Cluster

        if self.broken:
            raise RuntimeError(
                "replication gap: this satellite lost continuity "
                "(RegionReplicationGap) — re-seed DR before failing over"
            )
        self.tlog.close()  # flush the WAL handle before recovery reads it
        lost = self.lag_versions() if not self.partitioned else None
        promoted = Cluster(wal_path=self.wal_path, **cluster_kwargs)
        TraceEvent("RegionFailover").detail(
            frontier=self.position,
            lag_at_failover=lost if lost is not None else "partitioned",
        ).log()
        return promoted
