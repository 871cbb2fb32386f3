r"""Cluster doctor: latency probes, recovery timeline, health verdict.

Ref parity: the health layer of fdbserver/Status.actor.cpp —
``latencyProbe`` (status runs REAL transactions against the cluster and
reports how long GRV/read/commit took), ``recovery_state`` (the named
phase the master recovery is in), and ``cluster.messages`` (the
machine-checkable alert list operators and watchdogs key off).

Three pieces, all cluster-owned so they survive txn-system recoveries:

* ``LatencyProber`` — periodically runs a tagged probe transaction
  (GRV → point read → commit on ``\xff/probe/latency``) against the
  live cluster and records per-hop latency bands into the cluster's
  ("prober", 0) registry. The probe key lives in the plain system
  keyspace (NOT the virtual \xff\xff space), so the probe exercises the
  full commit pipeline — sequencer, resolver, tlog, storage — while the
  storage read sampler's ``key < \xff`` guard keeps it out of workload
  heatmaps. Cadence rides the injected deterministic clock with jitter
  from the named "latency-probe" stream: same-seed
  sims fire the same probes at the same steps.
* ``RecoveryTimeline`` — a bounded ring of per-recovery phase
  breakdowns (fence → coordinator CAS → recruit → tlog replay →
  accept-commits), stamped off the deterministic clock. Simulations
  install ``cluster.clock_advance`` so each phase consumes simulated
  time and same-seed runs agree byte-for-byte.
* ``build_health`` — folds lag/saturation rollups (storage durability
  lag, tlog queue depth, GRV queue depth, per-reason ratekeeper denial
  counters) with the prober and timeline into one ``cluster.health``
  doc carrying a doctor verdict (``healthy | degraded | unavailable``),
  sorted reasons, and FDB-style ``messages``.

``set_enabled(False)`` is the module kill switch: the prober stops
firing and
``maybe_probe`` becomes a cheap no-op; the health DOC stays readable —
turning off probes must not blind the doctor.
"""

import threading

from foundationdb_tpu_torch.core import deterministic
from foundationdb_tpu_torch.core.errors import FDBError

# the probe row: plain system keyspace (replicated everywhere, excluded
# from heatmaps by the storage sampler's key < \xff guard), never the
# virtual \xff\xff space — a probe must pay the REAL commit pipeline
PROBE_KEY = b"\xff/probe/latency"
PROBE_TAG = "probe"

_enabled = True
_enabled_mu = threading.Lock()


def set_enabled(on):
    """Process-wide prober kill switch. The health document stays
    readable either way."""
    global _enabled
    with _enabled_mu:
        _enabled = bool(on)


def enabled():
    return _enabled


class LatencyProber:
    """Live GRV/read/commit probe transactions (ref: Status.actor.cpp
    latencyProbe). Pull-based: ``maybe_probe()`` fires at most once per
    knob interval off the injected clock; thread-mode clusters drive it
    from a daemon loop, sims/tests call it from their own schedule."""

    def __init__(self, cluster):
        self.cluster = cluster
        reg = cluster._role_registry("prober")
        self._m_grv = reg.latency("probe_grv")
        self._m_read = reg.latency("probe_read")
        self._m_commit = reg.latency("probe_commit")
        self._m_probes = reg.counter("probes")
        self._m_failures = reg.counter("probe_failures")
        # jittered cadence off the named deterministic stream: same-seed
        # runs draw the same offsets, real fleets de-align
        self._rng = deterministic.rng("latency-probe")
        self._next_due = None
        self.last_error = None  # last failed probe's error code
        self._stop = threading.Event()
        self._thread = None

    # ── cadence ──────────────────────────────────────────────────────
    def maybe_probe(self):
        """Fire one probe if the interval elapsed; returns True iff a
        probe ran (successfully or not)."""
        if not enabled() or not self.cluster.knobs.health_probe_enabled:
            return False
        interval = self.cluster.knobs.health_probe_interval_s
        now = deterministic.now()
        if self._next_due is None:
            # first call arms the schedule with a jittered offset so a
            # fleet of probers never thunders in step
            self._next_due = now + interval * self._rng.random()
            return False
        if now < self._next_due:
            return False
        self._next_due = now + interval * (0.5 + self._rng.random())
        self.probe_now()
        return True

    def probe_now(self):
        """One probe transaction: GRV, point read, commit — each hop
        timed off the injected clock. Lock-aware (a locked database is
        not an unhealthy one) and tagged so workload attribution can
        separate probe traffic; returns True on success."""
        tr = self.cluster.database().create_transaction()
        tr.options.set_tag(PROBE_TAG)
        tr.options.set_lock_aware()
        t0 = deterministic.now()
        try:
            tr.get_read_version()
            t1 = deterministic.now()
            tr.get(PROBE_KEY)
            t2 = deterministic.now()
            # deterministic payload: the probe sequence number
            tr.set(PROBE_KEY, b"%d" % self._m_probes.value)
            tr.commit()
            t3 = deterministic.now()
        except FDBError as e:
            # a failing probe IS the signal: count it and move on (the
            # doctor reads probe_failures; retrying here would hide the
            # outage the probe exists to witness)
            self._m_probes.inc()
            self._m_failures.inc()
            self.last_error = e.code
            return False
        self._m_probes.inc()
        self.last_error = None
        self._m_grv.record(t1 - t0)
        self._m_read.record(t2 - t1)
        self._m_commit.record(t3 - t2)
        return True

    # ── background driver (thread-mode clusters only) ────────────────
    def start(self):
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="latency-prober", daemon=True
        )
        self._thread.start()

    def _loop(self):
        from foundationdb_tpu_torch.utils.trace import SEV_ERROR, TraceEvent

        interval = self.cluster.knobs.health_probe_interval_s
        while not self._stop.wait(interval):
            try:
                self.maybe_probe()
            except Exception as e:
                # the prober must never take the cluster down — but a
                # broken probe is forensics-worthy, not silence
                TraceEvent("LatencyProbeError", severity=SEV_ERROR) \
                    .detail(error=repr(e))
                self._m_failures.inc()

    def stop(self):
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5)

    # ── reporting ────────────────────────────────────────────────────
    def status(self):
        return {
            "enabled": enabled()
            and bool(self.cluster.knobs.health_probe_enabled),
            "probes": self._m_probes.value,
            "failures": self._m_failures.value,
            "last_error": self.last_error,
            "grv": self._m_grv.bands_ms(),
            "read": self._m_read.bands_ms(),
            "commit": self._m_commit.bands_ms(),
        }


# ── recovery-state timeline ──────────────────────────────────────────
RECOVERY_PHASES = ("fence", "cas", "recruit", "replay", "accept")


class RecoveryTimeline:
    """Bounded ring of txn-system recovery phase breakdowns (ref: the
    recovery_state section of status json + the master recovery trace
    events operators graph). Cluster-owned: survives every recovery it
    records; byte-identical across same-seed sims because every stamp
    comes off the injected clock."""

    MAX_RECORDS = 16

    def __init__(self):
        self.records = []
        self.count = 0  # total recoveries ever (the ring forgets, this doesn't)

    def begin(self, trigger, clock_advance=None):
        return _RecoveryRecorder(self, trigger, clock_advance)

    def last_recovery_ms(self):
        return self.records[-1]["total_ms"] if self.records else 0.0

    def snapshot(self):
        return {
            "count": self.count,
            "last_recovery_ms": self.last_recovery_ms(),
            "records": [dict(r) for r in self.records],
        }


class _RecoveryRecorder:
    """One in-flight recovery's phase stopwatch. ``clock_advance`` is
    the simulation's hook (each phase mark consumes a simulated tick so
    same-seed phase durations are nonzero AND identical); production
    leaves it None and measures real elapsed time."""

    def __init__(self, timeline, trigger, clock_advance):
        self._timeline = timeline
        self._advance = clock_advance
        started = deterministic.now()
        self._last = started
        self.record = {
            "generation": None,
            "trigger": trigger,
            "started_at": round(started, 6),
            "phases": {},
            "total_ms": 0.0,
        }

    def phase(self, name):
        """Close the phase that just ran (marks are placed AFTER each
        phase's work in cluster._recover_txn_system)."""
        if self._advance is not None:
            self._advance()
        now = deterministic.now()
        self.record["phases"][name] = round((now - self._last) * 1000, 3)
        self._last = now

    def finish(self, generation, recovered_version):
        self.record["generation"] = generation
        self.record["recovered_version"] = recovered_version
        self.record["total_ms"] = round(
            sum(self.record["phases"].values()), 3
        )
        tl = self._timeline
        tl.count += 1
        tl.records.append(self.record)
        del tl.records[: -tl.MAX_RECORDS]


# ── health doc + verdict ─────────────────────────────────────────────
# FDB-style cluster.messages (ref: the messages array Status.actor.cpp
# emits): name → operator-facing description, keyed by reason
_MESSAGES = {
    "sequencer_down": "The sequencer is unreachable; commits and read "
                      "versions cannot be served until recovery.",
    "commit_proxy_down": "The commit proxy is unreachable; commits fail "
                         "until recovery.",
    "storage_servers_down": "No storage server is reachable; the "
                            "database is unavailable.",
    "log_quorum_lost": "The log system has lost its ack quorum; commits "
                       "cannot become durable.",
    "storage_server_down": "One or more storage servers are down; "
                           "recruitment is pending.",
    "log_replica_down": "One or more log replicas are down; the log "
                        "tier is degraded.",
    "resolver_down": "One or more resolvers are down; respawn is "
                     "pending.",
    "storage_lag": "A storage server's durability lag exceeds the "
                   "doctor threshold.",
    "workload_saturated": "The ratekeeper is shedding load "
                          "(target TPS squeezed below capacity).",
    "probe_failures": "The most recent latency probe failed; the "
                      "transaction path may be impaired.",
    "probe_trend": "A latency probe p99 is rising monotonically across "
                   "consecutive history windows; latency is trending "
                   "toward the SLO threshold before breaching it.",
    "region_lag": "Remote-region replication lag exceeds the doctor "
                  "threshold; a failover now would lose that much.",
    "region_replication_broken": "Region replication lost log "
                                 "continuity; the satellite must be "
                                 "re-seeded before it can fail over.",
    "satellite_down": "The satellite region is unreachable (WAN "
                      "partition); replication lag is growing.",
    "rpc_endpoints_failed": "The failure monitor holds one or more RPC "
                            "endpoints marked failed; calls to them "
                            "are being skipped until a recovery probe "
                            "succeeds.",
    "data_inconsistent": "The consistency scan confirmed replica "
                         "divergence (re-read against the live shard "
                         "map); the data is corrupt on at least one "
                         "replica.",
}


def build_health(cluster):
    """The ``cluster.health`` document: verdict + sorted reasons +
    messages + probe bands + recovery timeline + lag/saturation
    rollups. A pure read — no probes fire, no state mutates — so
    status() stays side-effect free."""
    from foundationdb_tpu_torch.server.tlog import TLogSystem
    from foundationdb_tpu_torch.utils import metrics as metrics_mod

    knobs = cluster.knobs
    storages = cluster.storages
    live_storages = sum(1 for s in storages if s.alive)
    sequencer_up = cluster.sequencer.alive
    proxy_up = cluster._commit_target().alive

    # ── lag rollups ──
    committed = cluster.sequencer.committed_version
    per_storage = []
    for i, s in enumerate(storages):
        lag = max(0, committed - s.durable_version) if s.alive else None
        per_storage.append({"id": i, "alive": s.alive,
                            "durability_lag_versions": lag})
    lags = [r["durability_lag_versions"] for r in per_storage
            if r["durability_lag_versions"] is not None]
    lag_max = max(lags, default=0)
    if isinstance(cluster.tlog, TLogSystem):
        logs = cluster.tlog.logs
        quorum_ok = cluster.tlog.live_count >= cluster.tlog.quorum
        logs_live, logs_total = cluster.tlog.live_count, cluster.tlog.n
    else:
        logs = [cluster.tlog]
        quorum_ok = True
        logs_live = logs_total = 1
    tlog_depth = max(
        (len(l._log) for l in logs if l.alive), default=0
    )
    tlog_pushes = sum(l.metrics.counter("pushes").value for l in logs)
    grv_depth = max(
        (reg.gauge("grv_queue_depth").value
         for reg in cluster._role_registries("grv_proxy")), default=0
    )

    # ── saturation (ratekeeper) ──
    rk = cluster.ratekeeper
    saturation = round(1.0 - rk.target_tps / max(rk.max_tps, 1e-9), 4)
    rk_doc = {
        "target_tps": rk.target_tps,
        "max_tps": rk.max_tps,
        "saturation": saturation,
        # per-reason denial counters (registry-backed: they survive
        # recovery)
        "admit_denied_tag": rk.metrics.counter("admit_denied_tag").value,
        "admit_denied_budget": rk.metrics.counter(
            "admit_denied_budget").value,
        "throttled_tags": len(rk.throttled_tags()),
    }

    # ── verdict ──
    unavailable, degraded = set(), set()
    if not sequencer_up:
        unavailable.add("sequencer_down")
    if not proxy_up:
        unavailable.add("commit_proxy_down")
    if live_storages == 0:
        unavailable.add("storage_servers_down")
    if not quorum_ok:
        unavailable.add("log_quorum_lost")
    if live_storages < len(storages):
        degraded.add("storage_server_down")
    if logs_live < logs_total:
        degraded.add("log_replica_down")
    if any(not r.alive for r in cluster.resolvers):
        degraded.add("resolver_down")
    if lag_max > knobs.doctor_lag_versions:
        degraded.add("storage_lag")
    if saturation >= 0.5:
        degraded.add("workload_saturated")
    # ── multi-region replication (server/region.py) ──
    # always-present section: tools never branch on a missing key. The
    # broken/partition split matters to an operator — broken needs a
    # re-seed, a partition just needs the WAN back (elif: broken
    # subsumes the connectivity complaint).
    reg = getattr(cluster, "regions", None)
    regions_doc = reg.status() if reg is not None else {
        "configured": False}
    if reg is not None and reg.replicating:
        if reg.broken:
            degraded.add("region_replication_broken")
        elif reg.partitioned:
            degraded.add("satellite_down")
        if (regions_doc["replication_lag_versions"]
                > knobs.doctor_region_lag_versions):
            degraded.add("region_lag")
    # ── RPC endpoint health ──
    # the port has no RPC layer yet (no failure monitor): the section
    # keeps the reference's shape with nothing failed, so tools read
    # the same document
    rpc_doc = {"failed": {}, "endpoints_failed": 0, "rpc_timeouts": 0}
    prober = getattr(cluster, "prober", None)
    probe_doc = prober.status() if prober is not None else {
        "enabled": False, "probes": 0, "failures": 0, "last_error": None,
        "grv": metrics_mod.merged_bands_ms([]),
        "read": metrics_mod.merged_bands_ms([]),
        "commit": metrics_mod.merged_bands_ms([]),
    }
    if probe_doc["last_error"] is not None:
        degraded.add("probe_failures")
    # ── continuous consistency scan (server/consistencyscan.py) ──
    # a CONFIRMED inconsistency (survived the live-map re-read) is a
    # degraded verdict: the database still serves, but at least one
    # replica holds corrupt data. The verdict transition makes the
    # flight recorder dump the black box automatically.
    scanner = getattr(cluster, "scanner", None)
    scan_doc = scanner.status() if scanner is not None else {
        "enabled": False, "round": 0, "progress_pct": 0.0, "cursor": "",
        "batches": 0, "keys_scanned": 0, "bytes_scanned": 0,
        "last_round_ms": 0.0, "round_age_s": 0.0,
        "inconsistencies": 0, "reread_saves": 0,
        "last_error": None, "errors": [],
    }
    if scan_doc["inconsistencies"]:
        degraded.add("data_inconsistent")
    # ── trend-aware early warning (utils/timeseries.py) ──
    # a probe p99 rising monotonically across doctor_trend_windows
    # history windows degrades the verdict BEFORE the instant
    # doctor_probe_p99_ms threshold breaches
    hist = getattr(cluster, "history", None)
    trend_alerts = hist.trend_alerts() if hist is not None else []
    if trend_alerts:
        degraded.add("probe_trend")
    if unavailable:
        verdict, reasons = "unavailable", unavailable | degraded
    elif degraded:
        verdict, reasons = "degraded", degraded
    else:
        verdict, reasons = "healthy", set()
    reasons = sorted(reasons)

    timeline = getattr(cluster, "recovery_timeline", None)
    rec = timeline.snapshot() if timeline is not None else {
        "count": 0, "last_recovery_ms": 0.0, "records": []}
    rec["generation"] = cluster.generation

    return {
        "verdict": verdict,
        "reasons": reasons,
        "messages": [
            {"name": r,
             "description": _MESSAGES.get(r, r)} for r in reasons
        ],
        "probe": probe_doc,
        "consistency_scan": scan_doc,
        "trend_alerts": trend_alerts,
        "recovery": rec,
        "lag": {
            "durability_lag_versions_max": lag_max,
            "storages": per_storage,
            "tlog_queue_depth": tlog_depth,
            "tlog_pushes": tlog_pushes,
            "logs_live": logs_live,
            "logs_total": logs_total,
            "grv_queue_depth": grv_depth,
        },
        "ratekeeper": rk_doc,
        "regions": regions_doc,
        "rpc": rpc_doc,
    }
