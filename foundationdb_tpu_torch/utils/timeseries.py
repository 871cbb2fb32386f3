r"""Time-series metrics history + flight recorder — the cluster's black box.

Ref parity: flow/TDMetric.actor.h (continuously-logged metric channels
with bounded history) and the latency/message history Status.actor.cpp
retains, so one status read shows where the cluster has BEEN, not just
where it is. Every point-in-time doc we already publish — the metric
registries, the workload heatmaps, the device profile, the health
verdict — gets a trajectory here:

* ``CounterSeries`` — per-window counter deltas → rates. Samples come
  from the CLUSTER-owned observability stores (metrics registries,
  heatmaps, device profiles), which already survive txn-system
  recovery, resolver respawn, and ``configure()`` shrink via their
  absorb/adopt semantics — so a window total never goes backwards; a
  defensive high-water clamp covers the one source that can rewind
  (a freshly recruited storage server's per-process registry).
* ``GaugeSeries`` — per-window sampled value, with ring-wide
  last/min/max rollups.
* ``LatencySeries`` — a latency band's p99 trajectory.
* ``HistoryCollector`` — cluster-owned; cuts one window per cadence
  interval off the injected clock, first-window offset jittered via
  the named "history-cadence" deterministic stream (same-seed runs cut
  identical windows, real fleets de-align). Thread-mode clusters drive
  it from a daemon loop; other pipelines call ``maybe_collect()`` on
  their own schedule, exactly like the latency prober and the region
  streamer.
* ``FlightRecorder`` — the black box: a health-verdict transition, a
  txn-system recovery, or a probe-SLO breach dumps a bounded artifact
  (recent windows, verdict timeline, recovery timeline, trace-ring
  tail, and the simulator's activated fault sites where a cluster names
  them) into an in-memory ring, optionally to a JSON file under
  ``knobs.flight_dir`` (``Cluster.flight_status``). Artifacts replay
  byte-identically across same-seed runs: every stamp is injected-clock
  time and serialization is sorted-key.

``set_enabled(False)`` is the module kill switch: ``maybe_collect``
becomes a cheap no-op while already-collected windows stay readable —
turning history off must not blind the reader.
"""

import json
import os
import threading
from collections import deque

from foundationdb_tpu_torch.core import deterministic
from foundationdb_tpu_torch.utils import lockdep
from foundationdb_tpu_torch.utils import metrics as metrics_mod

_enabled = True
_enabled_mu = threading.Lock()


def set_enabled(on):
    """Process-wide collector kill switch (history_smoke measures the
    delta). Collected windows stay readable either way."""
    global _enabled
    with _enabled_mu:
        _enabled = bool(on)


def enabled():
    return _enabled


def _jsonable(obj):
    """A JSON-ready deep copy: bytes and other odd detail values become
    their repr, deterministically — flight artifacts must serialize to
    identical bytes under a seed, so the sanitizer never consults
    anything but the value itself."""
    return json.loads(json.dumps(obj, sort_keys=True, default=repr))


# ── per-metric rings ─────────────────────────────────────────────────
class CounterSeries:
    """Bounded ring of per-window samples for ONE monotone counter:
    each window keeps the sampled total and the rate the delta implies.
    The high-water clamp enforces the cluster-owned stores' no-rewind
    contract on sources that lack it (per-process storage registries
    reset when a dead server is recruited)."""

    __slots__ = ("name", "_ring", "_high")

    def __init__(self, name, capacity):
        self.name = name
        self._ring = deque(maxlen=capacity)
        self._high = None

    def push(self, t, total, dt):
        total = float(total)
        if self._high is not None and total < self._high:
            total = self._high  # never rewind a window
        delta = 0.0 if self._high is None else total - self._high
        self._high = total
        self._ring.append({
            "t": round(t, 6),
            "total": round(total, 6),
            "rate": round(delta / max(dt, 1e-9), 3),
        })

    def windows(self):
        return [dict(r) for r in self._ring]


class GaugeSeries:
    """Bounded ring of per-window gauge samples; the snapshot carries
    last/min/max rollups over the retained windows."""

    __slots__ = ("name", "_ring")

    def __init__(self, name, capacity):
        self.name = name
        self._ring = deque(maxlen=capacity)

    def push(self, t, value):
        self._ring.append({"t": round(t, 6),
                           "value": round(float(value), 6)})

    def windows(self):
        return [dict(r) for r in self._ring]

    def rollup(self):
        vals = [r["value"] for r in self._ring]
        if not vals:
            return {"last": None, "min": None, "max": None}
        return {"last": vals[-1], "min": min(vals), "max": max(vals)}


class LatencySeries:
    """Bounded ring of a latency band's p99 per window — the
    trajectory trend-aware doctor alerts read."""

    __slots__ = ("name", "_ring")

    def __init__(self, name, capacity):
        self.name = name
        self._ring = deque(maxlen=capacity)

    def push(self, t, p99_ms):
        self._ring.append({"t": round(t, 6),
                           "p99_ms": round(float(p99_ms), 6)})

    def windows(self):
        return [dict(r) for r in self._ring]


# ── trend detection (the probe_trend degraded reason in the health
#    verdict) ─────────────────────────────────────────────────────────
def rising_p99(rows, windows=3, min_rise_pct=5.0):
    """A monotone p99 rise across the last ``windows`` windows →
    ``{from_ms, to_ms, rise_pct, windows}``, else None. Strictly
    increasing nonzero values with a total rise past ``min_rise_pct``
    — the threshold keeps reservoir warm-up wiggle from alerting."""
    if windows < 2 or len(rows) < windows:
        return None
    vals = [r["p99_ms"] for r in rows[-windows:]]
    if any(v <= 0 for v in vals):
        return None
    if any(b <= a for a, b in zip(vals, vals[1:])):
        return None
    rise_pct = (vals[-1] - vals[0]) / vals[0] * 100.0
    if rise_pct < min_rise_pct:
        return None
    return {"from_ms": round(vals[0], 3), "to_ms": round(vals[-1], 3),
            "rise_pct": round(rise_pct, 2), "windows": windows}


# ── the collector ────────────────────────────────────────────────────
HEAT_DIMS = ("conflict", "read", "write")


class HistoryCollector:
    """Cluster-owned retention layer: one fixed-cadence window samples
    every role's MetricsRegistry (via the cluster-level counter sums),
    the KeyRangeHeatmaps, the DeviceProfiles, the ratekeeper gauges,
    and the health verdict. Pull-based like the latency prober:
    ``maybe_collect()`` fires at most once per knob cadence off the
    injected clock; thread-mode clusters drive it from a daemon loop,
    sims/tests call it from their own schedule."""

    def __init__(self, cluster):
        self.cluster = cluster
        cap = cluster.knobs.history_windows
        self._counters = {}
        self._gauges = {}
        self._latencies = {}
        self.heat = {dim: deque(maxlen=cap) for dim in HEAT_DIMS}
        self.verdicts = deque(maxlen=cap)
        self.transitions = deque(maxlen=cap)
        self.windows_collected = 0
        # jittered first-window offset off the named deterministic
        # stream: same-seed runs cut the same windows; a real
        # fleet's collectors never thunder in step
        self._rng = deterministic.rng("history-cadence")
        self._next_due = None
        self._last_t = None
        # leaf lock: held only while mutating/copying the rings, never
        # while sampling the cluster (no lock-order edges)
        self._mu = lockdep.lock("HistoryCollector._mu")
        self.recorder = FlightRecorder(cluster)
        self._stop = threading.Event()
        self._thread = None

    # ── cadence ──────────────────────────────────────────────────────
    def maybe_collect(self):
        """Cut one window if the cadence elapsed; returns True iff a
        window was collected."""
        if not enabled() or not self.cluster.knobs.history_enabled:
            return False
        cadence = self.cluster.knobs.history_cadence_s
        now = deterministic.now()
        if self._next_due is None:
            self._next_due = now + cadence * self._rng.random()
            return False
        if now < self._next_due:
            return False
        # fixed cadence: a late arrival stays on the original grid
        # (no drift), missed windows are skipped rather than
        # burst-collected, and the next due time is strictly in the
        # future so an immediate re-poll never double-collects
        missed = max(0.0, now - self._next_due)
        self._next_due += cadence * (1 + int(missed // cadence))
        if self._next_due <= now:  # float-boundary guard
            self._next_due += cadence
        self.collect_now()
        return True

    def collect_now(self):
        """One window: sample everything (no lock held), then append to
        the per-metric rings and hand the window to the flight
        recorder. Returns the window timestamp."""
        c = self.cluster
        t = deterministic.now()
        dt = max((t - self._last_t) if self._last_t is not None
                 else c.knobs.history_cadence_s, 1e-9)
        health = c.health_status()

        counters = {
            "txn_committed": c._sum_counter("commit_proxy",
                                            "txn_committed"),
            "txn_conflicted": (
                c._sum_counter("commit_proxy", "abort_not_committed")
                + c._sum_counter("commit_proxy",
                                 "abort_transaction_too_old")),
            "txn_started": c._sum_counter("grv_proxy", "grv_grants"),
            "reads": sum(
                s.metrics.counter("point_reads").value
                + s.metrics.counter("range_reads").value
                + s.metrics.counter("batched_reads").value
                for s in c.storages),
            "probes": c._sum_counter("prober", "probes"),
            "probe_failures": c._sum_counter("prober", "probe_failures"),
            "tlog_pushes": health["lag"]["tlog_pushes"],
            "admit_denied": (health["ratekeeper"]["admit_denied_tag"]
                             + health["ratekeeper"]["admit_denied_budget"]),
            "recoveries": health["recovery"]["count"],
            "device_dispatches": sum(
                p.dispatches for p in c._device_store.values()),
        }
        # commit-pipeline stage busy-seconds: per-window rates give the
        # hottest-stage trajectory
        for stage in ("pack", "dispatch", "resolve", "apply"):
            total = 0.0
            for reg in c._role_registries("commit_proxy"):
                s = reg.get_latency(f"stage_{stage}")
                if s is not None:
                    total += s.total_seconds()
            counters[f"stage_{stage}_s"] = round(total, 6)

        rk = c.ratekeeper.history_sample()
        gauges = {
            "target_tps": rk["target_tps"],
            "saturation": rk["saturation"],
            "grv_queue_depth": health["lag"]["grv_queue_depth"],
            "tlog_queue_depth": health["lag"]["tlog_queue_depth"],
            "storage_lag_versions":
                health["lag"]["durability_lag_versions_max"],
            "storages_live": sum(
                1 for r in health["lag"]["storages"] if r["alive"]),
        }

        p99s = {
            "probe_grv": health["probe"]["grv"].get("p99_ms", 0.0),
            "probe_read": health["probe"]["read"].get("p99_ms", 0.0),
            "probe_commit": health["probe"]["commit"].get("p99_ms", 0.0),
            "commit_e2e": metrics_mod.merged_bands_ms(
                [r.get_latency("commit_e2e")
                 for r in c._role_registries("commit_proxy")])["p99_ms"],
            "grv_grant": metrics_mod.merged_bands_ms(
                [r.get_latency("grv_grant")
                 for r in c._role_registries("grv_proxy")])["p99_ms"],
        }

        hot = c.hot_ranges_status(top=c.knobs.history_heat_top)

        cap = c.knobs.history_windows
        with self._mu:
            for name, total in counters.items():
                s = self._counters.get(name)
                if s is None:
                    s = self._counters[name] = CounterSeries(name, cap)
                s.push(t, total, dt)
            for name, value in gauges.items():
                g = self._gauges.get(name)
                if g is None:
                    g = self._gauges[name] = GaugeSeries(name, cap)
                g.push(t, value)
            for name, p99 in p99s.items():
                ls = self._latencies.get(name)
                if ls is None:
                    ls = self._latencies[name] = LatencySeries(name, cap)
                ls.push(t, p99)
            for dim in HEAT_DIMS:
                self.heat[dim].append({
                    "t": round(t, 6),
                    "total": hot["totals"][dim]["heat"],
                    "rows": hot["hot_ranges"][dim],
                })
            prev = self.verdicts[-1]["verdict"] if self.verdicts else None
            if prev is not None and prev != health["verdict"]:
                self.transitions.append({
                    "t": round(t, 6), "from": prev,
                    "to": health["verdict"],
                })
            self.verdicts.append({
                "t": round(t, 6), "verdict": health["verdict"],
                "reasons": list(health["reasons"]),
            })
            self._last_t = t
            self.windows_collected += 1
        self.recorder.observe(t, health, self)
        return t

    # ── trend hook (the probe_trend degraded reason) ─────────────────
    def trend_alerts(self):
        """Live monotone-p99-rise scan over the in-memory rings — the
        health verdict's early-warning input. Empty while fewer than
        ``doctor_trend_windows`` windows exist."""
        k = self.cluster.knobs
        alerts = []
        with self._mu:
            for name in ("probe_grv", "probe_commit"):
                ls = self._latencies.get(name)
                if ls is None:
                    continue
                hit = rising_p99(list(ls._ring), k.doctor_trend_windows,
                                 k.doctor_trend_min_rise_pct)
                if hit is not None:
                    alerts.append({"name": name, **hit})
        return alerts

    # ── reporting ────────────────────────────────────────────────────
    def recent_windows(self, n):
        """The last ``n`` windows of every series — the flight
        artifact's history section."""
        with self._mu:
            return {
                "counters": {
                    name: s.windows()[-n:]
                    for name, s in sorted(self._counters.items())},
                "gauges": {
                    name: g.windows()[-n:]
                    for name, g in sorted(self._gauges.items())},
                "latency_p99_ms": {
                    name: ls.windows()[-n:]
                    for name, ls in sorted(self._latencies.items())},
            }

    def recent_verdicts(self, n):
        with self._mu:
            return [dict(v) for v in list(self.verdicts)[-n:]]

    def status(self):
        """The metrics-history document (``Cluster.history_status`` and
        the status document's ``history``)."""
        k = self.cluster.knobs
        with self._mu:
            series = {
                "counters": {
                    name: s.windows()
                    for name, s in sorted(self._counters.items())},
                "gauges": {
                    name: {"windows": g.windows(), **g.rollup()}
                    for name, g in sorted(self._gauges.items())},
                "latency_p99_ms": {
                    name: ls.windows()
                    for name, ls in sorted(self._latencies.items())},
            }
            heat = {dim: [dict(w) for w in ring]
                    for dim, ring in self.heat.items()}
            verdicts = [dict(v) for v in self.verdicts]
            transitions = [dict(v) for v in self.transitions]
            n = self.windows_collected
        return {
            "enabled": enabled() and bool(k.history_enabled),
            "cadence_s": k.history_cadence_s,
            "capacity": k.history_windows,
            "windows": min(n, k.history_windows),
            "windows_collected": n,
            "series": series,
            "heat": heat,
            "verdicts": verdicts,
            "transitions": transitions,
            "trend_alerts": self.trend_alerts(),
            "flight": self.recorder.summary(),
        }

    # ── background driver (thread-mode clusters only) ────────────────
    def start(self):
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="history-collector", daemon=True
        )
        self._thread.start()

    def _loop(self):
        from foundationdb_tpu_torch.utils.trace import SEV_ERROR, TraceEvent

        # wake at half the cadence so a window lands within ~1.5x of
        # its due time even when the loop and the schedule de-phase
        interval = max(self.cluster.knobs.history_cadence_s / 2, 0.05)
        while not self._stop.wait(interval):
            try:
                self.maybe_collect()
            except Exception as e:
                # the collector must never take the cluster down — but
                # a broken window is forensics-worthy, not silence
                TraceEvent("HistoryCollectError", severity=SEV_ERROR) \
                    .detail(error=repr(e))

    def stop(self):
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5)


# ── the flight recorder ──────────────────────────────────────────────
class FlightRecorder:
    """The black box. ``observe()`` runs after every window; three
    edge-triggered conditions dump a bounded artifact: a health-verdict
    TRANSITION (either direction — the end of an incident is forensics
    too), a txn-system recovery (the timeline count advanced), and a
    probe-SLO breach (p99 crossed ``doctor_probe_p99_ms``; hysteresis
    re-arms only after it drops back under). Artifacts land in an
    in-memory ring (``Cluster.flight_status`` reads the newest) and,
    when ``knobs.flight_dir`` is set, as ``flight-<seq>.json`` files
    with sorted keys — byte-identical across same-seed runs."""

    def __init__(self, cluster):
        self.cluster = cluster
        self.artifacts = deque(maxlen=cluster.knobs.flight_max_dumps)
        self.dump_count = 0
        self.last_triggers = []
        self.dir = cluster.knobs.flight_dir or None
        self._prev_verdict = None
        self._prev_recoveries = None
        self._probe_breached = set()
        # leaf lock around the artifact ring; file IO stays outside it
        self._mu = lockdep.lock("FlightRecorder._mu")

    def observe(self, t, health, collector):
        """Trigger scan for one window; dumps at most one artifact (a
        window with several triggers records them all on it)."""
        triggers = []
        verdict = health["verdict"]
        if self._prev_verdict is not None and verdict != self._prev_verdict:
            triggers.append(f"verdict:{self._prev_verdict}->{verdict}")
        self._prev_verdict = verdict
        rc = health["recovery"]["count"]
        if self._prev_recoveries is not None and rc > self._prev_recoveries:
            recs = health["recovery"]["records"]
            triggers.append(
                "recovery:" + (recs[-1]["trigger"] if recs else "unknown"))
        self._prev_recoveries = rc
        slo = self.cluster.knobs.doctor_probe_p99_ms
        for hop in ("grv", "commit"):
            p99 = health["probe"][hop].get("p99_ms", 0.0) or 0.0
            if p99 > slo:
                if hop not in self._probe_breached:
                    self._probe_breached.add(hop)
                    triggers.append(f"probe_slo:{hop}")
            else:
                self._probe_breached.discard(hop)
        if triggers:
            self.dump(t, triggers, health, collector)
        return triggers

    def dump(self, t, triggers, health, collector):
        kn = self.cluster.knobs
        sites_fn = getattr(self.cluster, "buggify_sites", None)
        artifact = {
            "flight_schema": 1,
            "seq": self.dump_count,
            "t": round(t, 6),
            "triggers": list(triggers),
            "generation": self.cluster.generation,
            "verdict": health["verdict"],
            "reasons": list(health["reasons"]),
            "windows": collector.recent_windows(kn.flight_windows),
            "verdict_timeline": collector.recent_verdicts(
                kn.flight_windows),
            "recovery": _jsonable(health["recovery"]),
            "trace_tail": self._trace_tail(kn.flight_trace_tail),
            "buggify_sites": sorted(sites_fn()) if callable(sites_fn)
            else [],
        }
        if self.dir:
            os.makedirs(self.dir, exist_ok=True)
            path = os.path.join(
                self.dir, f"flight-{self.dump_count:04d}.json")
            with open(path, "w") as f:
                # sorted keys + no wall-time stamps: the same seed
                # writes the same bytes — the chaos-test contract
                f.write(json.dumps(artifact, sort_keys=True, indent=1,
                                   default=repr))
            artifact["path"] = path
        with self._mu:
            self.artifacts.append(artifact)
            self.dump_count += 1
            self.last_triggers = list(triggers)
        return artifact

    @staticmethod
    def _trace_tail(n):
        from foundationdb_tpu_torch.utils.trace import global_trace_log

        events = global_trace_log().events()
        return [_jsonable(e) for e in events[-n:]]

    def latest(self):
        with self._mu:
            return self.artifacts[-1] if self.artifacts else None

    def summary(self):
        with self._mu:
            return {
                "dumps": self.dump_count,
                "retained": len(self.artifacts),
                "last_triggers": list(self.last_triggers),
                "dir": self.dir,
            }
