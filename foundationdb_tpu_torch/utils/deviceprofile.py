"""Device-path execution profile: per-dispatch accounting of the
resolver's compiled steps on the card.

Ref parity: flow/Profiler.actor.cpp (the sampling profiler whose doc
rides status json) and the device-side counters Status.actor.cpp folds
into ``cluster.*``. Per dispatch: the pad bucket chosen against the
batches and txns actually live (pad waste), live against padded entry
slots per conflict side (pr/pw/rr/rw), compiled-step captures by key,
staging-set reuse, the bytes of the packed tensors copied to the card,
the enqueue wall and the wait for the statuses, the lanes' routed
entries (lane skew), the step body that served each live batch
(``kernel_routes``, named in resolver/resolver.py's docstring) and a
closed ``fallback_cause`` taxonomy.

Every capture site is on the host, around the step's enqueue or the
read of its statuses, and adds no host sync.

Determinism: durations use ``core.deterministic.now()`` (the metrics.py
clock contract): under a step clock a span inside one step is exactly
0.0, so two same-seed runs emit byte-identical documents. Everything
else is integer counters.

Overhead: the module-level ``set_enabled(False)`` kill switch turns
every ``record_*`` into an early return.
"""

import threading

from foundationdb_tpu_torch.core import deterministic
from foundationdb_tpu_torch.utils import lockdep

_enabled = True

# the closed taxonomy: snapshot() emits every cause (zeros included) so
# the doc's shape is stable. The port has no kernel fallback: its first
# cause keeps the reference's key and stays 0
FALLBACK_CAUSES = (
    "pallas_to_jit",   # a kernel unavailable, the plain step instead
    "flat_to_legacy",  # flat batch mixed with legacy / width mismatch
    "sharded_to_local",  # mesh lanes clamped below the requested fleet
    "over_capacity",   # flat batch exceeds a lane cap -> decode+repack
    "too_old_rv",      # read version below the resolver's fenced base
)

SIDES = ("pr", "pw", "rr", "rw")


def set_enabled(on):
    """Process-wide kill switch."""
    global _enabled
    _enabled = bool(on)


def enabled():
    return _enabled


def now():
    """The injected clock every profiler duration uses (sim: the step
    clock; production: the wall clock)."""
    return deterministic.now()


class DeviceProfile:
    """Per-resolver device-path profile. The cluster owns one per
    resolver index (like the metric registries) and re-hands it across
    respawn/recovery/configure so history never rewinds; ``absorb``
    bypasses the kill switch because carried history is not new
    overhead."""

    def __init__(self, name, index=0):
        self.name = name
        self.index = index
        self._lock = lockdep.lock("DeviceProfile._lock")
        # dispatch accounting
        self.dispatches = 0
        self.batches_live = 0
        self.batch_slots = 0
        self.txns_live = 0
        self.txn_slots = 0
        self.bucket_histogram = {}  # str(B) -> dispatches at bucket B
        # per-side entry occupancy: live vs padded slots
        self.entries_live = {s: 0 for s in SIDES}
        self.entry_slots = {s: 0 for s in SIDES}
        # compiled-step captures: a new (key, signature) in the
        # resolver's ops/conflict.StepCache
        self.recompiles = 0
        self.compile_keys = {}  # str(key) -> count
        # staging sets (resolver/packing.py _flat_staging)
        self.staging_reuse_hits = 0
        self.staging_reuse_misses = 0
        # host->device transfer estimate (sum of packed array nbytes)
        self.transfer_bytes = 0
        # walls (deterministic clock; 0.0 under the sim step clock)
        self.dispatch_wall_s = 0.0
        self.verdict_reduce_wall_s = 0.0
        # mesh lanes: accumulated per-lane dispatch wall (hash-sharded
        # mode / legacy host fan-out) OR per-lane routed-entry counts
        # (range-sharded mode — known at split time, before the device
        # runs). One profile only ever fills one of the two: skew over
        # mixed units would be meaningless.
        self.lane_walls_s = []
        self.lane_entries = []
        self.lane_dispatches = 0
        # fallback-cause taxonomy
        self.fallback_causes = {c: 0 for c in FALLBACK_CAUSES}
        # which per-batch step body executed ("fused_accept" |
        # "ring_hits" | "plain"), counted per live batch served
        self.kernel_routes = {}

    # ── capture sites (all host-side, all gated) ──

    def record_dispatch(self, bucket, live_batches, live_txns, txn_slots,
                        entries_live=None, entry_slots=None,
                        transfer_bytes=0, wall_s=0.0):
        if not _enabled:
            return
        with self._lock:
            self.dispatches += 1
            self.batches_live += int(live_batches)
            self.batch_slots += int(bucket)
            self.txns_live += int(live_txns)
            self.txn_slots += int(txn_slots)
            b = str(int(bucket))
            self.bucket_histogram[b] = self.bucket_histogram.get(b, 0) + 1
            if entries_live:
                for s in SIDES:
                    self.entries_live[s] += int(entries_live.get(s, 0))
            if entry_slots:
                for s in SIDES:
                    self.entry_slots[s] += int(entry_slots.get(s, 0))
            self.transfer_bytes += int(transfer_bytes)
            self.dispatch_wall_s += float(wall_s)

    def record_compile(self, key):
        if not _enabled:
            return
        with self._lock:
            self.recompiles += 1
            k = str(key)
            self.compile_keys[k] = self.compile_keys.get(k, 0) + 1

    def record_fallback(self, cause, n=1):
        if not _enabled:
            return
        with self._lock:
            self.fallback_causes[cause] = (
                self.fallback_causes.get(cause, 0) + int(n))

    def record_kernel_route(self, route, n=1):
        """One successful dispatch served by ``route`` (n = live
        batches it carried), recorded once the step is enqueued."""
        if not _enabled:
            return
        with self._lock:
            self.kernel_routes[route] = (
                self.kernel_routes.get(route, 0) + int(n))

    def record_staging(self, hit):
        if not _enabled:
            return
        with self._lock:
            if hit:
                self.staging_reuse_hits += 1
            else:
                self.staging_reuse_misses += 1

    def record_lanes(self, walls_s):
        """Per-lane dispatch walls for ONE mesh dispatch (index = lane,
        stable device order) — accumulated so skew reflects the run."""
        if not _enabled:
            return
        with self._lock:
            if len(self.lane_walls_s) < len(walls_s):
                self.lane_walls_s.extend(
                    0.0 for _ in range(len(walls_s) - len(self.lane_walls_s)))
            for i, w in enumerate(walls_s):
                self.lane_walls_s[i] += float(w)
            self.lane_dispatches += 1

    def record_lane_counts(self, counts):
        """Per-lane routed-entry counts for ONE dispatch (range-sharded
        mesh: the ShardRouter split, or the legacy proxy fan-out's
        clipped sub-batches). Same lane_skew_pct rollup as the wall
        instrument — balance in entries instead of seconds."""
        if not _enabled:
            return
        with self._lock:
            if len(self.lane_entries) < len(counts):
                self.lane_entries.extend(
                    0 for _ in range(len(counts) - len(self.lane_entries)))
            for i, c in enumerate(counts):
                self.lane_entries[i] += int(c)
            self.lane_dispatches += 1

    def record_verdict_reduce(self, wall_s):
        if not _enabled:
            return
        with self._lock:
            self.verdict_reduce_wall_s += float(wall_s)

    # ── carryover + rollup ──

    def absorb(self, other):
        """Fold a prior incarnation's totals in (respawn / recovery /
        configure shrink). Bypasses the kill switch: carried history is
        not new overhead."""
        with other._lock:
            o = {
                "dispatches": other.dispatches,
                "batches_live": other.batches_live,
                "batch_slots": other.batch_slots,
                "txns_live": other.txns_live,
                "txn_slots": other.txn_slots,
                "bucket_histogram": dict(other.bucket_histogram),
                "entries_live": dict(other.entries_live),
                "entry_slots": dict(other.entry_slots),
                "recompiles": other.recompiles,
                "compile_keys": dict(other.compile_keys),
                "staging_reuse_hits": other.staging_reuse_hits,
                "staging_reuse_misses": other.staging_reuse_misses,
                "transfer_bytes": other.transfer_bytes,
                "dispatch_wall_s": other.dispatch_wall_s,
                "verdict_reduce_wall_s": other.verdict_reduce_wall_s,
                "lane_walls_s": list(other.lane_walls_s),
                "lane_entries": list(other.lane_entries),
                "lane_dispatches": other.lane_dispatches,
                "fallback_causes": dict(other.fallback_causes),
                "kernel_routes": dict(other.kernel_routes),
            }
        with self._lock:
            self.dispatches += o["dispatches"]
            self.batches_live += o["batches_live"]
            self.batch_slots += o["batch_slots"]
            self.txns_live += o["txns_live"]
            self.txn_slots += o["txn_slots"]
            for k, v in o["bucket_histogram"].items():
                self.bucket_histogram[k] = (
                    self.bucket_histogram.get(k, 0) + v)
            for s in SIDES:
                self.entries_live[s] += o["entries_live"].get(s, 0)
                self.entry_slots[s] += o["entry_slots"].get(s, 0)
            self.recompiles += o["recompiles"]
            for k, v in o["compile_keys"].items():
                self.compile_keys[k] = self.compile_keys.get(k, 0) + v
            self.staging_reuse_hits += o["staging_reuse_hits"]
            self.staging_reuse_misses += o["staging_reuse_misses"]
            self.transfer_bytes += o["transfer_bytes"]
            self.dispatch_wall_s += o["dispatch_wall_s"]
            self.verdict_reduce_wall_s += o["verdict_reduce_wall_s"]
            if len(self.lane_walls_s) < len(o["lane_walls_s"]):
                self.lane_walls_s.extend(
                    0.0 for _ in range(len(o["lane_walls_s"])
                                       - len(self.lane_walls_s)))
            for i, w in enumerate(o["lane_walls_s"]):
                self.lane_walls_s[i] += w
            if len(self.lane_entries) < len(o["lane_entries"]):
                self.lane_entries.extend(
                    0 for _ in range(len(o["lane_entries"])
                                     - len(self.lane_entries)))
            for i, c in enumerate(o["lane_entries"]):
                self.lane_entries[i] += c
            self.lane_dispatches += o["lane_dispatches"]
            for c, v in o["fallback_causes"].items():
                self.fallback_causes[c] = (
                    self.fallback_causes.get(c, 0) + v)
            for r, v in o["kernel_routes"].items():
                self.kernel_routes[r] = self.kernel_routes.get(r, 0) + v

    def snapshot(self):
        """JSON-ready doc (sorted, stably rounded). ``pad_waste_pct``
        is the slot share PADDING burned: 1 - live/slots over every
        dispatch; ``lane_skew_pct`` is (max-min)/max over the
        accumulated per-lane loads — walls when the wall instrument
        filled, routed-entry counts otherwise — 0 when balanced or
        single-lane."""
        with self._lock:
            lanes = list(self.lane_walls_s)
            entries = list(self.lane_entries)
            skew_src = [float(x) for x in (lanes or entries)]
            txn_slots = self.txn_slots
            txns_live = self.txns_live
            hits, misses = (self.staging_reuse_hits,
                            self.staging_reuse_misses)
            pad_waste = (
                round((1.0 - txns_live / txn_slots) * 100, 2)
                if txn_slots else 0.0)
            lane_max = max(skew_src) if skew_src else 0.0
            lane_skew = (
                round((lane_max - min(skew_src)) / lane_max * 100, 2)
                if lane_max > 0 else 0.0)
            return {
                "name": self.name,
                "id": self.index,
                "dispatches": self.dispatches,
                "batches_live": self.batches_live,
                "batch_slots": self.batch_slots,
                "txns_live": txns_live,
                "txn_slots": txn_slots,
                "pad_waste_pct": pad_waste,
                "bucket_histogram": dict(sorted(
                    self.bucket_histogram.items(),
                    key=lambda kv: int(kv[0]))),
                "entries_live": dict(self.entries_live),
                "entry_slots": dict(self.entry_slots),
                "recompiles": self.recompiles,
                "compile_keys": dict(sorted(self.compile_keys.items())),
                "staging_reuse_hits": hits,
                "staging_reuse_misses": misses,
                "staging_reuse_rate": round(
                    hits / max(hits + misses, 1), 3),
                "transfer_bytes": self.transfer_bytes,
                "dispatch_wall_ms": round(self.dispatch_wall_s * 1e3, 3),
                "verdict_reduce_wall_ms": round(
                    self.verdict_reduce_wall_s * 1e3, 3),
                "lanes": max(len(lanes), len(entries)),
                "lane_dispatches": self.lane_dispatches,
                "lane_walls_ms": [round(w * 1e3, 3) for w in lanes],
                "lane_entries": entries,
                "lane_skew_pct": lane_skew,
                "fallback_causes": dict(sorted(
                    self.fallback_causes.items())),
                "kernel_routes": dict(sorted(
                    self.kernel_routes.items())),
            }


def merged_snapshot(profiles):
    """One aggregate doc over several DeviceProfiles (the cluster-wide
    ``cluster.device.aggregate`` rollup)."""
    acc = DeviceProfile("aggregate")
    for p in profiles:
        if p is not None:
            acc.absorb(p)
    return acc.snapshot()
