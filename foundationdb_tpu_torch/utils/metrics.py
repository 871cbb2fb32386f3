"""Cluster metrics: counters, gauges, and latency bands per role.

Ref parity: fdbserver/Stats.h (CounterCollection, LatencySample,
LatencyBands) + the per-role metrics that Status.actor.cpp aggregates
into the status json document. Every role owns a named
:class:`MetricsRegistry`; hot paths record through pre-resolved handles
(one lock, a few float ops), and ``snapshot()`` produces the JSON-ready
dict that rides the role's ``status()`` into the cluster's status
document.

Determinism: the registry draws its wall clock from
``core.deterministic.now()`` and the reservoir's eviction choices from
the ``metrics-reservoir`` named stream, so a seeded simulation produces
byte-identical snapshots for the same schedule (no ambient entropy or
``time.time`` here). Durations are measured as differences
of the injected clock — under the sim's step clock a span inside one
step is exactly 0.0, which is what "deterministic latency" means there;
in production the clock is the real wall clock.

Overhead: the module-level ``set_enabled(False)`` kill switch turns
every ``record``/``inc``/``set`` into an early return; chip_smoke.py's
phase 16 measures the commit path with every module's switch on and
off.
"""

import threading

from foundationdb_tpu_torch.core import deterministic
from foundationdb_tpu_torch.utils import lockdep

_enabled = True


def set_enabled(on):
    """Process-wide kill switch."""
    global _enabled
    _enabled = bool(on)


def enabled():
    return _enabled


def now():
    """The injected clock every metric timestamp/duration uses (sim:
    the step clock; production: the wall clock)."""
    return deterministic.now()


class Counter:
    """Monotonic counter (ref: Stats.h Counter). ``inc`` is a single
    GIL-atomic add on an int — a torn read costs a momentarily stale
    snapshot, never a lost invariant, so no lock on the hot path."""

    __slots__ = ("name", "_v")

    def __init__(self, name):
        self.name = name
        self._v = 0

    def inc(self, n=1):
        if not _enabled:
            return
        self._v += n

    def add_base(self, n):
        """Fold a prior incarnation's total in (recovery carryover) —
        bypasses the kill switch: carried history is not new overhead."""
        self._v += n

    @property
    def value(self):
        return self._v


class Gauge:
    """Last-written value (ref: the status json's point-in-time gauges:
    target tps, queue depths, versions)."""

    __slots__ = ("name", "_v")

    def __init__(self, name):
        self.name = name
        self._v = 0

    def set(self, v):
        if not _enabled:
            return
        self._v = v

    @property
    def value(self):
        return self._v


class LatencySample:
    """Reservoir sample yielding p50/p90/p99/max (ref: Stats.h
    LatencySample / LatencyBands). A fixed-size reservoir keeps memory
    bounded no matter how long the run; once full, each new observation
    replaces a uniformly random slot with probability K/count — the
    classic reservoir invariant, drawn from the ``metrics-reservoir``
    deterministic stream so seeded sims replay identical samples. The
    true count/total/max are tracked exactly (percentiles come from the
    reservoir; ``max`` never lies), so p50 ≤ p90 ≤ p99 ≤ max holds by
    construction."""

    __slots__ = ("name", "_k", "_res", "_count", "_total", "_max", "_rng",
                 "_lock")

    def __init__(self, name, reservoir=512):
        self.name = name
        self._k = reservoir
        self._res = []
        self._count = 0
        self._total = 0.0
        self._max = 0.0
        self._rng = deterministic.rng("metrics-reservoir")
        self._lock = lockdep.lock("LatencySample._lock")

    def record(self, seconds):
        if not _enabled:
            return
        s = float(seconds)
        with self._lock:
            self._count += 1
            self._total += s
            if s > self._max:
                self._max = s
            if len(self._res) < self._k:
                self._res.append(s)
            else:
                j = self._rng.randrange(self._count)
                if j < self._k:
                    self._res[j] = s

    @property
    def count(self):
        return self._count

    def total_seconds(self):
        return self._total

    def _percentile(self, ordered, q):
        if not ordered:
            return 0.0
        i = min(len(ordered) - 1, int(q * (len(ordered) - 1) + 0.5))
        return ordered[i]

    def bands_ms(self):
        """{count, mean_ms, p50_ms, p90_ms, p99_ms, max_ms} — the
        latency-band snapshot every consumer (status json, bench lines)
        shares. Monotone: percentiles index one sorted reservoir and
        max is the exact running max (≥ any reservoir entry)."""
        with self._lock:
            res = sorted(self._res)
            count, total, mx = self._count, self._total, self._max
        return {
            "count": count,
            "mean_ms": round(total / count * 1e3, 3) if count else 0.0,
            "p50_ms": round(self._percentile(res, 0.50) * 1e3, 3),
            "p90_ms": round(self._percentile(res, 0.90) * 1e3, 3),
            "p99_ms": round(self._percentile(res, 0.99) * 1e3, 3),
            "max_ms": round(mx * 1e3, 3),
        }

    def absorb(self, other):
        """Fold another sample in (recovery carryover / fleet rollups):
        counts and totals add exactly; the reservoirs concatenate and
        re-trim, which keeps every percentile inside the union's true
        range (an approximation, like any reservoir)."""
        with other._lock:
            o_res = list(other._res)
            o_count, o_total, o_max = other._count, other._total, other._max
        with self._lock:
            self._count += o_count
            self._total += o_total
            self._max = max(self._max, o_max)
            self._res.extend(o_res)
            if len(self._res) > self._k:
                # deterministic trim: keep an evenly strided subset of
                # the sorted union (preserves the distribution's shape)
                merged = sorted(self._res)
                step = len(merged) / self._k
                self._res = [merged[int(i * step)] for i in range(self._k)]


def merged_bands_ms(samples):
    """One latency-band dict over several LatencySamples (fleet rollup:
    the cluster's commit p99 across every proxy)."""
    samples = [s for s in samples if s is not None]
    if not samples:
        return LatencySample("empty").bands_ms()
    acc = LatencySample(samples[0].name, reservoir=512)
    for s in samples:
        acc.absorb(s)
    return acc.bands_ms()


class MetricsRegistry:
    """Named per-role metric collection (ref: CounterCollection). Roles
    create (or are handed) one at construction; the cluster keeps
    registries ALIVE across role recruitment so recovery never rewinds
    a counter. Handles are cached by name — the hot path never pays a
    dict lookup if the caller keeps the returned object."""

    def __init__(self, role, index=0):
        self.role = role
        self.index = index
        self._lock = lockdep.lock("MetricsRegistry._lock")
        self._counters = {}
        self._gauges = {}
        self._latencies = {}

    def counter(self, name):
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name)
            return c

    def gauge(self, name):
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name)
            return g

    def latency(self, name, reservoir=512):
        with self._lock:
            s = self._latencies.get(name)
            if s is None:
                s = self._latencies[name] = LatencySample(
                    name, reservoir=reservoir
                )
            return s

    def get_latency(self, name):
        """The sample if it exists (rollups must not create empties)."""
        return self._latencies.get(name)

    def snapshot(self):
        """JSON-ready snapshot: the role's status() payload."""
        with self._lock:
            counters = {n: c.value for n, c in self._counters.items()}
            gauges = {n: g.value for n, g in self._gauges.items()}
            lats = list(self._latencies.items())
        return {
            "role": self.role,
            "id": self.index,
            "time": now(),
            "counters": counters,
            "gauges": gauges,
            "latency_ms": {n: s.bands_ms() for n, s in lats},
        }

    def absorb(self, other):
        """Fold a retiring registry's history in (a configure() that
        shrinks a fleet must not lose the orphaned members' totals)."""
        with other._lock:
            o_counters = dict(other._counters)
            o_lats = dict(other._latencies)
        for n, c in o_counters.items():
            self.counter(n).add_base(c.value)
        for n, s in o_lats.items():
            self.latency(n).absorb(s)
