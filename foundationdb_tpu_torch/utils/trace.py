"""Stage timers, latency samples and trace events.

The port's own copy of ``StageStats`` (the JAX package's
``utils/trace.py``), without a metrics registry: the port has none yet,
so the batcher's submit→settle latency (``commit_e2e``) is a
:class:`LatencySample` of its own. Both are fed from several threads
(the batcher thread, the apply worker, waiting clients) under a plain
lock. :class:`TraceEvent` is the reference's structured event
(``TraceEvent("Type").detail(k=v).log()``), kept in a bounded
in-process log (:func:`trace_events`) instead of a file sink.
"""

import collections
import random
import threading
import time

SEV_INFO = 10
SEV_WARN_ALWAYS = 30
SEV_ERROR = 40

_events = collections.deque(maxlen=10_000)


class TraceEvent:
    """One structured event: a type, a severity and details, appended to
    the in-process log by ``log()`` (once)."""

    def __init__(self, type_, severity=SEV_INFO):
        self.type = type_
        self.severity = severity
        self._details = {}
        self._logged = False

    def detail(self, **kwargs):
        self._details.update(kwargs)
        return self

    def log(self):
        if not self._logged:
            self._logged = True
            _events.append(dict(self._details, type=self.type,
                                severity=self.severity, time=time.time()))


def trace_events(type_=None):
    """The logged events, oldest first (of ``type_`` only, if given)."""
    return [e for e in list(_events) if type_ is None or e["type"] == type_]


class StageStats:
    """Cumulative wall time per pipeline stage (pack / dispatch /
    resolve / apply). The batcher thread times stages A+B, the apply
    worker stage C; reads take a consistent snapshot."""

    def __init__(self):
        self._lock = threading.Lock()
        self._total_s = {}
        self._count = {}

    def add(self, stage, seconds):
        with self._lock:
            self._total_s[stage] = self._total_s.get(stage, 0.0) + seconds
            self._count[stage] = self._count.get(stage, 0) + 1

    def count(self, stage):
        with self._lock:
            return self._count.get(stage, 0)

    def mean_ms(self, stage):
        with self._lock:
            n = self._count.get(stage, 0)
            return (self._total_s.get(stage, 0.0) / n * 1e3) if n else 0.0

    def summary(self):
        """{stage: mean ms per observation} for every recorded stage."""
        with self._lock:
            return {
                s: round(self._total_s[s] / self._count[s] * 1e3, 3)
                for s in self._total_s if self._count.get(s)
            }

    def reset(self):
        with self._lock:
            self._total_s = {}
            self._count = {}


class LatencySample:
    """Seconds of one span (the batcher's submit→settle window), kept
    as a uniform reservoir of at most ``CAP`` observations (Vitter's
    algorithm R, seeded) so a long run holds bounded memory; p50 / p99
    are read from the reservoir."""

    CAP = 100_000

    def __init__(self):
        self._lock = threading.Lock()
        self._rng = random.Random(0)
        self._values = []
        self.count = 0

    def record(self, seconds):
        with self._lock:
            self.count += 1
            if len(self._values) < self.CAP:
                self._values.append(seconds)
            else:
                j = self._rng.randrange(self.count)
                if j < self.CAP:
                    self._values[j] = seconds

    def percentile_ms(self, q):
        """The ``q``-th percentile in ms (nearest rank), 0.0 when empty."""
        with self._lock:
            vals = sorted(self._values)
        if not vals:
            return 0.0
        rank = min(len(vals) - 1, max(0, int(round(q / 100 * len(vals))) - 1))
        return vals[rank] * 1e3

    def reset(self):
        with self._lock:
            self._values = []
            self.count = 0
