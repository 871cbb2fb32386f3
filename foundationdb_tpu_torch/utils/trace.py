"""Structured trace events, the trace sink, and stage timers.

Ref parity: flow/Trace.cpp TraceEvent. The reference emits XML/JSON
trace files per role with severity, type, time, and arbitrary detail
fields; tooling greps them for forensics. Ours keeps the same shape
(one JSON object per line) with a process-wide sink
(:func:`global_trace_log`: an in-memory ring, and a rolling file when
``FDB_TPU_TRACE_FILE`` names one), a per-event fluent detail API,
severity filtering and per-type suppression.

:class:`StageStats` is the commit pipeline's cumulative wall time per
stage; given a metrics registry it also records each stage into a
``stage_<name>`` latency band of that registry.
"""

import io
import json
import os
import threading
import time

from foundationdb_tpu_torch.utils import lockdep
from collections import deque

SEV_DEBUG = 5
SEV_INFO = 10
SEV_WARN = 20
SEV_WARN_ALWAYS = 30
SEV_ERROR = 40

_SEV_NAMES = {
    SEV_DEBUG: "debug",
    SEV_INFO: "info",
    SEV_WARN: "warn",
    SEV_WARN_ALWAYS: "warn_always",
    SEV_ERROR: "error",
}


class TraceLog:
    """Process-wide sink for TraceEvents (ref: g_traceLog).

    File sinks ROLL (ref: flow/Trace.cpp rolled trace files): when the
    open file passes ``max_file_bytes``, it rotates to ``path.1`` (older
    rolls shift to ``.2`` … ``.roll_count``, the oldest is deleted) so a
    long bench or sim run never grows one unbounded file. The in-memory
    ring buffer is kept ALONGSIDE any open file sink, so ``events()``
    keeps working for tests even when a path is set.
    """

    def __init__(self, path=None, min_severity=SEV_INFO, clock=time.time,
                 max_file_bytes=None, roll_count=None, type_budget=None,
                 suppression_interval_s=None):
        self._lock = lockdep.lock("TraceLog._lock")
        self._path = path
        self._file = None
        self._file_bytes = 0
        self.max_buffered = 10_000
        # a bounded deque IS the ring: append past maxlen evicts the
        # oldest in O(1) (the old list-trim was O(n) per hot event)
        self._buffer = deque(maxlen=self.max_buffered)
        self.min_severity = min_severity
        self.clock = clock
        self.closed = False
        self.max_file_bytes = (
            max_file_bytes if max_file_bytes is not None
            else int(os.environ.get("FDB_TPU_TRACE_ROLL_BYTES", 10_000_000))
        )
        self.roll_count = (
            roll_count if roll_count is not None
            else int(os.environ.get("FDB_TPU_TRACE_ROLL_COUNT", 4))
        )
        # per-type rate suppression (ref: flow/Trace.cpp event
        # suppression): identical event types past the per-interval
        # budget are DROPPED and counted, so a hot-loop SEV_ERROR can
        # no longer flood the ring and roll every file. 0 disables.
        # The default sits well above legitimate traffic (a 1%-sampled
        # tracing e2e emits ~6k Span events per 5s) — this is a flood
        # breaker, not a sampler.
        self.type_budget = (
            type_budget if type_budget is not None
            else int(os.environ.get("FDB_TPU_TRACE_TYPE_BUDGET", 20_000))
        )
        self.suppression_interval_s = (
            suppression_interval_s if suppression_interval_s is not None
            else float(os.environ.get("FDB_TPU_TRACE_SUPPRESS_INTERVAL",
                                      5.0))
        )
        self._type_counts = {}
        self._window_start = None
        self.suppressed_events = 0
        self.suppressed_by_type = {}

    def open(self, path):
        with self._lock:
            self._path = path
            self.closed = False
            if self._file:
                self._file.close()
            self._file = open(path, "a", buffering=1)
            self._file_bytes = self._file.tell()

    def close(self):
        with self._lock:
            self.closed = True
            if self._file:
                self._file.close()
                self._file = None

    def _roll_locked(self):
        """Rotate path → path.1 → … → path.roll_count (oldest dropped).
        roll_count 0 truncates in place — bounded either way."""
        self._file.close()
        self._file = None
        if self.roll_count > 0:
            oldest = f"{self._path}.{self.roll_count}"
            if os.path.exists(oldest):
                os.remove(oldest)
            for i in range(self.roll_count - 1, 0, -1):
                src = f"{self._path}.{i}"
                if os.path.exists(src):
                    os.replace(src, f"{self._path}.{i + 1}")
            os.replace(self._path, f"{self._path}.1")
        else:
            os.remove(self._path)
        self._file = open(self._path, "a", buffering=1)
        self._file_bytes = 0

    def _suppress_locked(self, event):
        """Whether this event exceeds its type's per-interval budget
        (drop + count). The window rides the sink's injected clock, so
        sim suppression decisions replay deterministically."""
        if not self.type_budget:
            return False
        t = event.get("time")
        if t is None:
            t = self.clock()
        if (self._window_start is None
                or t - self._window_start >= self.suppression_interval_s):
            self._window_start = t
            self._type_counts = {}
        type_ = event["type"]
        n = self._type_counts.get(type_, 0) + 1
        self._type_counts[type_] = n
        if n <= self.type_budget:
            return False
        self.suppressed_events += 1
        self.suppressed_by_type[type_] = (
            self.suppressed_by_type.get(type_, 0) + 1
        )
        return True

    def emit(self, event):
        if event["severity"] < self.min_severity:
            return
        # serialization is deferred until a file sink provably needs a
        # line: ring-only sinks (tests, benches) skip json.dumps, a
        # per-event cost at tracing-level volumes
        line = None
        if self._path is not None:
            line = json.dumps(event, separators=(",", ":"), default=repr)
        with self._lock:
            if self.closed:
                return  # interpreter teardown / explicit close: drop
            if self._suppress_locked(event):
                return
            if self._file is None and self._path is not None:
                self._file = open(self._path, "a", buffering=1)
                self._file_bytes = self._file.tell()
            if self._file is not None:
                if line is None:  # path set concurrently with open()
                    line = json.dumps(event, separators=(",", ":"),
                                      default=repr)
                data = line + "\n"
                self._file.write(data)
                self._file_bytes += len(data)
                if (self.max_file_bytes
                        and self._file_bytes >= self.max_file_bytes):
                    self._roll_locked()
            # the ring buffer fills regardless of the file sink, so
            # events() serves tests and forensics either way (deque
            # maxlen: the oldest half is long gone, newest retained)
            self._buffer.append(event)

    def events(self, type_=None):
        """Ring-buffered events (file sink or not), newest last."""
        with self._lock:
            return [
                e for e in self._buffer if type_ is None or e["type"] == type_
            ]

    def clear(self):
        with self._lock:
            self._buffer.clear()
            # fresh forensics window: suppression counts restart with
            # the buffer (cumulative suppressed_events totals remain),
            # so back-to-back sim runs sharing the process see
            # identical suppression decisions
            self._type_counts = {}
            self._window_start = None


_global = TraceLog(
    path=os.environ.get("FDB_TPU_TRACE_FILE"),
    min_severity=int(os.environ.get("FDB_TPU_TRACE_SEVERITY", SEV_INFO)),
)


def global_trace_log():
    return _global


class StageStats:
    """Cumulative wall-time counters for a multi-stage pipeline (the
    commit path's pack / resolve / apply stages). The batcher feeds it
    from two threads — the producer times stage A+B, the apply worker
    times stage C — so accumulation is lock-protected; reads take a
    consistent snapshot. The bench surfaces ``summary()`` so per-stage
    cost (and which stage is critical-path) lands in the artifact."""

    def __init__(self, registry=None):
        self._lock = lockdep.lock("StageStats._lock")
        self._total_s = {}
        self._count = {}
        # optional metrics registry: every add() also records into a
        # per-stage LatencySample, so the bench's stage means gain
        # latency BANDS in status json without a second timing site
        self._registry = registry
        self._bands = {}

    def add(self, stage, seconds):
        with self._lock:
            self._total_s[stage] = self._total_s.get(stage, 0.0) + seconds
            self._count[stage] = self._count.get(stage, 0) + 1
        if self._registry is not None:
            band = self._bands.get(stage)
            if band is None:
                band = self._bands[stage] = self._registry.latency(
                    f"stage_{stage}"
                )
            band.record(seconds)

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
        """Zero the means (a bench's run boundary); the registry's bands
        are cluster history and keep counting."""
        with self._lock:
            self._total_s = {}
            self._count = {}


class TraceEvent:
    """Fluent structured event (ref: TraceEvent(\"Type\").detail(...).log()).

    Usage::

        TraceEvent("CommitBatch", severity=SEV_INFO).detail(
            txns=32, version=cv).log()

    Events also log on ``with``-exit or garbage collection, mirroring the
    reference's log-on-destruct.
    """

    def __init__(self, type_, severity=SEV_INFO, log=None):
        self.type = type_
        self.severity = severity
        self._details = {}
        self._log = log if log is not None else _global
        self._logged = False

    def detail(self, **kwargs):
        self._details.update(kwargs)
        return self

    def error(self, exc):
        self.severity = max(self.severity, SEV_ERROR)
        self._details["error"] = str(exc)
        return self

    def log(self):
        if self._logged:
            return
        self._logged = True
        self._log.emit(
            {
                "type": self.type,
                "severity": self.severity,
                "sev_name": _SEV_NAMES.get(self.severity, str(self.severity)),
                "time": self._log.clock(),
                **{
                    k: (v.decode("latin-1") if isinstance(v, bytes) else v)
                    for k, v in self._details.items()
                },
            }
        )

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc is not None:
            self.error(exc)
        self.log()
        return False

    def __del__(self):
        # Log-on-destruct, EXCEPT at interpreter shutdown: a GC pass
        # after the global sink closed (or after module globals were
        # torn down to None) must never print spurious errors from a
        # half-dead runtime. ``closed`` is the explicit signal; the
        # broad guards cover teardown states where even attribute
        # access on the sink can fail.
        try:
            log = self._log
            if log is None or getattr(log, "closed", False):
                return
            self.log()
        except Exception:
            pass


def trace_events(type_=None):
    """The global sink's buffered events, oldest first (of ``type_``
    only, if given)."""
    return _global.events(type_)
