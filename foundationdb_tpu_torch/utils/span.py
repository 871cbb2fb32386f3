"""Distributed tracing spans — per-request hop attribution.

Ref parity: fdbclient/Tracing.actor.cpp (Span/OTELSpan) plus the
``g_traceBatch`` TransactionDebug events the reference stitches by
debugID across GRV proxy → commit proxy → resolver → tlog. A sampled
transaction carries a SpanContext on every hop (``CommitRequest.
span_context`` on the commit path, and a thread-ambient context for
in-process calls); each role opens a child span around its work and
finished spans emit as ``type="Span"`` TraceEvents, so they ride the
sinks, rolling and suppression of ``utils/trace.py``, from which a
tool can rebuild each trace's tree.

Determinism: trace/span ids draw from the ``span-id`` named
stream and sampling decisions from ``span-sample``, both on the
``core/deterministic.py`` seam; begin/end stamps come off the injected
clock. Two same-seed sims therefore emit byte-identical Span streams.

Overhead: with tracing off (``sample_rate`` 0 and no per-transaction
force) every call site degrades to :data:`NULL` — a shared no-op span
whose methods return immediately — so the commit hot path pays a couple
of attribute calls per transaction. Promotion of UNSAMPLED traffic adds
no per-transaction clock stamp:

- **aborts** promote per-transaction on the ERROR path only
  (:func:`promote_lite` — zero cost on the happy path; the record
  carries the error class and retry count, not durations);
- **slow commits** promote per BATCH WINDOW: the batcher/proxy already
  stamp every window's submit→settle span for the commit_e2e band, and
  a window outliving ``tracing_slow_commit_ms`` emits a
  ``commit.window`` span from those same stamps
  (:func:`slow_window_span` — no new clock reads anywhere).

Full hop-level trees come from sampled or forced transactions.
"""

import threading

from foundationdb_tpu_torch.core import deterministic
from foundationdb_tpu_torch.utils import trace as trace_mod

# named deterministic streams: a seeded run mints identical ids and
# sampling decisions every time (a raw uuid4/random span id here would
# make seed replays diverge)
_ID_STREAM = "span-id"
_SAMPLE_STREAM = "span-sample"

now = deterministic.now  # the injected clock every span stamp uses

# process-wide gauges (GIL-atomic ints, the metrics Counter idiom):
# sampled = root transaction spans that will emit (drawn or promoted),
# emitted = Span TraceEvents actually written
_spans_sampled = 0
_spans_emitted = 0


def spans_sampled():
    return _spans_sampled


def spans_emitted():
    return _spans_emitted


# The named stream OBJECTS are cached here after first use: the
# registry hands back the same persistent random.Random per name
# forever (deterministic.seed() re-seeds the objects in place), so
# caching skips the registry lock on every id/sampling draw, which the
# hot path makes for every transaction.
_id_stream = None
_sample_stream = None


def _new_id():
    global _id_stream
    s = _id_stream
    if s is None:
        s = _id_stream = deterministic.rng(_ID_STREAM)
    return s.getrandbits(64)


def should_sample(rate):
    """One sampling draw from the seeded stream. rate<=0 never draws
    (tracing off must not perturb the stream's sequence) and rate>=1
    never draws either (always on)."""
    if rate <= 0.0:
        return False
    if rate >= 1.0:
        return True
    global _sample_stream
    s = _sample_stream
    if s is None:
        s = _sample_stream = deterministic.rng(_SAMPLE_STREAM)
    return s.random() < rate


# ── ambient context ──────────────────────────────────────────────────
# The thread's current SpanContext — a (trace_id, span_id, sampled)
# tuple, exactly what the wire's tracing frame carries. In-process
# calls (sync GRV, the commit pipeline's role calls) read it instead of
# threading a parameter through every signature (a transport would
# install it on its handler thread from the incoming frame).
_tls = threading.local()


def current():
    return getattr(_tls, "ctx", None)


def set_current(ctx):
    """Install ``ctx`` as this thread's ambient context; returns the
    prior value so callers restore in a finally."""
    prior = getattr(_tls, "ctx", None)
    _tls.ctx = ctx
    return prior


class _NullSpan:
    """The shared no-op span: every tracing call site holds one of
    these when tracing is off, so the hot path cost is a method call
    that returns immediately. Falsy, children are itself, context is
    None (nothing propagates)."""

    __slots__ = ()
    sampled = False
    trace_id = 0
    span_id = 0
    parent_id = 0

    def child(self, name, **attrs):
        return self

    def attr(self, **kw):
        return self

    def finish(self, end=None, **attrs):
        pass

    def context(self):
        return None

    def __bool__(self):
        return False

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


NULL = _NullSpan()


class Span:
    """One timed hop of a trace (ref: Span in Tracing.actor.cpp).

    Finished spans emit a ``type="Span"`` TraceEvent at :meth:`finish`.
    Ids ride the deterministic seam; stamps ride the injected clock.
    Every constructed Span is an emitting one — the unsampled hot path
    constructs nothing (see :data:`NULL` and :func:`promote_lite`).
    """

    __slots__ = ("name", "trace_id", "span_id", "parent_id",
                 "begin", "end", "attrs_d", "_log")

    sampled = True  # class-level: a constructed Span always emits

    def __init__(self, name, trace_id=None, parent_id=0, log=None,
                 begin=None):
        self.name = name
        self.trace_id = trace_id if trace_id is not None else _new_id()
        self.span_id = _new_id()
        self.parent_id = parent_id
        self.begin = begin if begin is not None else now()
        self.end = None
        self.attrs_d = None
        self._log = log

    def child(self, name, **attrs):
        sp = Span(name, trace_id=self.trace_id, parent_id=self.span_id,
                  log=self._log)
        if attrs:
            sp.attrs_d = dict(attrs)
        return sp

    def attr(self, **kw):
        d = self.attrs_d
        if d is None:
            self.attrs_d = dict(kw)
        else:
            d.update(kw)
        return self

    def context(self):
        """The wire-propagatable SpanContext of THIS span (children on
        other hops parent to it)."""
        return (self.trace_id, self.span_id, True)

    def finish(self, end=None, **attrs):
        if self.end is not None:
            return  # idempotent: a span settles exactly once
        self.end = now() if end is None else end
        if attrs:
            self.attr(**attrs)
        self._emit()

    def _emit(self):
        global _spans_emitted
        _spans_emitted += 1
        # the event dict is built directly (no TraceEvent fluent
        # object): span emission runs at trace volume, and the extra
        # allocation + detail-merge + destructor guard were measurable
        log = self._log if self._log is not None \
            else trace_mod.global_trace_log()
        ev = {
            "type": "Span",
            "severity": trace_mod.SEV_INFO,
            "sev_name": "info",
            "time": log.clock(),
            "span": self.name,
            "trace": "%016x" % self.trace_id,
            "sid": "%016x" % self.span_id,
            "parent": "%016x" % self.parent_id,
            "begin": round(self.begin, 6),
            "end": round(self.end, 6),
            "dur_ms": round((self.end - self.begin) * 1e3, 3),
        }
        if self.attrs_d:
            ev.update(self.attrs_d)
        log.emit(ev)

    def __bool__(self):
        return True

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc is not None:
            self.attr(error=str(exc)[:200])
        self.finish()
        return False


def transaction_span(sample_rate, forced=False, log=None):
    """The client transaction's root span: an emitting span when the
    per-transaction force or the sampling draw hits, else :data:`NULL`
    (the draw is inlined — this runs once per transaction). Unsampled
    promotion is reconstruction-based (:func:`promote_lite`,
    :func:`slow_window_span`), not object-based."""
    global _spans_sampled, _sample_stream
    if not forced:
        if sample_rate <= 0.0:
            return NULL
        if sample_rate < 1.0:
            s = _sample_stream
            if s is None:
                s = _sample_stream = deterministic.rng(_SAMPLE_STREAM)
            if s.random() >= sample_rate:
                return NULL
    _spans_sampled += 1
    return Span("transaction", log=log)


def promote_lite(begin, end, commit_begin=None, error_code=None,
                 retries=0, log=None):
    """Retrospective promotion of an UNSAMPLED transaction that turned
    out to matter (an abort, or a late force): the happy path kept no
    state, so the record is reconstructed here — the one-in-a-thousand
    pays for its trace, the other 999 paid nothing."""
    global _spans_sampled
    _spans_sampled += 1
    root = Span("transaction", log=log, begin=begin)
    root.attr(promoted=1, retries=retries)
    status = "committed" if error_code is None else "error"
    if commit_begin is not None:
        csp = root.child("txn.commit")
        csp.begin = commit_begin
        if error_code is not None:
            csp.attr(error_code=error_code)
        csp.finish(end=end, status=status)
    root.finish(end=end, status=status)
    return root


def slow_window_span(begin, end, txns, log=None):
    """The per-WINDOW slow-commit promotion: a batch window whose
    submit→settle span outlived ``tracing_slow_commit_ms`` emits one
    ``commit.window`` record built from the stamps the commit_e2e
    latency band already took — slow-commit attribution with zero
    added clock reads on the hot path (every member of the window
    shares the reported latency, so window granularity is honest)."""
    global _spans_sampled
    _spans_sampled += 1
    root = Span("commit.window", log=log, begin=begin)
    root.finish(end=end, promoted=1, txns=txns)
    return root


def from_context(name, ctx, log=None, **attrs):
    """A server-side span continuing an incoming SpanContext; NULL when
    the context is absent or unsampled (roles only trace sampled
    traces)."""
    if ctx is None or not ctx[2]:
        return NULL
    sp = Span(name, trace_id=ctx[0], parent_id=ctx[1], log=log)
    if attrs:
        sp.attrs_d = dict(attrs)
    return sp


def emit_span(name, ctx, begin=None, end=None, **attrs):
    """Construct-and-finish a span with explicit stamps — the synthetic
    stage spans the batcher derives from its StageStats timings."""
    sp = from_context(name, ctx)
    if sp is NULL:
        return NULL
    if begin is not None:
        sp.begin = begin
    sp.finish(end=end, **attrs)
    return sp


def first_request_context(requests):
    """The first SAMPLED ``span_context`` carried by an iterable of
    commit requests, or None — how a batch/group picks the trace it
    attributes shared work to."""
    for r in requests:
        c = getattr(r, "span_context", None)
        if c is not None and c[2]:
            return c
    return None


def batch_span(requests, name="proxy.batch", log=None):
    """A span for a whole commit batch: parented to the FIRST sampled
    member's context and LINKING every sampled member span id (ref:
    the reference's batch-level span adding each txn's token as a
    link) — the one place a shared-version batch meets its member
    transactions' traces."""
    first = None
    links = None
    for r in requests:
        c = getattr(r, "span_context", None)
        if c is not None and c[2]:
            if first is None:
                first = c
                links = []
            links.append("%016x" % c[1])
    if first is None:
        return NULL
    sp = from_context(name, first, log=log)
    sp.attrs_d = {"links": links, "txns": len(requests)}
    return sp
