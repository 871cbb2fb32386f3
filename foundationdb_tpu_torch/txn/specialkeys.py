"""The special key space: \\xff\\xff/... module registry.

Ref parity: fdbclient/SpecialKeySpace.actor.cpp — keys above \\xff\\xff
are not stored rows but views and management handles materialized by the
client at read time:

- the documents: ``\\xff\\xff/status/json`` (the whole status document),
  ``status/health`` (the doctor), ``status/flight`` (the flight
  recorder), ``status/consistency_scan``, ``metrics/json``,
  ``metrics/hot_ranges``, ``metrics/device`` and ``metrics/history``,
  each the cluster's section as JSON bytes
- ``\\xff\\xff/connection_string`` → ``local`` in process
- ``\\xff\\xff/transaction/conflicting_keys/<begin>`` → after a commit
  failed 1020 with ``options.set_report_conflicting_keys()``, boundary
  rows ("1" opens a conflicting range, "0" closes it — the reference's
  exact encoding)
- ``\\xff\\xff/management/excluded/<id>`` → storage exclusion: ``set``
  begins draining the storage at commit, ``clear`` re-includes it, range
  reads list current exclusions (ref: excludedServersSpecialKeyRange)
- ``\\xff\\xff/management/db_locked`` → the lock uid; ``set`` locks and
  ``clear`` unlocks at commit (unlocking needs LOCK_AWARE)
- ``\\xff\\xff/tracing/`` → ``token`` is transaction-local (nonzero
  forces this transaction's trace sampled); ``sample_rate`` and
  ``enabled`` change the cluster's rate at commit

Reads of special keys take no read-conflict ranges and never touch
storage. Management writes are buffered on the transaction and applied
at commit time, like the reference's special-key commit path.

A copy of the JAX package's ``txn/specialkeys.py`` for an in-process
cluster. Waiting for RPC: a remote client's connection string (its
cluster-file body) and the views' fallbacks for a remote cluster, which
slice them out of the status document.
"""

import json

from foundationdb_tpu_torch.core.errors import err
from foundationdb_tpu_torch.utils import span as span_mod

PREFIX = b"\xff\xff"
END = b"\xff\xff\xff"


def contains(key):
    """True iff ``key`` (bytes) lies in the special space [PREFIX, END)."""
    return isinstance(key, bytes) and key.startswith(PREFIX) and key < END


STATUS_JSON = b"\xff\xff/status/json"
HEALTH = b"\xff\xff/status/health"
METRICS_JSON = b"\xff\xff/metrics/json"
HOT_RANGES = b"\xff\xff/metrics/hot_ranges"
DEVICE = b"\xff\xff/metrics/device"
HISTORY = b"\xff\xff/metrics/history"
FLIGHT = b"\xff\xff/status/flight"
CONSISTENCY_SCAN = b"\xff\xff/status/consistency_scan"
CONNECTION_STRING = b"\xff\xff/connection_string"
CONFLICTING_KEYS = b"\xff\xff/transaction/conflicting_keys/"
EXCLUDED = b"\xff\xff/management/excluded/"
DB_LOCKED = b"\xff\xff/management/db_locked"
TRACING = b"\xff\xff/tracing/"
TRACING_TOKEN = b"\xff\xff/tracing/token"
TRACING_RATE = b"\xff\xff/tracing/sample_rate"
TRACING_ENABLED = b"\xff\xff/tracing/enabled"

# the document views, in the reference's order of evaluation: key, the
# cluster's section, and whether non-JSON values print as their repr
# (the flight recorder's artifact may hold some)
_VIEWS = (
    (STATUS_JSON, lambda c: c.status(), False),
    (HEALTH, lambda c: c.health_status(), False),
    (METRICS_JSON, lambda c: c.metrics_status(), False),
    (HOT_RANGES, lambda c: c.hot_ranges_status(), False),
    (DEVICE, lambda c: c.device_profile_status(), False),
    (HISTORY, lambda c: c.history_status(), False),
    (FLIGHT, lambda c: c.flight_status(), True),
    (CONSISTENCY_SCAN, lambda c: c.consistency_scan_status(), False),
)
_VIEW_OF = {key: (doc, loose) for key, doc, loose in _VIEWS}

_DEFAULT_ENABLED_RATE = 0.01  # `tracing on` without an explicit rate


def _view(tr, key):
    doc, loose = _VIEW_OF[key]
    return json.dumps(doc(tr._cluster), sort_keys=True,
                      default=repr if loose else None).encode()


def _excluded_rows(tr):
    """Current exclusions overlaid with this txn's pending management
    writes (read-your-writes, like the reference SpecialKeySpace merging
    uncommitted special-space writes into reads)."""
    sids = set(tr._cluster.list_excluded())
    for op, sid in tr._special_writes:
        if op == "exclude":
            sids.add(sid)
        elif op == "include":
            sids.discard(sid)
    return [(EXCLUDED + str(s).encode(), b"") for s in sorted(sids)]


def _conflicting_rows(tr):
    """Boundary encoding: each conflicting range [b, e) contributes
    (prefix+b, "1") and (prefix+e, "0"). Overlapping/adjacent ranges are
    merged first so an interior end key cannot close a region another
    range still covers."""
    ranges = sorted(tr._conflicting_ranges or [])
    merged = []
    for b, e in ranges:
        if merged and b <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([b, e])
    rows = []
    for b, e in merged:
        rows.append((CONFLICTING_KEYS + b, b"1"))
        rows.append((CONFLICTING_KEYS + e, b"0"))
    return rows


def _tracing_rows(tr):
    """The tracing module's materialized rows (cluster config + this
    transaction's token), RYW-overlaid with pending tracing writes."""
    cfg = tr._cluster.tracing_config()
    rate, enabled = cfg["sample_rate"], cfg["enabled"]
    for op, val in tr._special_writes:
        if op == "tracing_rate":
            rate, enabled = val, val > 0
        elif op == "tracing_enabled":
            enabled = val
            rate = _DEFAULT_ENABLED_RATE if val and rate <= 0 else (
                rate if val else 0.0
            )
    sp = tr._span
    if tr._trace_forced or (
        sp is not None and sp is not span_mod.NULL and sp.sampled
    ):
        token = (b"%016x" % sp.context()[0]) if sp is not None \
            and sp is not span_mod.NULL else b"1"
    else:
        token = b"0"
    return [
        (TRACING_ENABLED, b"1" if enabled else b"0"),
        (TRACING_RATE, repr(rate).encode()),
        (TRACING_TOKEN, token),
    ]


def _lock_row(tr):
    uid = tr._cluster.lock_uid()
    for op, val in tr._special_writes:
        if op == "lock":
            uid = val
        elif op == "unlock":
            uid = None
    return uid


def get(tr, key):
    if key in _VIEW_OF:
        return _view(tr, key)
    if key == CONNECTION_STRING:
        return tr._cluster.connection_string().encode()
    if key == DB_LOCKED:
        return _lock_row(tr)
    for prefix, rows in ((TRACING, _tracing_rows),
                         (CONFLICTING_KEYS, _conflicting_rows),
                         (EXCLUDED, _excluded_rows)):
        if key.startswith(prefix):
            return dict(rows(tr)).get(key)
    raise err("key_outside_legal_range")


def get_range(tr, begin, end, limit=0, reverse=False):
    rows = [(key, get(tr, key))
            for key in [k for k, _, _ in _VIEWS] + [CONNECTION_STRING]
            if begin <= key < end]
    for module in (_conflicting_rows, _excluded_rows, _tracing_rows):
        rows += [(k, v) for k, v in module(tr) if begin <= k < end]
    if begin <= DB_LOCKED < end:
        # same RYW overlay as the point get; the row exists only while
        # locked (an unlocked database has no db_locked row to list)
        uid = _lock_row(tr)
        if uid is not None:
            rows.append((DB_LOCKED, uid))
    rows.sort(reverse=reverse)
    if limit:
        rows = rows[:limit]
    return rows


def write(tr, key, value):
    """Buffer a management write; applied by ``commit_special``."""
    if key.startswith(EXCLUDED):
        tr._special_writes.append(("exclude", _parse_sid(key)))
        return
    if key == DB_LOCKED:
        tr._special_writes.append(("lock", value or b"lock"))
        return
    if key == TRACING_TOKEN:
        # txn-local, immediate (ref: the reference's tracing token):
        # nonzero forces THIS transaction sampled, b"0" un-forces
        if value and value != b"0":
            tr.options.set_trace()
        else:
            tr._trace_forced = False
        return
    if key == TRACING_RATE:
        try:
            rate = float(value)
        except (TypeError, ValueError):
            raise err("invalid_option_value") from None
        if not 0.0 <= rate <= 1.0:
            raise err("invalid_option_value")
        tr._special_writes.append(("tracing_rate", rate))
        return
    if key == TRACING_ENABLED:
        tr._special_writes.append(
            ("tracing_enabled", value not in (None, b"", b"0"))
        )
        return
    raise err("key_outside_legal_range")


def clear(tr, key):
    if key.startswith(EXCLUDED):
        tr._special_writes.append(("include", _parse_sid(key)))
        return
    if key == DB_LOCKED:
        tr._special_writes.append(("unlock", None))
        return
    if key == TRACING_TOKEN:
        tr._trace_forced = False  # txn-local, immediate (like write 0)
        return
    if key == TRACING_ENABLED:
        tr._special_writes.append(("tracing_enabled", False))
        return
    raise err("key_outside_legal_range")


def clear_range(tr, begin, end):
    if begin.startswith(EXCLUDED) and end.startswith(EXCLUDED):
        for k, _ in _excluded_rows(tr):
            if begin <= k < end:
                tr._special_writes.append(("include", _parse_sid(k)))
        return
    raise err("key_outside_legal_range")


def _parse_sid(key):
    raw = key[len(EXCLUDED):]
    try:
        return int(raw.decode())
    except (UnicodeDecodeError, ValueError):
        raise err("invalid_option_value") from None


def commit_special(tr):
    """Apply buffered management writes (commit-time semantics, ref:
    SpecialKeySpace::commit). Idempotent operations; failures surface as
    the commit's error.

    A locked database fences management writes too: unlocking (or any
    other management change) requires the LOCK_AWARE option, exactly as
    the reference's unlockDatabase does — otherwise any fenced client
    could clear the lock through the read-only commit path."""
    if tr._special_writes and not tr._lock_aware:
        if tr._cluster.lock_uid() is not None:
            tr._special_writes = []
            raise err("database_locked")
    cluster = tr._cluster
    for op, arg in tr._special_writes:
        if op == "exclude":
            cluster.exclude_storage(arg)
        elif op == "include":
            cluster.include_storage(arg)
        elif op == "lock":
            cluster.lock_database(arg)
        elif op == "unlock":
            cluster.unlock_database()
        elif op == "tracing_rate":
            cluster.set_tracing(sample_rate=arg)
        elif op == "tracing_enabled":
            cluster.set_tracing(enabled=arg)
    tr._special_writes = []
