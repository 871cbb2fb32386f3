"""Client Transaction: snapshot reads, read-your-writes, OCC commit.

Ref parity: fdbclient/NativeAPI.actor.cpp (Transaction) layered with
fdbclient/ReadYourWrites.actor.cpp, in the shape of FDB's Python binding
(bindings/python/fdb/impl.py): tr[key], tr[b:e], tr.get_range, key
selectors, atomic ops, versionstamps, the snapshot view, watches and the
on_error retry protocol.

At commit the client encodes its conflict ranges into flat limb blobs
(core/flatpack.py) when ``commit_pack_path="flat"``, so the proxy and
packer never re-parse a key. ``commit()`` goes through the cluster's
commit proxy, which a batching pipeline (server/batcher.py) turns into
submit-and-wait; ``commit_async`` / ``commit_finish`` split the two.

Transaction repair (txn/repair.py) is on by default (``txn_repair``):
each attempt records its storage reads, every commit asks for the
conflicting ranges, and ``on_error`` repairs a 1020 instead of backing
off — a replay (``repair_ready``: resubmit without the body) or a
seeded rerun whose reads come from the verified cache.

Options for the cluster's controls: ``set_lock_aware`` (commits while
the database is locked), ``set_tag`` (at most 5 tags of at most 16
bytes, throttled per tag at the GRV: 1213), the GRV priorities
``set_priority_batch`` / ``set_priority_system_immediate``, and
idempotency ids (``set_idempotency_id``, ``set_automatic_idempotency``:
an id drawn from core/deterministic.py's ``"idempotency-id"`` stream,
kept across retries), with which a 1021 is answered by looking the id's
row up instead of a blind retry. Tenants wrap a transaction in
layers/tenant.py's ``TenantTransaction`` (keys under the tenant's
prefix, the tenant's tag set).

Tracing (utils/span.py): under ``tracing_sample_rate`` (or
``options.set_trace()``) a transaction's root span draws from the
seeded "span-sample" stream at its first traced operation; a sampled
one emits ``txn.grv``, ``txn.read``, ``txn.read_range`` and
``txn.commit`` children, and its commit request carries the commit
span's context, under which the proxy's and resolver's spans nest. An
unsampled transaction that aborts while tracing is on is promoted after
the fact (``promote_lite``).

Special keys (txn/specialkeys.py): a read in ``[\\xff\\xff,
\\xff\\xff\\xff)`` is materialized from the cluster (no read version,
no read conflict range, never storage); a set or clear there buffers a
management write that commit applies after the data half, on every
commit path; atomics and selectors there raise 2004. A failed commit
keeps its ``conflicting_key_ranges`` for
``\\xff\\xff/transaction/conflicting_keys/``. Not ported yet: RPC.
"""

import time

from foundationdb_tpu_torch.core import deterministic, flatpack, systemdata
from foundationdb_tpu_torch.utils import span as span_mod
from foundationdb_tpu_torch.core.commit import CommitRequest
from foundationdb_tpu_torch.core.errors import FDBError, err
from foundationdb_tpu_torch.core.keys import (
    KeySelector,
    MAX_KEY_SIZE,
    MAX_VALUE_SIZE,
    key_successor,
    strinc,
)
from foundationdb_tpu_torch.core.mutations import Mutation, Op
from foundationdb_tpu_torch.core.versions import Versionstamp
from foundationdb_tpu_torch.txn import repair as repair_mod
from foundationdb_tpu_torch.txn import specialkeys
from foundationdb_tpu_torch.txn.futures import FutureRange, FutureValue
from foundationdb_tpu_torch.txn.rows import WriteMap
from foundationdb_tpu_torch.utils.backoff import Backoff
from foundationdb_tpu_torch.utils.trace import TraceEvent


def _check_key(key, limit=MAX_KEY_SIZE):
    key = bytes(key)
    if len(key) > limit:
        raise err("key_too_large")
    return key


def _check_value(value, limit=MAX_VALUE_SIZE):
    value = bytes(value)
    if len(value) > limit:
        raise err("value_too_large")
    return value


class TransactionOptions:
    def __init__(self, tr):
        self._tr = tr

    def set_read_your_writes_disable(self):
        self._tr._ryw_disabled = True

    def set_next_write_no_write_conflict_range(self):
        self._tr._next_write_no_conflict = True

    def set_report_conflicting_keys(self):
        self._tr._report_conflicting_keys = True

    def set_retry_limit(self, n):
        self._tr._retry_limit = int(n)

    def set_max_retry_delay(self, seconds):
        self._tr._max_retry_delay = float(seconds)

    def set_transaction_repair(self):
        """Repair this transaction's conflicts whatever the ``txn_repair``
        knob says (txn/repair.py)."""
        if self._tr._repair is None:
            self._tr._repair = repair_mod.RepairEngine()

    def set_lock_aware(self):
        """Ref: LOCK_AWARE — commit even while the database is locked."""
        self._tr._lock_aware = True

    def set_tag(self, tag):
        """A transaction tag for per-tag throttling (ref: the TAG option
        and TagThrottler): at most 5 tags of at most 16 bytes."""
        if isinstance(tag, bytes):
            # latin-1 is a byte bijection: distinct tags stay distinct
            tag = tag.decode("latin-1")
        if len(tag.encode("latin-1", "replace")) > 16:
            raise err("invalid_option_value")
        if tag not in self._tr._tags:
            if len(self._tr._tags) >= 5:
                raise err("invalid_option_value")
            self._tr._tags.append(tag)

    def set_auto_throttle_tag(self, tag):
        """Ref: AUTO_THROTTLE_TAG — the ratekeeper samples every tag for
        auto-throttling, so this is set_tag."""
        self.set_tag(tag)

    def set_priority_batch(self):
        """Ref: PRIORITY_BATCH — the GRV runs on spare capacity only."""
        self._tr._priority = "batch"

    def set_priority_system_immediate(self):
        """Ref: PRIORITY_SYSTEM_IMMEDIATE — the GRV bypasses the
        ratekeeper."""
        self._tr._priority = "immediate"

    def set_trace(self):
        """Sample this transaction's trace whatever
        ``tracing_sample_rate`` says (ref: the DEBUG_TRANSACTION_
        IDENTIFIER / LOG_TRANSACTION option pair). Best set before the
        first operation; a late force still promotes at commit."""
        self._tr._trace_forced = True
        if self._tr._span is span_mod.NULL:
            # the root was made unsampled: rebuild it at the next use
            self._tr._span = None

    def set_idempotency_id(self, idempotency_id):
        """Ref: IDEMPOTENCY_ID — a token of at most 255 bytes the proxy
        records with the commit: a retry after 1021 resolves to the
        original outcome instead of applying twice."""
        if not idempotency_id or len(idempotency_id) > 255:
            raise err("invalid_option_value")
        self._tr._idempotency_id = bytes(idempotency_id)

    def set_automatic_idempotency(self):
        """Ref: AUTOMATIC_IDEMPOTENCY — an id drawn at commit time and
        kept across the retry loop."""
        self._tr._auto_idempotency = True



class _Snapshot:
    """Snapshot-isolation view: reads add no read conflict ranges."""

    def __init__(self, tr):
        self._tr = tr

    def get(self, key):
        return self._tr.get(key, snapshot=True)

    def __getitem__(self, key):
        if isinstance(key, slice):
            return self._tr.get_range(key.start, key.stop, snapshot=True)
        return self._tr.get(key, snapshot=True)

    def get_range(self, begin, end, **kw):
        kw["snapshot"] = True
        return self._tr.get_range(begin, end, **kw)

    def get_key(self, selector):
        return self._tr.get_key(selector, snapshot=True)

    def get_range_startswith(self, prefix, **kw):
        kw["snapshot"] = True
        return self._tr.get_range_startswith(prefix, **kw)


class Transaction:
    def __init__(self, database):
        self.db = database
        self._reset()

    @property
    def _cluster(self):
        return self.db._cluster

    def _reset(self):
        self._pending_reads = []  # issued reads not yet waited on
        knobs = self.db._knobs
        self._knobs = knobs
        self._read_version = None
        self._writes = WriteMap()
        self._mutation_log = []  # [Mutation] in sequence order
        self._read_conflicts = []  # [(begin, end)]
        self._write_conflicts = []
        self._committed_version = None
        self._versionstamp = None
        # active | committing | committed | error | cancelled
        self._state = "active"
        self._ryw_disabled = False
        self._next_write_no_conflict = False
        self._report_conflicting_keys = False
        self._lock_aware = False
        self._idempotency_id = None
        self._auto_idempotency = False
        self._tags = []  # transaction tags (per-tag throttling)
        self._priority = "default"
        self._retry_limit = None
        self._max_retry_delay = knobs.max_retry_delay_s
        self._backoff = Backoff(initial_s=knobs.initial_backoff_s,
                                max_s=knobs.max_retry_delay_s,
                                growth=knobs.backoff_growth)
        self._retries = 0
        self._size = 0
        self._special_writes = []  # buffered \xff\xff management writes
        self._conflicting_ranges = None  # from a failed reporting commit
        self._watches_pending = []
        # transaction repair (txn/repair.py): the op-log recorder (None =
        # repair off), the verified read caches a repaired retry serves
        # from, and the replay and commit flags
        self._repair = (repair_mod.RepairEngine() if knobs.txn_repair
                        else None)
        self._repair_cache = None  # key -> value, proven at _read_version
        self._repair_range_cache = None  # (b, e, limit, rev) -> tuple(rows)
        self._repair_ready = False  # op log replayed: commit, skip the body
        self._repair_assisted = False  # this attempt rode a repair
        # tracing: the lazy root span (None until the first traced op,
        # NULL when unsampled), the in-flight commit span, the force flag
        self._span = None
        self._commit_span = None
        self._trace_forced = False
        self._options = None
        self._snapshot_view = None

    @property
    def options(self):
        if self._options is None:
            self._options = TransactionOptions(self)
        return self._options

    @property
    def snapshot(self):
        if self._snapshot_view is None:
            self._snapshot_view = _Snapshot(self)
        return self._snapshot_view

    # ─────────────────────────── tracing ──────────────────────────────
    def _trace_span(self):
        """The lazy root span: made at the first traced operation, so an
        untraced transaction never draws from the sampling stream."""
        sp = self._span
        if sp is None:
            sp = self._span = span_mod.transaction_span(
                self._knobs.tracing_sample_rate, forced=self._trace_forced)
        return sp

    def _child_span(self, name):
        """(span, its context) of a sampled root's child, or (None, None)."""
        sp = self._span
        if sp is None or not sp.sampled:
            return None, None
        child = sp.child(name)
        return child, child.context()

    def _trace_commit_done(self, error):
        """Settle the trace: a sampled one finishes its commit span and
        root; an unsampled one under an enabled rate is promoted only
        when it failed (or was forced too late)."""
        root = self._span
        if root is None:
            return
        if root is span_mod.NULL:
            if ((error is not None or self._trace_forced)
                    and self._knobs.tracing_sample_rate > 0.0):
                end = span_mod.now()
                span_mod.promote_lite(
                    end, end, commit_begin=end,
                    error_code=None if error is None else error.code,
                    retries=self._retries)
            self._span = None
            return
        csp = self._commit_span
        if csp is not None:
            if error is not None:
                csp.finish(status="error", error_code=error.code)
            else:
                csp.finish(status="committed",
                           version=self._committed_version)
            self._commit_span = None
        root.finish(status="error" if error is not None else "committed",
                    retries=self._retries)
        self._span = None  # a reused handle restarts its trace

    # ─────────────────────────── versions ─────────────────────────────
    def get_read_version(self):
        if self._read_version is None:
            grv = self._cluster.grv_proxy
            sp = self._trace_span()
            if not sp.sampled:
                self._read_version = grv.get_read_version(
                    priority=self._priority, tags=tuple(self._tags))
                return self._read_version
            gsp = sp.child("txn.grv")
            # the GRV proxy's grant span parents to this one
            prior = span_mod.set_current(gsp.context())
            try:
                self._read_version = grv.get_read_version(
                    priority=self._priority, tags=tuple(self._tags))
            finally:
                span_mod.set_current(prior)
            gsp.finish(version=self._read_version)
        return self._read_version

    def set_read_version(self, version):
        self._read_version = int(version)

    def get_committed_version(self):
        if self._committed_version is None:
            raise err("no_commit_version")
        return self._committed_version

    def get_versionstamp(self):
        """A callable giving the txn's 10-byte versionstamp after commit
        (the binding returns a future)."""
        return self._require_versionstamp

    def _require_versionstamp(self):
        if self._versionstamp is None:
            raise err("no_commit_version")
        return self._versionstamp

    # ───────────────────────────── reads ──────────────────────────────
    def _guard(self):
        if self._state in ("committed", "committing"):
            raise err("used_during_commit")
        if self._state == "cancelled":
            raise err("transaction_cancelled")

    def _read_future(self, key, rv, snapshot, fold_entry=None):
        """One storage point read; its op-log record, read conflict range
        and RYW fold happen on the consuming wait(). A repaired retry
        serves it from the verified cache, resolver-proven equal to
        storage at ``rv``."""
        writes = self._writes if fold_entry is not None else None
        cache = self._repair_cache
        if cache is not None and key in cache:
            val = cache[key]
            self._record_point_read(key, val, snapshot)
            if not snapshot:
                self._add_read_conflict(key, key_successor(key))
            return FutureValue(writes.fold(fold_entry, val)
                               if writes is not None else val)

        rsp, ctx = self._child_span("txn.read")

        def finalize(val, error):
            if rsp is not None:
                rsp.finish()
            if error is not None:
                return None
            self._record_point_read(key, val, snapshot)
            if not snapshot:
                self._add_read_conflict(key, key_successor(key))
            return writes.fold(fold_entry, val) if writes is not None else val

        prior = span_mod.set_current(ctx)
        try:
            val, e = self._cluster.read_storage(key).get(key, rv), None
        except FDBError as exc:
            val, e = None, exc
        finally:
            span_mod.set_current(prior)
        fut = FutureValue(val, e, finalize)
        self._pending_reads.append(fut)
        return fut

    def _record_point_read(self, key, val, snapshot):
        eng = self._repair
        if eng is not None and not snapshot and key not in eng.point_reads:
            eng.point_reads[key] = val

    def get_async(self, key, snapshot=False):
        """Future-returning point read; :meth:`get` waits on it."""
        self._guard()
        key = _check_key(key)
        if key.startswith(b"\xff") and specialkeys.contains(key):
            return self._special_read(FutureValue, specialkeys.get, key)
        rv = self.get_read_version()
        if not self._ryw_disabled:
            known, needs_base, entry = self._writes.lookup(key)
            if known:
                if not needs_base:
                    return FutureValue(self._writes.fold(entry, None))
                return self._read_future(key, rv, snapshot, fold_entry=entry)
        return self._read_future(key, rv, snapshot)

    def get(self, key, snapshot=False):
        return self.get_async(key, snapshot=snapshot).wait()

    def _special_read(self, cls, read, *args):
        """A settled future of a special-space read: no read version, no
        conflict range. Its rows are not verifiable at a later version,
        so this attempt's op log never replays."""
        if self._repair is not None:
            self._repair.unreplayable = True
        try:
            return cls(read(self, *args))
        except FDBError as e:
            return cls(error=e)

    def get_key_async(self, selector, snapshot=False):
        """Future-returning key-selector resolution."""
        self._guard()
        if specialkeys.contains(getattr(selector, "key", None)):
            # selectors are not defined over the materialized special space
            raise err("key_outside_legal_range")
        rv = self.get_read_version()
        if self._repair is not None:
            # a selector's resolution is not recorded key by key, so it
            # cannot be verified at the repair version: never replay
            self._repair.unreplayable = True

        def finalize(k, error):
            if error is not None:
                return None
            if not snapshot and k not in (b"", b"\xff"):
                self._add_read_conflict(k, key_successor(k))
            return k

        try:
            k, e = self._cluster.read_storage().resolve_selector(selector, rv), None
        except FDBError as exc:
            k, e = None, exc
        fut = FutureValue(k, e, finalize)
        self._pending_reads.append(fut)
        return fut

    def get_key(self, selector, snapshot=False):
        return self.get_key_async(selector, snapshot=snapshot).wait()

    def get_range_async(self, begin, end, limit=0, reverse=False,
                        snapshot=False, streaming_mode=None):
        """Future-returning range read: snapshot rows overlaid with this
        txn's writes as they stand when the read is issued. begin/end:
        bytes or KeySelector (selectors resolve at issue)."""
        self._guard()
        if specialkeys.contains(begin) or (
                isinstance(begin, KeySelector)
                and specialkeys.contains(begin.key)):
            # the special space takes literal bytes only
            if not specialkeys.contains(begin) or not isinstance(end, bytes):
                raise err("key_outside_legal_range")
            return self._special_read(
                FutureRange, specialkeys.get_range, begin,
                min(end, specialkeys.END), limit, reverse)
        rv = self.get_read_version()
        st = self._cluster.read_storage()
        if begin is None:
            begin = b""
        if end is None:
            end = b"\xff"
        b = begin if isinstance(begin, bytes) else st.resolve_selector(begin, rv)
        e = end if isinstance(end, bytes) else st.resolve_selector(end, rv)
        if b > e:
            raise err("inverted_range")
        overlaps = not self._ryw_disabled and (
            self._writes.cleared_in(b, e)
            or next(self._writes.overlay_range(b, e), None) is not None)
        if overlaps:
            # merge: fetch the whole base range, overlay the writes
            cleared = list(self._writes.cleared_in(b, e))
            overlay = list(self._writes.overlay_range(b, e))
            req_limit, req_reverse = 0, False
        else:
            # no uncommitted writes in range: limit and reverse go to storage
            cleared = overlay = None
            req_limit, req_reverse = limit, reverse
        sig = (b, e, req_limit, req_reverse)
        writes = self._writes

        def postprocess(rows):
            if overlay is None:
                return rows
            d = dict(rows)
            for cb, ce in cleared:
                for k in [k for k in d if cb <= k < ce]:
                    del d[k]
            for k, entry in overlay:
                base = d.get(k) if not entry.independent else None
                v = writes.fold(entry, base)
                if v is None:
                    d.pop(k, None)
                else:
                    d[k] = v
            out = sorted(d.items(), reverse=reverse)
            return out[:limit] if limit else out

        def record(rows):
            """The op-log entry and the read conflict range, which covers
            what was actually observed."""
            eng = self._repair
            if eng is not None and not snapshot and sig not in eng.range_reads:
                eng.range_reads[sig] = tuple(rows)
            out = postprocess(rows)
            if not snapshot:
                if limit and out:
                    hi = key_successor(out[-1][0]) if not reverse else e
                    lo = b if not reverse else out[-1][0]
                    self._add_read_conflict(lo, hi)
                else:
                    self._add_read_conflict(b, e)
            return out

        rcache = self._repair_range_cache
        if rcache is not None and sig in rcache:
            return FutureRange(record(list(rcache[sig])))

        rsp, ctx = self._child_span("txn.read_range")

        def finalize(rows, error):
            if rsp is not None:
                rsp.finish()
            if error is not None:
                return None
            return record(rows)

        prior = span_mod.set_current(ctx)
        try:
            rows, exc = st.get_range(b, e, rv, limit=req_limit,
                                     reverse=req_reverse), None
        except FDBError as x:
            rows, exc = None, x
        finally:
            span_mod.set_current(prior)
        fut = FutureRange(rows, exc, finalize)
        self._pending_reads.append(fut)
        return fut

    def get_range(self, begin, end, limit=0, reverse=False, snapshot=False,
                  streaming_mode=None):
        """Merged range read → list[(key, value)]."""
        return self.get_range_async(begin, end, limit=limit, reverse=reverse,
                                    snapshot=snapshot).wait()

    def get_range_startswith(self, prefix, **kw):
        prefix = bytes(prefix)
        return self.get_range(prefix, strinc(prefix), **kw)

    # ───────────────────────────── writes ─────────────────────────────
    def _add_read_conflict(self, begin, end):
        self._read_conflicts.append((begin, end))

    def _add_write_conflict(self, begin, end):
        if self._next_write_no_conflict:
            self._next_write_no_conflict = False
            return
        self._write_conflicts.append((begin, end))

    def add_read_conflict_range(self, begin, end):
        self._guard()
        self._read_conflicts.append((bytes(begin), bytes(end)))

    def add_read_conflict_key(self, key):
        self.add_read_conflict_range(key, key_successor(key))

    def add_write_conflict_range(self, begin, end):
        self._guard()
        self._write_conflicts.append((bytes(begin), bytes(end)))

    def add_write_conflict_key(self, key):
        self.add_write_conflict_range(key, key_successor(key))

    def _log_mutation(self, m):
        self._mutation_log.append(m)
        self._size += len(m.key) + len(m.param or b"")
        if self._size > self._knobs.transaction_size_limit:
            raise err("transaction_too_large")

    def set(self, key, value):
        self._guard()
        key = _check_key(key, self._knobs.key_size_limit)
        value = _check_value(value, self._knobs.value_size_limit)
        if key.startswith(b"\xff") and specialkeys.contains(key):
            specialkeys.write(self, key, value)
            return
        self._writes.set(key, value)
        self._log_mutation(Mutation(Op.SET, key, value))
        self._add_write_conflict(key, key + b"\x00")

    def clear(self, key):
        self._guard()
        key = _check_key(key)
        if specialkeys.contains(key):
            specialkeys.clear(self, key)
            return
        self._writes.clear(key)
        self._log_mutation(Mutation(Op.CLEAR_RANGE, key, key_successor(key)))
        self._add_write_conflict(key, key_successor(key))

    def clear_range(self, begin, end):
        self._guard()
        begin, end = _check_key(begin), _check_key(end)
        if begin > end:
            raise err("inverted_range")
        if specialkeys.contains(begin):
            specialkeys.clear_range(self, begin, end)
            return
        self._writes.clear_range(begin, end)
        self._log_mutation(Mutation(Op.CLEAR_RANGE, begin, end))
        self._add_write_conflict(begin, end)

    def clear_range_startswith(self, prefix):
        prefix = bytes(prefix)
        self.clear_range(prefix, strinc(prefix))

    def _atomic(self, op, key, param):
        self._guard()
        key = _check_key(key)
        if specialkeys.contains(key):
            # management modules take set and clear only
            raise err("key_outside_legal_range")
        param = bytes(param)
        self._writes.atomic(op, key, param)
        self._log_mutation(Mutation(op, key, param))
        self._add_write_conflict(key, key_successor(key))

    def add(self, key, param):
        self._atomic(Op.ADD, key, param)

    def bit_and(self, key, param):
        self._atomic(Op.BIT_AND, key, param)

    def bit_or(self, key, param):
        self._atomic(Op.BIT_OR, key, param)

    def bit_xor(self, key, param):
        self._atomic(Op.BIT_XOR, key, param)

    def min(self, key, param):
        self._atomic(Op.MIN, key, param)

    def max(self, key, param):
        self._atomic(Op.MAX, key, param)

    def byte_min(self, key, param):
        self._atomic(Op.BYTE_MIN, key, param)

    def byte_max(self, key, param):
        self._atomic(Op.BYTE_MAX, key, param)

    def append_if_fits(self, key, param):
        self._atomic(Op.APPEND_IF_FITS, key, param)

    def compare_and_clear(self, key, param):
        self._atomic(Op.COMPARE_AND_CLEAR, key, param)

    def set_versionstamped_key(self, key, value):
        self._guard()
        # the key is known only at commit, so it declares no write
        # conflict (versionstamped keys are unique)
        self._log_mutation(Mutation(Op.SET_VERSIONSTAMPED_KEY, key, value))

    def set_versionstamped_value(self, key, value):
        self._guard()
        key = _check_key(key)
        self._log_mutation(Mutation(Op.SET_VERSIONSTAMPED_VALUE, key, value))
        self._add_write_conflict(key, key_successor(key))

    def __getitem__(self, key):
        if isinstance(key, slice):
            return self.get_range(key.start, key.stop)
        return self.get(key)

    def __setitem__(self, key, value):
        self.set(key, value)

    def __delitem__(self, key):
        if isinstance(key, slice):
            self.clear_range(key.start, key.stop)
        else:
            self.clear(key)

    def get_estimated_range_size_bytes(self, begin, end):
        """Ref: fdb_transaction_get_estimated_range_size_bytes — from
        data distribution's sampled shard sizes, an estimate."""
        self._guard()
        if self._repair is not None:
            self._repair.unreplayable = True  # sampled: not re-verifiable
        return self._cluster.estimated_range_size_bytes(
            _check_key(begin), _check_key(end))

    def get_range_split_points(self, begin, end, chunk_size):
        """Ref: fdb_transaction_get_range_split_points — keys cutting
        [begin, end) into chunks of about ``chunk_size`` bytes, both
        ends included."""
        self._guard()
        if self._repair is not None:
            self._repair.unreplayable = True
        return self._cluster.range_split_points(
            _check_key(begin), _check_key(end), int(chunk_size))

    def get_approximate_size(self):
        """The commit payload this transaction has accumulated so far."""
        self._guard()
        return self._size

    # ─────────────────────────── watches ──────────────────────────────
    def watch(self, key):
        """Register interest in a key's changes; active after commit."""
        self._guard()
        key = _check_key(key)
        handle = _WatchHandle(key, self.get(key, snapshot=True))
        self._watches_pending.append(handle)
        return handle

    def _activate_watches(self):
        for h in self._watches_pending:
            h._bind(self._cluster.read_storage(h.key).watch(h.key, h.seen_value))
        self._watches_pending = []

    # ─────────────────────────── commit ───────────────────────────────
    def _drain_reads(self):
        """Settle every issued read before the commit request is built,
        so each adds its conflict range; per-read errors stay with
        their futures."""
        pending, self._pending_reads = self._pending_reads, []
        for fut in pending:
            try:
                fut.wait()
            except FDBError:
                pass

    def _build_commit_request(self):
        self._drain_reads()
        # a read-free txn needs no GRV: the proxy assigns its read
        # version (the resolver compares nothing against it). A tagged
        # txn pays the GRV (its tag gate is there), and so does one with
        # an idempotency id: OCC serializes a retry against its original
        # on the id row, which needs an honest read version
        idmp = self._ensure_idempotency_id()
        if (self._read_version is None and not self._read_conflicts
                and not self._tags and idmp is None):
            rv = None
        else:
            rv = self.get_read_version()
        rcr = _coalesce(self._read_conflicts)
        wcr = _coalesce(self._write_conflicts)
        flat = None
        if self._knobs.commit_pack_path == "flat":
            flat = flatpack.encode_conflicts(rcr, wcr, self._knobs.key_limbs)
        # the commit span: its context rides the request, and the
        # proxy's batch and stage spans parent to it
        sctx = None
        sp = self._trace_span()
        if sp is not span_mod.NULL:
            csp = self._commit_span = sp.child(
                "txn.commit", mutations=len(self._mutation_log))
            sctx = csp.context()
        return CommitRequest(
            read_version=rv,
            mutations=list(self._mutation_log),
            read_conflict_ranges=rcr,
            write_conflict_ranges=wcr,
            # the repair engine needs the conflicting ranges and the
            # rejecting commit version on every 1020 it might repair
            report_conflicting_keys=(self._report_conflicting_keys
                                     or self._repair is not None),
            lock_aware=self._lock_aware,
            idempotency_id=idmp,
            flat_conflicts=flat,
            span_context=sctx,
            tags=tuple(self._tags),
        )

    def _ensure_idempotency_id(self):
        if self._idempotency_id is None and self._auto_idempotency:
            self._idempotency_id = deterministic.token_bytes(
                16, name="idempotency-id")
        return self._idempotency_id

    def _lookup_idempotency(self):
        """The commit version if this txn's id row exists at a fresh read
        version, else None. A cluster mid-recovery may fail the check:
        the 1021 then stands, and the retry resubmits the same id, which
        the proxy's dedupe resolves."""
        key = systemdata.idmp_key(self._idempotency_id)
        try:
            rv = self._cluster.grv_proxy.get_read_version(
                priority="immediate")
            row = self._cluster.read_storage(key).get(key, rv)
        except Exception:
            return None
        return None if row is None else systemdata.unpack_version(row)

    @property
    def repair_ready(self):
        """True when a conflict repair replayed this transaction's op log
        verbatim: the retry loop resubmits (``commit()`` /
        ``commit_async()``) WITHOUT running the body again, which would
        apply the restored mutations twice."""
        return self._repair_ready

    def try_repair(self, error):
        """Repair a failed commit instead of the cold restart
        (txn/repair.py). True: repaired, read version moved to the
        rejecting commit version, no backoff owed — retry now, checking
        :attr:`repair_ready` first. False: restart cold (the caller owns
        reset and backoff). ``on_error`` calls this itself."""
        if not isinstance(error, FDBError):
            return False
        return repair_mod.attempt(self, error)

    def commit(self):
        self._guard()
        self._repair_ready = False  # consumed: this IS the resubmission
        self._drain_reads()
        if not self._mutation_log and not self._write_conflicts:
            # read-only or management-only: nothing to resolve
            specialkeys.commit_special(self)
            self._state = "committed"
            self._activate_watches()
            self._trace_commit_done(None)
            return
        self._precheck_special_lock()
        # through a batching proxy this is submit-and-wait: concurrent
        # committers share a batch
        self._finish_commit(
            self._cluster.commit_proxy.commit(self._build_commit_request()))

    def commit_async(self):
        """Submit to the batching commit proxy; returns a CommitFuture.

        The caller waits until ``fut.done()`` (or on ``fut.result()``),
        then calls :meth:`commit_finish` to apply the outcome. Needs a
        proxy that takes ``submit`` (``commit_pipeline="thread"`` or
        ``"manual"``); the synchronous proxy does not."""
        self._guard()
        self._repair_ready = False  # consumed: this IS the resubmission
        self._drain_reads()
        if not self._mutation_log and not self._write_conflicts:
            from foundationdb_tpu_torch.server.batcher import CommitFuture

            # the same contract as commit()'s read-only path
            specialkeys.commit_special(self)
            self._state = "committed"
            self._activate_watches()
            self._trace_commit_done(None)
            fut = CommitFuture()
            fut.set(None)
            return fut
        self._precheck_special_lock()
        req = self._build_commit_request()
        # in flight: further ops, or a second commit, fail with
        # used_during_commit instead of resubmitting the mutation log
        self._state = "committing"
        return self._cluster.commit_proxy.submit(req)

    def commit_finish(self, fut):
        """Apply a resolved commit_async future (raises FDBError on a
        conflict, exactly like commit())."""
        if self._state == "committed":  # the read-only path is done
            return
        self._finish_commit(fut.result(timeout=0))

    def _precheck_special_lock(self):
        """A transaction with management writes checks the lock before
        its data commits, so a locked database rejects the whole
        transaction (see _finish_commit for the race that remains)."""
        if (self._special_writes and not self._lock_aware
                and self._cluster.lock_uid() is not None):
            raise err("database_locked")

    def _finish_commit(self, result):
        """Data and management writes are not atomic: the data commit
        becomes durable first, then the buffered special-key writes
        apply. A lock that lands between the two halves fences only the
        management half, which is dropped with a trace: the data commit
        passed the proxy's lock check and stands."""
        if (isinstance(result, FDBError) and result.code == 1021
                and self._idempotency_id is not None):
            # commit_unknown_result (ref: IdempotencyId): the id row
            # commits with the mutations, so its presence proves the
            # commit applied: the original outcome, not a 1021
            recovered = self._lookup_idempotency()
            if recovered is not None:
                result = recovered
        if isinstance(result, FDBError):
            self._state = "error"
            self._conflicting_ranges = getattr(
                result, "conflicting_key_ranges", None)
            self._trace_commit_done(result)
            raise result
        if self._repair_assisted:
            # a repaired retry committed: the goodput repair exists for
            repair_mod.note(self._cluster, "repair_commits")
            self._repair_assisted = False
        self._committed_version = result
        self._versionstamp = Versionstamp.from_version(result).tr_version
        self._trace_commit_done(None)
        try:
            specialkeys.commit_special(self)
        except FDBError as e:
            if e.description != "database_locked" or self._lock_aware:
                # a genuine management failure (a lock-aware txn is never
                # fenced; locking over another uid raises its own 1038)
                self._state = "error"
                raise
            TraceEvent("ManagementWritesFencedByLock", severity=30).detail(
                committed_version=result).log()
        self._state = "committed"
        self._activate_watches()

    def on_error(self, error):
        """The retry protocol (ref: Transaction::onError): back off and
        reset for retryable errors, re-raise others."""
        if not isinstance(error, FDBError) or not error.is_retryable:
            raise error
        self._retries += 1
        if self._retry_limit is not None and self._retries > self._retry_limit:
            raise error
        if self.try_repair(error):
            # repaired: no backoff owed, retry now (repair_ready decides
            # whether the body runs again)
            return
        self._backoff.max_s = self._max_retry_delay
        self._backoff.sleep()
        # the retry count, backoff schedule and these options survive the
        # reset, as in the reference binding; the idempotency id too: the
        # same id rides every retry, or the dedupe has nothing to match
        keep = (self._retries, self._backoff, self._retry_limit,
                self._max_retry_delay, self._idempotency_id,
                self._auto_idempotency, self._trace_forced, self._tags)
        self._reset()
        (self._retries, self._backoff, self._retry_limit,
         self._max_retry_delay, self._idempotency_id,
         self._auto_idempotency, self._trace_forced, self._tags) = keep

    def reset(self):
        self._reset()

    def cancel(self):
        """Ref: fdb_transaction_cancel — further use raises 1025 until
        reset()."""
        self._state = "cancelled"
        self._pending_reads = []


class _WatchHandle:
    """Client-side watch future (ref: Watch in NativeAPI)."""

    def __init__(self, key, seen_value):
        self.key = key
        self.seen_value = seen_value
        self._watch = None

    def _bind(self, storage_watch):
        self._watch = storage_watch

    @property
    def active(self):
        return self._watch is not None

    def is_set(self):
        return self._watch is not None and self._watch.fired

    def wait(self, timeout=None, poll=0.001):
        """Block until fired (in-process commits fire synchronously)."""
        if self._watch is None:
            raise err("operation_failed")
        start = time.monotonic()
        poller = Backoff(initial_s=poll, max_s=0.02, growth=1.5)
        while not self._watch.fired:
            if timeout is not None and time.monotonic() - start > timeout:
                raise err("timed_out")
            poller.sleep()
        return True


def _coalesce(ranges):
    """Sort and merge overlapping conflict ranges."""
    if len(ranges) <= 1:
        return list(ranges)
    rs = sorted(ranges)
    out = [list(rs[0])]
    for b, e in rs[1:]:
        if b <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([b, e])
    return [(b, e) for b, e in out]
