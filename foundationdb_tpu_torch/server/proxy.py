"""Commit proxy: batches client commits through resolution to the log.

Ref parity: fdbserver/CommitProxyServer.actor.cpp commitBatch() — the
pipeline is getVersion → resolve → tlog push → storage apply → reply.
The whole batch shares one commit version. The device resolver makes
large batches cheaper per txn, so the proxy's job is to keep batches
full. ``commit_batches`` resolves a backlog of batches in one resolver
dispatch (``Resolver.resolve_many``), each batch with its own version;
``commit_batches_begin`` / ``commit_batches_finish`` split that backlog
into stages for the batcher's pipeline (server/batcher.py).

A proxy FLEET (server/fleet.py) shares two :class:`VersionGate`\\ s that
order the stateful stages — resolver history, then log and storage —
in the sequencer's chained grant order, so several proxies pack and
route at once while the state changes serially.

The proxy serves the cluster's storage servers (its own list, so that a
recruited replacement is seen). With data distribution (server/
datadistribution.py) and ``replication < n_storage``, ``_route`` sends
each mutation to its shard's team (system keys to every storage) and
the tlog push carries that per-storage split as tags; the proxy feeds
DD's byte accounting in the ordered tail. It drives either one resolver
(a single device resolver, a lane fleet of resolver/meshresolver.py, or
one host set, Python or native) or several host resolvers, each owning
a contiguous key range derived from the shard map
(``update_resolver_ranges``): then every batch is clipped per resolver,
the sub-batches resolve on a thread pool, and a txn commits iff every
resolver accepts it (``_resolve``).

Admission before a batch takes a version: an idempotency id already
committed answers its original version (``_dedupe_idempotent``); under
a constrained ratekeeper a read-free request pays its admission here
(1037); a locked database (``lock_uid``) fails every request that is not
lock-aware with 1038; a tenant mode other than ``"optional"`` fails a
request that writes outside the space the mode allows (2130 / 2134,
``_tenant_mode_violation``). An id-carrying request writes its
``\\xff\\x02/idmp/`` row with the commit, and conflicts on it, and expired
rows are cleared every ``pump_interval`` batches.

After the log has a batch: with a sync satellite (server/region.py) the
batch reaches the remote region's log before any storage applies it or
any client sees its ack; the change feeds (server/changefeed.py) get its
mutations after the storage apply and before the version is readable.
Observability (utils/): the proxy's metrics registry, which the
cluster owns and hands each incarnation, counts committed txns, batches
and every abort by error class (``abort_<name>``), each tag's outcomes
(``tag_<outcome>_<tag>``), repairs and scheduler decisions, and holds
the ``commit_e2e`` latency band (a batching wrapper records it instead,
with the queue wait). A rejected txn charges the cluster's conflict
heatmap at its first read keys. A batch with a sampled member emits a
``proxy.batch`` span around its ordered tail, under which the log push
and the storage applies nest; the resolver's scan span nests under the
first sampled member's context.
"""

import time

from foundationdb_tpu_torch.core import flatpack, systemdata
from foundationdb_tpu_torch.core.commit import CommitRequest  # noqa: F401
from foundationdb_tpu_torch.core.errors import FDBError
from foundationdb_tpu_torch.core.mutations import (
    Mutation,
    Op,
    substitute_versionstamp,
)
from foundationdb_tpu_torch.core.status import COMMITTED, CONFLICT, TOO_OLD
from foundationdb_tpu_torch.resolver.resolver import ResolverDown
from foundationdb_tpu_torch.resolver.skiplist import TxnRequest
from foundationdb_tpu_torch.server import scheduler
from foundationdb_tpu_torch.server.sequencer import SequencerDown
from foundationdb_tpu_torch.server.tlog import TLogDown
from foundationdb_tpu_torch.utils import deviceprofile
from foundationdb_tpu_torch.utils import heatmap as heatmap_mod
from foundationdb_tpu_torch.utils import lockdep
from foundationdb_tpu_torch.utils import metrics as metrics_mod
from foundationdb_tpu_torch.utils import span as span_mod
from foundationdb_tpu_torch.utils.trace import SEV_ERROR, TraceEvent

_STAMPED = (Op.SET_VERSIONSTAMPED_KEY, Op.SET_VERSIONSTAMPED_VALUE)
REPAIR_COUNTERS = ("repair_attempts", "repair_commits", "repair_fallbacks")


class GateTimeout(Exception):
    """A gate turn no one will take (a peer proxy died between its
    grant and its advance): the fleet is wedged until a txn-system
    recovery rebuilds the gates. Callers answer a retryable 1021 and
    mark the proxy dead; it never reaches a client."""


class VersionGate:
    """Version-ordered turnstile for a commit-proxy fleet (ref: the
    sequencer's prevVersion chaining, resolvers and logs taking batches
    in version order). A batch granted (prev, v) passes once every
    earlier grant has: ``enter(prev)`` blocks until the frontier reaches
    ``prev``; ``advance(v)`` moves it."""

    def __init__(self, start, timeout=60.0):
        self._v = start
        self.timeout = timeout
        self._cond = lockdep.condition("VersionGate._cond")

    def enter(self, prev, timeout=None):
        with self._cond:
            if not self._cond.wait_for(
                lambda: self._v >= prev,
                self.timeout if timeout is None else timeout,
            ):
                raise GateTimeout(
                    f"version gate stuck at {self._v}, waiting for {prev}")

    def advance(self, v):
        with self._cond:
            if v > self._v:
                self._v = v
            self._cond.notify_all()


class _PipelinedGroup:
    """One backlog group mid-pipeline: versions granted, txns packed,
    resolve dispatched lazily (stages A+B). ``commit_batches_finish``
    runs stage C. A group that failed in begin carries its results and
    whether its grant's gate turns are still owed; ``resolve_s`` /
    ``apply_s`` are stage-C timings for the batcher's StageStats."""

    __slots__ = ("request_batches", "metas", "handle", "first_prev",
                 "last_cv", "granted", "results_list", "error",
                 "resolve_s", "apply_s", "plans", "trace_ctx")

    def __init__(self, request_batches):
        self.request_batches = request_batches
        self.metas = None
        # per-batch SchedulePlans: finish maps position-ordered results
        # back to request order through these
        self.plans = None
        self.handle = None
        self.first_prev = self.last_cv = None
        self.granted = False
        self.results_list = None
        self.error = None
        self.resolve_s = 0.0
        self.apply_s = 0.0
        # the group's first sampled span context, scanned once in begin
        # (the batcher's stage spans reuse it)
        self.trace_ctx = None


class CommitProxy:
    # id rows outlive the MVCC window by this factor: the slack a delayed
    # retry has to arrive and still dedupe instead of applying twice
    IDMP_RETENTION_WINDOWS = 10

    def __init__(self, sequencer, resolvers, tlog, storages, knobs,
                 ratekeeper=None, dd=None, change_feeds=None, regions=None,
                 resolve_gate=None, log_gate=None, metrics=None,
                 heatmap=None, fanout_profile=None):
        self.alive = True
        # the role's registry: the cluster hands every incarnation the
        # same one, so no counter goes backwards across a recovery
        self.metrics = (metrics if metrics is not None
                        else metrics_mod.MetricsRegistry("commit_proxy"))
        self._m_committed = self.metrics.counter("txn_committed")
        self._m_batches = self.metrics.counter("commit_batches")
        self._abort_counters = {}
        self._tag_counters = {}
        # the cluster's conflict heatmap (None: workload sampling off)
        self.conflict_heat = heatmap
        # the host fan-out's lane counts land in the cluster's resolver-0
        # device profile
        self._fanout_profile = fanout_profile
        # commit_e2e is recorded here unless a batching wrapper claims it
        self.spans_owned_externally = False
        self._m_e2e = self.metrics.latency("commit_e2e")
        self._m_sched_reordered = self.metrics.counter("sched_reordered")
        self._m_sched_deferred = self.metrics.counter("sched_deferred")
        self.sequencer = sequencer
        # the cluster's own list: a recruit replacing an entry is seen here
        self.resolvers = resolvers
        self.tlog = tlog
        # the cluster's own list: a recruited storage is seen here
        self.storages = storages
        self.knobs = knobs
        self.ratekeeper = ratekeeper
        self.dd = dd  # data distribution: the shard map and byte accounting
        # the database lock's uid (None: unlocked); the cluster sets it
        self.lock_uid = None
        # "optional", "required" or "disabled" (layers/tenant.py); the
        # cluster sets it
        self.tenant_mode = "optional"
        # the cluster's ChangeFeedRegistry (shared by a fleet's members)
        self.change_feeds = change_feeds
        # the cluster's RegionReplicator, or None; the cluster swaps it
        # when regions are configured or removed
        self.regions = regions
        # fleet ordering (None when this proxy is the whole fleet)
        self.resolve_gate = resolve_gate
        self.log_gate = log_gate
        self.commit_count = 0
        self.conflict_count = 0
        # how many request batches packed columnar vs legacy
        self.pack_flat_batches = 0
        self.pack_legacy_batches = 0
        # the batch scheduler's decisions (zero with the knob off)
        self.sched_batches = 0
        self.sched_reordered_total = 0
        self.sched_deferred_total = 0
        # client threads may drive the proxy directly: the pipeline's
        # state (resolver history, log order, storage) changes serially
        self._commit_mu = lockdep.rlock("CommitProxy._commit_mu")
        self._batches_since_pump = 0
        self.pump_interval = 64  # batches between durability pumps
        self._pool = None  # sub-resolve threads, made at first fan-out
        self.resolver_bounds = None  # n-1 split keys; None: even split
        self.update_resolver_ranges(fence=False)

    @property
    def resolver(self):
        """The first resolver (the only one unless host resolvers fan out)."""
        return self.resolvers[0]

    def note_repair(self, name, n=1):
        """Count a transaction-repair outcome its client reports
        (txn/repair.py)."""
        if n > 0:
            self.metrics.counter(name).inc(n)

    @property
    def repair_counts(self):
        counters = self.metrics.snapshot()["counters"]
        return {name: counters.get(name, 0) for name in REPAIR_COUNTERS}

    def _note_abort(self, name, n=1):
        """One counter per error class of the txns this proxy failed
        (ref: the per-reason txn counters of status json)."""
        if n <= 0 or not metrics_mod.enabled():
            return
        c = self._abort_counters.get(name)
        if c is None:
            c = self._abort_counters[name] = self.metrics.counter(
                f"abort_{name}")
        c.inc(n)

    def _note_tags(self, outcome, tags):
        """Per-tag outcomes: ``tag_{outcome}_{tag}`` counters (ref: the
        per-tag counters TagThrottle reads)."""
        if not tags or not metrics_mod.enabled():
            return
        for t in tags:
            key = (outcome, t)
            c = self._tag_counters.get(key)
            if c is None:
                c = self._tag_counters[key] = self.metrics.counter(
                    f"tag_{outcome}_{t}")
            c.inc()

    def _conflict_heat(self, req, out):
        """Append one rejected txn's conflict heat to ``out`` as (entry,
        weight) pairs. A flat request's charged keys are its raw limb
        entries sliced out of the blobs (order-isomorphic to the keys,
        nothing decoded); a legacy one encodes its first keys. The
        abort's unit weight is split across the charged entries, so the
        total heat counts aborts."""
        entries = []
        f = req.flat_conflicts
        if f is not None:
            w = flatpack.entry_width(f.num_limbs)
            blob = f.read_point_blob
            for o in range(0, min(len(blob), 8 * w), w):
                entries.append(blob[o: o + w])
            rblob = f.read_range_blob  # pairs: each range's begin
            for o in range(0, min(len(rblob), 16 * w), 2 * w):
                entries.append(rblob[o: o + w])
            if not entries:  # read-free: the write set instead
                blob = f.write_point_blob
                for o in range(0, min(len(blob), 8 * w), w):
                    entries.append(blob[o: o + w])
        else:
            limbs = self.knobs.key_limbs
            ranges = req.read_conflict_ranges or req.write_conflict_ranges
            for begin, _end in ranges[:8]:
                e = flatpack.encode_entry(begin, limbs)
                if e is not None:  # over-capacity keys stay unsampled
                    entries.append(e)
        if entries:
            wgt = 1.0 / len(entries)
            out.extend((e, wgt) for e in entries)

    def status(self):
        """This role's status payload: liveness and the registry."""
        return {"alive": self.alive, "metrics": self.metrics.snapshot()}

    def update_resolver_ranges(self, fence=True):
        """Derive each host resolver's key range from the shard map,
        weighted by the shards' sampled bytes, so resolver load follows
        the writes (ref: the keyResolvers map the proxies keep from
        keyServers); an even first-byte split until the map has enough
        shards to cut n ranges. The cluster calls this after every
        rebalance round and at recovery. A boundary that moves strands
        history in the resolver that used to own a key, so a change
        rebuilds the resolvers fenced at the committed version: in-flight
        txns get TOO_OLD and retry with fresh reads, as a reference
        resolver range changes only through a fencing recovery.
        ``fence=False`` is for construction, when there is no history.
        One resolver (a device resolver or a lane fleet) has no ranges."""
        n = len(self.resolvers)
        if n == 1:
            return
        smap = self.dd.map if self.dd is not None else None
        if smap is None or len(smap) < n:
            new_bounds = None
        else:
            weights = [size + 1 for size in smap.sizes]  # empty ones count
            total = sum(weights)
            bounds, acc = [], 0
            for i in range(len(smap) - 1):
                acc += weights[i]
                if (acc >= (len(bounds) + 1) * total / n
                        and len(bounds) < n - 1):
                    bounds.append(smap.boundaries[i + 1])
            new_bounds = bounds if len(bounds) == n - 1 else None
        if new_bounds != self.resolver_bounds and fence:
            cv = self.sequencer.committed_version
            for i in range(n):
                self.resolvers[i] = self.resolvers[i].respawn(cv)
        self.resolver_bounds = new_bounds

    def _resolver_range(self, i, n):
        """Resolver i's key range: the shard map's bounds when derived,
        else an even first-byte split. The last upper bound is None
        (+infinity), so no key, the system keys included, escapes."""
        b = self.resolver_bounds
        if b is not None:
            return (b[i - 1] if i else b""), (b[i] if i < len(b) else None)
        return _resolver_range(i, n)

    def kill(self):
        """Process death: every commit answers 1021 until the failure
        monitor recruits a new transaction-system generation."""
        self.alive = False

    def close(self):
        """Release the sub-resolve thread pool."""
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None

    def commit(self, request):
        """Single-transaction batch (the synchronous client path)."""
        return self.commit_batch([request])[0]

    def commit_batch(self, requests):
        """Resolve and commit a batch; returns per-request (version or
        FDBError). Accepted txns' mutations are logged in batch order and
        applied to storage before the reply, so a later GRV sees them."""
        if not requests:
            return []
        if not self.alive or not self.sequencer.alive:
            self._note_abort("commit_unknown_result", len(requests))
            return [FDBError.from_name("commit_unknown_result")
                    for _ in requests]
        t0 = (None if self.spans_owned_externally
              or not metrics_mod.enabled() else metrics_mod.now())
        try:
            with self._commit_mu:
                return self._commit_batch_locked(requests)
        except GateTimeout:
            return self._gate_wedged(len(requests))
        finally:
            if t0 is not None:
                self._note_e2e(t0, len(requests))

    def _note_e2e(self, t0, n_txns):
        """The commit_e2e band, and with tracing on a ``commit.window``
        span for a window that outlived ``tracing_slow_commit_ms`` (the
        batcher's _record_span for proxies without one)."""
        end = metrics_mod.now()
        dur = max(0.0, end - t0)
        self._m_e2e.record(dur)
        if (self.knobs.tracing_sample_rate > 0.0
                and dur * 1e3 >= self.knobs.tracing_slow_commit_ms):
            span_mod.slow_window_span(t0, end, txns=n_txns)

    def _gate_wedged(self, n):
        """A gate turn went unclaimed (a peer died between grant and
        advance): mark this proxy dead, so a recovery can build fresh
        gates, and answer 1021 — the batch's fate is unknown."""
        self.kill()
        self._note_abort("commit_unknown_result", n)
        return [FDBError.from_name("commit_unknown_result") for _ in range(n)]

    def _partition_rejects(self, requests, reject_fn):
        """Per-request admission: ``reject_fn(request)`` names an error
        (rejected) or is None (passes); the passing requests commit as a
        sub-batch. The merged results, or None when nothing was rejected
        (the caller goes on with the whole batch)."""
        results = [None] * len(requests)
        passing = []
        for i, r in enumerate(requests):
            bad = reject_fn(r)
            if bad is None:
                passing.append((i, r))
            else:
                self._note_abort(bad)
                results[i] = FDBError.from_name(bad)
        if len(passing) == len(requests):
            return None
        if passing:
            try:
                sub = self._commit_batch_admitted([r for _, r in passing])
            except GateTimeout:
                # only the sub-batch's fate is unknown: the definite
                # rejections stand
                sub = self._gate_wedged(len(passing))
            for (i, _), res in zip(passing, sub):
                results[i] = res
        return results

    @staticmethod
    def _tenant_mode_violation(mode, mutations):
        """The structural tenant-mode check, by key range: tenant data
        lives in [\\xfd, \\xfe), plain user data in [, \\xfd) and
        [\\xfe, \\xff), system keys (exempt) from \\xff. A clear range is
        judged by its whole span: one that straddles a boundary violates
        whichever space the mode forbids."""
        for m in mutations:
            if m.key >= b"\xff":
                continue
            if m.op == Op.CLEAR_RANGE:
                b, e = m.key, min(m.param, b"\xff")
                touches_tenant = b < b"\xfe" and e > b"\xfd"
                touches_plain = b < b"\xfd" or e > b"\xfe"
            else:
                touches_tenant = m.key.startswith(b"\xfd")
                touches_plain = not touches_tenant
            if mode == "required" and touches_plain:
                return "tenant_name_required"
            if mode == "disabled" and touches_tenant:
                return "tenants_disabled"
        return None

    def _idmp_lookup(self, idempotency_id):
        """The commit version recorded for ``idempotency_id``, or None,
        read from a live storage's system keys (replicated everywhere) at
        its latest version: every earlier commit of this serialized
        pipeline is visible there."""
        key = systemdata.idmp_key(idempotency_id)
        for s in self.storages:
            if s.alive:
                row = s.get(key, s.version)
                return None if row is None else systemdata.unpack_version(row)
        return None

    def _pin_idmp_rv(self, request_batches):
        """Give read-free id-carrying requests their read version before
        their dedupe lookup runs: the lookup and the OCC conflict on the
        id row (``_idmp_point``) together cover every interleaving with
        a concurrently committing original only if the read version is
        fixed first."""
        for reqs in request_batches:
            for r in reqs:
                if r.read_version is None and r.idempotency_id:
                    r.read_version = self.sequencer.committed_version

    def _dedupe_idempotent(self, requests):
        """Exactly-once at the proxy (ref: IdempotencyId): a request whose
        id already committed answers its original version and applies
        nothing. The merged results, or None when nothing matched."""
        self._pin_idmp_rv([requests])
        results = [None] * len(requests)
        passing = []
        for i, r in enumerate(requests):
            v = (self._idmp_lookup(r.idempotency_id)
                 if r.idempotency_id else None)
            if v is None:
                passing.append((i, r))
            else:
                self.metrics.counter("idmp_dedupe_hits").inc()
                results[i] = v  # the original commit's version: success
        if len(passing) == len(requests):
            return None
        if passing:
            sub = self._commit_batch_admitted([r for _, r in passing])
            for (i, _), res in zip(passing, sub):
                results[i] = res
        return results

    def _constrained(self):
        """True when the ratekeeper's budget can refuse an admission."""
        rk = self.ratekeeper
        return rk is not None and rk.target_tps < rk.UNLIMITED_TPS

    def _commit_batch_locked(self, requests):
        if any(r.idempotency_id for r in requests):
            out = self._dedupe_idempotent(requests)
            if out is not None:
                return out
        return self._commit_batch_admitted(requests)

    def _commit_batch_admitted(self, requests):
        """The batch past the idempotency dedupe: the ratekeeper's gate
        for read-free requests, the database lock, then the pipeline."""
        if self._constrained():
            # read-free requests skipped the GRV; under a constrained
            # budget they pay admission here instead (the same bucket,
            # the same retryable 1037). The gate assigns the read version
            # on admission, so a sub-batch cannot be charged twice
            rk = self.ratekeeper
            rv_now = self.sequencer.committed_version

            def gate(r):
                if r.read_version is not None:
                    return None
                if rk.admit():
                    r.read_version = rv_now
                    return None
                return "process_behind"

            out = self._partition_rejects(requests, gate)
            if out is not None:
                return out
        if self.lock_uid is not None:
            # the database is locked (ref: lockDatabase, 1038): only
            # lock-aware transactions pass
            out = self._partition_rejects(
                requests,
                lambda r: None if r.lock_aware else "database_locked")
            if out is not None:
                return out
        mode = self.tenant_mode
        if mode != "optional":
            out = self._partition_rejects(
                requests,
                lambda r: self._tenant_mode_violation(mode, r.mutations))
            if out is not None:
                return out
        try:
            prev, cv = self.sequencer.next_commit_versions(1)[0]
        except SequencerDown:
            # the kill raced past the entry check: the same 1021
            self._note_abort("commit_unknown_result", len(requests))
            return [FDBError.from_name("commit_unknown_result")
                    for _ in requests]
        window = self._window(cv)
        requests, plan = self._maybe_schedule(requests)
        try:
            txns = self._build_txns(requests)
        except BaseException:
            # granted but neither gate consumed: skip both turns or
            # every successor waits on a turn no one will take
            self._skip_turns_quiet(prev, cv)
            raise
        # the resolver's scan span nests under the first sampled
        # member's commit span
        rctx = span_mod.first_request_context(requests)
        try:
            prior_ctx = span_mod.set_current(rctx) if rctx else None
            try:
                statuses = self._resolve_ordered(txns, cv, window, prev)
            finally:
                if rctx is not None:
                    span_mod.set_current(prior_ctx)
        except ResolverDown:
            # resolution never ran: definitively not committed; the
            # granted version still consumes its log turn
            self._skip_turns_quiet(prev, cv)
            self._note_abort("not_committed", len(requests))
            return [FDBError.from_name("not_committed") for _ in requests]
        except GateTimeout:
            raise
        except BaseException:
            # the resolve gate's finally already advanced; the log turn
            # is still owed
            self._skip_turns_quiet(prev, cv)
            raise
        results = self._finalize_batch(requests, txns, statuses, cv, window,
                                       prev, traced=rctx is not None,
                                       plan=plan)
        return plan.restore(results) if plan is not None else results

    def _resolve_ordered(self, txns, cv, window, prev):
        """Resolution in global version order: the history is stateful,
        so a fleet's batches enter it exactly in grant order."""
        if self.resolve_gate is None:
            return self._resolve(txns, cv, window)
        self.resolve_gate.enter(prev)
        try:
            return self._resolve(txns, cv, window)
        finally:
            # advance even on failure: the version is consumed either way
            self.resolve_gate.advance(cv)

    def _skip_turns_quiet(self, prev, cv):
        """Consume a failed batch's turns at both gates without doing its
        work, in order but quietly: called from failure handlers, a
        wedged gate must not replace the outcome being propagated. Once
        one gate proves wedged the other gets a zero wait, and the proxy
        marks itself dead."""
        wedged = False
        for gate in (self.resolve_gate, self.log_gate):
            if gate is None:
                continue
            try:
                gate.enter(prev, timeout=0.0 if wedged else None)
                gate.advance(cv)
            except GateTimeout:
                wedged = True
                self.kill()

    def commit_batches(self, request_batches):
        """Commit a backlog of batches: each gets its own commit version,
        resolution for all of them takes one resolver dispatch, then each
        batch finalizes in order. The same results as commit_batch per
        batch."""
        if (len(self.resolvers) != 1 or not self.alive
                or not self.sequencer.alive):
            # several host resolvers take the per-batch fan-out (each
            # batch records its own commit_e2e)
            return [self.commit_batch(reqs) for reqs in request_batches]
        t0 = (None if self.spans_owned_externally
              or not metrics_mod.enabled() else metrics_mod.now())
        try:
            return self._commit_batches_outer(request_batches)
        finally:
            if t0 is not None:
                # one record per backlog: its batches reply together
                self._note_e2e(t0, sum(len(r) for r in request_batches))

    def _commit_batches_outer(self, request_batches):
        try:
            with self._commit_mu:
                if (self.lock_uid is not None
                        or self.tenant_mode != "optional"):
                    # checked under the mutex: a lock or a tenant mode
                    # that landed while the backlog queued applies to it
                    # as commit_batch would (the reference checks only
                    # the lock here, so its backlogs skip the mode)
                    return self._commit_each(request_batches)
                return self._commit_batches_locked(request_batches)
        except GateTimeout:
            return [self._gate_wedged(len(reqs)) for reqs in request_batches]

    def _commit_each(self, request_batches):
        """A backlog batch by batch, under the held mutex. A wedge part
        way through leaves the known outcomes standing: only the rest is
        unknown."""
        out = []
        try:
            for reqs in request_batches:
                out.append(self._commit_batch_locked(reqs))
        except GateTimeout:
            for reqs in request_batches[len(out):]:
                out.append(self._gate_wedged(len(reqs)))
        return out

    def _needs_serial_route(self, request_batches):
        """A dedupe hit, or a read-free request under a constrained
        budget, sends a backlog batch by batch, where each is admitted
        (both are rare: a real 1021 retry, an overloaded cluster)."""
        self._pin_idmp_rv(request_batches)
        if any(r.idempotency_id and self._idmp_lookup(r.idempotency_id)
               is not None for reqs in request_batches for r in reqs):
            return True
        return self._constrained() and any(
            r.read_version is None for reqs in request_batches for r in reqs)

    def _commit_batches_locked(self, request_batches):
        if self._needs_serial_route(request_batches):
            return self._commit_each(request_batches)
        try:
            # the whole backlog's versions in one chained grant: no other
            # proxy's batch lands inside the run, so one gate span covers it
            pairs = self.sequencer.next_commit_versions(len(request_batches))
        except SequencerDown:
            self._note_abort("commit_unknown_result",
                             sum(len(r) for r in request_batches))
            return [[FDBError.from_name("commit_unknown_result") for _ in reqs]
                    for reqs in request_batches]
        first_prev, last_cv = pairs[0][0], pairs[-1][1]
        try:
            metas, plans = self._build_group(request_batches, pairs)
        except BaseException:
            self._skip_turns_quiet(first_prev, last_cv)
            raise
        gctx = span_mod.first_request_context(
            r for reqs in request_batches for r in reqs)
        if self.resolve_gate is not None:
            self.resolve_gate.enter(first_prev)
        try:
            prior_ctx = span_mod.set_current(gctx) if gctx else None
            try:
                statuses_list = self.resolver.resolve_many(
                    [(txns, cv, window) for _, txns, cv, window in metas])
            finally:
                if gctx is not None:
                    span_mod.set_current(prior_ctx)
        except ResolverDown:
            self._skip_turns_quiet(first_prev, last_cv)
            self._note_abort("not_committed",
                             sum(len(r) for r in request_batches))
            return [[FDBError.from_name("not_committed") for _ in reqs]
                    for reqs in request_batches]
        except BaseException:
            # resolve_many touches no gate: skip the owed log turn
            # quietly and let the root cause propagate
            self._skip_turns_quiet(first_prev, last_cv)
            raise
        finally:
            if self.resolve_gate is not None:
                self.resolve_gate.advance(last_cv)
        if self.log_gate is not None:
            self.log_gate.enter(first_prev)
        try:
            return self._finalize_group(metas, statuses_list, plans,
                                        traced=gctx is not None)
        finally:
            if self.log_gate is not None:
                self.log_gate.advance(last_cv)

    def _build_group(self, request_batches, pairs):
        """Each batch of a granted backlog scheduled and built: the
        (requests, txns, cv, window) metas and the SchedulePlans."""
        metas, plans = [], []
        for reqs, (_prev, cv) in zip(request_batches, pairs):
            reqs, plan = self._maybe_schedule(reqs)
            plans.append(plan)
            metas.append((reqs, self._build_txns(reqs), cv, self._window(cv)))
        return metas, plans

    def _finalize_group(self, metas, statuses_list, plans, traced):
        out = []
        for (reqs, txns, cv, window), statuses, plan in zip(
                metas, statuses_list, plans):
            res = self._finalize_batch(reqs, txns, statuses, cv, window,
                                       traced=traced, plan=plan)
            out.append(plan.restore(res) if plan is not None else res)
        return out

    # ── pipelined backlog (server/batcher.py's bounded pipeline) ─────
    # The serial backlog split into stages so the batcher keeps
    # commit_pipeline_depth groups in flight: stages A+B (begin: grant,
    # host packing, gate-ordered LAZY resolve dispatch) on the batcher
    # thread while stage C (finish: status sync, tlog push, storage
    # apply) runs on the apply thread for the previous group. The
    # resolve gate orders dispatch, the log gate the tail; without a
    # fleet the batcher's FIFO apply queue gives the same order.

    def pipeline_eligible(self, request_batches):
        """Stage-A admission: the pipelined route serves the common case.
        The database lock, a tenant mode, a constrained ratekeeper with
        read-free requests, a dedupe hit, the host resolvers' fan-out and
        dead roles take the serial commit_batches, which handles them."""
        if (len(self.resolvers) != 1 or not self.alive
                or not self.sequencer.alive or self.lock_uid is not None
                or self.tenant_mode != "optional"):
            return False
        return not self._needs_serial_route(request_batches)

    def commit_batches_begin(self, request_batches):
        """Stages A+B of the pipelined backlog: chained version grant,
        host packing and the gate-ordered lazy resolve dispatch. Always
        returns a _PipelinedGroup: a failure is captured in the group
        (results precomputed, owed gate turns recorded) so the caller
        settles it through commit_batches_finish in order with the rest.
        Begin runs on one thread in grant order; finish runs FIFO on one
        thread."""
        group = _PipelinedGroup(request_batches)
        n_total = sum(len(reqs) for reqs in request_batches)

        def err_1021():
            self._note_abort("commit_unknown_result", n_total)
            return [[FDBError.from_name("commit_unknown_result") for _ in reqs]
                    for reqs in request_batches]

        try:
            pairs = self.sequencer.next_commit_versions(len(request_batches))
        except SequencerDown:
            group.results_list = err_1021()
            return group
        group.first_prev, group.last_cv = pairs[0][0], pairs[-1][1]
        group.granted = True
        try:
            metas, group.plans = self._build_group(request_batches, pairs)
        except Exception as e:
            group.error = e
            group.results_list = err_1021()
            return group
        gctx = group.trace_ctx = span_mod.first_request_context(
            r for reqs in request_batches for r in reqs)
        try:
            if self.resolve_gate is not None:
                self.resolve_gate.enter(group.first_prev)
            try:
                prior_ctx = span_mod.set_current(gctx) if gctx else None
                try:
                    group.handle = self.resolver.resolve_many(
                        [(txns, cv, window)
                         for _, txns, cv, window in metas], lazy=True)
                finally:
                    if gctx is not None:
                        span_mod.set_current(prior_ctx)
            finally:
                if self.resolve_gate is not None:
                    self.resolve_gate.advance(group.last_cv)
        except GateTimeout:
            # a wedged fleet: kill and 1021s; no turn is consumed, only
            # a recovery (fresh gates) unwedges
            group.granted = False
            group.results_list = [self._gate_wedged(len(reqs))
                                  for reqs in request_batches]
            return group
        except ResolverDown:
            # definitively not committed; the log turn is still owed
            self._note_abort("not_committed", n_total)
            group.results_list = [
                [FDBError.from_name("not_committed") for _ in reqs]
                for reqs in request_batches]
            return group
        except Exception as e:
            group.error = e
            group.results_list = err_1021()
            return group
        group.metas = metas
        return group

    def commit_batches_finish(self, group):
        """Stage C of the pipelined backlog: materialize the statuses
        (the one host sync), then the gate-ordered tail — tlog push,
        storage apply, reporting. Also where a group that failed in
        begin settles: its owed gate turns are consumed here, in
        pipeline order."""
        if group.results_list is not None:
            if group.granted:
                self._skip_turns_quiet(group.first_prev, group.last_cv)
            return group.results_list
        t0 = time.perf_counter()
        try:
            statuses_list = group.handle.wait()
        except Exception as e:
            # the dispatched step faulted at materialization: the history
            # of these versions is suspect, and both turns are owed
            self._skip_turns_quiet(group.first_prev, group.last_cv)
            group.error = e
            self._note_abort("commit_unknown_result", sum(
                len(reqs) for reqs in group.request_batches))
            return [[FDBError.from_name("commit_unknown_result") for _ in reqs]
                    for reqs in group.request_batches]
        group.resolve_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        with self._commit_mu:
            if not self.alive or not self.sequencer.alive:
                # killed mid-pipeline: nothing may reach the log
                self._skip_turns_quiet(group.first_prev, group.last_cv)
                self._note_abort("commit_unknown_result", sum(
                    len(reqs) for reqs in group.request_batches))
                return [[FDBError.from_name("commit_unknown_result")
                         for _ in reqs]
                        for reqs in group.request_batches]
            try:
                if self.log_gate is not None:
                    self.log_gate.enter(group.first_prev)
            except GateTimeout:
                return [self._gate_wedged(len(reqs))
                        for reqs in group.request_batches]
            try:
                return self._finalize_group(
                    group.metas, statuses_list, group.plans,
                    traced=group.trace_ctx is not None)
            finally:
                if self.log_gate is not None:
                    self.log_gate.advance(group.last_cv)
                group.apply_s = time.perf_counter() - t1

    def _window(self, cv):
        return max(0, cv - self.knobs.max_read_transaction_life_versions)

    def _maybe_schedule(self, requests):
        """Reorder the batch host-side (server/scheduler.py) so reads
        resolve before the writes they overlap. Returns the request list
        in commit order and the plan that maps results back to request
        order, or (requests, None) when the knob is off or the pass
        declined."""
        if not self.knobs.commit_batch_scheduling or len(requests) < 2:
            return requests, None
        plan = scheduler.schedule(requests)
        if plan is None or plan.identity:
            return requests, None
        self.sched_batches += 1
        self.sched_reordered_total += plan.reordered
        self.sched_deferred_total += plan.deferred
        self._m_sched_reordered.inc(plan.reordered)
        self._m_sched_deferred.inc(plan.deferred)
        return [requests[i] for i in plan.order], plan

    def _try_build_flat(self, requests):
        """The columnar batch build (core/flatpack.py), when the knob,
        the resolver and every request agree; else None (legacy)."""
        if (self.knobs.commit_pack_path != "flat"
                or len(self.resolvers) != 1
                or not self.resolver.accepts_flat):
            return None
        return flatpack.build_flat_batch(requests, self.knobs.key_limbs,
                                         self._idmp_point)

    @staticmethod
    def _idmp_point(r):
        """The id row an id-carrying request writes and read-conflicts
        on, or None: OCC then serializes a retry against its own
        original even on different fleet members or pipeline groups."""
        iid = r.idempotency_id
        return systemdata.idmp_key(iid) if iid else None

    def _build_txns(self, requests):
        """The batch for the resolver: a FlatTxnBatch, or TxnRequests
        with points split from ranges. A read-free request (read_version
        None) gets the current committed version: the resolver compares
        nothing against it, it only places the txn in the window."""
        rv_assigned = None
        n_lazy = 0
        for r in requests:
            if r.read_version is None:
                if rv_assigned is None:
                    rv_assigned = self.sequencer.committed_version
                r.read_version = rv_assigned
                n_lazy += 1
        if n_lazy and self.ratekeeper is not None:
            # they bypassed the GRV's admission sample: feed its base, or
            # tagged shares read inflated
            self.ratekeeper.note_untagged_admissions(n_lazy)
        flat = self._try_build_flat(requests)
        if flat is not None:
            self.pack_flat_batches += 1
            return flat
        self.pack_legacy_batches += 1
        if not all(r.wants_point_split for r in self.resolvers):
            # the Python host set takes a point as the tiny range it is
            out = []
            for r in requests:
                ik = self._idmp_point(r)
                extra = [(ik, ik + b"\x00")] if ik is not None else []
                out.append(TxnRequest(
                    read_version=r.read_version,
                    range_reads=(list(r.read_conflict_ranges) + extra
                                 if extra else r.read_conflict_ranges),
                    range_writes=(list(r.write_conflict_ranges) + extra
                                  if extra else r.write_conflict_ranges)))
            return out
        out = []
        for r in requests:
            pr, rr = _split_ranges(r.read_conflict_ranges)
            pw, rw = _split_ranges(r.write_conflict_ranges)
            ik = self._idmp_point(r)
            if ik is not None:
                pr = pr + [ik]
                pw = pw + [ik]
            out.append(TxnRequest(read_version=r.read_version,
                                  point_reads=pr, point_writes=pw,
                                  range_reads=rr, range_writes=rw))
        return out

    def _finalize_batch(self, requests, txns, statuses, cv, window,
                        prev=None, traced=True, plan=None):
        """Everything after resolution: results, the id rows and their
        clean-up, the routing, then (ordered) DD accounting, the tlog push
        (1021 when it fails), storage apply, version reporting and the
        periodic durability pump. ``prev`` orders this batch behind the
        fleet's earlier grants at the log gate (None: the caller holds
        the order); the results are assembled outside the ordered
        section. A batch with a sampled member gets a ``proxy.batch``
        span (parented to the first, linking every one), ambient around
        the ordered tail so the log push and storage apply spans nest
        under it; ``traced`` False skips the scan for one."""
        bsp = span_mod.batch_span(requests) if traced else span_mod.NULL
        hm = self.conflict_heat
        heat = [] if hm is not None and heatmap_mod.enabled() else None
        try:
            results = []
            batch_mutations = []
            conflicts = too_old = 0
            for i, (req, st) in enumerate(zip(requests, statuses)):
                if st == COMMITTED:
                    batch_mutations.extend(
                        substitute_versionstamp(m, cv, batch_order=0,
                                                txn_order=i)
                        if m.op in _STAMPED else m
                        for m in req.mutations)
                    if req.idempotency_id:
                        # the id row commits with the txn's mutations:
                        # its presence later proves this commit applied
                        batch_mutations.append(Mutation(
                            Op.SET, systemdata.idmp_key(req.idempotency_id),
                            systemdata.pack_version(cv)))
                    results.append(cv)
                    if req.tags:
                        self._note_tags("committed", req.tags)
                elif st == TOO_OLD:
                    results.append(FDBError.from_name("transaction_too_old"))
                    conflicts += 1
                    too_old += 1
                    if req.tags:
                        self._note_tags("too_old", req.tags)
                else:
                    if req.tags:
                        self._note_tags("conflicted", req.tags)
                    if heat is not None:
                        self._conflict_heat(req, heat)
                    e = FDBError.from_name("not_committed")
                    if req.report_conflicting_keys:
                        e.conflicting_key_ranges = self._conflicting_ranges(
                            txns[i])
                        e.conflict_version = cv
                    results.append(e)
                    conflicts += 1
            if self._batches_since_pump == 0 and self.commit_count:
                # the clean-up of expired ids rides the batch after each
                # pump; the retention is a multiple of the MVCC window,
                # as a 1021 retry may arrive long after its original
                horizon = max(0, cv - self.IDMP_RETENTION_WINDOWS
                              * self.knobs.max_read_transaction_life_versions)
                batch_mutations.extend(self._idmp_expired(horizon))
            # routed before the push, so that the log keeps the
            # per-storage split (ref: mutations tagged with storage tags)
            routed = self._route(batch_mutations)
            tags = (dict(enumerate(routed)) if self.dd is not None
                    and self.dd.replication < len(self.storages) else None)
            if heat:
                hm.charge_many(heat)
        except BaseException:
            # the version's log turn must still be consumed
            if prev is not None:
                self._skip_turns_quiet(prev, cv)
            raise
        if prev is not None and self.log_gate is not None:
            self.log_gate.enter(prev)
        try:
            if bsp is span_mod.NULL:
                return self._finalize_ordered(len(requests), results,
                                              batch_mutations, conflicts,
                                              too_old, routed, tags, cv,
                                              window)
            prior_ctx = span_mod.set_current(bsp.context())
            try:
                return self._finalize_ordered(len(requests), results,
                                              batch_mutations, conflicts,
                                              too_old, routed, tags, cv,
                                              window)
            finally:
                span_mod.set_current(prior_ctx)
                if plan is not None:
                    bsp.finish(version=cv, conflicts=conflicts,
                               sched_reordered=plan.reordered,
                               sched_deferred=plan.deferred)
                else:
                    bsp.finish(version=cv, conflicts=conflicts)
        finally:
            if prev is not None and self.log_gate is not None:
                self.log_gate.advance(cv)

    def _finalize_ordered(self, n_requests, results, batch_mutations,
                          conflicts, too_old, routed, tags, cv, window):
        """The version-ordered tail: counters, DD's byte samples, the
        tlog push, storage apply and reporting — everything that mutates
        shared state."""
        self.conflict_count += conflicts
        n_ok = len(results) - conflicts
        self._m_batches.inc()
        # the batch's errors by class: each rejection is a conflict or a
        # too-old read version
        self._note_abort("not_committed", conflicts - too_old)
        self._note_abort("transaction_too_old", too_old)
        if self.dd is not None:
            for m in batch_mutations:
                if m.key >= b"\xff":
                    continue  # system rows are not user load
                if m.op == Op.CLEAR_RANGE:
                    self.dd.note_clear_range(m.key, m.param)
                else:
                    self.dd.note_write(m.key,
                                       len(m.key) + len(m.param or b""))
        # push even empty batches so storage's version advances with cv
        try:
            self.tlog.push(cv, batch_mutations, tags=tags)
        except TLogDown:
            # the would-be commits are in limbo: honest 1021; definite
            # rejections stand
            self._note_abort("commit_unknown_result", n_ok)
            return [r if isinstance(r, FDBError)
                    else FDBError.from_name("commit_unknown_result")
                    for r in results]
        self.commit_count += n_ok
        self._m_committed.inc(n_ok)  # counted once the log has them
        regions = self.regions
        if regions is not None and regions.config.satellite_mode == "sync":
            # the batch reaches the remote region's log before any client
            # sees its ack: a primary-region loss from here on loses
            # nothing. A partitioned WAN or a dead satellite degrades to
            # a counted miss, never a stall
            regions.sync_push(cv, batch_mutations)
        for sid, muts in enumerate(routed):
            storage = self.storages[sid]
            if not storage.alive:
                # a dead storage misses the batch; its recruit replays
                # the log, so skipping strands no partial state
                continue
            try:
                storage.apply(cv, muts)
                storage.advance_window(window)
            except Exception:
                # the batch is committed (the log has it): a 1021 here
                # would let a retry pass the dedupe and commit twice. The
                # storage's state is suspect: it dies, and its recruit
                # replays the log from its durable version
                TraceEvent("StorageApplyFailed", severity=SEV_ERROR).detail(
                    storage=sid, version=cv).log()
                storage.kill()
        if self.change_feeds is not None and batch_mutations:
            # after the log has the batch and before its version is
            # readable: a consumer reading up to a version it observed
            # sees that version's entries
            self.change_feeds.note_commit(cv, batch_mutations)
        self.sequencer.report_committed(cv)
        if self.ratekeeper is not None:
            self.ratekeeper.observe_commit(n_requests, conflicts)
        self._batches_since_pump += 1
        if self._batches_since_pump >= self.pump_interval:
            self._batches_since_pump = 0
            self._pump_durability(window)
        return results

    def _conflicting_ranges(self, txn):
        """Which of a rejected txn's read ranges conflicted: exact from
        the Python host sets; the device and the native set keep no
        per-range verdicts, so there every read range (conservative)."""
        ranges = []
        for r in self.resolvers:
            cset = getattr(r, "cset", None)
            if cset is None or not hasattr(cset, "conflicting_ranges"):
                return sorted(set(txn.read_ranges()))
            ranges.extend(cset.conflicting_ranges(txn))
        return sorted(set(ranges))

    def _resolve(self, txns, cv, window):
        if len(self.resolvers) == 1:
            return self.resolvers[0].resolve(txns, cv, window)
        # Key-range sharded host resolvers (ref: the resolution fan-out of
        # CommitProxyServer.actor.cpp): each sees the whole batch with its
        # conflict ranges clipped to its key range, and a txn commits iff
        # every resolver accepts it. The sub-batches dispatch on a thread
        # pool: the native set releases the interpreter lock while it
        # resolves. Verdicts join in resolver order, so the result does
        # not depend on the schedule.
        n = len(self.resolvers)
        shard_batches = []
        for ri in range(n):
            lo, hi = self._resolver_range(ri, n)
            shard_batches.append([
                TxnRequest(
                    read_version=t.read_version,
                    point_reads=_clip_points(t.point_reads, lo, hi),
                    point_writes=_clip_points(t.point_writes, lo, hi),
                    range_reads=_clip(t.range_reads, lo, hi),
                    range_writes=_clip(t.range_writes, lo, hi),
                )
                for t in txns
            ])
        if deviceprofile.enabled() and self._fanout_profile is not None:
            # the fan-out's lane balance: conflict entries that survived
            # each resolver's clip
            self._fanout_profile.record_lane_counts([
                sum(len(t.point_reads) + len(t.point_writes)
                    + len(t.range_reads) + len(t.range_writes)
                    for t in batch)
                for batch in shard_batches])
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(
                max_workers=n, thread_name_prefix="sub-resolve")
        futs = [self._pool.submit(res.resolve, batch, cv, window)
                for res, batch in zip(self.resolvers, shard_batches)]
        verdicts = [f.result() for f in futs]
        out = []
        for i in range(len(txns)):
            vs = [v[i] for v in verdicts]
            if any(v == TOO_OLD for v in vs):
                out.append(TOO_OLD)
            elif all(v == COMMITTED for v in vs):
                out.append(COMMITTED)
            else:
                out.append(CONFLICT)
        return out

    def _idmp_expired(self, horizon, cap=1000):
        """CLEARs of the id rows whose commit version fell below the
        retention horizon, scanned from a live storage's system keys."""
        live = next((s for s in self.storages if s.alive), None)
        if live is None:
            return []
        out = []
        for k, v in live.read_range(systemdata.IDMP_PREFIX,
                                    systemdata.IDMP_END, live.version):
            if systemdata.unpack_version(v) < horizon:
                out.append(Mutation(Op.CLEAR, k, None))
                if len(out) >= cap:
                    break
        return out

    def _pump_durability(self, window):
        """The updateStorage analog: fold versions that left the MVCC
        window into the engines, pop the log up to what every storage
        (a dead one's frozen durable version included: its recruit
        replays from there) holds durably, and feed the ratekeeper the
        durability lag found before the flush."""
        live = [s for s in self.storages if s.alive]
        if not live:
            return
        lag = max(0, window - min(s.durable_version for s in live))
        for s in live:
            # a versioned engine serves reads below its durable version,
            # so it may flush to the latest; a single-version engine
            # stops at the window floor
            s.flush(None if s.versioned_engine else window)
        self.tlog.pop(min(s.durable_version for s in self.storages))
        if self.ratekeeper is not None:
            self.ratekeeper.update(storage_lag_versions=lag)

    def _route(self, mutations):
        """The batch's mutations by owning storage, in one pass (ref:
        mutations tagged with storage tags through keyServers). Full
        replication is the identity. A clear range goes to every storage
        whose shards it overlaps (a partial owner clears only what it
        holds); system keys go everywhere, so recovery can read the
        shard map from any storage."""
        n = len(self.storages)
        if self.dd is None or self.dd.replication >= n:
            return [mutations] * n
        smap = self.dd.map
        per = [[] for _ in range(n)]
        for m in mutations:
            if m.key >= b"\xff":
                owners = range(n)
            elif m.op == Op.CLEAR_RANGE:
                owners = set()
                for i in smap.shards_overlapping(m.key, m.param):
                    owners.update(smap.teams[i])
            else:
                owners = smap.team_for(m.key)
            for sid in owners:
                per[sid].append(m)
        return per


def _split_ranges(ranges):
    """Conflict ranges → (points, true ranges): single-key ranges
    [k, k+\\x00) go to the resolver's point lanes (hash-table checks)."""
    points, true_ranges = [], []
    for b, e in ranges:
        if len(e) == len(b) + 1 and e[-1] == 0 and e.startswith(b):
            points.append(b)
        else:
            true_ranges.append((b, e))
    return points, true_ranges


def _resolver_range(i, n):
    """Resolver i's key range: an even first-byte split; the last range's
    upper bound is None (+infinity), so no key escapes every check."""
    lo = bytes([256 * i // n]) if i else b""
    hi = bytes([256 * (i + 1) // n]) if i + 1 < n else None
    return lo, hi


def _clip_points(keys, lo, hi):
    return [k for k in keys if k >= lo and (hi is None or k < hi)]


def _clip(ranges, lo, hi):
    out = []
    for b, e in ranges:
        cb = max(b, lo)
        ce = e if hi is None else min(e, hi)
        if cb < ce:
            out.append((cb, ce))
    return out
