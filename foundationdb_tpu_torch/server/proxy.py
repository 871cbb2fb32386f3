"""Commit proxy: batches client commits through resolution to the log.

Ref parity: fdbserver/CommitProxyServer.actor.cpp commitBatch() — the
pipeline is getVersion → resolve → tlog push → storage apply → reply.
The whole batch shares one commit version. The device resolver makes
large batches cheaper per txn, so the proxy's job is to keep batches
full. ``commit_batches`` resolves a backlog of batches in one resolver
dispatch (``Resolver.resolve_many``), each batch with its own version.

The port's proxy serves one resolver and one storage server holding the
whole keyspace; the version gates of a proxy fleet, tenants,
idempotency ids, system keys, regions and the pipelined (lazy) backlog
are not ported yet.
"""

import threading

from foundationdb_tpu_torch.core import flatpack
from foundationdb_tpu_torch.core.commit import CommitRequest  # noqa: F401
from foundationdb_tpu_torch.core.errors import FDBError
from foundationdb_tpu_torch.core.mutations import Op, substitute_versionstamp
from foundationdb_tpu_torch.core.status import COMMITTED, TOO_OLD
from foundationdb_tpu_torch.resolver.resolver import ResolverDown
from foundationdb_tpu_torch.resolver.skiplist import TxnRequest
from foundationdb_tpu_torch.server import scheduler
from foundationdb_tpu_torch.server.sequencer import SequencerDown
from foundationdb_tpu_torch.server.tlog import TLogDown

_STAMPED = (Op.SET_VERSIONSTAMPED_KEY, Op.SET_VERSIONSTAMPED_VALUE)


def _errors(name, n):
    return [FDBError.from_name(name) for _ in range(n)]


class CommitProxy:
    def __init__(self, sequencer, resolver, tlog, storage, knobs):
        self.alive = True
        self.sequencer = sequencer
        self.resolver = resolver
        self.tlog = tlog
        self.storage = storage
        self.knobs = knobs
        self.commit_count = 0
        self.conflict_count = 0
        # how many request batches packed columnar vs legacy
        self.pack_flat_batches = 0
        self.pack_legacy_batches = 0
        # client threads may drive the proxy directly: the pipeline's
        # state (resolver history, log order, storage) changes serially
        self._commit_mu = threading.RLock()
        self._batches_since_pump = 0
        self.pump_interval = 64  # batches between durability pumps

    def status(self):
        return {"alive": self.alive, "metrics": {
            "txn_committed": self.commit_count,
            "txn_conflicted": self.conflict_count,
            "pack_flat_batches": self.pack_flat_batches,
            "pack_legacy_batches": self.pack_legacy_batches}}

    def kill(self):
        """Process death: every commit answers 1021."""
        self.alive = False

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
            return _errors("commit_unknown_result", len(requests))
        with self._commit_mu:
            try:
                cv = self.sequencer.next_commit_versions(1)[0][1]
            except SequencerDown:
                return _errors("commit_unknown_result", len(requests))
            window = self._window(cv)
            requests, plan = self._maybe_schedule(requests)
            txns = self._build_txns(requests)
            try:
                statuses = self.resolver.resolve(txns, cv, window)
            except ResolverDown:
                return _errors("not_committed", len(requests))
            results = self._finalize_batch(requests, txns, statuses, cv,
                                           window)
        return plan.restore(results) if plan is not None else results

    def commit_batches(self, request_batches):
        """Commit a backlog of batches: each gets its own commit version,
        resolution for all of them takes one resolver dispatch, then each
        batch finalizes in order. The same results as commit_batch per
        batch."""
        if not self.alive or not self.sequencer.alive:
            return [self.commit_batch(reqs) for reqs in request_batches]
        with self._commit_mu:
            try:
                # the whole backlog's versions in one chained grant
                pairs = self.sequencer.next_commit_versions(
                    len(request_batches))
            except SequencerDown:
                return [_errors("commit_unknown_result", len(reqs))
                        for reqs in request_batches]
            metas = []
            plans = []
            for reqs, (_prev, cv) in zip(request_batches, pairs):
                reqs, plan = self._maybe_schedule(reqs)
                plans.append(plan)
                metas.append((reqs, self._build_txns(reqs), cv,
                              self._window(cv)))
            try:
                statuses_list = self.resolver.resolve_many(
                    [(txns, cv, window) for _, txns, cv, window in metas])
            except ResolverDown:
                return [_errors("not_committed", len(reqs))
                        for reqs in request_batches]
            out = []
            for (reqs, txns, cv, window), statuses, plan in zip(
                    metas, statuses_list, plans):
                res = self._finalize_batch(reqs, txns, statuses, cv, window)
                out.append(plan.restore(res) if plan is not None else res)
            return out

    def _window(self, cv):
        return max(0, cv - self.knobs.max_read_transaction_life_versions)

    def _maybe_schedule(self, requests):
        """Reorder the batch host-side (server/scheduler.py) so reads
        resolve before the writes they overlap. Returns the request list
        in commit order and the plan that maps results back to request
        order, or (requests, None)."""
        if len(requests) < 2:
            return requests, None
        plan = scheduler.schedule(requests)
        if plan is None or plan.identity:
            return requests, None
        return [requests[i] for i in plan.order], plan

    def _try_build_flat(self, requests):
        """The columnar batch build (core/flatpack.py), when the knob,
        the resolver and every request agree; else None (legacy)."""
        if (self.knobs.commit_pack_path != "flat"
                or not self.resolver.accepts_flat):
            return None
        return flatpack.build_flat_batch(requests, self.knobs.key_limbs)

    def _build_txns(self, requests):
        """The batch for the resolver: a FlatTxnBatch, or TxnRequests
        with points split from ranges. A read-free request (read_version
        None) gets the current committed version: the resolver compares
        nothing against it, it only places the txn in the window."""
        rv_assigned = None
        for r in requests:
            if r.read_version is None:
                if rv_assigned is None:
                    rv_assigned = self.sequencer.committed_version
                r.read_version = rv_assigned
        flat = self._try_build_flat(requests)
        if flat is not None:
            self.pack_flat_batches += 1
            return flat
        self.pack_legacy_batches += 1
        if self.resolver.backend == "cpu":
            # the host set takes a point as the tiny range it is
            return [TxnRequest(read_version=r.read_version,
                               range_reads=r.read_conflict_ranges,
                               range_writes=r.write_conflict_ranges)
                    for r in requests]
        out = []
        for r in requests:
            pr, rr = _split_ranges(r.read_conflict_ranges)
            pw, rw = _split_ranges(r.write_conflict_ranges)
            out.append(TxnRequest(read_version=r.read_version,
                                  point_reads=pr, point_writes=pw,
                                  range_reads=rr, range_writes=rw))
        return out

    def _finalize_batch(self, requests, txns, statuses, cv, window):
        """Everything after resolution: results, the tlog push (1021
        when it fails), storage apply, version reporting and the
        periodic durability pump."""
        results = []
        batch_mutations = []
        conflicts = 0
        for i, (req, st) in enumerate(zip(requests, statuses)):
            if st == COMMITTED:
                batch_mutations.extend(
                    substitute_versionstamp(m, cv, batch_order=0, txn_order=i)
                    if m.op in _STAMPED else m
                    for m in req.mutations)
                results.append(cv)
            elif st == TOO_OLD:
                results.append(FDBError.from_name("transaction_too_old"))
                conflicts += 1
            else:
                e = FDBError.from_name("not_committed")
                if req.report_conflicting_keys:
                    e.conflicting_key_ranges = self._conflicting_ranges(txns[i])
                    e.conflict_version = cv
                results.append(e)
                conflicts += 1
        self.conflict_count += conflicts
        n_ok = len(results) - conflicts
        # push even empty batches so storage's version advances with cv
        try:
            self.tlog.push(cv, batch_mutations)
        except TLogDown:
            # the would-be commits are in limbo: honest 1021; definite
            # rejections stand
            return [r if isinstance(r, FDBError)
                    else FDBError.from_name("commit_unknown_result")
                    for r in results]
        self.commit_count += n_ok
        if self.storage.alive:
            self.storage.apply(cv, batch_mutations)
            self.storage.advance_window(window)
        self.sequencer.report_committed(cv)
        self._batches_since_pump += 1
        if self._batches_since_pump >= self.pump_interval:
            self._batches_since_pump = 0
            self._pump_durability(window)
        return results

    def _conflicting_ranges(self, txn):
        """Which of a rejected txn's read ranges conflicted: exact from
        the host set; the device keeps no per-range verdicts, so there
        every read range (conservative)."""
        cset = getattr(self.resolver, "cset", None)
        if cset is not None:
            return sorted(set(cset.conflicting_ranges(txn)))
        return sorted(set(txn.read_ranges()))

    def _pump_durability(self, window):
        """The updateStorage analog: fold versions that left the MVCC
        window into the engine, then pop the log up to what is durable."""
        if not self.storage.alive:
            return
        self.storage.flush(window)
        self.tlog.pop(self.storage.durable_version)


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
