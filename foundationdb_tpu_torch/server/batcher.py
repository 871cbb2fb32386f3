"""Cross-client commit batching — the commit proxy's real job.

Ref parity: fdbserver/CommitProxyServer.actor.cpp commitBatcher: client
commits accumulate into a batch bounded by an interval and a size cap;
the whole batch shares one commit version and one resolver dispatch.
The device resolver makes big batches cheaper per txn, so keeping
batches full is what matters: a 1-txn batch pads the step's 1024 txn
slots to 0.1% occupancy.

Two drive modes:

- **thread**: a daemon batcher thread collects submissions for up to
  ``interval_s`` (or until ``max_batch``), then drives the inner proxy.
  Clients block on a CommitFuture. With ``knobs.commit_pipeline_depth
  > 1`` the drain loop is a bounded two-stage pipeline: the batcher
  thread runs stages A+B of each backlog group (version grant, host
  packing, the gate-ordered lazy resolve dispatch:
  ``proxy.commit_batches_begin``) and an apply worker runs stage C
  (status sync, tlog push, storage apply: ``proxy.commit_batches_finish``)
  strictly in grant order — group N+1 packs on the host and resolves on
  the device while group N applies. Depth 1 is the serial loop. Client
  threads read storage under its mutation lock, which apply takes too.

- **manual**: no thread, no wall clock. Callers submit and later call
  ``pump(step)``, which flushes when the batch is full or ``flush_after``
  steps have passed since the first pending submission. A synchronous
  ``commit()`` flushes at once, every pending submission riding along in
  the same batch. Manual mode always runs depth 1.

The port's own copy of the JAX package's ``server/batcher.py``, without
its metrics registry, spans, trace events and lock-order checking: the
submit→settle latency (``commit_e2e``) and the stage timers are plain
samples (utils/trace.py), and the last failure is kept in
``last_batch_error``.
"""

import threading
import time
from collections import deque

from foundationdb_tpu_torch.core.errors import FDBError
from foundationdb_tpu_torch.utils.trace import LatencySample, StageStats

_UNSET = object()


class CommitFuture:
    """Resolves to a commit version (int) or an FDBError.

    Futures of one BatchingCommitProxy share its completion condition: a
    whole batch resolves together, so one notify_all per batch wakes
    every waiter. A standalone future (no proxy) must be ``set`` before
    ``result`` is awaited (read-only fast paths set it at once)."""

    __slots__ = ("_result", "_proxy", "born")

    def __init__(self, proxy=None):
        self._result = _UNSET
        self._proxy = proxy
        self.born = None  # monotonic stamp of a batch window's first submit

    def done(self):
        return self._result is not _UNSET

    def set(self, result):
        # first settlement wins: once a waiter may have acted on a
        # verdict (the stranded-batch watchdog's 1021), a late real
        # result must not replace it
        if self._result is _UNSET:
            self._result = result

    def result(self, timeout=None):
        """Block until resolved; returns a version or an FDBError.

        Waits in bounded chunks and runs the proxy's stranded-batch
        watchdog between them: a batch wedged in the inner proxy past
        the commit deadline settles as 1021 on the waiting thread, so a
        hung pipeline costs a deadline, never a hung client."""
        if self._result is not _UNSET:
            return self._result
        if self._proxy is None:
            raise TimeoutError("standalone commit future never resolved")
        cond = self._proxy._done_cond
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            chunk = 0.25
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0 and not self.done():
                    raise TimeoutError("commit future not resolved")
                chunk = min(chunk, max(0.0, remaining))
            with cond:
                cond.wait_for(self.done, chunk)
            if self.done():
                return self._result
            self._proxy._check_stranded()


class BatchingCommitProxy:
    """Accumulates CommitRequests into shared-version batches."""

    WATCHDOG_GRACE_S = 1.0

    # cap on batches per backlog group. The resolver chunks a backlog
    # into scans of its widest pad bucket, so this bounds how much queue
    # drains per settle round, not the dispatch width.
    MAX_BACKLOG = 64

    # Conflict-adaptive backlog depth: every txn of one settle round
    # resolves against read versions from before the round, so OCC
    # conflicts grow with depth × contention. AIMD on the observed
    # conflict rate (ref: the ratekeeper damping overload).
    BACKLOG_SHRINK_AT = 0.35  # conflict rate that halves the depth
    BACKLOG_GROW_AT = 0.15  # conflict rate that lets depth double

    def __init__(self, inner, max_batch=None, interval_s=None,
                 flush_after=4, mode="thread"):
        if mode not in ("thread", "manual"):
            raise ValueError(f"mode must be 'thread' or 'manual', got {mode!r}")
        self.inner = inner
        knobs = inner.knobs
        self.max_batch = max_batch or min(knobs.batch_txn_capacity, 1024)
        self.interval_s = (interval_s if interval_s is not None
                           else knobs.commit_batch_interval_s)
        self.flush_after = flush_after  # manual mode: steps before a flush
        self.mode = mode
        self._lock = threading.Lock()
        self._pending = []  # [(request, future)]
        self._first_pending_step = None
        self._wake = threading.Condition(self._lock)
        self._done_cond = threading.Condition()  # batch-completion waiters
        self._closed = False
        # stranded-batch watchdog bound: two commit deadlines plus grace
        self.watchdog_s = 2 * knobs.rpc_deadline_commit_s + self.WATCHDOG_GRACE_S
        self._running = None  # the batch driving the inner proxy
        self._running_since = 0.0
        self.stranded_settled = 0
        self.batches_committed = 0
        self.txns_batched = 0
        self.max_batch_seen = 0
        self.last_batch_error = None  # the last failure's exception
        # AIMD target: an int written by one thread at a time and read
        # by the next group (staleness is harmless)
        self._backlog_target = self.MAX_BACKLOG
        self._thread = None
        # bounded commit pipeline (thread mode only): up to ``depth``
        # backlog groups in flight. Manual mode is always serial.
        depth = knobs.commit_pipeline_depth
        self.pipeline_depth = max(1, int(depth)) if mode == "thread" else 1
        # submit→settle seconds per settled batch window: the latency the
        # "< 2 ms added p99" target is read from
        self.commit_e2e = LatencySample()
        self.stages = StageStats()
        self._inflight = deque()  # [(chunks, _PipelinedGroup)] FIFO
        self._inflight_cv = threading.Condition()
        self._occ_level = 0
        self._occ_t = time.perf_counter()
        self._occ_busy = 0.0  # seconds with >= 1 group in flight
        self._occ_area = 0.0  # integral of the in-flight count over them
        self._apply_thread = None
        if mode == "thread" and self.pipeline_depth > 1:
            self._apply_thread = threading.Thread(
                target=self._apply_loop, name="commit-apply", daemon=True)
            self._apply_thread.start()
        if mode == "thread":
            self._thread = threading.Thread(
                target=self._batcher_loop, name="commit-batcher", daemon=True)
            self._thread.start()

    # ────────────────────────── client surface ──────────────────────────
    def submit(self, request):
        """Enqueue a commit; returns a CommitFuture."""
        fut = CommitFuture(self)
        with self._lock:
            if self._closed:
                raise RuntimeError("batching proxy is closed")
            if not self._pending:
                # stamp the first submit of each batch window only: the
                # oldest, whose span _record_span takes
                fut.born = time.monotonic()
            self._pending.append((request, fut))
            self._wake.notify()
        return fut

    def commit(self, request):
        """Synchronous commit (the Transaction.commit path). Thread
        mode: submit and block while the batcher forms the batch, so
        concurrent committers share a version. Manual mode: submit and
        flush now, with every pending submission."""
        fut = self.submit(request)
        if self.mode == "thread":
            return fut.result()
        self.flush()
        return fut.result(timeout=0)

    # ─────────────────────────── batch driving ──────────────────────────
    def flush(self):
        """Drain everything pending into one run, then wait for every
        in-flight pipelined group: when flush returns, every submitted
        commit has resolved."""
        with self._lock:
            pending, self._pending = self._pending, []
            self._first_pending_step = None
        if pending:
            self._run_batch(pending)
        self.drain_pipeline()

    def pump(self, step):
        """Manual-mode heartbeat: flush when full or when ``flush_after``
        steps have passed since the first pending submission."""
        with self._lock:
            n = len(self._pending)
            if n and self._first_pending_step is None:
                self._first_pending_step = step
            due = n >= self.max_batch or (
                n and step - self._first_pending_step >= self.flush_after)
        if due:
            self.flush()

    def _adapt_backlog(self, txns, conflicts):
        if txns == 0:
            return
        rate = conflicts / txns
        if rate > self.BACKLOG_SHRINK_AT:
            self._backlog_target = max(1, self._backlog_target // 2)
        elif rate < self.BACKLOG_GROW_AT:
            self._backlog_target = min(self.MAX_BACKLOG,
                                       self._backlog_target * 2)

    def _check_stranded(self):
        """Stranded-batch watchdog (run by waiting clients between wait
        chunks): a batch driving the inner proxy past ``watchdog_s``
        settles every future in it with 1021 — the commits may have
        happened. The wedged drive runs on; its late ``set`` calls lose
        to the watchdog's (first settlement wins)."""
        with self._lock:
            run = self._running
            if run is None or (time.monotonic() - self._running_since
                               < self.watchdog_s):
                return
            self._running = None  # claimed: exactly one waiter settles
            self.stranded_settled += len(run)
        unknown = FDBError.from_name("commit_unknown_result")
        for _, fut in run:
            fut.set(unknown)
        with self._done_cond:
            self._done_cond.notify_all()

    def _run_batch(self, pending):
        with self._lock:
            self._running = pending
            self._running_since = time.monotonic()
        try:
            self._run_batch_inner(pending)
        finally:
            with self._lock:
                if self._running is pending:
                    self._running = None

    def _run_batch_inner(self, pending):
        chunks = [pending[i:i + self.max_batch]
                  for i in range(0, len(pending), self.max_batch)]
        while chunks:
            depth = self._backlog_target
            group, chunks = chunks[:depth], chunks[depth:]
            if len(group) > 1:
                # a backlog: one resolver dispatch covers every chunk
                reqs = [[r for r, _ in c] for c in group]
                if self._apply_thread is not None:
                    try:
                        eligible = self.inner.pipeline_eligible(reqs)
                    except Exception as e:
                        self._fail_chunks(group, e)
                        continue
                    if eligible:
                        # stages A+B now, stage C on the apply worker
                        # while the next group packs here
                        try:
                            self._pipeline_submit(group, reqs)
                        except Exception as e:
                            # begin died outside its own guards: the
                            # futures still resolve
                            self._fail_chunks(group, e)
                        continue
                # serial route: in-flight groups settle first, or this
                # group's versions would overtake theirs at the log
                self.drain_pipeline()
                try:
                    results_list = self.inner.commit_batches(reqs)
                except Exception as e:
                    self._fail_chunks(group, e)
                    continue
                self._settle_group(group, results_list)
                continue
            self.drain_pipeline()
            for chunk in group:
                try:
                    results = self.inner.commit_batch([r for r, _ in chunk])
                except Exception as e:
                    # never propagate: every future must resolve, and the
                    # remaining chunks still get their turn; the chunk
                    # may or may not be durable — 1021
                    self._fail_chunks([chunk], e)
                    continue
                self._settle_group([chunk], [results])

    def _settle_group(self, group, results_list):
        """Settle each chunk's futures and feed the AIMD backlog."""
        txns = conflicts = 0
        for chunk, results in zip(group, results_list):
            self._settle(chunk, results)
            txns += len(results)
            conflicts += sum(1 for r in results
                             if isinstance(r, FDBError) and r.code == 1020)
        self._adapt_backlog(txns, conflicts)

    # ─────────────────────── pipeline executor ──────────────────────
    def _occ_transition(self, new_level):
        """Time-weighted in-flight accounting (under _inflight_cv):
        ``pipeline_depth_effective`` is the mean number of groups in
        flight while the pipeline was busy — 1.0 means the stages never
        overlapped, about ``depth`` that the pipe stayed full."""
        now = time.perf_counter()
        if self._occ_level > 0:
            dt = now - self._occ_t
            self._occ_busy += dt
            self._occ_area += self._occ_level * dt
        self._occ_t = now
        self._occ_level = new_level

    @property
    def pipeline_depth_effective(self):
        with self._inflight_cv:
            if self._occ_busy <= 0:
                return 1.0
            return round(self._occ_area / self._occ_busy, 2)

    def stage_summary(self):
        """Per-stage mean wall ms and occupancy: pack (stage A host work:
        grant, schedule, batch build, staging), dispatch (stage B's batch
        copy and scan call), resolve (the host sync in stage C), apply
        (tlog push, storage apply); the submit→settle p50 / p99; the
        pack-path split, the scheduler's decisions and the packers'
        staging reuse rate."""
        inner = self.inner
        flat, legacy = inner.pack_flat_batches, inner.pack_legacy_batches
        out = {
            "stage_pack_ms": round(self.stages.mean_ms("pack"), 3),
            "stage_dispatch_ms": round(self.stages.mean_ms("dispatch"), 3),
            "stage_resolve_ms": round(self.stages.mean_ms("resolve"), 3),
            "stage_apply_ms": round(self.stages.mean_ms("apply"), 3),
            "pipelined_groups": self.stages.count("apply"),
            "pipeline_depth": self.pipeline_depth,
            "pipeline_depth_effective": self.pipeline_depth_effective,
            "commit_e2e_p50_ms": round(self.commit_e2e.percentile_ms(50), 3),
            "commit_e2e_p99_ms": round(self.commit_e2e.percentile_ms(99), 3),
            "pack_path": ("flat" if flat and not legacy else
                          "mixed" if flat else "legacy"),
            "pack_flat_batches": flat,
            "pack_legacy_batches": legacy,
            "sched_batches": inner.sched_batches,
            "sched_reordered": inner.sched_reordered_total,
            "sched_deferred": inner.sched_deferred_total,
        }
        hits = misses = 0
        r = inner.resolver
        fast = getattr(r, "_fast", None)
        for pk in (getattr(r, "packer", None), fast[0] if fast else None):
            if pk is not None:
                hits += pk.flat_reuse_hits
                misses += pk.flat_reuse_misses
        out["pack_reuse_rate"] = (round(hits / (hits + misses), 3)
                                  if hits + misses else 0.0)
        return out

    def reset_stats(self):
        """Zero the batch counters, stage timers, latency sample and
        occupancy (between phases of a measurement)."""
        with self._done_cond:
            self.batches_committed = self.txns_batched = 0
            self.max_batch_seen = 0
        self.stages.reset()
        self.commit_e2e.reset()
        with self._inflight_cv:
            self._occ_busy = self._occ_area = 0.0
            self._occ_t = time.perf_counter()

    def _pipeline_submit(self, group_chunks, reqs):
        """Stages A+B for one backlog group, then hand it to the apply
        worker; blocks while ``pipeline_depth`` groups are in flight
        (bounding version-grant runahead and host memory)."""
        with self._inflight_cv:
            while (len(self._inflight) >= self.pipeline_depth
                   and self._apply_thread.is_alive()):
                self._inflight_cv.wait(timeout=1.0)
        d0 = self.inner.resolver.dispatch_wall_s
        t0 = time.perf_counter()
        pgroup = self.inner.commit_batches_begin(reqs)
        pack_s = time.perf_counter() - t0
        # hand the group over before any other fallible call: once
        # queued, stage C settles its futures even if this thread dies
        with self._inflight_cv:
            self._inflight.append((group_chunks, pgroup))
            self._occ_transition(len(self._inflight))
            self._inflight_cv.notify_all()
        # the dispatch accumulated on this thread inside begin: its own
        # stage, so pack is the host packing alone
        dispatch_s = max(0.0, self.inner.resolver.dispatch_wall_s - d0)
        self.stages.add("pack", max(0.0, pack_s - dispatch_s))
        self.stages.add("dispatch", dispatch_s)

    def drain_pipeline(self):
        """Block until every in-flight group has settled (the ordering
        barrier before serial routes, flush and close)."""
        if self._apply_thread is None:
            return
        with self._inflight_cv:
            while self._inflight and self._apply_thread.is_alive():
                self._inflight_cv.wait(timeout=1.0)

    def _apply_loop(self):
        while True:
            with self._inflight_cv:
                while not self._inflight and not self._closed:
                    self._inflight_cv.wait()
                if not self._inflight and self._closed:
                    return
                group_chunks, pgroup = self._inflight[0]
            try:
                self._finish_group(group_chunks, pgroup)
            except Exception as e:  # last resort: keep the worker up
                self.last_batch_error = e
                self._fail_chunks(group_chunks, e)
            finally:
                with self._inflight_cv:
                    self._inflight.popleft()
                    self._occ_transition(len(self._inflight))
                    self._inflight_cv.notify_all()

    def _finish_group(self, group_chunks, pgroup):
        """Stage C for one group: finish at the proxy, settle futures in
        order, feed the AIMD backlog and the stage timers."""
        try:
            results_list = self.inner.commit_batches_finish(pgroup)
        except Exception as e:
            self._fail_chunks(group_chunks, e)
            return
        if pgroup.error is not None:
            # the group failed inside the proxy (its results are honest
            # 1020s / 1021s): keep the root cause
            self.last_batch_error = pgroup.error
        self.stages.add("resolve", pgroup.resolve_s)
        self.stages.add("apply", pgroup.apply_s)
        self._settle_group(group_chunks, results_list)

    def _settle(self, chunk, results):
        self._record_span(chunk)
        for (_, fut), res in zip(chunk, results):
            fut.set(res)
        with self._done_cond:  # one wakeup for the whole batch
            # under _done_cond: the batcher thread, the apply worker and
            # callers (manual mode) all settle
            self.batches_committed += 1
            self.txns_batched += len(chunk)
            self.max_batch_seen = max(self.max_batch_seen, len(chunk))
            self._done_cond.notify_all()

    def _record_span(self, chunk):
        """One commit_e2e record per settled batch window: from the
        window's oldest submit (the stamped head future) to now. Every
        txn of the window replies together, so this is its worst case."""
        born = chunk[0][1].born if chunk else None
        if born is not None:
            self.commit_e2e.record(max(0.0, time.monotonic() - born))

    def _fail_chunks(self, chunks, e):
        self.last_batch_error = e
        for chunk in chunks:
            self._record_span(chunk)  # a failure reply is still a reply
            for _, fut in chunk:
                fut.set(e if isinstance(e, FDBError) else
                        FDBError.from_name("commit_unknown_result"))
        with self._done_cond:
            self._done_cond.notify_all()

    def _batcher_loop(self):
        while True:
            with self._wake:
                while not self._pending and not self._closed:
                    self._wake.wait()
                if self._closed and not self._pending:
                    return
            # the batch window: let concurrent committers pile in
            if self.interval_s:
                time.sleep(self.interval_s)
            with self._lock:
                pending, self._pending = self._pending, []
                self._first_pending_step = None
            if pending:
                try:
                    self._run_batch(pending)
                except Exception as e:  # last resort: keep the thread up
                    self.last_batch_error = e

    def fail_pending(self, error):
        """Resolve every queued commit with ``error`` (the proxy went
        down before the batch formed)."""
        with self._lock:
            pending, self._pending = self._pending, []
            self._first_pending_step = None
        for _, fut in pending:
            fut.set(error)
        with self._done_cond:
            self._done_cond.notify_all()

    def close(self):
        with self._lock:
            self._closed = True
            self._wake.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30)
            if self._thread.is_alive():
                # still mid-batch: the batcher owns the pipeline; a flush
                # from here would interleave two runs on shared state
                return
        self.flush()
        if self._apply_thread is not None:
            # flush drained the pipe; the closed flag ends the worker
            with self._inflight_cv:
                self._inflight_cv.notify_all()
            self._apply_thread.join(timeout=30)
        self.inner.close()  # release the sub-resolve pool

    # everything else (commit_count, pack counters, …) passes through
    def __getattr__(self, name):
        return getattr(self.inner, name)
