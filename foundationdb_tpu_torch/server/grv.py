"""GRV proxy: hands out read versions, gated by the ratekeeper.

Ref parity: fdbserver/GrvProxyServer.actor.cpp — a read version is the
latest committed version, so reads observe every prior commit (external
consistency); the ratekeeper (server/ratekeeper.py) can refuse a grant
under saturation (1037, process_behind) or for a throttled tag (1213,
tag_throttled), both retryable.

``BatchingGrvProxy`` is the reference's transaction-start batching
loop: concurrent clients' requests queue for a batch window and are
granted from ONE committed-version read. Under throttling a request is
delayed in its queue until the token bucket refills, not bounced; only
a request older than ``max_wait_s`` is rejected (retryable). A tagged
request meets its tag gate on entry, before it queues.
"""

import threading
import time

from foundationdb_tpu_torch.core.errors import err
from foundationdb_tpu_torch.utils.backoff import Backoff


class GrvProxy:
    def __init__(self, sequencer, ratekeeper=None):
        self.sequencer = sequencer
        self.ratekeeper = ratekeeper
        self.grv_count = 0
        self.throttled = 0  # 1037s for the budget
        self.tag_throttled = 0  # 1213s for a tag

    def get_read_version(self, priority="default", tags=()):
        """The latest committed version, if the ratekeeper admits the
        request: ``priority`` "batch" pays more, "immediate" passes."""
        if not self.sequencer.alive:
            # the version authority is dead: retryable until recruitment
            raise err("process_behind")
        if self.ratekeeper is not None:
            ok, reason = self.ratekeeper.admit_with_reason(priority, tags)
            if not ok:
                # which gate closed: a tag's quota (1213) or the budget
                if reason == "tag":
                    self.tag_throttled += 1
                    raise err("tag_throttled")
                self.throttled += 1
                raise err("process_behind")
        self.grv_count += 1
        return self.sequencer.committed_version

    def status(self):
        return {"alive": self.sequencer.alive, "grv_grants": self.grv_count,
                "grv_throttled": self.throttled,
                "grv_tag_throttled": self.tag_throttled}


class BatchingGrvProxy:
    """Cross-client GRV batching with delay-based admission (thread
    deployments)."""

    def __init__(self, inner, interval_s=0.0005, max_wait_s=2.0,
                 start_thread=True):
        # start_thread=False: deterministic harnesses drive _grant_round
        # themselves (no thread, no wall clock)
        self.inner = inner
        self.interval_s = interval_s
        self.max_wait_s = max_wait_s
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        # two queues so batch-priority traffic cannot head-of-line-block
        # default traffic (ref: per-priority GRV queues)
        self._queues = {"default": [], "batch": []}
        self._closed = False
        self._pending = 0  # queued + drained-but-unresolved requests
        self.batches_granted = 0
        self.fast_grants = 0  # granted inline, no queue ahead
        self.delayed_count = 0  # requests that waited >= 1 extra round
        self.max_round = 0  # largest single-round grant
        self._thread = None
        if start_thread:
            self._thread = threading.Thread(
                target=self._grant_loop, name="grv-batcher", daemon=True)
            self._thread.start()

    def __getattr__(self, name):  # grv_count, sequencer, … pass through
        return getattr(self.inner, name)

    def get_read_version(self, priority="default", tags=()):
        if not self.inner.sequencer.alive:
            # the fast path and the grant loop read committed_version
            # directly, so liveness is checked here too
            raise err("process_behind")
        if priority == "immediate":
            with self._lock:  # counter consistency with the grant loop
                return self.inner.get_read_version(priority)
        rk = self.inner.ratekeeper
        if rk is not None and tags and not rk.tag_gate(tags):
            # a tag gate closes at once (1213) rather than queueing: a
            # throttled tag must not hold the shared FIFO ahead of other
            # traffic; the global budget is charged by the grant round
            raise err("tag_throttled")
        qkey = "batch" if priority == "batch" else "default"
        with self._lock:
            if (not self._closed and self._pending == 0
                    and (rk is None or rk.admit(priority))):
                # uncontended: no request ahead in any state, and the
                # budget has room — grant inline, no thread handoff (a
                # fresh arrival never takes a refilled token from an
                # older request a grant round holds)
                self.inner.grv_count += 1
                self.fast_grants += 1
                return self.inner.sequencer.committed_version
        fut = self._make_future(priority)
        with self._lock:
            if self._closed:
                raise err("process_behind")
            self._queues[qkey].append(fut)
            self._pending += 1
            self._wake.notify()
        fut["event"].wait()
        if fut["error"] is not None:
            raise fut["error"]
        return fut["value"]

    def _grant_loop(self):
        # a round that granted nothing backs off (to 20 ms); a granting
        # round resets to the batch interval
        throttle = Backoff(initial_s=self.interval_s, max_s=0.02,
                           growth=2.0, jitter=0.0)
        while True:
            with self._wake:
                while not (self._queues["default"] or self._queues["batch"]
                           or self._closed):
                    self._wake.wait()
                if self._closed:
                    pending = self._queues["default"] + self._queues["batch"]
                    self._queues = {"default": [], "batch": []}
                    self._pending = 0
                    for fut in pending:
                        fut["error"] = err("process_behind")
                        fut["event"].set()
                    return
                n_waiting = (len(self._queues["default"])
                             + len(self._queues["batch"]))
            # adaptive window: a lone request waits briefly for
            # companions; under load the previous round is the window
            sleep_s = throttle.current
            if n_waiting < 2 or sleep_s > self.interval_s:
                time.sleep(sleep_s)
            if self._grant_round():
                throttle.reset()
            else:
                throttle.delay()

    @staticmethod
    def _make_future(priority, born=None):
        """The queued-request record _grant_round consumes (one
        construction point, shared with deterministic tests)."""
        return {"event": threading.Event(), "value": None, "error": None,
                "born": time.monotonic() if born is None else born,
                "waited": False, "priority": priority}

    def _grant_round(self, now=None):
        """One grant round: drain the queues, grant strict-FIFO per
        priority (default first) from one committed-version read until
        the ratekeeper's first denial, age out over-waited requests,
        requeue the rest at the front. ``now`` overrides the aging
        clock. Returns whether anything was granted."""
        with self._lock:
            work = {p: list(self._queues[p]) for p in ("default", "batch")}
            self._queues = {"default": [], "batch": []}
        rk = self.inner.ratekeeper
        if not self.inner.sequencer.alive:
            # the sequencer died with requests queued: fail them
            # retryably rather than grant a dead authority's version
            with self._lock:
                n = 0
                for qkey in ("default", "batch"):
                    for fut in work[qkey]:
                        fut["error"] = err("process_behind")
                        fut["event"].set()
                        n += 1
                self._pending -= n
            return False
        version = None  # one committed-version read per round
        granted_any = False
        round_granted = 0
        resolved = 0  # granted + aged out: leave the _pending count
        for qkey in ("default", "batch"):
            queue = work[qkey]
            n_granted = 0
            for fut in queue:
                # one admit per denial: a denied head holds its queue
                if rk is not None and not rk.admit(fut["priority"]):
                    break
                if version is None:
                    version = self.inner.sequencer.committed_version
                    self.batches_granted += 1
                fut["value"] = version
                fut["event"].set()
                n_granted += 1
                granted_any = True
            round_granted += n_granted
            resolved += n_granted
            rest = queue[n_granted:]
            if not rest:
                continue
            t = time.monotonic() if now is None else now
            keep = []
            for fut in rest:
                if t - fut["born"] > self.max_wait_s:
                    fut["error"] = err("process_behind")
                    fut["event"].set()
                    resolved += 1
                else:
                    if not fut["waited"]:
                        fut["waited"] = True
                        self.delayed_count += 1
                    keep.append(fut)
            if keep:
                with self._lock:  # requeue at the front: FIFO kept
                    self._queues[qkey] = keep + self._queues[qkey]
        with self._lock:
            self.inner.grv_count += round_granted
            self._pending -= resolved
            self.max_round = max(self.max_round, round_granted)
        return granted_any

    def status(self):
        out = self.inner.status()
        out.update(batches_granted=self.batches_granted,
                   fast_grants=self.fast_grants, max_round=self.max_round)
        return out

    def close(self):
        with self._lock:
            self._closed = True
            self._wake.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10)
