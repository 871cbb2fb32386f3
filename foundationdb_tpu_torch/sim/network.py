"""Message-level network simulation.

Ref parity: fdbrpc/sim2.actor.cpp — in the reference's simulation every
RPC is a message delivered after a seeded latency, so requests from
different actors reorder, drop, and stall behind partitions; whole
classes of distributed bugs only manifest under that reordering.

Ours models the client ↔ cluster edge the same way: a call becomes a
message with a seeded delivery delay (in scheduler steps); the simulation
delivers due messages each step in DELIVERY order — not send order — and
the caller's actor yields until its reply future resolves. Drops surface
as retryable errors (commit_unknown_result for commits, since the client
cannot know whether the request reached the proxy). A partition delays
every in-window message until it heals, producing burst reordering.

A copy of the JAX package's ``sim/network.py``.
"""

import heapq

from foundationdb_tpu_torch.core.errors import err


class NetFuture:
    """Resolves when the message's reply is delivered."""

    __slots__ = ("done", "value", "error")

    def __init__(self):
        self.done = False
        self.value = None
        self.error = None

    def result(self):
        if not self.done:
            raise RuntimeError("network reply not yet delivered")
        if self.error is not None:
            raise self.error
        return self.value


class SimNetwork:
    def __init__(self, rng, buggify, clock, min_latency=1, max_latency=6,
                 drop_p=0.002):
        self.rng = rng
        self.buggify = buggify
        self.clock = clock  # () -> current scheduler step
        self.min_latency = min_latency
        self.max_latency = max_latency
        self.drop_p = drop_p
        self._queue = []  # heap [(deliver_at, seq, fn, fut, kind)]
        self._seq = 0
        self._partition_until = 0
        self.delivered = 0
        self.reordered = 0  # messages that overtook an older pending one
        self.dropped = 0
        self.partitions = 0

    def call(self, fn, kind="call"):
        """Send ``fn`` as a message; returns a NetFuture. The thunk runs
        at delivery time — state observed is delivery-time state, exactly
        like a request crossing a real network."""
        now = self.clock()
        fut = NetFuture()
        self._seq += 1
        if self.buggify("net_drop", fire_p=self.drop_p):
            # request (or its reply) lost: the caller learns after a
            # timeout-shaped delay; a lost commit is ambiguous (1021)
            self.dropped += 1
            heapq.heappush(
                self._queue,
                (now + 4 * self.max_latency, self._seq, None, fut, kind),
            )
            return fut
        delay = self.rng.randint(self.min_latency, self.max_latency)
        deliver_at = now + delay
        if deliver_at < self._partition_until:
            # queue behind the partition, jittered for the same reason
            # the heal jitters (see partition())
            deliver_at = self._partition_until + self.rng.randint(
                0, self.max_latency
            )
        heapq.heappush(
            self._queue, (deliver_at, self._seq, fn, fut, kind)
        )
        return fut

    def partition(self, for_steps):
        """Sever the link: every in-flight and new message stalls until
        the partition heals (ref: sim2 network partitions). The heal
        releases the backlog with per-message jitter — clamping all to
        the same instant would tie-break the heap on send order and
        erase the very reordering the latency model created."""
        self.partitions += 1
        until = self.clock() + for_steps
        self._partition_until = max(self._partition_until, until)
        self._queue = [
            (
                d if d >= until
                else until + self.rng.randint(0, self.max_latency),
                s, fn, fut, kind,
            )
            for d, s, fn, fut, kind in self._queue
        ]
        heapq.heapify(self._queue)

    def deliver_due(self, step):
        """Execute every message due at ``step``, in delivery order."""
        while self._queue and self._queue[0][0] <= step:
            _, seq, fn, fut, kind = heapq.heappop(self._queue)
            if any(s < seq for _, s, *_ in self._queue):
                self.reordered += 1  # overtook an older in-flight message
            if fn is None:
                fut.error = err(
                    "commit_unknown_result" if kind == "commit"
                    else "process_behind"
                )
            else:
                try:
                    fut.value = fn()
                except BaseException as e:
                    fut.error = e
            fut.done = True
            self.delivered += 1

    @property
    def pending(self):
        return len(self._queue)
