"""Horizontally scaled transaction frontend: commit-proxy and GRV fleets.

Ref parity: the reference runs a fleet of commit proxies and GRV proxies
(fdbserver/CommitProxyServer.actor.cpp, GrvProxyServer.actor.cpp), with
the sequencer chaining each batch's version to the one granted before it
(masterserver.actor.cpp getVersion prevVersion) so batches from
different proxies interleave into one serial order. The chaining is
``Sequencer.next_commit_versions``; two ``VersionGate``\\ s order the
stateful stages across the fleet (server/proxy.py). These facades give
the fleet the surface one proxy has:

- ``ProxyFleet`` round-robins client commits across its members, fans
  the database lock, the tenant mode and the region replicator out to
  every member, derives the host resolvers' ranges once for all of
  them, and sums their counters;
- ``GrvFleet`` round-robins read-version requests.
"""

import itertools


class ProxyFleet:
    """``members`` are the client-facing proxies (batching wrappers in a
    pipeline, the bare proxies otherwise); ``inners`` the bare
    ``CommitProxy`` instances they drive."""

    def __init__(self, members, inners):
        self.members = members
        self.inners = inners
        self._rr = itertools.count()

    def _pick(self):
        return self.members[next(self._rr) % len(self.members)]

    # ── client surface (round-robined) ──
    def commit(self, request):
        return self._pick().commit(request)

    def submit(self, request):
        return self._pick().submit(request)

    def commit_batch(self, requests):
        return self._pick().commit_batch(requests)

    def commit_batches(self, request_batches):
        return self.inners[next(self._rr) % len(self.inners)].commit_batches(
            request_batches)

    # ── management surface ──
    @property
    def inner(self):
        # the cluster unwraps a batching pipeline through .inner; the
        # fleet is its own management target
        return self

    @property
    def alive(self):
        return all(p.alive for p in self.inners)

    def kill(self):
        for p in self.inners:
            p.kill()

    @property
    def lock_uid(self):
        return self.inners[0].lock_uid

    @lock_uid.setter
    def lock_uid(self, uid):
        # every member enforces the lock: a commit through any proxy of a
        # locked database fails 1038
        for p in self.inners:
            p.lock_uid = uid

    @property
    def tenant_mode(self):
        return self.inners[0].tenant_mode

    @tenant_mode.setter
    def tenant_mode(self, mode):
        for p in self.inners:
            p.tenant_mode = mode

    @property
    def regions(self):
        return self.inners[0].regions

    @regions.setter
    def regions(self, replicator):
        # a sync satellite gates every member's commits
        for p in self.inners:
            p.regions = replicator

    def update_resolver_ranges(self, fence=True):
        """One member derives (and on a move fences) the ranges; the
        rest copy its bounds: deriving per member would fence the shared
        resolvers once a proxy."""
        self.inners[0].update_resolver_ranges(fence=fence)
        for p in self.inners[1:]:
            p.resolver_bounds = self.inners[0].resolver_bounds

    # ── lifecycle / pipeline plumbing ──
    def flush(self):
        for m in self.members:
            if hasattr(m, "flush"):
                m.flush()

    def pump(self, step):
        for m in self.members:
            if hasattr(m, "pump"):
                m.pump(step)

    def fail_pending(self, error):
        for m in self.members:
            if hasattr(m, "fail_pending"):
                m.fail_pending(error)

    def close(self):
        for m in self.members:
            if hasattr(m, "close"):
                m.close()
        for p in self.inners:
            p.close()

    # ── aggregated counters ──
    @property
    def commit_count(self):
        return sum(p.commit_count for p in self.inners)

    @property
    def conflict_count(self):
        return sum(p.conflict_count for p in self.inners)

    @property
    def txns_batched(self):
        return sum(getattr(m, "txns_batched", 0) for m in self.members)

    @property
    def batches_committed(self):
        return sum(getattr(m, "batches_committed", 0) for m in self.members)

    @property
    def max_batch_seen(self):
        return max((getattr(m, "max_batch_seen", 0) for m in self.members),
                   default=0)

    @property
    def _backlog_target(self):
        # the most throttled member's depth: the honest contention signal
        return min((getattr(m, "_backlog_target", 1) for m in self.members),
                   default=1)

    def stage_summary(self):
        """The members' stage timings: means across members, the largest
        configured depth, summed batch counts."""
        sums = [m.stage_summary() for m in self.members
                if hasattr(m, "stage_summary")]
        if not sums:
            return {}
        out = {}
        for k in sums[0]:
            vals = [s[k] for s in sums]
            if k == "pipeline_depth":
                out[k] = max(vals)
            elif k == "pack_path":
                out[k] = vals[0] if len(set(vals)) == 1 else "mixed"
            elif k in ("pack_flat_batches", "pack_legacy_batches",
                       "pipelined_groups", "sched_batches",
                       "sched_reordered", "sched_deferred"):
                out[k] = sum(vals)
            else:
                out[k] = round(sum(vals) / len(vals), 3)
        return out

    def __len__(self):
        return len(self.inners)


class GrvFleet:
    def __init__(self, members):
        self.members = members
        self._rr = itertools.count()

    def get_read_version(self, priority="default", tags=()):
        return self.members[next(self._rr) % len(self.members)] \
            .get_read_version(priority, tags)

    @property
    def grv_count(self):
        return sum(m.grv_count for m in self.members)

    def status(self):
        return {"alive": self.members[0].sequencer.alive,
                "grv_grants": self.grv_count, "count": len(self.members)}

    def close(self):
        for m in self.members:
            if hasattr(m, "close"):
                m.close()

    def __getattr__(self, name):  # sequencer, … pass through
        return getattr(self.members[0], name)

    def __len__(self):
        return len(self.members)
