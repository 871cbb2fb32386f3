"""Ratekeeper: cluster-wide admission control.

Ref parity: fdbserver/Ratekeeper.actor.cpp — computes a transactions-per-
second budget from storage/tlog health and conflict rates; GRV proxies
enforce it by delaying or rejecting read-version grants. Ours keeps the
same two-loop shape:

* a **token bucket** at the GRV edge (``admit``), refilled at the current
  target TPS, with batch-priority txns charged more so they only run on
  spare capacity and immediate-priority (system) txns exempt;
* a **control loop** (``update``, pumped by the commit proxy's durability pump)
  that recomputes the target: storage durability lag (versions the
  storage tier is behind the committed version — the analog of the
  reference's storage-queue spring) squeezes the budget smoothly toward
  a floor, and a high conflict ratio (wasted work under contention)
  trims it, recovering multiplicatively when health returns.

The per-reason denial counters live in the role's metrics registry
(utils/metrics.py), as the reference's do; ``status()`` sets the
throttle gauges from the live fields when it is read.
"""

import time

from foundationdb_tpu_torch.utils import lockdep
from foundationdb_tpu_torch.utils import metrics as metrics_mod


class Ratekeeper:
    # lag (in versions) where the budget starts shrinking / hits the floor
    LAG_SOFT = 1_000_000  # ~1s at 1M versions/sec (the reference's 5s MVCC
    LAG_HARD = 4_000_000  # window leaves ~1s headroom before TOO_OLD pain)
    CONFLICT_TRIM = 0.5  # conflict ratio above which the budget is trimmed
    FLOOR_FRACTION = 0.01
    # ── per-tag auto-throttling (ref: fdbserver/TagThrottler.actor.cpp,
    # GrvProxyTagThrottler.actor.cpp: busy tags get their own rate limit
    # so one abusive workload cannot starve the rest) ──
    TAG_SAMPLE_MIN = 64  # admissions before a tag can auto-throttle
    TAG_BUSY_FRACTION = 0.5  # share of admissions that reads as "busy"
    TAG_RELEASE_FACTOR = 1.5  # limit regrowth per healthy control round

    def __init__(self, target_tps=1e9, batch_priority_fraction=0.5,
                 clock=None, tag_busy_threshold=1.0):
        self.max_tps = target_tps
        self.target_tps = target_tps
        self.batch_priority_fraction = batch_priority_fraction
        # standalone busy-tag policy (knob tag_throttle_busyness, ref:
        # TagThrottler auto-throttling a busy tag without waiting for
        # global pressure): a tag whose admission share exceeds this
        # threshold gets its own limit even while the cluster budget is
        # healthy. 1.0 = off (a share can never exceed 1.0); the
        # under-pressure AIMD path below is always on.
        self.tag_busy_threshold = float(tag_busy_threshold)
        # injectable clock: a caller drives the token bucket off its own
        # counter instead of wall time, so admissions replay exactly
        self.clock = clock if clock is not None else time.monotonic
        self._tokens = target_tps
        self._last_refill = self.clock()
        self._recent_txns = 0
        self._recent_conflicts = 0
        self.throttled_count = 0  # GRV requests rejected at the gate
        # per-tag state: sampled admissions per control window, manual
        # quotas (operator), auto limits (control loop), token buckets
        self._tag_counts = {}  # tag -> admissions this window
        self._recent_admits = 0  # all admissions this window (share base)
        self._tag_window_start = self.clock()
        self.tag_quotas = {}  # tag -> tps (manual, sticky)
        self.tag_limits = {}  # tag -> tps (auto, AIMD)
        self._tag_buckets = {}  # tag -> [tokens, last_refill]
        self.tag_throttled_count = 0
        # per-tag busyness (workload attribution, gauge only): the last
        # completed control window's cnt/total share per tag, captured
        # BEFORE _update_tags_locked resets its sample — a future
        # tag-throttle PR turns policy on against exactly this signal
        self.tag_busyness = {}
        # thread-mode clusters admit from many client threads while the
        # batcher thread feeds observe_commit/update: the token bucket's
        # read-modify-write must not interleave
        self._mu = lockdep.lock("Ratekeeper._mu")
        # the throttle gauges and per-reason denial counters of the
        # status document (ref: the qos section Ratekeeper feeds in
        # Status.actor.cpp); the gauges are set when status() reads them
        self.metrics = metrics_mod.MetricsRegistry("ratekeeper")
        self._m_denied_tag = self.metrics.counter("admit_denied_tag")
        self._m_denied_budget = self.metrics.counter("admit_denied_budget")

    # ── GRV-edge enforcement (ref: GrvProxy transaction budgets) ──
    def admit(self, priority="default", tags=()):
        ok, _ = self.admit_with_reason(priority, tags)
        return ok

    # Above this target the bucket cannot practically constrain anything
    # (refill outruns any achievable admission rate), so admission is a
    # foregone conclusion and the lock is pure hot-path overhead.
    UNLIMITED_TPS = 1e8

    def admit_with_reason(self, priority="default", tags=()):
        """→ (admitted, None | "tag" | "budget"). Tag buckets are
        checked before the global bucket so a throttled tag's denial
        never burns global tokens; admissions (not attempts) feed the
        busy-tag sample, or a throttled-but-retrying tag could never
        observe a rate low enough to be released."""
        if priority == "immediate":
            return True, None  # system txns bypass (ref: TransactionPriority::IMMEDIATE)
        if (not tags and not self.tag_quotas and not self.tag_limits
                and not self._tag_counts
                and self.target_tps >= self.UNLIMITED_TPS):
            # unconstrained fast path: no tag rules exist, no tagged
            # traffic has been sampled, and the global bucket is
            # effectively unbounded — admission cannot fail. The racy
            # counter only feeds the tagged-share estimate; requiring an
            # empty _tag_counts keeps untagged increments from racing
            # (and shrinking) the admissions base while tagged txns take
            # the locked path, which would bias TOWARD spurious
            # auto-throttling.
            self._recent_admits += 1
            return True, None
        with self._mu:
            now = self.clock()
            ok, limited = self._tags_check_locked(tags, now)
            if not ok:
                return False, "tag"
            if not self._global_pass_locked(priority, now):
                # tag buckets deliberately NOT charged on a global deny:
                # a tagged client retrying 1037 under saturation must
                # not drain its quota with zero admissions
                return False, "budget"
            for b in limited:
                b[0] -= 1.0
            self._note_admit_locked(tags)
            return True, None

    def note_untagged_admissions(self, n):
        """Read-free commits skip the GRV (rv assigned at the proxy)
        but still belong in the busy-tag sample's admissions BASE:
        without them ``cnt/total`` overstates every tag's share and
        auto-throttling turns against innocent tags (round-5 review).
        Called once per batch, under the lock."""
        with self._mu:
            self._recent_admits += n

    def tag_gate(self, tags):
        """The tag half alone (BatchingGrvProxy closes tag gates before
        queueing so a throttled tag never occupies the shared FIFO; the
        global budget is charged later by the grant loop). Both the tag
        count and the admissions base are sampled here — the grant
        loop's untagged admit() adds to the base again, so tagged share
        is under- (never over-) estimated for batching deployments,
        biasing AWAY from spurious auto-throttling."""
        if not tags:
            return True
        with self._mu:
            now = self.clock()
            ok, limited = self._tags_check_locked(tags, now)
            if not ok:
                return False
            for b in limited:
                b[0] -= 1.0
            self._note_admit_locked(tags)
            return True

    def _tags_check_locked(self, tags, now):
        """All-or-nothing check → (ok, limited_buckets): the CALLER
        charges the returned buckets only once the whole admission
        passes (a multi-tag txn denied by its second tag — or by the
        global budget — must not burn any tag's token)."""
        limited = []
        for tag in tags:
            limit = self.tag_quotas.get(tag, self.tag_limits.get(tag))
            if limit is None:
                continue
            b = self._tag_buckets.get(tag)
            if b is None:
                b = self._tag_buckets[tag] = [limit, now]
            b[0] = min(limit, b[0] + (now - b[1]) * limit)
            b[1] = now
            if b[0] < 1.0:
                self.tag_throttled_count += 1
                self._m_denied_tag.inc()
                return False, []
            limited.append(b)
        return True, limited

    def _global_pass_locked(self, priority, now):
        need = 1.0
        if priority == "batch":
            # batch priority only runs when spare capacity exists
            need = 1.0 / max(self.batch_priority_fraction, 1e-6)
        self._tokens = min(
            self.target_tps,
            self._tokens + (now - self._last_refill) * self.target_tps,
        )
        self._last_refill = now
        if self._tokens >= need:
            self._tokens -= need
            return True
        self.throttled_count += 1
        self._m_denied_budget.inc()
        return False

    def _note_admit_locked(self, tags):
        self._recent_admits += 1
        for tag in tags:
            self._tag_counts[tag] = self._tag_counts.get(tag, 0) + 1

    def observe_commit(self, txns, conflicts):
        """Both arguments are per-batch increments."""
        with self._mu:
            self._recent_txns += txns
            self._recent_conflicts += conflicts

    # ── control loop (ref: Ratekeeper::updateRate) ──
    def update(self, storage_lag_versions=0):
        """Recompute target TPS from tier health; returns the new target.

        ``storage_lag_versions``: committed version minus the slowest
        storage's durable version (the commit proxy's durability pump
        computes it).
        """
        with self._mu:
            return self._update_locked(storage_lag_versions)

    def _update_locked(self, storage_lag_versions):
        floor = self.max_tps * self.FLOOR_FRACTION
        # storage spring: full rate below LAG_SOFT, linear squeeze to the
        # floor at LAG_HARD (the reference's smoothed storage queue term)
        if storage_lag_versions <= self.LAG_SOFT:
            lag_target = self.max_tps
        elif storage_lag_versions >= self.LAG_HARD:
            lag_target = floor
        else:
            frac = (storage_lag_versions - self.LAG_SOFT) / (
                self.LAG_HARD - self.LAG_SOFT
            )
            lag_target = self.max_tps - frac * (self.max_tps - floor)

        # conflict trim: mostly-wasted work means admitting more txns only
        # manufactures retries; shed a third, recover gradually when healthy.
        # Sub-threshold samples decay 25% per round instead of hard
        # resetting: a sustained storm accumulates to the 100-txn sample
        # even at low per-round volume (equilibrium 3x the per-round
        # count), while a one-off burst fades within a few rounds and
        # cannot trim a later, healthy period.
        target = min(lag_target, self.max_tps)
        total = self._recent_txns
        if total >= 100:
            ratio = self._recent_conflicts / total
            if ratio > self.CONFLICT_TRIM:
                target = max(floor, min(target, self.target_tps * (2 / 3)))
            self._recent_txns = 0
            self._recent_conflicts = 0
        else:
            self._recent_txns = self._recent_txns * 3 // 4
            self._recent_conflicts = self._recent_conflicts * 3 // 4
        if target > self.target_tps:
            # recover at most 10% per round so oscillation damps out
            target = min(target, max(self.target_tps * 1.1, floor))
        self.target_tps = max(floor, target)
        self._update_tags_locked()
        return self.target_tps

    def _update_tags_locked(self):
        """Busy-tag auto-throttling (ref: TagThrottler::autoThrottleTag):
        while the cluster is shedding load, a tag responsible for more
        than TAG_BUSY_FRACTION of admissions gets its own limit at half
        its observed rate (multiplicative decrease); healthy rounds
        regrow the limit until it clears the tag's demand, then release
        it. Manual quotas (tag_quotas) are operator-sticky and never
        auto-released.

        The STANDALONE policy (tag_busy_threshold < 1.0) additionally
        throttles a tag whose admission share exceeds the threshold
        even WITHOUT global pressure — and holds the limit (no regrow)
        while the tag stays over-threshold, so one abusive workload is
        capped the moment it dominates admissions rather than only
        after it saturates the cluster."""
        now = self.clock()
        elapsed = max(now - self._tag_window_start, 1e-9)
        total = self._recent_admits
        if self._tag_counts:
            # retain the window's per-tag admission share as a gauge:
            # captured here because the sample resets below
            self.tag_busyness = {
                tag: round(cnt / max(total, 1), 4)
                for tag, cnt in sorted(self._tag_counts.items())
            }
        under_pressure = self.target_tps < self.max_tps * 0.9
        # visit limited-but-silent tags too: a tag that stopped sending
        # must have its limit regrown/released, not kept forever
        for tag in set(self._tag_counts) | set(self.tag_limits):
            cnt = self._tag_counts.get(tag, 0)
            rate = cnt / elapsed
            busy = (
                cnt >= self.TAG_SAMPLE_MIN
                and total > 0
                and cnt / total > self.TAG_BUSY_FRACTION
            )
            standalone = (
                self.tag_busy_threshold < 1.0
                and cnt >= self.TAG_SAMPLE_MIN
                and total > 0
                and cnt / total > self.tag_busy_threshold
            )
            limit = self.tag_limits.get(tag)
            if (under_pressure and busy) or standalone:
                new_limit = max(rate / 2, 1.0)
                self.tag_limits[tag] = (
                    min(limit, new_limit) if limit is not None else new_limit
                )
            elif limit is not None and not under_pressure:
                grown = limit * self.TAG_RELEASE_FACTOR
                if grown > rate * 2:
                    del self.tag_limits[tag]
                    self._tag_buckets.pop(tag, None)
                else:
                    self.tag_limits[tag] = grown
        # drop buckets for stale released tags; reset the sample window
        for tag in list(self._tag_buckets):
            if tag not in self.tag_limits and tag not in self.tag_quotas:
                del self._tag_buckets[tag]
        self._tag_counts = {}
        self._recent_admits = 0
        self._tag_window_start = now

    def set_tag_quota(self, tag, tps):
        """Operator-set per-tag rate limit (ref: the tag quota system);
        ``tps=None`` clears it."""
        with self._mu:
            if tps is None:
                self.tag_quotas.pop(tag, None)
                if tag not in self.tag_limits:
                    self._tag_buckets.pop(tag, None)
            else:
                self.tag_quotas[tag] = float(tps)

    def throttled_tags(self):
        """Snapshot for status json: tag -> effective tps limit."""
        with self._mu:
            out = dict(self.tag_limits)
            out.update(self.tag_quotas)
            return out

    def set_target_tps(self, tps):
        self.max_tps = float(tps)
        self.target_tps = min(self.target_tps, self.max_tps)

    def history_sample(self):
        """Point-in-time admission gauges for the history collector
        (utils/timeseries.py); unlike ``status()`` it sets no gauge."""
        with self._mu:
            return {
                "target_tps": round(self.target_tps, 2),
                "saturation": round(
                    1.0 - self.target_tps / max(self.max_tps, 1e-9), 4),
                "throttled": self.throttled_count,
                "tag_throttled": self.tag_throttled_count,
            }

    def status(self):
        """This role's status payload: the throttle gauges, set from the
        live fields here (admission pays nothing for them), and the
        denial counters."""
        m = self.metrics
        m.gauge("target_tps").set(self.target_tps)
        m.gauge("max_tps").set(self.max_tps)
        m.gauge("throttled").set(self.throttled_count)
        m.gauge("tag_throttled").set(self.tag_throttled_count)
        m.gauge("throttled_tags").set(len(self.throttled_tags()))
        m.gauge("saturation").set(
            round(1.0 - self.target_tps / max(self.max_tps, 1e-9), 4))
        doc = {"alive": True, "metrics": m.snapshot()}
        with self._mu:
            if self.tag_busyness:
                doc["tag_busyness"] = dict(self.tag_busyness)
        return doc
