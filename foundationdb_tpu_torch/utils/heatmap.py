"""Workload-attribution heatmaps: bounded, decayed key-range histograms.

Ref parity: fdbserver/StorageMetrics.actor.cpp (byte-sampled per-key
metrics and ``getReadHotRanges``) + the per-range conflict attribution
that fdbclient/TagThrottle.actor.cpp's throttling decisions lean on.
Every producer (commit proxy conflict charging, storage read/write
sampling) owns a :class:`KeyRangeHeatmap`; ``cluster.status()``
aggregates their snapshots under ``cluster.workload.hot_ranges``.

Determinism: decay timestamps ride ``core.deterministic.now()`` (the
sim's step clock when seeded) and the storage sampling draws ride the
``key-sample`` named stream, so two same-seed simulations emit
byte-identical hot-range snapshots (no ambient entropy here).

Overhead: the module-level ``set_enabled(False)`` kill switch turns
every ``charge`` into an early return (chip_smoke.py's phase 16
measures it).
"""

import heapq
import struct
import threading

from foundationdb_tpu_torch.core import deterministic
from foundationdb_tpu_torch.utils import lockdep

_enabled = True


def set_enabled(on):
    """Process-wide kill switch."""
    global _enabled
    _enabled = bool(on)


def enabled():
    return _enabled


def entry_key(entry):
    """Flat limb entry → raw key (core/flatpack.py layout: the key
    zero-padded to 4·L bytes followed by >I(len)). The commit proxy
    charges raw ENTRIES — order-isomorphic to keys, zero decode on the
    abort path, the same trick as server/scheduler.py — and snapshots
    pay this decode only when someone actually reads the heatmap."""
    return entry[: struct.unpack(">I", entry[-4:])[0]]


class KeyRangeHeatmap:
    """Bounded decayed histogram over an ordered byte keyspace.

    Buckets are anchor keys kept in sorted order; bucket *i* owns the
    range [anchor_i, anchor_{i+1}) and the last bucket runs to the end
    of the keyspace. ``charge(key, w)`` credits the bucket anchored at
    ``key`` — new anchors insert freely until ``max_buckets``, then the
    adjacent pair with the least combined heat coalesces (the lower
    anchor absorbs the upper's range and weight), so state stays
    bounded forever while hot anchors survive the merges.

    Heat decays exponentially with ``half_life_s`` off the injected
    deterministic clock, applied lazily per bucket: a bucket's stored
    (weight, stamp) pair reads as ``weight * 2**-((now-stamp)/hl)``.

    ``decode`` maps stored bucket keys to real keys at snapshot time
    (identity by default); total weight is conserved by merges and
    ``absorb`` — a recovery or fleet shrink never rewinds heat.
    """

    def __init__(self, name, max_buckets=64, half_life_s=30.0,
                 decode=None):
        self.name = name
        self._k = max(2, int(max_buckets))
        self._hl = float(half_life_s)
        self._decode = decode if decode is not None else (lambda k: k)
        self._lock = lockdep.lock("KeyRangeHeatmap._lock")
        self._w = {}  # anchor bytes -> weight at stamp
        self._t = {}  # anchor bytes -> decay stamp
        self._charges = 0  # exact lifetime event count (never decays)

    # ── hot path ──
    def charge(self, key, weight=1.0):
        if weight > 0.0:
            self.charge_many(((key, weight),))

    def charge_many(self, items):
        """``charge`` of each (key, weight) of ``items``, in order, under
        one lock and one clock read: a batch's conflict heat at the cost
        of one call."""
        if not _enabled:
            return
        now = deterministic.now()
        with self._lock:
            ws, ts = self._w, self._t
            for key, weight in items:
                if weight <= 0.0:
                    continue
                self._charges += 1
                w = ws.get(key)
                if w is not None:
                    ws[key] = w * self._decay(now - ts[key]) + weight
                    ts[key] = now
                else:
                    ws[key] = weight
                    ts[key] = now
                    # amortized bound: let anchors overshoot to 4k and
                    # fold back to k in one coalesce, rather than on
                    # every over-cap insert (under uniform keys nearly
                    # every charge is a fresh anchor); the read side
                    # (snapshot / split_points) coalesces to k on the
                    # way out, so the published document is still
                    # k-bounded.
                    if len(ws) > 4 * self._k:
                        self._coalesce_locked(now)

    def _decay(self, dt):
        if self._hl <= 0.0 or dt <= 0.0:
            return 1.0
        return 2.0 ** (-dt / self._hl)

    def _settle_locked(self, now):
        """Bring every bucket's lazy (weight, stamp) pair to ``now`` so
        weights are directly comparable."""
        for k, t in self._t.items():
            if t != now:
                self._w[k] *= self._decay(now - t)
                self._t[k] = now

    def _coalesce_locked(self, now):
        """Adjacent-range merge: fold the least-heat neighbor pairs into
        their lower anchors until the bucket bound holds. Total weight
        is conserved; anchors stay a sorted subset of charged keys.

        Cost matters here — this runs from the charge hot path. The
        textbook loop (extract the global min pair, repeat) is O(k^2)
        per coalesce; instead each
        pass picks the excess-th smallest pair sum as a threshold and
        folds qualifying pairs in ONE left-to-right sweep. Chained folds
        inflate the absorbing anchor past the threshold, so merges
        spread out like the exact algorithm's; the globally minimal pair
        always qualifies, so every pass merges at least once and the
        loop terminates in a handful of passes."""
        self._settle_locked(now)
        anchors = sorted(self._w)
        while len(anchors) > self._k:
            excess = len(anchors) - self._k
            sums = [self._w[anchors[i]] + self._w[anchors[i + 1]]
                    for i in range(len(anchors) - 1)]
            thresh = heapq.nsmallest(excess, sums)[-1]
            kept = [anchors[0]]
            merges = 0
            for hi in anchors[1:]:
                lo = kept[-1]
                if (merges < excess
                        and self._w[lo] + self._w[hi] <= thresh):
                    self._w[lo] += self._w.pop(hi)
                    del self._t[hi]
                    merges += 1
                else:
                    kept.append(hi)
            anchors = kept

    # ── read side ──
    @property
    def charges(self):
        return self._charges

    def total_heat(self):
        now = deterministic.now()
        with self._lock:
            return sum(
                w * self._decay(now - self._t[k])
                for k, w in self._w.items()
            )

    def snapshot(self, top=None):
        """JSON-ready sorted range list: ``[{begin, end, heat}, ...]``
        (begin/end are latin-1 decoded keys; the last range's end is
        None = the keyspace end). ``top`` keeps only the N hottest
        ranges, still ordered by key so they read as a map."""
        now = deterministic.now()
        with self._lock:
            self._coalesce_locked(now)  # publish at most max_buckets
            anchors = sorted(self._w)
            rows = []
            for i, a in enumerate(anchors):
                end = (self._decode(anchors[i + 1])
                       if i + 1 < len(anchors) else None)
                rows.append({
                    "begin": self._decode(a).decode("latin-1"),
                    "end": end.decode("latin-1") if end is not None
                    else None,
                    "heat": round(self._w[a], 4),
                })
        if top is not None and len(rows) > top:
            keep = sorted(rows, key=lambda r: (-r["heat"], r["begin"]))
            keep = {id(r) for r in keep[:top]}
            rows = [r for r in rows if id(r) in keep]
        return rows

    def split_points(self, n):
        """Suggested split keys at cumulative-heat quantiles: n-1 keys
        cutting the keyspace into n shards of roughly equal CURRENT
        heat — the exact input a lane-sharding pass needs."""
        if n <= 1:
            return []
        now = deterministic.now()
        with self._lock:
            self._coalesce_locked(now)  # quantiles over the k-bounded map
            anchors = sorted(self._w)
            weights = [self._w[a] for a in anchors]
        total = sum(weights)
        if total <= 0.0 or len(anchors) < 2:
            return []
        points = []
        acc = 0.0
        targets = [total * i / n for i in range(1, n)]
        ti = 0
        for a, w in zip(anchors, weights):
            while ti < len(targets) and acc >= targets[ti]:
                key = self._decode(a)
                if not points or points[-1] != key:
                    points.append(key)
                ti += 1
            acc += w
        return points

    def absorb(self, other):
        """Fold a retiring heatmap's state in (txn-system recovery,
        resolver respawn, configure() fleet shrink): weights add at a
        common stamp — heat never rewinds. Mirrors MetricsRegistry's
        adopt/absorb lifecycle, and deliberately bypasses the kill
        switch: carried history is not new overhead."""
        now = deterministic.now()
        with other._lock:
            other._settle_locked(now)
            o_rows = list(other._w.items())
            o_charges = other._charges
        with self._lock:
            self._settle_locked(now)
            for k, w in o_rows:
                self._w[k] = self._w.get(k, 0.0) + w
                self._t[k] = now
            self._charges += o_charges
            if len(self._w) > self._k:
                self._coalesce_locked(now)


def merged(heatmaps, name="merged", max_buckets=64, half_life_s=30.0,
           decode=None):
    """One heatmap over several producers (fleet rollup: the cluster's
    conflict heat across every commit proxy)."""
    acc = KeyRangeHeatmap(name, max_buckets=max_buckets,
                          half_life_s=half_life_s, decode=decode)
    for h in heatmaps:
        if h is not None:
            acc.absorb(h)
    return acc
