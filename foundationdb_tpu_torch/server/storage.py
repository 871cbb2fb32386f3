"""Storage server: MVCC versioned reads over an ordered key space.

Ref parity: fdbserver/storageserver.actor.cpp — serves reads at a
client's read version inside the MVCC window, applies committed
mutations in version order, resolves key selectors, evaluates atomic
ops, and fires watches. Two tiers as in the reference: a versioned
in-memory overlay holding the window, above a single-version engine
(server/kvstore.py) that holds the state as of the *durable version*;
``flush()`` folds overlay versions into the engine. A versioned engine
(``versioned = True``) takes every overlay version instead, and serves
reads below the durable version from its chains.

Selector resolution and range reads live in :class:`RangeReadInterface`,
which the storage router (server/router.py) shares, so the partitioned
tier's reads cannot diverge from one storage's. ``export_shard`` /
``ingest_shard`` are data distribution's copy of a shard with its MVCC
history (ref: fetchKeys).

Observability: the storage's metrics registry (an apply band, a served
read band, volume counters; a recruit adopts its predecessor's) and,
once the cluster attaches its heatmaps, countdown sampling of read and
write keys (one sample in ``sample_every`` accesses on average, drawn
from the "key-sample" stream; system keys are never charged). A traced
batch's apply is a ``storage.apply`` span.
"""

import itertools
from collections import deque

from foundationdb_tpu_torch.core import deterministic
from foundationdb_tpu_torch.core.errors import FDBError, err
from foundationdb_tpu_torch.core.keys import KeySelector, key_successor
from foundationdb_tpu_torch.core.mutations import ATOMIC_OPS, Op, apply_atomic
from foundationdb_tpu_torch.server.kvstore import KeyValueStoreMemory
from foundationdb_tpu_torch.utils import heatmap as heatmap_mod
from foundationdb_tpu_torch.utils import lockdep
from foundationdb_tpu_torch.utils import metrics as metrics_mod
from foundationdb_tpu_torch.utils import span as span_mod
from foundationdb_tpu_torch.utils.sorteddict import SortedDict

_MISS = object()  # the overlay has no entry at or below the read version


class Watch:
    """Fires when the watched key's value diverges from the seen value.
    Ref: watchValue in storageserver.actor.cpp."""

    def __init__(self, key, seen_value):
        self.key = key
        self.seen_value = seen_value
        self.fired = False
        self._callbacks = []

    def on_fire(self, cb):
        if self.fired:
            cb()
        else:
            self._callbacks.append(cb)

    def _fire(self):
        if not self.fired:
            self.fired = True
            for cb in self._callbacks:
                cb()


class RangeReadInterface:
    """Selector resolution and range reads over any provider of
    ``_iter_live(begin, end, version, reverse)`` and ``_check_version``:
    one storage's merged overlay and engine, or the router's tier
    stitched across shards."""

    _WALK_END = b"\xff\xff"  # past every user and system key

    def _live_keys(self, begin, end, version, reverse=False):
        for k, _ in self._iter_live(begin, end, version, reverse=reverse):
            yield k

    def read_range(self, begin, end, version, limit=None):
        """The (key, value) rows of [begin, end) at ``version``, without
        selectors: data distribution's shard read (ref: fetchKeys'
        getRange stream)."""
        self._check_version(version)
        out = []
        for kv in self._iter_live(begin, end, version):
            out.append(kv)
            if limit is not None and len(out) >= limit:
                break
        return out

    def resolve_selector(self, sel: KeySelector, version):
        """A key selector's key (ref: findKey): start at the last live
        key < (or <=) sel.key, then move ``offset`` live keys right.
        Clamps to b'' and the \\xff sentinel."""
        self._check_version(version)
        offset = sel.offset
        upper = sel.key + b"\x00" if sel.or_equal else sel.key
        need = 1 if offset > 0 else (-offset + 1)
        prev = list(itertools.islice(
            self._live_keys(b"", upper, version, reverse=True), need))
        if offset > 0:
            start = prev[0] + b"\x00" if prev else b""
            following = self._live_keys(start, self._WALK_END, version)
            k = next(itertools.islice(following, offset - 1, None), None)
            return k if k is not None else b"\xff"
        idx = -offset
        return prev[idx] if idx < len(prev) else b""

    def get_range(self, begin_sel, end_sel, version, limit=0, reverse=False):
        """Half-open range read between keys or key selectors."""
        self._check_version(version)
        begin = (begin_sel if isinstance(begin_sel, bytes)
                 else self.resolve_selector(begin_sel, version))
        end = (end_sel if isinstance(end_sel, bytes)
               else self.resolve_selector(end_sel, version))
        if begin > end:
            return []
        out = []
        for kv in self._iter_live(begin, end, version, reverse=reverse):
            out.append(kv)
            if limit and len(out) >= limit:
                break
        return out


class StorageServer(RangeReadInterface):
    def __init__(self, window_versions=5_000_000, engine=None):
        # overlay: key -> [(version, value or None)] ascending, every
        # version > durable_version; None is a tombstone
        self._overlay = SortedDict()
        self._dirty = deque()  # (version, key) in apply order, for flush
        # client threads read while the commit path applies
        self._mu = lockdep.rlock("StorageServer._mu")
        self.alive = True
        self.engine = engine if engine is not None else KeyValueStoreMemory()
        # a versioned engine (the Redwood role) keeps per-key version
        # chains: the MVCC window extends into the durable tier
        self.versioned_engine = bool(getattr(self.engine, "versioned", False))
        self.durable_version = self.engine.stored_version()
        self.oldest_version = (self.engine.oldest_retained
                               if self.versioned_engine
                               else self.durable_version)
        self.version = self.durable_version  # latest applied
        self.window_versions = window_versions
        self._watches = {}  # key -> [Watch]
        # the apply band and volume counters (ref: StorageMetrics); a
        # recruit adopts this registry, so no counter goes backwards
        self.metrics = metrics_mod.MetricsRegistry("storage")
        self._bind_metrics()
        # read and write key sampling into the cluster's heatmaps
        # (attach_heatmaps; None: sampling off). A countdown: one
        # decrement per access, a draw only when a sample fires
        self._read_heat = None
        self._write_heat = None
        self._sample_every = 8
        self._sample_w = 8.0
        self._srng = None
        self._read_cd = 1  # the first access is sampled
        self._write_cd = 1
        # placement tag: the primary region's id when regions are
        # configured (recruitment carries it to the replacement)
        self.region = None

    @classmethod
    def recover(cls, engine, log_records, window_versions=5_000_000):
        """Rebuild from a durable engine and the log records past its
        durable version (ref: storage server recovery peeking the
        tlog)."""
        ss = cls(window_versions=window_versions, engine=engine)
        for version, mutations in log_records:
            if version > ss.durable_version:
                ss.apply(version, mutations)
        return ss

    # ───────────────────────────── writes ──────────────────────────────
    def apply(self, version, mutations):
        """Apply one batch's mutations at ``version`` (monotone)."""
        if version <= self.version:
            raise ValueError(f"apply out of order: {version} <= {self.version}")
        asp = span_mod.from_context("storage.apply", span_mod.current(),
                                    version=version)
        t0 = metrics_mod.now()
        with self._mu:
            overlay = self._overlay
            dirty_append = self._dirty.append
            for m in mutations:
                op = m.op
                if op is Op.SET:
                    key = m.key
                    chain = overlay.get(key)
                    if chain is None:
                        overlay[key] = chain = []
                    chain.append((version, m.param))
                    dirty_append((version, key))
                    if self._watches:
                        self._fire_watches(key, m.param)
                elif op is Op.CLEAR_RANGE:
                    self._apply_clear_range(m.key, m.param, version)
                elif op is Op.CLEAR:
                    self._append(m.key, version, None)
                elif op in ATOMIC_OPS:
                    old = self._lookup(m.key, version)
                    self._append(m.key, version, apply_atomic(op, old, m.param))
                else:
                    raise ValueError(f"unresolved mutation {op} reached storage")
            self.version = version
        self._m_apply.record(max(0.0, metrics_mod.now() - t0))
        self._m_mutations.inc(len(mutations))
        if self._write_heat is not None and mutations:
            # one countdown step per apply call; a key of the batch is
            # drawn only when it fires
            self._write_cd -= len(mutations)
            if self._write_cd <= 0:
                self._write_cd = self._srng.randrange(
                    1, 2 * self._sample_every + 1)
                if heatmap_mod.enabled():
                    m = mutations[self._srng.randrange(len(mutations))]
                    if m.key < b"\xff":  # user keys only, as reads
                        self._write_heat.charge(m.key, self._sample_w)
        asp.finish(mutations=len(mutations))

    def _apply_clear_range(self, begin, end, version):
        # tombstone every key the clear shadows: overlay keys in range and
        # engine keys in range not yet overlaid
        keys = set(self._overlay.irange(begin, end, inclusive=(True, False)))
        keys.update(k for k, _ in self.engine.get_range(begin, end))
        for k in keys:
            self._append(k, version, None)

    def _append(self, key, version, value):
        chain = self._overlay.get(key)
        if chain is None:
            chain = self._overlay[key] = []
        chain.append((version, value))
        self._dirty.append((version, key))
        if self._watches:
            self._fire_watches(key, value)

    def _fire_watches(self, key, value):
        watchers = self._watches.get(key)
        if watchers:
            for w in watchers:
                if value != w.seen_value:
                    w._fire()
            self._watches[key] = [w for w in watchers if not w.fired]

    def flush(self, up_to_version=None):
        """Make versions <= ``up_to_version`` durable: fold the newest
        overlay entry at or below it into the engine, prune the overlay,
        advance durable_version. Returns the new durable version."""
        if up_to_version is None:
            up_to_version = self.version
        up_to_version = min(up_to_version, self.version)
        if up_to_version <= self.durable_version:
            return self.durable_version
        with self._mu:
            touched = set()
            while self._dirty and self._dirty[0][0] <= up_to_version:
                touched.add(self._dirty.popleft()[1])
            for key in touched:
                chain = self._overlay.get(key)
                if chain is None:
                    continue
                folded = _MISS
                keep = []
                for v, val in chain:
                    if v <= up_to_version:
                        if self.versioned_engine:
                            # every version goes down intact
                            self.engine.set_versioned(key, v, val)
                        folded = val
                    else:
                        keep.append((v, val))
                if folded is not _MISS and not self.versioned_engine:
                    if folded is None:
                        self.engine.clear_range(key, key_successor(key))
                    else:
                        self.engine.set(key, folded)
                if keep:
                    self._overlay[key] = keep
                else:
                    del self._overlay[key]
            self.engine.commit(up_to_version)
            self.durable_version = up_to_version
            if not self.versioned_engine:
                # a single-version engine: reads below it are gone
                self.oldest_version = max(self.oldest_version,
                                          up_to_version)
            return self.durable_version

    def advance_window(self, oldest):
        """Advance the MVCC read floor (flushing is the proxy's pump).
        A versioned engine prunes the history that fell below it."""
        if oldest > self.oldest_version:
            self.oldest_version = oldest
            if self.versioned_engine:
                with self._mu:
                    self.engine.prune(min(oldest, self.durable_version))

    def kill(self):
        self.alive = False

    # ───────────────────────────── reads ───────────────────────────────
    def _check_version(self, version):
        if not self.alive:
            raise err("process_behind")
        if version < self.oldest_version:
            raise err("transaction_too_old")
        if version > self.version:
            raise err("future_version")

    def _lookup(self, key, version):
        """Value of key at version (overlay first, engine beneath)."""
        val = self._overlay_at(key, version)
        if val is not _MISS:
            return val
        if self.versioned_engine:
            return self.engine.get_at(key, version)
        return self.engine.get(key)

    def _overlay_at(self, key, version):
        """Newest overlay value at or below ``version`` (or _MISS)."""
        val = _MISS
        for v, x in self._overlay.get(key, ()):
            if v <= version:
                val = x
            else:
                break
        return val

    def get(self, key, version):
        self._check_version(version)
        self._m_reads.inc()
        if self._read_heat is not None:
            self._read_cd -= 1
            if self._read_cd <= 0:
                self._sample_read(key)
        with self._mu:
            return self._lookup(key, version)

    def read_batch(self, ops):
        """Serve several reads under one lock crossing. ``ops`` are
        ``("g", key, rv)`` → value or None, ``("r", begin, end, rv,
        limit, reverse)`` → [(k, v)], ``("s", selector, rv)`` → key; an
        FDBError fills its own slot, never the batch's. Each read counts
        and samples as its unbatched form does."""
        t0 = metrics_mod.now()
        out = []
        with self._mu:
            for op in ops:
                try:
                    kind = op[0]
                    if kind == "g":
                        out.append(self.get(op[1], op[2]))
                    elif kind == "r":
                        out.append(self.get_range(op[1], op[2], op[3],
                                                  limit=op[4],
                                                  reverse=op[5]))
                    elif kind == "s":
                        out.append(self.resolve_selector(op[1], op[2]))
                    else:
                        raise err("client_invalid_operation")
                except FDBError as e:
                    out.append(e)
        self._m_read_batch.record(max(0.0, metrics_mod.now() - t0))
        # reads per batch, recorded /1e3 so the band's ms read back as
        # the raw batch size
        self._m_read_batch_keys.record(len(ops) / 1e3)
        self._m_read_batches.inc()
        self._m_batched_reads.inc(len(ops))
        return out

    def _iter_live(self, begin, end, version, reverse=False):
        """Lazy merged (key, value) iteration of engine and overlay at
        ``version``: the overlay wins ties, and the engine cursor moves
        only as far as the caller consumes."""
        self._m_range_reads.inc()
        if self._read_heat is not None:
            # a range read charges its begin key
            self._read_cd -= 1
            if self._read_cd <= 0:
                self._sample_read(begin)
        with self._mu:
            yield from self._iter_live_locked(begin, end, version, reverse)

    def _iter_live_locked(self, begin, end, version, reverse):
        sentinel = object()
        ov = iter(self._overlay.irange(begin, end, inclusive=(True, False),
                                       reverse=reverse))
        base = (self.engine.iter_range_at(begin, end, version,
                                          reverse=reverse)
                if self.versioned_engine
                else self.engine.iter_range(begin, end, reverse=reverse))
        ko = next(ov, sentinel)
        kb = next(base, sentinel)
        while ko is not sentinel or kb is not sentinel:
            if kb is sentinel:
                take_overlay = True
            elif ko is sentinel:
                take_overlay = False
            elif ko == kb[0]:
                val = self._overlay_at(ko, version)
                if val is _MISS:
                    val = kb[1]
                if val is not None:
                    yield ko, val
                ko = next(ov, sentinel)
                kb = next(base, sentinel)
                continue
            else:
                take_overlay = (ko < kb[0]) != reverse
            if take_overlay:
                val = self._overlay_at(ko, version)
                if val is not _MISS and val is not None:
                    yield ko, val
                ko = next(ov, sentinel)
            else:
                yield kb
                kb = next(base, sentinel)

    def export_shard(self, begin, end):
        """A snapshot of [begin, end) with its MVCC history: the engine's
        rows at the durable version (a versioned engine's chains) and
        every overlay chain, for a joiner to ingest so that reads at
        pre-move versions stay right (ref: fetchKeys and the mutations
        that bring a joining storage up to date)."""
        with self._mu:
            if self.versioned_engine:
                base = dict(self.engine.iter_chains(begin, end))
            else:
                base = {k: [(self.durable_version, v)]
                        for k, v in self.engine.iter_range(begin, end)}
            keys = set(base)
            keys.update(self._overlay.irange(begin, end,
                                             inclusive=(True, False)))
            rows = []
            for k in sorted(keys):
                chain = list(base.get(k, ()))
                chain.extend(self._overlay.get(k, ()))
                rows.append((k, chain))
            return self.oldest_version, self.version, rows

    def ingest_shard(self, begin, end, export):
        """Install an ``export_shard`` snapshot: [begin, end) is cleared
        first, so stale rows and the source's deletes do not survive, and
        the read floor rises to the source's (versions below it were not
        exported: they answer TOO_OLD, never a silent miss)."""
        oldest, version, rows = export
        with self._mu:
            self.version = max(self.version, version)
            self.oldest_version = max(self.oldest_version, oldest)
            if self.versioned_engine:
                # evict the stale history physically: a clear would
                # tombstone at the durable version, above the ingested
                # chain's lower versions
                self.engine.erase_range(begin, end)
            else:
                self.engine.clear_range(begin, end)
            for k in list(self._overlay.irange(begin, end,
                                               inclusive=(True, False))):
                del self._overlay[k]
            for k, chain in rows:
                self._overlay[k] = list(chain)
                for v, _ in chain:
                    self._dirty.append((v, k))

    # ───────────────────────────── watches ─────────────────────────────
    def fire_watches_in_range(self, begin, end):
        """Fire every watch on a key of [begin, end): the shard moved
        away, so watchers re-read from its new owner instead of waiting
        on a storage that no longer receives the key's mutations."""
        with self._mu:
            for key in list(self._watches):
                if begin <= key and (end is None or key < end):
                    for w in self._watches.pop(key):
                        w._fire()

    def watch(self, key, seen_value):
        if not self.alive:
            raise err("process_behind")
        with self._mu:
            w = Watch(key, seen_value)
            if self._lookup(key, self.version) != seen_value:
                w._fire()
            else:
                self._watches.setdefault(key, []).append(w)
            return w

    # ───────────────────────────── metrics ─────────────────────────────
    def _bind_metrics(self):
        reg = self.metrics
        self._m_apply = reg.latency("storage_apply")
        self._m_mutations = reg.counter("mutations_applied")
        self._m_reads = reg.counter("point_reads")
        self._m_range_reads = reg.counter("range_reads")
        self._m_read_batch = reg.latency("read_batch")
        self._m_read_batch_keys = reg.latency("read_batch_keys")
        self._m_read_batches = reg.counter("read_batches")
        self._m_batched_reads = reg.counter("batched_reads")

    def adopt_metrics(self, registry):
        """A recruit continues its predecessor's registry, folding in
        what this instance counted (its replay)."""
        if registry is self.metrics:
            return
        registry.absorb(self.metrics)
        self.metrics = registry
        self._bind_metrics()

    def attach_heatmaps(self, read_heat, write_heat, sample_every=8):
        """Sample into the cluster's read and write heatmaps (a recruit
        gets the same ones). The draws come from the "key-sample"
        stream."""
        self._read_heat = read_heat
        self._write_heat = write_heat
        self._sample_every = max(1, int(sample_every))
        self._sample_w = float(self._sample_every)
        self._srng = deterministic.rng("key-sample")

    def _sample_read(self, key):
        """The countdown fired: a randomized stride (mean about
        sample_every) so periodic access cannot alias with it; the
        weight scales with the stride. System keys stay out: the status
        machinery reads them on every poll."""
        self._read_cd = self._srng.randrange(1, 2 * self._sample_every + 1)
        if key < b"\xff" and heatmap_mod.enabled():
            self._read_heat.charge(key, self._sample_w)

    def status(self):
        self.metrics.gauge("version").set(self.version)
        self.metrics.gauge("durable_version").set(self.durable_version)
        self.metrics.gauge("durability_lag_versions").set(
            max(0, self.version - self.durable_version))
        return {"alive": self.alive, "region": self.region,
                "metrics": self.metrics.snapshot()}
