"""The Resolver role — batched MVCC conflict detection behind a backend knob.

Ref parity: fdbserver/Resolver.actor.cpp (resolveBatch). The commit proxy
hands a batch of transactions in arrival order; the resolver returns
per-txn statuses and remembers accepted writes for the MVCC window.

``resolver_backend="cuda"`` packs each batch into fixed-shape arrays,
moves them to the device, and runs ops/conflict.py's step there; the
history lives on the device and is updated in place, so only the batch
goes in and T statuses come out. The step is compiled
(ops/conflict.StaticStep, the port of the reference's jitted steps): one
per (variant, pad width B) and batch signature, captured as a CUDA graph
on a card at its first dispatch and replayed after that, counted in
``status()["graphs"]`` (``precompile`` captures them all up front). The
graphs hold the state's addresses, so the state is never replaced:
:meth:`Resolver.load_state` copies a history in. The device is
``cuda:0`` unless the caller passes ``device="cpu"`` (the tests do);
without a card and without that, construction raises. ``"cpu"`` runs
the exact host ConflictSet (resolver/skiplist.py) and ``"native"`` its
C++ twin (native/conflict_set.cpp, built by g++ at first use), which
releases the interpreter lock while it resolves.

Batches come as lists of TxnRequests or as columnar FlatTxnBatches
(core/flatpack.py, the commit proxy's default). A flat batch the flat
lane cannot serve (a read version below the device base, lane overflow,
a limb-width mismatch) decodes to TxnRequests and takes the legacy
packer: the same semantics by another route, counted in
``flat_fallbacks``.

A kernel that fails to build or launch raises: there is no fallback.

Observability: the role's metrics registry (``resolve_batches``,
``resolve_txns``, backlog and flat-fallback counters; a respawned
resolver continues it), a ``resolver.scan`` span under the proxy's
ambient trace context, and the device profile (utils/deviceprofile.py),
which the cluster owns and hands each incarnation (``adopt_profile``).
Its capture sites are all on the host, around the step's enqueue and
the statuses' read, and add no host sync: each dispatch's padding and
entry occupancy, the bytes of the packed tensors copied to the device,
the enqueue wall (``dispatch_wall_ms``) and the wait for the statuses
(``verdict_reduce_wall_ms``), each capture of a compiled step as a
compile (keyed as the StepCache keys it), the structured fallback
causes, and the step body that served each live batch, by route:

- ``fused_accept``: the full variant with the accept kernel
  (ops/accept.py; the reference's ``pallas_scan``);
- ``ring_hits``: the full variant with the ring kernel (ops/ring.py; the
  reference's ``pallas_ring``, which the reference's backlog scans
  strip and the port's keep);
- ``plain``: the torch step (the fast variant, the lanes, or the full
  variant with both kernels off), whose greedy acceptance on a card is
  ``accept_sweep`` (the reference's ``jit``).

The port has no kernel fallback, so ``pallas_to_jit`` stays 0.
"""

import time

import numpy as np
import torch

from foundationdb_tpu_torch.convert import host_reader
from foundationdb_tpu_torch.core.flatpack import FlatTxnBatch
from foundationdb_tpu_torch.core.options import DEFAULT_KNOBS
from foundationdb_tpu_torch.core.status import COMMITTED, CONFLICT, TOO_OLD
from foundationdb_tpu_torch.core.versions import REBASE_THRESHOLD
from foundationdb_tpu_torch.ops import conflict as ck
from foundationdb_tpu_torch.ops.accept import MAX_TXNS
from foundationdb_tpu_torch.resolver.packing import BatchPacker
from foundationdb_tpu_torch.resolver.skiplist import CpuConflictSet
from foundationdb_tpu_torch.utils import deviceprofile, lockdep
from foundationdb_tpu_torch.utils import metrics as metrics_mod
from foundationdb_tpu_torch.utils import span as span_mod

__all__ = ["COMMITTED", "CONFLICT", "TOO_OLD", "Resolver", "ResolverDown",
           "ResolveHandle", "params_from_knobs", "fast_params_of"]

# pad widths of a backlog dispatch: a backlog pads to the smallest that
# fits; deeper backlogs chunk into scans of the widest. The accept-kernel
# route takes the wider ladder, as in the JAX package, and a legacy
# (TxnRequest) backlog off that route pads to BACKLOG_B at least, as the
# JAX package pads it to one fixed bucket.
BACKLOG_B = 8
PAD_BUCKETS = (2, 4, BACKLOG_B)
PAD_BUCKETS_ACCEPT_KERNEL = (2, 4, 8, 16, 32)
KERNEL_KNOB_VALUES = ("auto", "on", "off")


class ResolverDown(Exception):
    """This resolver process is dead; the proxy fails the batch
    not_committed and the cluster controller recruits a replacement."""


class ResolveHandle:
    """Deferred result of a ``resolve_many`` dispatch.

    CUDA work is enqueued when ``resolve_many`` returns, the statuses'
    copy to pinned host memory included; ``wait()`` makes the one host
    sync (on the event behind that copy) and unpacks per-batch status
    lists, on any thread (the commit pipeline dispatches on its batcher
    thread and waits on its apply thread). Host backends resolve eagerly
    — their handle hands the finished result back."""

    __slots__ = ("_materialize", "_result")

    def __init__(self, materialize=None, result=None):
        self._materialize = materialize
        self._result = result

    def wait(self):
        if self._materialize is not None:
            self._result = self._materialize()
            self._materialize = None
        return self._result


def params_from_knobs(knobs, use_ring_kernel=False, use_accept_kernel=False):
    """The one knobs → ResolverParams mapping."""
    return ck.ResolverParams(
        txns=knobs.batch_txn_capacity,
        point_reads=knobs.point_reads_per_txn,
        point_writes=knobs.point_writes_per_txn,
        range_reads=knobs.range_reads_per_txn,
        range_writes=knobs.range_writes_per_txn,
        key_width=knobs.key_limbs + 1,
        hash_bits=knobs.hash_table_bits,
        ring_capacity=knobs.range_ring_capacity,
        bucket_bits=knobs.coarse_buckets_bits,
        ring_partition_bits=knobs.ring_partition_bits,
        use_ring_kernel=use_ring_kernel,
        use_accept_kernel=use_accept_kernel,
    )


def fast_params_of(params):
    """The point-specialized variant's params: range lanes statically
    off, point writes still recorded into the coarse summary the full
    variant's later range reads consult. Both kernels are stripped: the
    point-only step is a handful of gathers. None when the config has no
    range lanes to specialize away."""
    if not (params.range_reads or params.range_writes):
        return None
    return params._replace(
        range_reads=0, range_writes=0, use_ring_kernel=False,
        use_accept_kernel=False, record_point_coarse=True,
    )


def _device_of(device):
    """cuda:0 by default; a CUDA device without a card raises."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "Resolver: no CUDA device is available; pass device='cpu' to "
            "run the device step on the CPU"
        )
    return dev


def _entry_counts(txns):
    """Live conflict entries of a TxnRequest list, by side."""
    ent = {"pr": 0, "pw": 0, "rr": 0, "rw": 0}
    for t in txns:
        ent["pr"] += len(t.point_reads)
        ent["pw"] += len(t.point_writes)
        ent["rr"] += len(t.range_reads)
        ent["rw"] += len(t.range_writes)
    return ent


def _flat_entry_counts(flats):
    return {"pr": sum(int(f.prc.sum()) for f in flats),
            "pw": sum(int(f.pwc.sum()) for f in flats),
            "rr": sum(int(f.rrc.sum()) for f in flats),
            "rw": sum(int(f.rwc.sum()) for f in flats)}


def _entry_slots(params, B):
    n = B * params.txns
    return {"pr": n * params.point_reads, "pw": n * params.point_writes,
            "rr": n * params.range_reads, "rw": n * params.range_writes}


def _nbytes(batch):
    """Bytes of a packed numpy batch (what is copied to the device)."""
    return sum(int(a.nbytes) for a in batch)


def _kernel_knob(knobs, name, on_cuda):
    value = getattr(knobs, name)
    if value not in KERNEL_KNOB_VALUES:
        raise ValueError(f"{name} must be one of {KERNEL_KNOB_VALUES}, "
                         f"got {value!r}")
    return value == "on" or (value == "auto" and on_cuda)


class Resolver:
    def __init__(self, knobs=DEFAULT_KNOBS, base_version=0, device=None,
                 history=None):
        self._init_role(knobs, knobs.resolver_backend, base_version, history)
        # the device lanes take the flat columnar batches and the native
        # set reads raw keys out of their blobs; the Python host set
        # works on byte ranges
        self.accepts_flat = self.backend in ("cuda", "native")
        if self.backend == "cuda":
            self.device = _device_of(device)
            on_cuda = self.device.type == "cuda"
            use_ring = _kernel_knob(knobs, "ring_kernel", on_cuda)
            use_accept = _kernel_knob(knobs, "accept_kernel", on_cuda)
            # "auto" stays off for shapes the kernels do not take; an
            # explicit "on" leaves them to validate_params
            if knobs.accept_kernel == "auto" and (
                    knobs.ring_partition_bits
                    or knobs.batch_txn_capacity > MAX_TXNS):
                use_accept = False
            if knobs.ring_kernel == "auto" and knobs.ring_partition_bits:
                use_ring = False
            if use_accept:
                use_ring = False  # the accept kernel checks the ring itself
            self.params = params_from_knobs(
                knobs, use_ring_kernel=use_ring, use_accept_kernel=use_accept)
            ck.validate_params(self.params)
            self.packer = BatchPacker(self.params)
            if self._state is None:
                self._state = ck.init_state(self.params, self.device)
            # A second variant with the range lanes statically off serves
            # batches that carry only point ops while no range write has
            # ever entered history. Both share the state: the fast one
            # records the hash table AND the coarse point summary.
            self._fast_packer = None
            self._fast_params = fast_params_of(self.params)
            self._range_history = False
            if self._fast_params is not None:
                self._fast_packer = BatchPacker(self._fast_params)
            self._scan_pad_buckets = (
                PAD_BUCKETS_ACCEPT_KERNEL if use_accept else PAD_BUCKETS)
        elif self.backend == "cpu":
            self.device = None
            self.cset = CpuConflictSet()
            self.cset.window_start = base_version
        elif self.backend == "native":
            from foundationdb_tpu_torch.native import NativeConflictSet

            self.device = None
            self.cset = NativeConflictSet()
            if base_version:
                # windows only move forward; an empty resolve installs it
                self.cset.resolve([], 0, base_version)
        else:
            raise ValueError(f"unknown resolver_backend {self.backend!r}")
        self.adopt_profile(self.profile)  # the packers' staging hooks

    def _init_role(self, knobs, backend, base_version, history):
        self.knobs = knobs
        self.backend = backend
        self.base_version = base_version
        self.alive = True
        # held around each compiled-step dispatch and the hand-over of
        # the history to a replacement (respawn)
        self._mu = lockdep.lock("Resolver._mu")
        self._init_metrics()
        # the device profile; the cluster hands its own (adopt_profile)
        self.profile = deviceprofile.DeviceProfile("resolver")
        # the device history and the compiled steps by (variant, B) —
        # (variant, k, B) on the "range" lanes — and batch signature;
        # ``history`` is a predecessor's pair, zeroed (respawn)
        self._state, self._steps = history or (None, ck.StepCache())
        self._steps.on_capture = self._note_capture
        # cumulative wall seconds of resolve_many's dispatch (the batch
        # copy and the scan call; a host backend's eager resolve): the
        # batcher subtracts it from its stage-A+B timer so host packing
        # and dispatch report as separate stages
        self.dispatch_wall_s = 0.0

    def _init_metrics(self, registry=None):
        """Build the role registry, or continue ``registry`` (a respawn
        hands over its predecessor's, folding this one's in)."""
        if registry is not None and registry is not getattr(
                self, "metrics", None):
            registry.absorb(self.metrics)
        self.metrics = (registry if registry is not None
                        else metrics_mod.MetricsRegistry("resolver"))
        self._m_batches = self.metrics.counter("resolve_batches")
        self._m_txns = self.metrics.counter("resolve_txns")
        self._m_backlogs = self.metrics.counter("backlog_dispatches")
        self._m_backlog_depth = self.metrics.gauge("backlog_depth")
        self._m_flat_fallbacks = self.metrics.counter("flat_fallbacks")
        # the reference's kernel-fallback counter: the port has no
        # fallback, so it stays 0
        self._m_pallas_fallbacks = self.metrics.counter("pallas_fallbacks")
        self._m_respawns = self.metrics.counter("respawns")

    @property
    def counters(self):
        """The registry's counters and the backlog-depth gauge."""
        snap = self.metrics.snapshot()
        return dict(snap["counters"],
                    backlog_depth=snap["gauges"]["backlog_depth"])

    def adopt_profile(self, profile):
        """Record into the cluster's DeviceProfile from now on, folding
        in what this instance recorded, so the device history survives
        respawns, recoveries and resizes."""
        if profile is not self.profile:
            profile.absorb(self.profile)
            self.profile = profile
        for packer in (getattr(self, "packer", None),
                       getattr(self, "_fast_packer", None)):
            if packer is not None:
                packer.profile = profile
        return profile

    def _note_capture(self, key):
        if deviceprofile.enabled():
            self.profile.record_compile(key)

    def _kernel_route(self, use_fast):
        """The step body that serves a dispatch of this variant (the
        profile's route names, see the module docstring)."""
        if not use_fast and self.params.use_accept_kernel:
            return "fused_accept"
        if not use_fast and self.params.use_ring_kernel:
            return "ring_hits"
        return "plain"

    @property
    def wants_point_split(self):
        """Whether single-key conflict ranges should arrive as points:
        the device's point lanes and the native set take them so; the
        Python host set takes a point as the tiny range it is."""
        return self.backend != "cpu"

    @property
    def state(self):
        """The live device history (ResolverState), updated in place."""
        return self._state

    def load_state(self, state):
        """Copy a history (a ResolverState of tensors of this resolver's
        shapes and dtypes, e.g. convert.state_from_numpy of a JAX
        resolver's state) into the live state tensors, in place: the
        compiled steps hold their addresses."""
        for name, dst, src in zip(ck.ResolverState._fields, self._state, state):
            if src.shape != dst.shape or src.dtype != dst.dtype:
                raise ValueError(
                    f"load_state: {name} must be {dst.dtype} "
                    f"{tuple(dst.shape)}, got {src.dtype} {tuple(src.shape)}")
            dst.copy_(src)

    def release(self):
        """Drop the device history and the compiled steps holding it."""
        self._steps = ck.StepCache()
        self._state = None

    def status(self):
        """This role's status payload (``device`` and ``graphs`` are the
        port's own)."""
        self.metrics.gauge("lanes").set(getattr(self, "n_lanes", 1))
        return {
            "alive": self.alive,
            "backend": self.backend,
            "device": str(self.device) if self.device is not None else None,
            "lanes": getattr(self, "n_lanes", 1),
            "metrics": self.metrics.snapshot(),
            "graphs": self._steps.stats(),
        }

    def kill(self):
        """Process death: in-memory conflict history is gone; the
        replacement must fence pre-death read versions."""
        self.alive = False

    def respawn(self, base_version):
        """A replacement of this resolver's own kind, fenced at
        ``base_version``, carrying the counters on. A device resolver
        hands the replacement its history tensors and compiled steps,
        zeroed in place: a fresh history at the addresses the captured
        graphs hold, so the first batch after a recovery replays instead
        of capturing anew (as ``jax.jit`` keeps its compilations across
        instances), and no dead instance keeps a graph pool. This
        instance is left dead and holding neither."""
        new = self._recruit(base_version, self._hand_over())
        new._init_metrics(self.metrics)
        new.adopt_profile(self.profile)
        new._m_respawns.inc()
        return new

    def _recruit(self, base_version, history):
        return type(self)(self.knobs, base_version=base_version,
                          device=self.device, history=history)

    def _hand_over(self):
        """Give up the history and compiled steps, zeroed (the state
        init_state makes) on the stream after any step already enqueued,
        or None for a host set; a dispatch here after this raises
        ResolverDown."""
        if self._state is None:
            return None
        with self._mu:
            self.alive = False
            history = (self._state, self._steps)
            self._state, self._steps = None, ck.StepCache()
        for t in history[0]:
            t.zero_()
        return history

    def _pad_bucket(self, nb):
        """Smallest scan pad width that fits ``nb`` batches."""
        for b in self._scan_pad_buckets:
            if nb <= b:
                return b
        return self._scan_pad_buckets[-1]

    def resolve(self, txns, commit_version, new_window_start):
        """txns: list[TxnRequest] or a FlatTxnBatch, in arrival order →
        list of statuses."""
        if not self.alive:
            raise ResolverDown()
        self._m_batches.inc()
        self._m_txns.inc(len(txns))
        # the host-side scan span under the proxy's ambient context
        ssp = span_mod.from_context("resolver.scan", span_mod.current(),
                                    txns=len(txns))
        try:
            if isinstance(txns, FlatTxnBatch):
                return self._resolve_flat(txns, commit_version,
                                          new_window_start)
            return self._resolve_txns(txns, commit_version, new_window_start)
        finally:
            ssp.finish()

    def _host_resolve(self, n, resolve):
        """A host set's resolve, profiled: slots equal live txns."""
        prof = deviceprofile.enabled()
        pt0 = deviceprofile.now() if prof else 0.0
        out = resolve()
        if prof:
            self.profile.record_dispatch(
                bucket=1, live_batches=1, live_txns=n, txn_slots=n,
                wall_s=deviceprofile.now() - pt0)
        return out

    def _profiled_step(self, use_fast, batch, n, ent=None):
        """One packed batch through the compiled single step, profiled:
        the enqueue's wall and the copied bytes (the dispatch), then the
        route once the step is enqueued. Returns ``read()``."""
        prof = deviceprofile.enabled()
        pt0 = deviceprofile.now() if prof else 0.0
        read = self._run_step(use_fast, batch)
        if prof:
            pp = self._fast_params if use_fast else self.params
            self.profile.record_dispatch(
                bucket=1, live_batches=1, live_txns=n, txn_slots=pp.txns,
                entries_live=ent,
                entry_slots=_entry_slots(pp, 1) if ent else None,
                transfer_bytes=_nbytes(batch),
                wall_s=deviceprofile.now() - pt0)
        self.profile.record_kernel_route(self._kernel_route(use_fast))
        return self._timed_read(read)

    def _timed_read(self, read):
        """``read`` whose wait for the statuses is the profile's verdict
        reduce wall."""
        def timed():
            prof = deviceprofile.enabled()
            rt0 = deviceprofile.now() if prof else 0.0
            arr = read()
            if prof:
                self.profile.record_verdict_reduce(deviceprofile.now() - rt0)
            return arr
        return timed

    def _resolve_txns(self, txns, commit_version, new_window_start):
        if self.backend != "cuda":
            return self._host_resolve(len(txns), lambda: self.cset.resolve(
                txns, commit_version, new_window_start))
        self._maybe_rebase(commit_version)
        # a read version below base_version is too old by construction:
        # reject on the host rather than clamp its uint32 offset to 0
        statuses = [None] * len(txns)
        live = []
        for i, t in enumerate(txns):
            if t.read_version < self.base_version:
                statuses[i] = TOO_OLD
            else:
                live.append((i, t))
        use_fast = self._pick_fast(t for _, t in live)
        packer = self._packer(use_fast)
        reads = []
        for c in range(0, max(len(live), 1), self.params.txns):
            chunk = live[c : c + self.params.txns]
            batch = packer.pack([t for _, t in chunk], self.base_version,
                                commit_version, new_window_start)
            reads.append((chunk, self._profiled_step(use_fast, batch,
                                                     len(chunk))))
        for chunk, read in reads:  # every chunk dispatched before a wait
            for (i, _), s in zip(chunk, read()[: len(chunk)].tolist()):
                statuses[i] = s
        return statuses

    def _resolve_flat(self, flat, commit_version, new_window_start):
        """Resolve one columnar batch: its limb rows are packed straight
        from the blobs into the staging ring. A batch the flat lane
        cannot serve decodes to TxnRequests and takes the legacy route."""
        if self.backend == "native":
            return self._host_resolve(len(flat), lambda: self.cset.resolve_flat(
                flat, commit_version, new_window_start))
        if self.backend == "cpu":
            return self._host_resolve(len(flat), lambda: self.cset.resolve(
                flat.to_txn_requests(), commit_version, new_window_start))
        self._maybe_rebase(commit_version)
        cause = self._flat_fallback_cause(flat)
        if cause is not None:
            # counted again as a batch of its own, as the reference counts
            self._m_flat_fallbacks.inc()
            self.profile.record_fallback(cause)
            return self.resolve(flat.to_txn_requests(), commit_version,
                                new_window_start)
        use_fast = self._pick_fast_flat([flat])
        batch = self._packer(use_fast).pack_flat(
            flat, self.base_version, commit_version, new_window_start)
        read = self._profiled_step(use_fast, batch, len(flat),
                                   ent=_flat_entry_counts([flat]))
        return read()[: len(flat)].tolist()

    def _packer(self, use_fast):
        return self._fast_packer if use_fast else self.packer

    def _make_step(self, use_fast, B):
        """The compiled step of (variant, B) over the live state: one
        batch for B == 1, else a scan of B."""
        params = self._fast_params if use_fast else self.params
        make = ck.make_resolve_fn if B == 1 else ck.make_resolve_scan_fn
        return make(params, self._state)

    def precompile(self):
        """Compile every step this resolver dispatches — each variant's
        single step and a scan of each pad width — before its first
        batch, as a server does at start-up: on a card each is captured
        now, and its first dispatch only replays. The history is
        untouched (a capture's warm-up runs on a scratch copy). Returns
        the keys compiled."""
        if self.backend != "cuda":
            return []
        keys = []
        variants = [False] + ([True] if self._fast_packer is not None else [])
        for use_fast in variants:
            empty = self._packer(use_fast).pack_empty(self.base_version, 0, 0)
            for B in (1, *self._scan_pad_buckets):
                batch = empty if B == 1 else ck.ResolveBatch(
                    *(np.stack([f] * B) for f in empty))
                keys.append(self._prepare(use_fast, B, batch))
        return keys

    def _prepare(self, use_fast, B, batch):
        key = (use_fast, B)
        self._steps.prepare(key, batch, lambda: self._make_step(use_fast, B))
        return key

    def _run_step(self, use_fast, batch):
        """One packed numpy batch through the compiled single step →
        ``read()`` of its statuses int32[T] (copied out at once, so a
        later step does not overwrite them)."""
        return self._replay((use_fast, 1), batch,
                            lambda: self._make_step(use_fast, 1))

    def _replay(self, key, batch, make_step):
        """The compiled step of ``key`` on ``batch`` → ``read()`` of its
        statuses. Raises ResolverDown if this resolver died (or handed
        its history to a replacement) since the caller checked."""
        with self._mu:
            if not self.alive:
                raise ResolverDown()
            return host_reader(self._steps.run(key, batch, make_step))

    def _flat_refused(self, flat):
        """Whether this flat batch must take the legacy lane: a read
        version below the device base (the host answers it), more txns
        or ops than the packed lanes, or another limb width."""
        return bool(len(flat) and int(flat.rv.min()) < self.base_version
                    or not self.packer.flat_fits(flat))

    def _flat_fallback_cause(self, flat):
        """Why a flat batch takes the legacy lane (the profile's
        fallback causes), or None when the flat lane serves it."""
        if len(flat) and int(flat.rv.min()) < self.base_version:
            return "too_old_rv"
        if self.packer.flat_fits(flat):
            return None
        p = self.params
        if (len(flat) > p.txns
                or flat.prc.max(initial=0) > p.point_reads
                or flat.pwc.max(initial=0) > p.point_writes
                or flat.rrc.max(initial=0) > p.range_reads
                or flat.rwc.max(initial=0) > p.range_writes):
            return "over_capacity"
        return "flat_to_legacy"  # another limb width

    def _pick_fast_flat(self, flats):
        """_pick_fast's columnar twin, on count maxima. Lane-overflowing
        batches were routed to the legacy lane before, so only range
        presence matters here."""
        if self._fast_packer is None:
            return False
        point_only = True
        for f in flats:
            if f.rwc.max(initial=0) > 0:
                self._range_history = True
                point_only = False
                break
            if f.rrc.max(initial=0) > 0:
                point_only = False
        return point_only and not self._range_history

    def _pick_fast(self, txns):
        """Whether the point-specialized variant may serve these txns —
        and the sticky _range_history update when a range write (or a
        point-write spill, which the packer records as ring history)
        appears."""
        if self._fast_packer is None:
            return False
        point_only = True
        pr_cap = self.params.point_reads
        pw_cap = self.params.point_writes
        for t in txns:
            if t.range_writes or len(t.point_writes) > pw_cap:
                self._range_history = True
                point_only = False
                break
            if t.range_reads or len(t.point_reads) > pr_cap:
                point_only = False  # needs range lanes this batch
        return point_only and not self._range_history

    def resolve_many(self, batches, lazy=False):
        """Resolve a backlog of batches in one dispatch.

        ``batches``: list of (txns, commit_version, new_window_start) in
        commit order, txns a TxnRequest list or a FlatTxnBatch.
        Semantically identical to :meth:`resolve` per batch.
        ``lazy=True`` returns a :class:`ResolveHandle`; the device work is
        enqueued and the host sync waits for ``wait()``.
        """
        if len(batches) > 1:
            self._m_backlogs.inc()
            self._m_backlog_depth.set(len(batches))
        ssp = span_mod.from_context("resolver.scan", span_mod.current())
        if ssp is not span_mod.NULL:
            # one scan span for the whole backlog; the ambient context
            # is cleared so an eager route's resolve() calls add no
            # nested ones
            ssp.attr(batches=len(batches),
                     txns=sum(len(t) for t, _, _ in batches))
            prior = span_mod.set_current(None)
            try:
                handle = self._dispatch_many(batches)
            finally:
                span_mod.set_current(prior)
                ssp.finish()
            return handle if lazy else handle.wait()
        handle = self._dispatch_many(batches)
        return handle if lazy else handle.wait()

    def _dispatch_many(self, batches):
        if (self.backend != "cuda" or len(batches) <= 1
                or any(len(t) > self.params.txns for t, _, _ in batches)):
            # host backend / degenerate backlogs resolve eagerly
            t0 = time.perf_counter()
            result = [self.resolve(t, cv, ws) for t, cv, ws in batches]
            self.dispatch_wall_s += time.perf_counter() - t0
            return ResolveHandle(result=result)
        widest = self._scan_pad_buckets[-1]
        if len(batches) > widest:
            handles = [self._dispatch_many(batches[i:i + widest])
                       for i in range(0, len(batches), widest)]
            return ResolveHandle(materialize=lambda: [
                statuses for h in handles for statuses in h.wait()])
        if not self.alive:
            raise ResolverDown()
        self._maybe_rebase(batches[-1][1])
        # the scans bypass resolve(): count their volume here
        self._m_batches.inc(len(batches))
        self._m_txns.inc(sum(len(t) for t, _, _ in batches))
        flats_present = any(isinstance(t, FlatTxnBatch) for t, _, _ in batches)
        if flats_present:
            if all(isinstance(t, FlatTxnBatch) for t, _, _ in batches):
                handle = self._dispatch_flat(batches)
                if handle is not None:
                    return handle
                # counted only here, as the reference counts: a mixed
                # backlog is no refusal of the flat lane
                self._m_flat_fallbacks.inc()
                self.profile.record_fallback(next(
                    (c for c in (self._flat_fallback_cause(t)
                                 for t, _, _ in batches) if c),
                    "flat_to_legacy"))
            else:
                self.profile.record_fallback("flat_to_legacy")
            # a flat batch the lane cannot serve, or flat and legacy
            # batches in one backlog (one scan threads one history):
            # the whole backlog decodes, as dispatch work
            t_dec = time.perf_counter()
            batches = [
                (t.to_txn_requests() if isinstance(t, FlatTxnBatch) else t,
                 cv, ws)
                for t, cv, ws in batches
            ]
            self.dispatch_wall_s += time.perf_counter() - t_dec
        per_batch = []
        all_live = []
        for txns, cv, ws in batches:
            statuses = [None] * len(txns)
            live = []
            for i, t in enumerate(txns):
                if t.read_version < self.base_version:
                    statuses[i] = TOO_OLD
                else:
                    live.append((i, t))
            per_batch.append((statuses, live, cv, ws))
            all_live.extend(t for _, t in live)
        use_fast = self._pick_fast(all_live)
        packer = self._packer(use_fast)
        packed = [
            packer.pack([t for _, t in live], self.base_version, cv, ws)
            for statuses, live, cv, ws in per_batch
        ]
        # pads are empty batches at the last batch's versions: they
        # leave the history exactly as the last live batch left it
        B = self._pad_bucket(len(packed))
        if not self.params.use_accept_kernel:
            B = max(BACKLOG_B, B)
        last_cv, last_ws = batches[-1][1], batches[-1][2]
        if len(packed) < B:
            pad = packer.pack_empty(self.base_version, last_cv, last_ws)
            packed.extend([pad] * (B - len(packed)))
        stacked = ck.ResolveBatch(*(np.stack(f) for f in zip(*packed)))
        read = self._scan(use_fast, stacked, len(per_batch), len(all_live),
                          _entry_counts(all_live))

        def materialize():
            arr = read()  # the one host sync for the backlog
            out = []
            for b, (statuses, live, _cv, _ws) in enumerate(per_batch):
                row = arr[b][: len(live)].tolist()
                for (i, _), s in zip(live, row):
                    statuses[i] = s
                out.append(statuses)
            return out

        return ResolveHandle(materialize=materialize)

    def _dispatch_flat(self, batches):
        """The columnar backlog dispatch: the whole group packs into one
        stacked staging set and takes the same scan. None when any batch
        needs the legacy lane."""
        flats = [t for t, _, _ in batches]
        if any(self._flat_refused(f) for f in flats):
            return None
        use_fast = self._pick_fast_flat(flats)
        stacked = self._packer(use_fast).pack_flat_group(
            flats, [(cv, ws) for _, cv, ws in batches], self.base_version,
            B=self._pad_bucket(len(flats)))
        read = self._scan(use_fast, stacked, len(flats),
                          sum(len(f) for f in flats), _flat_entry_counts(flats))

        def materialize():
            arr = read()  # the one host sync for the backlog
            return [arr[b][: len(f)].tolist() for b, f in enumerate(flats)]

        return ResolveHandle(materialize=materialize)

    def _scan(self, use_fast, stacked, n_batches, n_txns, ent):
        """Enqueue a stacked backlog's compiled scan, with no host sync:
        the batch copy and the replay go on the stream, and the statuses
        are copied out behind them (convert.host_reader). Returns
        ``read()``, which gives the statuses [B, T] as numpy on any
        thread: they are this dispatch's own copy, which no later
        dispatch writes, and on a card ``read`` waits only for the event
        recorded behind that copy on the dispatching thread's stream.
        Profiled as one dispatch of ``n_batches`` live batches."""
        prof = deviceprofile.enabled()
        pt0 = deviceprofile.now() if prof else 0.0
        t0 = time.perf_counter()
        read = self._run_scan(use_fast, stacked)
        self.dispatch_wall_s += time.perf_counter() - t0
        self.profile.record_kernel_route(self._kernel_route(use_fast),
                                         n=n_batches)
        if prof:
            B = stacked.rv.shape[0]
            pp = self._fast_params if use_fast else self.params
            self.profile.record_dispatch(
                bucket=B, live_batches=n_batches, live_txns=n_txns,
                txn_slots=B * pp.txns, entries_live=ent,
                entry_slots=_entry_slots(pp, B),
                transfer_bytes=_nbytes(stacked),
                wall_s=deviceprofile.now() - pt0)
        return self._timed_read(read)

    def _run_scan(self, use_fast, stacked):
        """A stacked numpy backlog [B, ...] through the compiled scan of
        (variant, B) → ``read()`` of its statuses [B, T]."""
        B = stacked.rv.shape[0]
        return self._replay((use_fast, B), stacked,
                            lambda: self._make_step(use_fast, B))

    def _maybe_rebase(self, commit_version):
        """Keep uint32 version offsets in range (core/versions.py): shift
        the device state down by the current window start; entries
        clamped to 0 are exactly those no admissible read can conflict
        with anymore."""
        if commit_version - self.base_version < REBASE_THRESHOLD:
            return
        delta = int(self.state.window_start.item())
        if delta == 0:
            raise RuntimeError(
                "version offsets exceed rebase threshold but the MVCC window "
                "never advanced; advance new_window_start to allow rebasing"
            )
        ck.rebase_state(self.state, delta)
        self.base_version += delta

    def window_start(self):
        if self.backend != "cuda":
            return self.cset.window_start
        return self.base_version + int(self.state.window_start.item())
