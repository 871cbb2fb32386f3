"""The Resolver role — batched MVCC conflict detection behind a backend knob.

Ref parity: fdbserver/Resolver.actor.cpp (resolveBatch). The commit proxy
hands a batch of transactions in arrival order; the resolver returns
per-txn statuses and remembers accepted writes for the MVCC window.

``resolver_backend="cuda"`` packs each batch into fixed-shape arrays,
moves them to the device, and runs ops/conflict.py's step there; the
history lives on the device and is updated in place, so only the batch
goes in and T statuses come out. The device is ``cuda:0`` unless the
caller passes ``device="cpu"`` (the tests do); without a card and
without that, construction raises. ``"cpu"`` runs the exact host
ConflictSet (resolver/skiplist.py).

A kernel that fails to build or launch raises: there is no fallback.
"""

import numpy as np
import torch

from foundationdb_tpu_torch.convert import batch_from_numpy
from foundationdb_tpu_torch.core.options import DEFAULT_KNOBS
from foundationdb_tpu_torch.core.status import COMMITTED, CONFLICT, TOO_OLD
from foundationdb_tpu_torch.core.versions import REBASE_THRESHOLD
from foundationdb_tpu_torch.ops import conflict as ck
from foundationdb_tpu_torch.ops.accept import MAX_TXNS
from foundationdb_tpu_torch.resolver.packing import BatchPacker
from foundationdb_tpu_torch.resolver.skiplist import CpuConflictSet

__all__ = ["COMMITTED", "CONFLICT", "TOO_OLD", "Resolver", "ResolverDown",
           "ResolveHandle", "params_from_knobs", "fast_params_of"]

# pad widths of a backlog dispatch: a backlog pads to the smallest that
# fits; deeper backlogs chunk into scans of the widest. The accept-kernel
# route takes the wider ladder, as in the JAX package.
PAD_BUCKETS = (2, 4, 8)
PAD_BUCKETS_ACCEPT_KERNEL = (2, 4, 8, 16, 32)
KERNEL_KNOB_VALUES = ("auto", "on", "off")


class ResolverDown(Exception):
    """This resolver process is dead; the proxy fails the batch
    not_committed and the cluster controller recruits a replacement."""


class ResolveHandle:
    """Deferred result of a ``resolve_many`` dispatch.

    CUDA work is enqueued when ``resolve_many`` returns; ``wait()`` makes
    the one host sync (the copy of the statuses) and unpacks per-batch
    status lists. Host backends resolve eagerly — their handle hands the
    finished result back."""

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


def _kernel_knob(knobs, name, on_cuda):
    value = getattr(knobs, name)
    if value not in KERNEL_KNOB_VALUES:
        raise ValueError(f"{name} must be one of {KERNEL_KNOB_VALUES}, "
                         f"got {value!r}")
    return value == "on" or (value == "auto" and on_cuda)


class Resolver:
    def __init__(self, knobs=DEFAULT_KNOBS, base_version=0, device=None):
        self.knobs = knobs
        self.backend = knobs.resolver_backend
        self.base_version = base_version
        self.alive = True
        self.counters = {"resolve_batches": 0, "resolve_txns": 0,
                         "backlog_dispatches": 0, "backlog_depth": 0,
                         "respawns": 0}
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
            self._resolve = ck.make_resolve_fn(self.params)
            self.packer = BatchPacker(self.params)
            self.state = ck.init_state(self.params, self.device)
            # A second variant with the range lanes statically off serves
            # batches that carry only point ops while no range write has
            # ever entered history. Both share the state: the fast one
            # records the hash table AND the coarse point summary.
            self._fast = None
            self._fast_params = fast_params_of(self.params)
            self._range_history = False
            if self._fast_params is not None:
                self._fast = (BatchPacker(self._fast_params),
                              ck.make_resolve_fn(self._fast_params))
            self._scan_fns = {}
            self._scan_pad_buckets = (
                PAD_BUCKETS_ACCEPT_KERNEL if use_accept else PAD_BUCKETS)
        elif self.backend == "cpu":
            self.device = None
            self.cset = CpuConflictSet()
            self.cset.window_start = base_version
        else:
            raise ValueError(f"unknown resolver_backend {self.backend!r}")

    def status(self):
        """This role's status payload."""
        return {
            "alive": self.alive,
            "backend": self.backend,
            "device": str(self.device) if self.device is not None else None,
            "lanes": 1,
            "metrics": dict(self.counters),
        }

    def kill(self):
        """Process death: in-memory conflict history is gone; the
        replacement must fence pre-death read versions."""
        self.alive = False

    def respawn(self, base_version):
        """A replacement of this resolver's own kind, fenced at
        ``base_version``, carrying the counters on."""
        new = type(self)(self.knobs, base_version=base_version,
                         device=self.device)
        new.counters = dict(self.counters)
        new.counters["respawns"] += 1
        return new

    def _pad_bucket(self, nb):
        """Smallest scan pad width that fits ``nb`` batches."""
        for b in self._scan_pad_buckets:
            if nb <= b:
                return b
        return self._scan_pad_buckets[-1]

    def _count(self, nbatches, ntxns):
        self.counters["resolve_batches"] += nbatches
        self.counters["resolve_txns"] += ntxns

    def resolve(self, txns, commit_version, new_window_start):
        """txns: list[TxnRequest] in arrival order → list of statuses."""
        if not self.alive:
            raise ResolverDown()
        self._count(1, len(txns))
        if self.backend == "cpu":
            return self.cset.resolve(txns, commit_version, new_window_start)
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
        packer, resolve_fn = self._fast if use_fast else (
            self.packer, self._resolve)
        for c in range(0, max(len(live), 1), self.params.txns):
            chunk = live[c : c + self.params.txns]
            batch = packer.pack([t for _, t in chunk], self.base_version,
                                commit_version, new_window_start)
            status, _accepted, self.state = resolve_fn(
                self.state, batch_from_numpy(batch, self.device))
            out = status[: len(chunk)].tolist()
            for (i, _), s in zip(chunk, out):
                statuses[i] = s
        return statuses

    def _pick_fast(self, txns):
        """Whether the point-specialized variant may serve these txns —
        and the sticky _range_history update when a range write (or a
        point-write spill, which the packer records as ring history)
        appears."""
        if self._fast is None:
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
        commit order. Semantically identical to :meth:`resolve` per
        batch. ``lazy=True`` returns a :class:`ResolveHandle`; the device
        work is enqueued and the host sync waits for ``wait()``.
        """
        if len(batches) > 1:
            self.counters["backlog_dispatches"] += 1
            self.counters["backlog_depth"] = len(batches)
        handle = self._dispatch_many(batches)
        return handle if lazy else handle.wait()

    def _dispatch_many(self, batches):
        if (self.backend != "cuda" or len(batches) <= 1
                or any(len(t) > self.params.txns for t, _, _ in batches)):
            # host backend / degenerate backlogs resolve eagerly
            return ResolveHandle(result=[
                self.resolve(t, cv, ws) for t, cv, ws in batches])
        widest = self._scan_pad_buckets[-1]
        if len(batches) > widest:
            handles = [self._dispatch_many(batches[i:i + widest])
                       for i in range(0, len(batches), widest)]
            return ResolveHandle(materialize=lambda: [
                statuses for h in handles for statuses in h.wait()])
        if not self.alive:
            raise ResolverDown()
        self._maybe_rebase(batches[-1][1])
        self._count(len(batches), sum(len(t) for t, _, _ in batches))
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
        packer = self._fast[0] if use_fast else self.packer
        packed = [
            packer.pack([t for _, t in live], self.base_version, cv, ws)
            for statuses, live, cv, ws in per_batch
        ]
        # pads are empty batches at the last batch's versions: they
        # leave the history exactly as the last live batch left it
        B = self._pad_bucket(len(packed))
        last_cv, last_ws = batches[-1][1], batches[-1][2]
        if len(packed) < B:
            pad = packer.pack_empty(self.base_version, last_cv, last_ws)
            packed.extend([pad] * (B - len(packed)))
        stacked = ck.ResolveBatch(*(np.stack(f) for f in zip(*packed)))
        self.state, st = self._get_scan_fn(use_fast)(
            self.state, batch_from_numpy(stacked, self.device))

        def materialize():
            arr = st.cpu().numpy()  # the one host sync for the backlog
            out = []
            for b, (statuses, live, _cv, _ws) in enumerate(per_batch):
                row = arr[b][: len(live)].tolist()
                for (i, _), s in zip(live, row):
                    statuses[i] = s
                out.append(statuses)
            return out

        return ResolveHandle(materialize=materialize)

    def _get_scan_fn(self, use_fast):
        scan_fn = self._scan_fns.get(use_fast)
        if scan_fn is None:
            params = self._fast_params if use_fast else self.params
            scan_fn = self._scan_fns[use_fast] = ck.make_resolve_scan_fn(params)
        return scan_fn

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
        if self.backend == "cpu":
            return self.cset.window_start
        return self.base_version + int(self.state.window_start.item())
