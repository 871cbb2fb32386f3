"""MeshResolver — a fleet of resolver lanes on one card, behind the
single-resolver API.

Ref parity: multi-resolver deployments key-range-shard conflict
detection across resolver processes, the commit proxy fanning out
sub-batches and AND-ing verdicts (fdbserver/CommitProxyServer.actor.cpp
resolution fan-out, fdbserver/Resolver.actor.cpp). The JAX package runs
the fleet as one ``shard_map`` program over a device mesh; the port runs
it as one step over a leading lane axis of one device's state
(parallel/mesh.py), with the mesh's global state shapes.

Two lane-ownership schemes, chosen by ``knobs.resolver_sharding``:

- ``"range"`` (the default): the host routes each packed entry to the
  lane(s) owning its key range (resolver/packing.ShardRouter, numpy, before
  the copy) and the device runs the compacted per-lane slots
  (ops/conflict.resolve_batch_presharded): per-lane work shrinks ~1/n.
  A batch whose skew overflows a lane's slots splits into k txn slices
  that run as a scan.
- ``"hash"``: the batch goes to every lane and each lane carves its
  ownership in the step (hash-sharded point table, bucket-sharded ring).
  No routing pass, no per-lane work reduction; a point-specialized twin
  serves point-only batches, as in the single resolver.

``Cluster(n_resolvers=k)`` builds one MeshResolver of k lanes; the
commit proxy sees one resolver and drives its single-resolver path,
``resolve_many``'s backlog scan included. Neither ported TPU kernel
runs here: the JAX package turns its Pallas kernels off on the mesh, so
the lanes run the plain torch step, with greedy acceptance by
``sweep_accept`` on a card. The steps are compiled as the single
resolver's are (keys (variant, B), and (variant, k, B) for the "range"
router's k txn slices).

The device profile records the "range" router's entries per lane at
each split (``lane_entries``, ``lane_skew_pct``). The reference's "hash"
mode times each lane's shard apart; here the lanes are one tensor
axis of one step, with no per-lane wall to read, so that mode records
none.
"""

import numpy as np

from foundationdb_tpu_torch.core.options import DEFAULT_KNOBS
from foundationdb_tpu_torch.ops import conflict as ck
from foundationdb_tpu_torch.parallel.mesh import (
    PreshardedResolverKernel,
    ShardedResolverKernel,
)
from foundationdb_tpu_torch.resolver.packing import BatchPacker, ShardRouter
from foundationdb_tpu_torch.resolver.resolver import (
    PAD_BUCKETS,
    Resolver,
    _device_of,
    fast_params_of,
    params_from_knobs,
)
from foundationdb_tpu_torch.utils import deviceprofile

SHARDING_MODES = ("range", "hash")


class MeshResolver(Resolver):
    """Resolver facade over the lane kernels of parallel/mesh.py.

    Inherits the host side of Resolver — base-version fencing, chunking
    of over-capacity batches, the flat and legacy lanes, backlog scans
    and the uint32 rebase — and swaps the device steps for the lanes'.
    """

    def __init__(self, knobs=DEFAULT_KNOBS, base_version=0, n_lanes=None,
                 device=None, history=None):
        self._init_role(knobs, "cuda", base_version, history)
        self.accepts_flat = True
        self.device = _device_of(device)
        # one lane per requested resolver: the lanes are a tensor axis of
        # one card, so nothing clamps them to a device count
        self.n_lanes = max(1, int(n_lanes or 1))
        # both kernels stay off and the ring flat: the lanes shard the
        # ring by bucket already, and the kernels take one flat ring
        self.params = params_from_knobs(knobs)._replace(ring_partition_bits=0)
        self.packer = BatchPacker(self.params)
        self.sharding = knobs.resolver_sharding
        if self.sharding not in SHARDING_MODES:
            raise ValueError(f"resolver_sharding must be one of "
                             f"{SHARDING_MODES}, got {self.sharding!r}")
        self._fast_packer = None
        self._fast_params = None
        self._range_history = False
        # the router's lane balance: entries routed to each lane, and how
        # many batches split into k txn slices, by k
        self.lane_entries = np.zeros(self.n_lanes, np.int64)
        self.split_chunks = {}
        if self.sharding == "range":
            self._kernel = PreshardedResolverKernel(
                self.params, self.n_lanes, self.device,
                make_state=history is None)
            self._router = ShardRouter(self.params, self.n_lanes)
            # no point-specialized twin: the compacted layout skips dead
            # sides per entry already
        else:
            self._kernel = ShardedResolverKernel(
                self.params, self.n_lanes, self.device,
                make_state=history is None)
            self._router = None
            self._fast_params = fast_params_of(self.params)
            if self._fast_params is not None:
                # the same state, range lanes statically off
                self._fast_kernel = ShardedResolverKernel(
                    self._fast_params, self.n_lanes, self.device,
                    make_state=False)
                self._fast_packer = BatchPacker(self._fast_params)
        if history is None:
            self._state = self._kernel.state
            self._kernel.state = None  # the history lives here
        self._scan_pad_buckets = PAD_BUCKETS
        self.adopt_profile(self.profile)  # the packers' staging hooks

    def _split_counted(self, stacked):
        """Route a stacked numpy ResolveBatch through the ShardRouter,
        counting the entries each lane took and the chunk factor."""
        sb, k, lane_counts = self._router.split(stacked)
        self.lane_entries += lane_counts
        if deviceprofile.enabled():
            self.profile.record_lane_counts(lane_counts.tolist())
        self.split_chunks[k] = self.split_chunks.get(k, 0) + 1
        return sb, k

    def _make_step(self, use_fast, B):
        kernel = self._fast_kernel if use_fast else self._kernel
        return kernel.static_step(self._state, B)

    def _run_step(self, use_fast, batch):
        if self._router is None:
            return super()._run_step(use_fast, batch)
        read = self._run_scan(use_fast, ck.ResolveBatch(
            *(np.asarray(a)[None] for a in batch)))
        return lambda: read()[0]

    def _prepare(self, use_fast, B, batch):
        if self._router is None:
            return super()._prepare(use_fast, B, batch)
        stacked = batch if B > 1 else ck.ResolveBatch(
            *(np.asarray(a)[None] for a in batch))
        sb, k, _ = self._router.split(stacked)
        key = (use_fast, k, B)
        self._steps.prepare(key, sb, lambda: self._make_step(use_fast, B))
        return key

    def _run_scan(self, use_fast, stacked):
        if self._router is None:
            return super()._run_scan(use_fast, stacked)
        # the router stacks B·k txn slices: k > 1 when a skew overflows a
        # lane's slots, each k its own compiled scan
        sb, k = self._split_counted(stacked)
        B = stacked.rv.shape[0]
        read = self._replay((use_fast, k, B), sb,
                            lambda: self._make_step(use_fast, B))
        return lambda: self._router.reassemble(read(), k)

    def status(self):
        doc = super().status()
        doc["sharding"] = self.sharding
        return doc

    def _recruit(self, base_version, history):
        """Recruitment: a fleet of the same lanes on the same device."""
        return MeshResolver(self.knobs, base_version=base_version,
                            n_lanes=self.n_lanes, device=self.device,
                            history=history)
