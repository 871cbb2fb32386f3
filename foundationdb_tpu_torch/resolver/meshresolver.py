"""MeshResolver — a fleet of resolver lanes on one card, behind the
single-resolver API.

Ref parity: multi-resolver deployments key-range-shard conflict
detection across resolver processes, the commit proxy fanning out
sub-batches and AND-ing verdicts (fdbserver/CommitProxyServer.actor.cpp
resolution fan-out, fdbserver/Resolver.actor.cpp). The JAX package runs
the fleet as one ``shard_map`` program over a device mesh; the port runs
it as one step over a leading lane axis of one device's state
(parallel/mesh.py), with the mesh's global state shapes.

The lanes own key ranges: the host routes each packed entry to the
lane(s) owning its keys (resolver/packing.ShardRouter, numpy, before
the copy) and the device runs the compacted per-lane slots
(ops/conflict.resolve_batch_presharded): per-lane work shrinks ~1/n. A
batch whose skew overflows a lane's slots splits into k txn slices that
run as a scan. ``knobs.resolver_sharding`` accepts "range" only.

``Cluster(n_resolvers=k)`` builds one MeshResolver of k lanes; the
commit proxy sees one resolver and drives its single-resolver path,
``resolve_many``'s backlog scan included. Neither ``fused_accept`` nor
the one-ring walk runs here: the JAX package turns its Pallas kernels
off on the mesh. On a card the lanes mark their pairs with
``lane_pairs``, walk their rings with ``ring_hits_lanes`` (ops/lanes.py,
ops/ring.py) and accept with ``sweep_accept``. The steps are compiled
as the single resolver's are, keyed (variant, k, B) by the router's k
txn slices; there is no point-specialized variant.

The device profile records the router's entries per lane at each
split (``lane_entries``, ``lane_skew_pct``), and the split's wall
as the dispatch's ``split`` stage (``router.split`` in a trace); the
reassembly of the lanes' statuses is the ``unpack`` stage. The lanes
are one tensor axis of one step, with no per-lane wall to read, so
nothing records lane walls (``lane_walls_ms`` stays empty).
"""

import numpy as np

from foundationdb_tpu_torch.core.options import DEFAULT_KNOBS
from foundationdb_tpu_torch.ops import conflict as ck
from foundationdb_tpu_torch.parallel.mesh import PreshardedResolverKernel
from foundationdb_tpu_torch.resolver.packing import BatchPacker, ShardRouter
from foundationdb_tpu_torch.resolver.resolver import (
    PAD_BUCKETS,
    Resolver,
    _device_of,
    params_from_knobs,
)
from foundationdb_tpu_torch.utils import deviceprofile


class MeshResolver(Resolver):
    """Resolver facade over the lane kernels of parallel/mesh.py.

    Inherits the host side of Resolver — base-version fencing, chunking
    of over-capacity batches, the flat and legacy lanes, backlog scans
    and the uint32 rebase — and swaps the device steps for the lanes'.
    """

    sharding = "range"  # status()["sharding"]: the lanes own key ranges

    def __init__(self, knobs=DEFAULT_KNOBS, base_version=0, n_lanes=None,
                 device=None, history=None):
        self._init_role(knobs, "cuda", base_version, history)
        self.accepts_flat = True
        self.device = _device_of(device)
        # one lane per requested resolver: the lanes are a tensor axis of
        # one card, so nothing clamps them to a device count
        self.n_lanes = max(1, int(n_lanes or 1))
        # both kernel flags stay off: those kernels take one flat ring,
        # and the lanes walk their rings with a kernel of their own
        self.params = params_from_knobs(knobs)
        self.packer = BatchPacker(self.params)
        # no point-specialized twin: on a card a lane's ring walk culls
        # every ring tile with no live entry newer than its queries before
        # it reads a key, so a point-only batch's ring checks cost a mask
        # read a tile
        self._fast_packer = None
        self._fast_params = None
        self._range_history = False
        # the router's lane balance: entries routed to each lane, and how
        # many batches split into k txn slices, by k
        self.lane_entries = np.zeros(self.n_lanes, np.int64)
        self.split_chunks = {}
        self._kernel = PreshardedResolverKernel(
            self.params, self.n_lanes, self.device,
            make_state=history is None)
        self._router = ShardRouter(self.params, self.n_lanes)
        if history is None:
            self._state = self._kernel.state
            self._kernel.state = None  # the history lives here
        self._scan_pad_buckets = PAD_BUCKETS
        self.adopt_profile(self.profile)  # the packers' staging hooks

    def _split_counted(self, stacked, st):
        """Route a stacked numpy ResolveBatch through the ShardRouter, as
        ``st``'s ``split`` stage, counting the entries each lane took and
        the chunk factor."""
        st.to("split")
        sb, k, lane_counts = self._router.split(stacked)
        self.lane_entries += lane_counts
        if deviceprofile.enabled():
            self.profile.record_lane_counts(lane_counts.tolist())
        self.split_chunks[k] = self.split_chunks.get(k, 0) + 1
        return sb, k

    def _make_step(self, use_fast, B):
        return self._kernel.static_step(self._state, B)

    def _run_step(self, use_fast, batch, st):
        read = self._run_scan(use_fast, ck.ResolveBatch(
            *(np.asarray(a)[None] for a in batch)), st)
        return lambda stages: read(stages)[0]

    def _prepare(self, use_fast, B, batch):
        stacked = batch if B > 1 else ck.ResolveBatch(
            *(np.asarray(a)[None] for a in batch))
        sb, k, _ = self._router.split(stacked)
        key = (use_fast, k, B)
        self._steps.prepare(key, sb, lambda: self._make_step(use_fast, B))
        return key

    def _run_scan(self, use_fast, stacked, st):
        # the router stacks B·k txn slices: k > 1 when a skew overflows a
        # lane's slots, each k its own compiled scan
        sb, k = self._split_counted(stacked, st)
        B = stacked.rv.shape[0]
        read = self._replay((use_fast, k, B), sb,
                            lambda: self._make_step(use_fast, B), st)
        return lambda stages: self._router.reassemble(read(stages), k)

    def status(self):
        doc = super().status()
        doc["sharding"] = self.sharding
        return doc

    def _recruit(self, base_version, history):
        """Recruitment: a fleet of the same lanes on the same device."""
        return MeshResolver(self.knobs, base_version=base_version,
                            n_lanes=self.n_lanes, device=self.device,
                            history=history)
