"""The resolver fleet on one card: n resolver lanes as a tensor axis.

FDB scales conflict detection by key-range-sharding resolvers across
processes, the commit proxy fanning out and AND-ing verdicts (ref:
fdbserver/CommitProxyServer.actor.cpp resolution fan-out). The JAX
package keeps the fleet inside one ``shard_map`` program over a device
mesh, one lane a device, verdicts combined by ``psum``/``pmax``. On one
H100 the lanes become the leading axis of one state
(ops/conflict.py): the global shapes stay the mesh's, so a JAX mesh
state carries over array for array (convert.state_from_numpy), and each
collective is a reduction over the lane axis.
"""

from foundationdb_tpu_torch.ops import conflict as ck

# ShardBatch fields that stay replicated across lanes (everything else
# is a per-lane compacted slot array on its leading axis)
_SHARD_REPLICATED = {"rv", "txn_mask", "cv", "new_window_start"}


def lane_view(sb, n):
    """A ShardBatch (one batch, slot arrays of n*Q entries) with each
    per-lane field viewed [n, Q, ...]; replicated fields as they are."""
    return ck.ShardBatch(*(
        f if name in _SHARD_REPLICATED
        else f.view(n, f.shape[0] // n, *f.shape[1:])
        for name, f in zip(ck.ShardBatch._fields, sb)))


class PreshardedResolverKernel:
    """The lane fleet, sharded by key range: the host router
    (resolver/packing.ShardRouter) sends each entry only to the lane(s)
    owning its keys, so a lane's ring scan and pairwise matrix shrink
    ~1/n while history capacity scales n-fold, hash table 2^HB * n and
    ring KR * n (ops/conflict.resolve_batch_presharded;
    ``ring_capacity`` is a lane's)."""

    def __init__(self, params: ck.ResolverParams, n_lanes, device="cpu",
                 make_state=True):
        ck.validate_presharded_params(params)
        self.params = params
        self.n = int(n_lanes)
        self.device = device
        self._scan_step = ck.scan_of(self._step)
        # make_state=False: the caller brings a history of its own (a
        # respawned resolver's)
        self.state = self.init_state() if make_state else None

    def _step(self, state, sb):
        return ck.resolve_batch_presharded(state, lane_view(sb, self.n),
                                           self.params)

    def static_step(self, state, B):
        """The compiled step over ``state`` (ops/conflict.StaticStep): the
        router's ShardBatch always stacks B·k txn slices, so a scan over
        them whatever B."""
        return ck.StaticStep(lambda s, sb: self._scan_step(s, sb)[1], state,
                             ck.ShardBatch)

    def init_state(self):
        """A fresh history at the mesh's global shapes."""
        return ck.init_state(self.params, self.device, n_lanes=self.n)
