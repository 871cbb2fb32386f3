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


class ShardedResolverKernel:
    """The "hash" fleet: the batch goes to every lane and each lane
    carves its ownership inside the step (ops/conflict.resolve_batch with
    ``n_lanes``). History capacity scales with the lanes (hash table
    2^HB * n, ring KR * n); per-lane work does not shrink."""

    def __init__(self, params: ck.ResolverParams, n_lanes, device="cpu",
                 make_state=True):
        self._validate(params)
        self.params = params
        self.n = int(n_lanes)
        self.device = device
        self._scan_step = ck.scan_of(self._step)
        # make_state=False: a twin sharing another kernel's state (the
        # point-specialized variant) builds none
        self.state = self.init_state() if make_state else None

    @staticmethod
    def _validate(params):
        ck.validate_params(params)

    def _step(self, state, batch):
        return ck.resolve_batch(state, batch, self.params, n_lanes=self.n)

    def static_step(self, state, B):
        """The compiled step over ``state`` (ops/conflict.StaticStep): one
        ResolveBatch for B == 1, else a scan of a stack of B."""
        if B == 1:
            fn = lambda s, b: self._step(s, b)[0]  # noqa: E731
        else:
            fn = lambda s, b: self._scan_step(s, b)[1]  # noqa: E731
        return ck.StaticStep(fn, state, ck.ResolveBatch)

    def init_state(self):
        """A fresh history at the mesh's global shapes."""
        return ck.init_state(self.params, self.device, n_lanes=self.n)


class PreshardedResolverKernel(ShardedResolverKernel):
    """The "range" fleet: the host router (resolver/packing.ShardRouter)
    sends each entry only to the lane(s) owning its keys, so a lane's
    ring scan and pairwise matrix shrink ~1/n while history capacity
    still scales n-fold (ops/conflict.resolve_batch_presharded). The
    state layout is the "hash" fleet's; ``ring_capacity`` is a lane's."""

    @staticmethod
    def _validate(params):
        ck.validate_presharded_params(params)

    def _step(self, state, sb):
        return ck.resolve_batch_presharded(state, lane_view(sb, self.n),
                                           self.params)

    def static_step(self, state, B):
        """The compiled step over ``state``: the router's ShardBatch
        always stacks B·k txn slices, so a scan over them whatever B."""
        return ck.StaticStep(lambda s, sb: self._scan_step(s, sb)[1], state,
                             ck.ShardBatch)
