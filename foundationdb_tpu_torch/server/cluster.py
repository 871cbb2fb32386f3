"""In-process cluster: wires the sequencer, GRV and commit proxies, the
resolver, the log and storage into a database.

Ref parity: the role wiring that ClusterController and Master recovery
perform (fdbserver/ClusterController.actor.cpp, masterserver.actor.cpp),
every role in one process as in the reference's simulation. The resolver
runs its conflict step on ``cuda:0`` unless the caller passes
``device="cpu"``; without a card and without that, construction raises.

The port's cluster has one resolver, one storage server and one log,
commits synchronously (each client commit is a batch of one;
``commit_batch`` / ``commit_batches`` take batches) and counts versions.
Recovery, replication, data distribution and the batching pipeline are
not ported yet.
"""

import dataclasses

from foundationdb_tpu_torch.core.options import DEFAULT_KNOBS
from foundationdb_tpu_torch.resolver.resolver import Resolver
from foundationdb_tpu_torch.server.grv import GrvProxy
from foundationdb_tpu_torch.server.proxy import CommitProxy
from foundationdb_tpu_torch.server.sequencer import Sequencer
from foundationdb_tpu_torch.server.storage import StorageServer
from foundationdb_tpu_torch.server.tlog import TLog


class Cluster:
    def __init__(self, knobs=None, device=None, **knob_overrides):
        # an argument the port does not take (a role count, a pipeline)
        # is an unknown Knobs field: replace raises TypeError
        knobs = dataclasses.replace(knobs or DEFAULT_KNOBS, **knob_overrides)
        self.knobs = knobs
        # the resolver first: it owns the device and raises without a card
        self.resolvers = [Resolver(knobs, base_version=0, device=device)]
        self.device = self.resolvers[0].device
        self.storages = [StorageServer(
            window_versions=knobs.max_read_transaction_life_versions)]
        self.tlog = TLog()
        self.sequencer = Sequencer(start_version=0)
        self.commit_proxy = CommitProxy(self.sequencer, self.resolvers[0],
                                        self.tlog, self.storages[0], knobs)
        self.grv_proxy = GrvProxy(self.sequencer)

    @property
    def storage(self):
        return self.storages[0]

    def read_storage(self, key=b""):
        """The storage that serves reads of ``key``: the one replica."""
        return self.storages[0]

    def database(self):
        from foundationdb_tpu_torch.txn.database import Database

        return Database(self)

    def status(self):
        """A reduced status document: availability, the committed-txn
        counter, and each role's status."""
        cp = self.commit_proxy
        resolver = self.resolvers[0]
        return {"cluster": {
            "database_available": all(
                (self.sequencer.alive, cp.alive, self.tlog.alive,
                 resolver.alive, self.storage.alive)),
            "workload": {"transactions": {
                "committed": {"counter": cp.commit_count},
                "conflicted": {"counter": cp.conflict_count}}},
            "processes": {
                "commit_proxy": cp.status(),
                "grv_proxy": self.grv_proxy.status(),
                "resolver": resolver.status(),
                "log": self.tlog.status(),
                "storage": self.storage.status(),
            },
        }}

    def close(self):
        """Release the resolver's device history; later commits answer
        1020 (the resolver is down)."""
        for r in self.resolvers:
            r.kill()
            r.state = None
