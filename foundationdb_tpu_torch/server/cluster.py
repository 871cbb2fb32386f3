"""In-process cluster: wires the sequencer, GRV and commit proxies, the
resolver, the log and storage into a database.

Ref parity: the role wiring that ClusterController and Master recovery
perform (fdbserver/ClusterController.actor.cpp, masterserver.actor.cpp),
every role in one process as in the reference's simulation. The resolver
runs its conflict step on ``cuda:0`` unless the caller passes
``device="cpu"``; without a card and without that, construction raises.

``commit_pipeline`` picks the commit front end: ``"sync"`` (each client
commit is a batch of one; ``commit_batch`` / ``commit_batches`` take
batches), ``"thread"`` (a batcher thread forms shared-version batches
from concurrent clients and pipelines their resolves on the device,
server/batcher.py; GRVs batch too) or ``"manual"`` (the caller pumps the
batcher). ``n_commit_proxies > 1`` builds a fleet ordered by version
gates (server/fleet.py).

``n_resolvers=k > 1`` with the ``"cuda"`` backend builds ONE
MeshResolver of k lanes on the device (resolver/meshresolver.py,
``resolver_sharding`` "range" or "hash"), which the proxy drives through
its single-resolver path; with the ``"cpu"`` backend it builds k exact
host sets, each owning a byte range of keys, behind the proxy's clipped
fan-out. A dead resolver is replaced by ``recruit_resolvers``, fenced at
the committed version, as the reference's recovery does.

The port's cluster has one storage server and one log and counts
versions. Recovery of the other roles, replication and data
distribution are not ported yet.
"""

import dataclasses

from foundationdb_tpu_torch.core.options import DEFAULT_KNOBS
from foundationdb_tpu_torch.resolver.meshresolver import MeshResolver
from foundationdb_tpu_torch.resolver.resolver import Resolver
from foundationdb_tpu_torch.server.grv import BatchingGrvProxy, GrvProxy
from foundationdb_tpu_torch.server.proxy import CommitProxy, VersionGate
from foundationdb_tpu_torch.server.sequencer import Sequencer
from foundationdb_tpu_torch.server.storage import StorageServer
from foundationdb_tpu_torch.server.tlog import TLog

COMMIT_PIPELINES = ("sync", "thread", "manual")


class Cluster:
    def __init__(self, knobs=None, device=None, commit_pipeline="sync",
                 commit_batch_max=None, commit_flush_after=4,
                 n_commit_proxies=1, n_resolvers=1, **knob_overrides):
        if commit_pipeline not in COMMIT_PIPELINES:
            raise ValueError(f"commit_pipeline must be one of "
                             f"{COMMIT_PIPELINES}, got {commit_pipeline!r}")
        if n_commit_proxies < 1:
            raise ValueError(f"n_commit_proxies must be >= 1, got "
                             f"{n_commit_proxies}")
        if n_resolvers < 1:
            raise ValueError(f"n_resolvers must be >= 1, got {n_resolvers}")
        # an argument the port does not take (a log count, a path) is
        # an unknown Knobs field: replace raises TypeError
        knobs = dataclasses.replace(knobs or DEFAULT_KNOBS, **knob_overrides)
        self.knobs = knobs
        self.commit_pipeline = commit_pipeline
        self._commit_batch_max = commit_batch_max
        self._commit_flush_after = commit_flush_after
        self.n_commit_proxies = n_commit_proxies
        # the resolvers first: they own the device and raise without a card
        if knobs.resolver_backend == "cuda" and n_resolvers > 1:
            self.resolvers = [MeshResolver(knobs, base_version=0,
                                           n_lanes=n_resolvers, device=device)]
        else:
            self.resolvers = [Resolver(knobs, base_version=0, device=device)
                              for _ in range(n_resolvers)]
        self.device = self.resolvers[0].device
        self.storages = [StorageServer(
            window_versions=knobs.max_read_transaction_life_versions)]
        self.tlog = TLog()
        self.sequencer = Sequencer(start_version=0)
        self.commit_proxy, self.grv_proxy = self._build_txn_frontend()

    def _make_commit_proxy(self, resolve_gate=None, log_gate=None):
        return CommitProxy(self.sequencer, self.resolvers, self.tlog,
                           self.storages[0], self.knobs,
                           resolve_gate=resolve_gate, log_gate=log_gate)

    def _build_txn_frontend(self):
        """One commit proxy and GRV proxy, or a fleet of
        ``n_commit_proxies`` of each with chained versions and one shared
        pair of version gates starting at the committed version."""
        if self.n_commit_proxies <= 1:
            return self._wire_pipeline(self._make_commit_proxy())
        from foundationdb_tpu_torch.server.fleet import GrvFleet, ProxyFleet

        start = self.sequencer.committed_version
        t = self.knobs.gate_timeout_s
        resolve_gate = VersionGate(start, timeout=t)
        log_gate = VersionGate(start, timeout=t)
        inners, members, grvs = [], [], []
        for _ in range(self.n_commit_proxies):
            inner = self._make_commit_proxy(resolve_gate, log_gate)
            wrapped, grv = self._wire_pipeline(inner)
            inners.append(inner)
            members.append(wrapped)
            grvs.append(grv)
        return ProxyFleet(members, inners), GrvFleet(grvs)

    def _wire_pipeline(self, inner):
        """Wrap a bare CommitProxy and a fresh GrvProxy in the configured
        pipeline: "thread" batches GRVs too (ref: GrvProxyServer's
        transaction-start batching)."""
        proxy = inner
        if self.commit_pipeline != "sync":
            from foundationdb_tpu_torch.server.batcher import (
                BatchingCommitProxy,
            )

            proxy = BatchingCommitProxy(
                inner, max_batch=self._commit_batch_max,
                flush_after=self._commit_flush_after,
                mode=self.commit_pipeline)
        grv = GrvProxy(self.sequencer)
        if self.commit_pipeline == "thread":
            grv = BatchingGrvProxy(grv,
                                   interval_s=self.knobs.grv_batch_interval_s)
        return proxy, grv

    def _commit_target(self):
        """The proxy that runs commit_batch (the batching wrapper
        unwrapped; a fleet is its own target)."""
        return getattr(self.commit_proxy, "inner", self.commit_proxy)

    def _inner_proxies(self):
        cp = self.commit_proxy
        if hasattr(cp, "inners"):
            return list(cp.inners)
        return [getattr(cp, "inner", cp)]

    @property
    def storage(self):
        return self.storages[0]

    def recruit_resolvers(self):
        """Replace every dead resolver with a fresh one of its own kind (a
        lane fleet recruits a lane fleet), fenced at the committed
        version: the replacement's history is empty, so every read
        version from before it answers TOO_OLD and retries with fresh
        reads (ref: a resolver failure forcing a recovery that fences the
        old epoch). Returns the indices replaced."""
        out = []
        for i, r in enumerate(self.resolvers):
            if not r.alive:
                self.resolvers[i] = r.respawn(self.sequencer.committed_version)
                out.append(i)
        return out

    def read_storage(self, key=b""):
        """The storage that serves reads of ``key``: the one replica."""
        return self.storages[0]

    def database(self):
        from foundationdb_tpu_torch.txn.database import Database

        return Database(self)

    def status(self):
        """A reduced status document: availability, the committed-txn
        counter, the commit pipeline and each role's status."""
        cp = self.commit_proxy
        inners = self._inner_proxies()
        return {"cluster": {
            "database_available": all(
                (self.sequencer.alive, self._commit_target().alive,
                 self.tlog.alive, self.storage.alive,
                 *(r.alive for r in self.resolvers))),
            # lanes, not host objects: a 3-lane fleet counts 3
            "resolvers": sum(getattr(r, "n_lanes", 1) for r in self.resolvers),
            "workload": {"transactions": {
                "committed": {"counter": cp.commit_count},
                "conflicted": {"counter": cp.conflict_count}}},
            "commit_pipeline": self.commit_pipeline,
            "processes": {
                "commit_proxy": dict(inners[0].status(),
                                     count=self.n_commit_proxies,
                                     members=[p.status() for p in inners]),
                "grv_proxy": self.grv_proxy.status(),
                "resolvers": [r.status() for r in self.resolvers],
                "log": self.tlog.status(),
                "storage": self.storage.status(),
            },
        }}

    def close(self):
        """Stop the batcher and GRV threads (committing what is pending),
        then release the resolver's device history; later commits answer
        1020 (the resolver is down)."""
        for frontend in (self.grv_proxy, self.commit_proxy):
            if hasattr(frontend, "close"):
                frontend.close()
        for r in self.resolvers:
            r.kill()
            r.release()
