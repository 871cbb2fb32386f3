"""In-process cluster: wires the sequencer, GRV and commit proxies, the
resolvers, the log and storage into a database, and recovers it.

Ref parity: the role wiring and recovery that ClusterController and
Master recovery perform (fdbserver/ClusterController.actor.cpp,
masterserver.actor.cpp, ClusterRecovery.actor.cpp), every role in one
process as in the reference's simulation. The resolver runs its
conflict step on ``cuda:0`` unless the caller passes ``device="cpu"``;
without a card and without that, construction raises before it touches
a file.

``commit_pipeline`` picks the commit front end: ``"sync"`` (each client
commit is a batch of one; ``commit_batch`` / ``commit_batches`` take
batches), ``"thread"`` (a batcher thread forms shared-version batches
from concurrent clients and pipelines their resolves on the device,
server/batcher.py; GRVs batch too) or ``"manual"`` (the caller pumps the
batcher). ``n_commit_proxies > 1`` builds a fleet ordered by version
gates (server/fleet.py).

``n_resolvers=k > 1`` with the ``"cuda"`` backend builds ONE
MeshResolver of k lanes on the device (resolver/meshresolver.py,
``resolver_sharding`` "range" or "hash"); with the ``"cpu"`` or
``"native"`` backend it builds k host sets, each owning a byte range of
keys, behind the proxy's clipped fan-out on a thread pool.

Durability: ``wal_path`` makes the log a write-ahead file (``n_tlogs >
1``: that many replicas at ``wal_path.<i>``, pushes acked by a majority),
``fsync=True`` syncs every push before its commit acks, and
``storage_engines=[engine]`` puts the storage server on a durable engine
(server/kvstore.py ``open_engine``). At construction the cluster
replays the log records newer than the storage's durable version, wins
a new generation at the coordinators (server/coordination.py; on disk
under ``coordination_dir``) and starts the sequencer and the resolvers
at the recovered version, so every read version from before the crash
answers transaction_too_old (1007). ``detect_and_recruit()`` is one
round of the failure monitor: a dead sequencer or commit proxy (a
``GateTimeout`` kills a fleet member) runs the transaction-system
recovery, a dead log replica rejoins from a live peer, a dead resolver
is respawned fenced at the committed version, a dead storage reboots on
its engine and replays the log. The caller pumps it, as the reference's
simulation does.

Not ported: several storage replicas and data distribution (the cluster
has one storage server holding the whole keyspace, so a log peek serves
it untagged), regions, and ``configure``'s resizes.
"""

import contextlib
import dataclasses
import threading

from foundationdb_tpu_torch.core.errors import FDBError
from foundationdb_tpu_torch.core.options import DEFAULT_KNOBS
from foundationdb_tpu_torch.resolver.meshresolver import MeshResolver
from foundationdb_tpu_torch.resolver.resolver import Resolver, _device_of
from foundationdb_tpu_torch.server.coordination import (
    CoordinationQuorum,
    CoordinatorDown,
    GenerationConflict,
)
from foundationdb_tpu_torch.server.grv import BatchingGrvProxy, GrvProxy
from foundationdb_tpu_torch.server.health import RecoveryTimeline
from foundationdb_tpu_torch.server.proxy import CommitProxy, VersionGate
from foundationdb_tpu_torch.server.sequencer import Sequencer
from foundationdb_tpu_torch.server.storage import StorageServer
from foundationdb_tpu_torch.server.tlog import TLog, TLogSystem

COMMIT_PIPELINES = ("sync", "thread", "manual")


class Cluster:
    def __init__(self, knobs=None, device=None, commit_pipeline="sync",
                 commit_batch_max=None, commit_flush_after=4,
                 n_commit_proxies=1, n_resolvers=1, wal_path=None,
                 n_tlogs=1, storage_engines=None, fsync=False,
                 coordination_dir=None, **knob_overrides):
        if commit_pipeline not in COMMIT_PIPELINES:
            raise ValueError(f"commit_pipeline must be one of "
                             f"{COMMIT_PIPELINES}, got {commit_pipeline!r}")
        if n_commit_proxies < 1:
            raise ValueError(f"n_commit_proxies must be >= 1, got "
                             f"{n_commit_proxies}")
        if n_resolvers < 1:
            raise ValueError(f"n_resolvers must be >= 1, got {n_resolvers}")
        if storage_engines is not None and len(storage_engines) != 1:
            raise ValueError("one storage engine: the storage server holds "
                             "the whole keyspace (no data distribution)")
        # an argument the port does not take is an unknown Knobs field:
        # replace raises TypeError
        knobs = dataclasses.replace(knobs or DEFAULT_KNOBS, **knob_overrides)
        if knobs.resolver_backend == "cuda":
            _device_of(device)  # without a card: raise before any file
        self.knobs = knobs
        self.commit_pipeline = commit_pipeline
        self._commit_batch_max = commit_batch_max
        self._commit_flush_after = commit_flush_after
        self.n_commit_proxies = n_commit_proxies
        # ── recovery (ref: master recovery replaying the logs into
        # storage): a replicated log recovers the union of its replicas'
        # WALs. Conflict history is not persisted: the resolvers open at
        # the recovered version, which fences every older read version
        if wal_path and n_tlogs > 1:
            records = TLogSystem.recover(wal_path, n_tlogs)
        elif wal_path:
            records = TLog.recover(wal_path)
        else:
            records = []
        self.storages = [StorageServer.recover(
            (storage_engines or [None])[0], records,
            knobs.max_read_transaction_life_versions)]
        recovered = max(s.version for s in self.storages)
        self.recovered_records = len(records)
        # ── the coordinated state: read, then lock the generation ──
        # (the reference also takes an injected quorum, for its remote
        # coordinators, and a coordinator count; neither is ported)
        self.coordination = CoordinationQuorum.local(3, coordination_dir)
        self.generation = self._win_generation(recovered)
        self.recovery_timeline = RecoveryTimeline()
        self.recruitments = 0  # roles the failure monitor replaced
        # serializes transaction-system recoveries
        self._recovery_mu = threading.Lock()
        # fsync=True: every push reaches the disk before its commit acks
        if n_tlogs > 1:
            self.tlog = TLogSystem(n_tlogs, wal_path=wal_path, fsync=fsync)
        else:
            self.tlog = TLog(wal_path=wal_path, fsync=fsync)
        self.tlog._first_version = recovered
        self.sequencer = Sequencer(start_version=recovered)
        if knobs.resolver_backend == "cuda" and n_resolvers > 1:
            self.resolvers = [MeshResolver(knobs, base_version=recovered,
                                           n_lanes=n_resolvers, device=device)]
        else:
            self.resolvers = [Resolver(knobs, base_version=recovered,
                                       device=device)
                              for _ in range(n_resolvers)]
        self.device = self.resolvers[0].device
        self.commit_proxy, self.grv_proxy = self._build_txn_frontend()

    def _win_generation(self, recovered):
        """CAS a new recovery generation at the coordinators: read g,
        commit g+1 expecting g. Two concurrent recoveries cannot both
        win a slot; the loser re-reads and bids for the next."""
        for _ in range(10):
            prior = self.coordination.read_quorum() or {}
            gen = prior.get("generation", 0) + 1
            try:
                self.coordination.write_quorum(
                    {"generation": gen, "recovered_version": recovered},
                    expect_generation=gen - 1)
                return gen
            except GenerationConflict:
                continue
        raise CoordinatorDown("could not win a recovery generation")

    def _make_commit_proxy(self, resolve_gate=None, log_gate=None):
        return CommitProxy(self.sequencer, self.resolvers, self.tlog,
                           self.storages, self.knobs,
                           resolve_gate=resolve_gate, log_gate=log_gate)

    def _build_txn_frontend(self):
        """One commit proxy and GRV proxy, or a fleet of
        ``n_commit_proxies`` of each with chained versions and one shared
        pair of version gates starting at the committed version. Used at
        start and by every transaction-system recovery."""
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
        """Replace every dead resolver with one of its own kind (a lane
        fleet recruits a lane fleet), fenced at the committed version:
        its history is empty, so every read version from before it
        answers TOO_OLD and retries with fresh reads (ref: a resolver
        failure forcing a recovery that fences the old epoch). Returns
        the indices replaced."""
        out = []
        for i, r in enumerate(self.resolvers):
            if not r.alive:
                self.resolvers[i] = r.respawn(self.sequencer.committed_version)
                out.append(i)
        return out

    # ── failure detection and recruitment (ref: ClusterController's
    # failureDetectionServer): "detection" is a killed role's alive flag
    # seen on the monitor's next round, which the caller pumps ──
    def detect_and_recruit(self):
        """One failure-monitor round; returns [(role, index), ...] of the
        recruitments made."""
        events = []
        if not self.sequencer.alive or not self._commit_target().alive:
            # a transaction-system recovery: new generation, fresh
            # sequencer and proxies, resolvers fenced; storage and the
            # logs stay. Liveness is checked again under the mutex
            with self._recovery_mu:
                if (not self.sequencer.alive
                        or not self._commit_target().alive):
                    self._recover_txn_system(
                        trigger="sequencer_failed" if not self.sequencer.alive
                        else "commit_proxy_failed")
                    events.append(("txn-system", 0))
        if isinstance(self.tlog, TLogSystem):
            for i, log in enumerate(self.tlog.logs):
                if not log.alive and self.tlog.revive(i) is not None:
                    events.append(("tlog", i))
        events += [("resolver", i) for i in self.recruit_resolvers()]
        for sid, s in enumerate(self.storages):
            if not s.alive:
                self._recruit_storage(sid)
                events.append(("storage", sid))
        self.recruitments += len(events)
        return events

    def _recover_txn_system(self, trigger="role_failure"):
        """The recovery state machine for a dead sequencer or commit
        proxy (ref: fdbserver/ClusterRecovery.actor.cpp): quiesce the old
        proxies, win a new generation at the coordinators, restart the
        version authority above everything the log acked, fence the
        resolvers at that version (pre-death read versions retry
        TOO_OLD) and recruit fresh proxies over the same storage and
        logs. Each phase is marked in ``recovery_timeline``."""
        rec = self.recovery_timeline.begin(trigger)
        old_proxy = self.commit_proxy
        old_inners = self._inner_proxies()
        # quiesce: mark both roles dead first (later batches answer 1021
        # at the entry check), then take every old proxy's commit mutex,
        # so batches already past the check finish under the old
        # generation before the log frontier is read: every acked commit
        # is at or below ``recovered``
        for p in old_inners:
            p.kill()
        self.sequencer.kill()
        with contextlib.ExitStack() as stack:
            for p in old_inners:
                stack.enter_context(p._commit_mu)
            recovered = max(self.tlog.last_version,
                            self.sequencer.committed_version)
        rec.phase("fence")
        gen = self.generation = self._win_generation(recovered)
        rec.phase("cas")
        self.sequencer = Sequencer(start_version=recovered)
        for i, r in enumerate(self.resolvers):
            self.resolvers[i] = r.respawn(recovered)
        old_grv = self.grv_proxy
        self.commit_proxy, self.grv_proxy = self._build_txn_frontend()
        rec.phase("recruit")
        # (the reference re-derives the database lock, the tenant mode
        # and the resolver ranges here; none is ported)
        rec.phase("replay")
        if self.commit_pipeline != "sync":
            # queued commits raced the death: 1021, their clients retry
            # against the new generation
            old_proxy.fail_pending(FDBError.from_name("commit_unknown_result"))
        old_proxy.close()
        if hasattr(old_grv, "close"):
            old_grv.close()
        rec.phase("accept")
        rec.finish(gen, recovered)

    def _recruit_storage(self, sid):
        """Replace a dead storage by rebooting on its durable engine and
        replaying the log from its durable version (ref: a storage
        process rejoining). The in-memory window died with it; the log
        covers the gap, as the pump never pops past a dead storage's
        durable version."""
        old = self.storages[sid]
        new = StorageServer.recover(
            old.engine, self.tlog.peek(old.engine.stored_version()),
            self.knobs.max_read_transaction_life_versions)
        new.counters = old.counters  # counters survive recruitment
        self.storages[sid] = new  # the proxies share this list
        # watches parked on the dead instance fire: clients re-read
        for key in list(old._watches):
            for w in old._watches.pop(key):
                w._fire()

    def read_storage(self, key=b""):
        """The storage that serves reads of ``key``: the one replica."""
        return self.storages[0]

    def database(self):
        from foundationdb_tpu_torch.txn.database import Database

        return Database(self)

    def status(self):
        """A reduced status document: availability, the committed-txn
        counter, the generation and recoveries, the commit pipeline and
        each role's status."""
        cp = self.commit_proxy
        inners = self._inner_proxies()
        return {"cluster": {
            "database_available": all(
                (self.sequencer.alive, self._commit_target().alive,
                 self.tlog.alive, self.storage.alive,
                 *(r.alive for r in self.resolvers))),
            "generation": self.generation,
            "recovery": self.recovery_timeline.snapshot(),
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
        release the resolvers' device history, then close the storage
        engine and the log files; later commits answer 1020 (the
        resolver is down)."""
        for frontend in (self.grv_proxy, self.commit_proxy):
            if hasattr(frontend, "close"):
                frontend.close()
        for r in self.resolvers:
            r.kill()
            r.release()
        for s in self.storages:
            s.engine.close()
        self.tlog.close()
