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
MeshResolver of k lanes on the device, sharded by key range
(resolver/meshresolver.py); with the ``"cpu"`` or
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
its engine and replays the log, keeping only the mutations it owns. The
caller pumps it, as the reference's simulation does.

Replication and data distribution: ``n_storage`` storage servers (one
engine each in ``storage_engines``) and ``replication`` copies of each
shard (default: every storage a full replica). With ``replication <
n_storage`` the keyspace is cut into shards owned by teams of that size
(server/datadistribution.py): the commit proxy routes each mutation to
its team and tags the log push, reads go through the storage router
(server/router.py, ``read_storage()``), and ``rebalance()`` splits,
merges and moves shards, persisting the map in ``\\xff/keyServers/``,
from which WAL recovery restores it. ``exclude_storage`` drains a
storage. The ratekeeper (server/ratekeeper.py; ``target_tps``,
``rk_clock``, ``set_tag_quota``) gates read versions at the GRV proxies
and read-free commits at the commit proxy. ``lock_database`` persists
``\\xff/dbLocked`` and fails every commit that is not lock-aware with
1038 until ``unlock_database``; the lock survives recovery, as do the
tenant mode and the tenant quotas (layers/tenant.py,
``_restore_tenant_config``).

Regions (server/region.py): ``regions={"primary", "remote",
"satellites", "satellite_mode"}`` attaches a satellite log in the remote
region, seeded with a snapshot of the database and kept caught up (sync
mode: before each commit acks; async: by a streamer), and persists the
config in ``\\xff/conf/regions``, from which WAL recovery re-attaches it.
When every primary process is dead, ``detect_and_recruit`` promotes the
remote region in place (``_region_failover``). ``configure`` resizes the
commit proxies and resolvers and changes the regions through a
transaction-system recovery. The cluster owns one change-feed registry
(server/changefeed.py) that every commit proxy feeds.

Observability (utils/, server/health.py, server/consistencyscan.py):
the cluster owns every role's metrics registry (``_role_registry``),
the workload heatmaps (``_role_heatmap``) and each resolver's device
profile (``_role_profile``), and hands them to every incarnation, so no
counter goes backwards across a recovery, a recruitment, a failover or
a resize (a shrinking fleet folds its orphans into member 0). On them
stand the latency prober (``prober``), the metrics history and flight
recorder (``history``) and the consistency scanner (``scanner``, its
cursor in ``\\xff/consistencyScan/``); a thread-mode cluster runs the
three on daemon threads, other pipelines pump ``maybe_probe`` /
``maybe_collect`` / ``maybe_scan``. ``status()`` is the reference's
whole document, with ``health`` (the doctor's verdict and the recovery
timeline), ``device``, ``history``, ``consistency_scan`` and ``trace``;
``consistency_check()`` audits every replica once; ``set_tracing``
changes the sample rate live.

The special keys (txn/specialkeys.py) read the documents above and
apply exclusions, the lock and the tracing rate through the cluster;
``connection_string()`` is ``"local"``. The metacluster layer
(layers/metacluster.py) writes the registration row that the status
document's ``metacluster`` section reads. The simulator
(sim/simulation.py) installs ``clock_advance`` and ``buggify_sites``.

Over the network (rpc/): ``rpc/service.py`` ``serve_cluster`` puts a
cluster behind the RPC transport, whose clients open it through a
cluster file (``RemoteCluster``; tools/fdbserver.py is the server
process). ``coordination=`` takes an injected quorum, such as
rpc/coordination.py's ``remote_quorum`` over coordinator processes,
else ``n_coordinators`` local ones; ``version_clock="wall"`` lets the
sequencer's versions advance with the injected clock as well as per
batch. The health document's ``rpc`` section is this process's failure
monitor (rpc/failuremon.py).
"""

import contextlib
import dataclasses
import itertools
import json

from foundationdb_tpu_torch.core import systemdata
from foundationdb_tpu_torch.core.commit import CommitRequest
from foundationdb_tpu_torch.core.errors import FDBError, err
from foundationdb_tpu_torch.core.mutations import Mutation, Op
from foundationdb_tpu_torch.core.options import DEFAULT_KNOBS
from foundationdb_tpu_torch.resolver.meshresolver import MeshResolver
from foundationdb_tpu_torch.resolver.resolver import Resolver, _device_of
from foundationdb_tpu_torch.server import consistencyscan as consistencyscan_mod
from foundationdb_tpu_torch.server import health as health_mod
from foundationdb_tpu_torch.server.changefeed import ChangeFeedRegistry
from foundationdb_tpu_torch.server.coordination import (
    CoordinationQuorum,
    CoordinatorDown,
    GenerationConflict,
)
from foundationdb_tpu_torch.server.datadistribution import (
    DataDistributor,
    ShardMap,
)
from foundationdb_tpu_torch.server.grv import BatchingGrvProxy, GrvProxy
from foundationdb_tpu_torch.server.proxy import CommitProxy, VersionGate
from foundationdb_tpu_torch.server.ratekeeper import Ratekeeper
from foundationdb_tpu_torch.server.region import RegionConfig, RegionReplicator
from foundationdb_tpu_torch.server.router import StorageRouter
from foundationdb_tpu_torch.server.sequencer import Sequencer
from foundationdb_tpu_torch.server.storage import StorageServer
from foundationdb_tpu_torch.server.tlog import TLog, TLogSystem
from foundationdb_tpu_torch.utils import deviceprofile
from foundationdb_tpu_torch.utils import heatmap as heatmap_mod
from foundationdb_tpu_torch.utils import lockdep
from foundationdb_tpu_torch.utils import metrics as metrics_mod
from foundationdb_tpu_torch.utils import span as span_mod
from foundationdb_tpu_torch.utils import timeseries as timeseries_mod
from foundationdb_tpu_torch.utils.trace import (
    SEV_WARN_ALWAYS,
    TraceEvent,
    global_trace_log,
)

COMMIT_PIPELINES = ("sync", "thread", "manual")


def _lock_state(uid):
    """Locked iff a uid exists (an empty uid still fences commits)."""
    if uid is None:
        return {"locked": False, "lock_uid": None}
    return {"locked": True, "lock_uid": uid.decode("utf-8", "replace")}


class Cluster:
    def __init__(self, knobs=None, device=None, commit_pipeline="sync",
                 commit_batch_max=None, commit_flush_after=4,
                 n_commit_proxies=1, n_resolvers=1, n_storage=1,
                 replication=None, wal_path=None, n_tlogs=1,
                 storage_engines=None, fsync=False, coordination_dir=None,
                 coordination=None, n_coordinators=3,
                 version_clock="counter", target_tps=None, rk_clock=None,
                 regions=None, **knob_overrides):
        if commit_pipeline not in COMMIT_PIPELINES:
            raise ValueError(f"commit_pipeline must be one of "
                             f"{COMMIT_PIPELINES}, got {commit_pipeline!r}")
        if n_commit_proxies < 1:
            raise ValueError(f"n_commit_proxies must be >= 1, got "
                             f"{n_commit_proxies}")
        if n_resolvers < 1:
            raise ValueError(f"n_resolvers must be >= 1, got {n_resolvers}")
        if version_clock not in Sequencer.CLOCKS:
            raise ValueError(f"version_clock must be one of "
                             f"{Sequencer.CLOCKS}, got {version_clock!r}")
        if storage_engines is None:
            storage_engines = [None] * n_storage
        elif len(storage_engines) != n_storage:
            if n_storage != 1:
                raise ValueError(f"n_storage={n_storage} but "
                                 f"{len(storage_engines)} storage_engines")
            n_storage = len(storage_engines)
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
        # the cluster-owned observability stores, keyed (role, index) and
        # handed to every incarnation of the role: metric registries,
        # workload heatmaps, and the resolvers' device profiles
        self._metrics_store = {}
        self._heatmap_store = {}
        self._device_store = {}
        self.ratekeeper = Ratekeeper(
            target_tps=target_tps if target_tps is not None else 1e9,
            clock=rk_clock, tag_busy_threshold=knobs.tag_throttle_busyness)
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
        # every storage replays the whole log: a non-owner holds shadow
        # rows of shards it does not own, which routing never reads and a
        # relocation clears before it installs. The heatmaps attach
        # before the replay, which they sample as any apply
        self.storages = [StorageServer(
            window_versions=knobs.max_read_transaction_life_versions,
            engine=eng) for eng in storage_engines]
        for sid, s in enumerate(self.storages):
            self._attach_heat(s, sid)
            for version, mutations in records:
                if version > s.version:
                    s.apply(version, mutations)
        recovered = max(s.version for s in self.storages)
        self.recovered_records = len(records)
        # ── the coordinated state: read, then lock the generation ──
        # (an injected quorum: the remote coordinators of rpc/
        # coordination.py, or any mix of local and remote replicas)
        self.coordination = coordination or CoordinationQuorum.local(
            n_coordinators, coordination_dir)
        self.generation = self._win_generation(recovered)
        TraceEvent("MasterRecovered").detail(
            generation=self.generation, version=recovered).log()
        self.recruitments = 0  # roles the failure monitor replaced
        # serializes transaction-system recoveries
        self._recovery_mu = lockdep.lock("Cluster._recovery_mu")
        # a simulation's hook: each recovery phase mark calls it, so a
        # simulated recovery consumes simulated time (None: real time)
        self.clock_advance = None
        # fsync=True: every push reaches the disk before its commit acks
        if n_tlogs > 1:
            self.tlog = TLogSystem(n_tlogs, wal_path=wal_path, fsync=fsync)
        else:
            self.tlog = TLog(wal_path=wal_path, fsync=fsync)
        self.tlog._first_version = recovered
        self.sequencer = Sequencer(version_clock=version_clock,
                                   start_version=recovered)
        self.resolvers = self._make_resolvers(n_resolvers, recovered, device)
        self.device = self.resolvers[0].device
        self._attach_device_profiles()
        # ── placement: the shard map persisted in \xff/keyServers/ is
        # restored (ref: recovery reading keyServers), else every shard
        # starts on the first ``replication`` storages ──
        restored = None
        if records:
            restored, replication = self._restored_shard_map(replication)
        self.replication = replication or n_storage
        self.dd = DataDistributor(self.storages, shard_map=restored,
                                  replication=self.replication)
        self.router = StorageRouter(self.storages, self.dd.map,
                                    itertools.count())
        self.change_feeds = ChangeFeedRegistry()
        # the doctor (server/health.py), the metrics history and flight
        # recorder (utils/timeseries.py) and the replica auditor
        # (server/consistencyscan.py), all on the stores above
        self.recovery_timeline = health_mod.RecoveryTimeline()
        self.prober = health_mod.LatencyProber(self)
        self.history = timeseries_mod.HistoryCollector(self)
        self.scanner = consistencyscan_mod.ConsistencyScanner(self)
        # the region replicator (None until a config attaches); the
        # frontend reads it
        self.regions = None
        self.commit_proxy, self.grv_proxy = self._build_txn_frontend()
        if records:
            self._restore_tenant_config()
            # the scan resumes where the old incarnation left it
            self.scanner.restore_cursor()
        # the argument wins; else a recovered \xff/conf/regions row
        # re-attaches (re-seeding the satellite; only a new config
        # writes the row)
        region_cfg = regions
        if region_cfg is None and records:
            s0 = self.storages[0]
            region_cfg = s0.get(systemdata.CONF_REGIONS, s0.version)
        if region_cfg is not None:
            self._attach_regions(RegionConfig.parse(region_cfg),
                                 persist=regions is not None)
        # daemon loops only in thread mode: other pipelines pump
        # maybe_probe / maybe_collect / maybe_scan on their own schedule
        if commit_pipeline == "thread":
            if knobs.health_probe_enabled:
                self.prober.start()
            if knobs.history_enabled:
                self.history.start()
            if knobs.consistency_scan_enabled:
                self.scanner.start()

    def _make_resolvers(self, lanes, base_version, device):
        """The resolvers for ``lanes`` lanes at ``base_version``: one
        MeshResolver of that many lanes on the device for the "cuda"
        backend, else that many Resolvers (host sets behind the proxy's
        fan-out, or one device resolver). Construction and configure's
        resize both build through here."""
        if self.knobs.resolver_backend == "cuda" and lanes > 1:
            return [MeshResolver(self.knobs, base_version=base_version,
                                 n_lanes=lanes, device=device)]
        return [Resolver(self.knobs, base_version=base_version,
                         device=device) for _ in range(lanes)]

    def _restore_tenant_config(self):
        """Re-apply the lock, the tenant mode and the tenant quotas from
        the system keys (their enforcement is proxy and ratekeeper state,
        which a restart or a region failover rebuilds empty)."""
        from foundationdb_tpu_torch.layers.tenant import (
            TENANT_MODE_KEY,
            TENANT_QUOTA_PREFIX,
            tenant_tag,
        )

        s0 = self.storages[0]
        target = self._commit_target()
        lock_row = s0.get(systemdata.DB_LOCKED, s0.version)
        if lock_row is not None:
            target.lock_uid = lock_row
        mode_row = s0.get(TENANT_MODE_KEY, s0.version)
        if mode_row is not None:
            target.tenant_mode = mode_row.decode()
        for k, v in s0.read_range(TENANT_QUOTA_PREFIX,
                                  TENANT_QUOTA_PREFIX + b"\xff", s0.version):
            self.ratekeeper.set_tag_quota(
                tenant_tag(k[len(TENANT_QUOTA_PREFIX):]), float(v))

    def _restored_shard_map(self, replication):
        """(ShardMap, replication) from the recovered \\xff/keyServers/
        and \\xff/conf/replication rows, or (None, ``replication``) when
        none were persisted, the map is torn, or it names a storage this
        fleet lacks (then full placement, as for a decode failure)."""
        s0 = self.storages[0]
        decoded = systemdata.decode_shard_map(s0.read_range(
            systemdata.KEY_SERVERS_PREFIX, systemdata.KEY_SERVERS_END,
            s0.version))
        if decoded is None:
            return None, replication
        smap = ShardMap.restore(*decoded)
        rep_row = s0.get(systemdata.CONF_REPLICATION, s0.version)
        persisted = int(rep_row) if rep_row is not None else replication
        fleet = len(self.storages)
        if (any(sid >= fleet for team in smap.teams for sid in team)
                or (persisted or 0) > fleet):
            TraceEvent("ShardMapFleetMismatch", severity=SEV_WARN_ALWAYS
                       ).detail(shards=len(smap), replication=persisted,
                                fleet=fleet).log()
            return None, replication
        TraceEvent("ShardMapRestored").detail(
            shards=len(smap), replication=persisted).log()
        return smap, persisted

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

    # ── the cluster-owned observability stores ──
    def _role_registry(self, role, i=0):
        """The (role, index) metrics registry, made at first use and
        handed to every later incarnation of that role."""
        key = (role, i)
        reg = self._metrics_store.get(key)
        if reg is None:
            reg = self._metrics_store[key] = metrics_mod.MetricsRegistry(
                role, index=i)
        return reg

    def _role_registries(self, role):
        return [reg for (r, _), reg in sorted(self._metrics_store.items())
                if r == role]

    def _role_heatmap(self, role, i=0, decode=None):
        """The (role, index) heatmap, as ``_role_registry``."""
        key = (role, i)
        hm = self._heatmap_store.get(key)
        if hm is None:
            hm = self._heatmap_store[key] = heatmap_mod.KeyRangeHeatmap(
                f"{role}:{i}", max_buckets=self.knobs.heatmap_max_buckets,
                half_life_s=self.knobs.heatmap_half_life_s, decode=decode)
        return hm

    def _role_heatmaps(self, role):
        return [hm for (r, _), hm in sorted(self._heatmap_store.items())
                if r == role]

    def _attach_heat(self, storage, sid):
        """Storage ``sid``'s sampling into the cluster's read and write
        heatmaps (a recruit gets the same ones)."""
        if self.knobs.workload_sampling:
            storage.attach_heatmaps(self._role_heatmap("storage_read", sid),
                                    self._role_heatmap("storage_write", sid),
                                    self.knobs.storage_sample_every)

    def _role_profile(self, i=0):
        """Resolver ``i``'s device profile, as ``_role_registry``."""
        key = ("resolver", i)
        prof = self._device_store.get(key)
        if prof is None:
            prof = self._device_store[key] = deviceprofile.DeviceProfile(
                "resolver", index=i)
        return prof

    def _attach_device_profiles(self):
        """Hand every resolver its profile (at start, after every
        recovery and resize). A shrinking fleet folds the orphaned
        indices' profiles into member 0 first: no count goes back."""
        n = max(1, len(self.resolvers))
        for (role, i) in list(self._device_store):
            if i >= n:
                self._role_profile(0).absorb(self._device_store.pop((role, i)))
        for i, r in enumerate(self.resolvers):
            r.adopt_profile(self._role_profile(i))

    def _make_commit_proxy(self, resolve_gate=None, log_gate=None, index=0):
        return CommitProxy(
            self.sequencer, self.resolvers, self.tlog, self.storages,
            self.knobs, self.ratekeeper, dd=self.dd,
            change_feeds=self.change_feeds, regions=self.regions,
            resolve_gate=resolve_gate, log_gate=log_gate,
            metrics=self._role_registry("commit_proxy", index),
            heatmap=(self._role_heatmap("commit_proxy", index,
                                        decode=heatmap_mod.entry_key)
                     if self.knobs.workload_sampling else None),
            fanout_profile=self._role_profile(0))

    def _build_txn_frontend(self):
        """One commit proxy and GRV proxy, or a fleet of
        ``n_commit_proxies`` of each with chained versions and one shared
        pair of version gates starting at the committed version. Used at
        start and by every transaction-system recovery. A shrinking fleet
        folds the orphaned members' registries and conflict heat into
        member 0, so cluster totals never go backwards."""
        n = max(1, self.n_commit_proxies)
        for (role, i) in list(self._metrics_store):
            if role in ("commit_proxy", "grv_proxy") and i >= n:
                self._role_registry(role, 0).absorb(
                    self._metrics_store.pop((role, i)))
        for (role, i) in list(self._heatmap_store):
            if role == "commit_proxy" and i >= n:
                self._role_heatmap(role, 0, decode=heatmap_mod.entry_key
                                   ).absorb(self._heatmap_store.pop((role, i)))
        if self.n_commit_proxies <= 1:
            return self._wire_pipeline(self._make_commit_proxy())
        from foundationdb_tpu_torch.server.fleet import GrvFleet, ProxyFleet

        start = self.sequencer.committed_version
        t = self.knobs.gate_timeout_s
        resolve_gate = VersionGate(start, timeout=t)
        log_gate = VersionGate(start, timeout=t)
        inners, members, grvs = [], [], []
        for i in range(self.n_commit_proxies):
            inner = self._make_commit_proxy(resolve_gate, log_gate, index=i)
            wrapped, grv = self._wire_pipeline(inner, index=i)
            inners.append(inner)
            members.append(wrapped)
            grvs.append(grv)
        return ProxyFleet(members, inners), GrvFleet(grvs)

    def _wire_pipeline(self, inner, index=0):
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
        grv = GrvProxy(self.sequencer, self.ratekeeper,
                       metrics=self._role_registry("grv_proxy", index))
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
        # the loss of the whole primary region comes first: with its
        # logs dead the transaction-system recovery below cannot read a
        # frontier, and the satellite log is the only durable state
        # left. A coordination failure part way leaves the roles dead and
        # the next round retries
        reg = self.regions
        if reg is not None and reg.should_failover(self):
            with self._recovery_mu:
                if reg.should_failover(self):
                    try:
                        self._region_failover()
                    except CoordinatorDown as e:
                        reg.note_failed_attempt(e)
                        return events
                    events.append(("region-failover", 0))
                    self.recruitments += 1
                    TraceEvent("RolesRecruited").detail(events=events).log()
                    return events
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
        if events:
            self.recruitments += len(events)
            TraceEvent("RolesRecruited").detail(events=events).log()
        return events

    def _recover_txn_system(self, new_resolver_lanes=None,
                            trigger="role_failure"):
        """The recovery state machine for a dead sequencer or commit
        proxy (ref: fdbserver/ClusterRecovery.actor.cpp): quiesce the old
        proxies, win a new generation at the coordinators, restart the
        version authority above everything the log acked, fence the
        resolvers at that version (pre-death read versions retry
        TOO_OLD) and recruit fresh proxies over the same storage and
        logs. Each phase is marked in ``recovery_timeline``.
        ``new_resolver_lanes`` (configure's resize) builds resolvers of
        that many lanes here, after the quiesce, and releases the old
        ones' history and compiled steps; otherwise each resolver is
        respawned, handing its own over."""
        rec = self.recovery_timeline.begin(trigger, self.clock_advance)
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
        self.sequencer = Sequencer(
            version_clock=self.sequencer.version_clock,
            start_version=recovered)
        if new_resolver_lanes is None:
            for i, r in enumerate(self.resolvers):
                self.resolvers[i] = r.respawn(recovered)
        else:
            old = list(self.resolvers)
            # in place: the quiesced proxies share this list
            self.resolvers[:] = self._make_resolvers(
                new_resolver_lanes, recovered, self.device)
            for r in old:
                r.kill()
                r.release()
        # every incarnation, respawned or rebuilt, takes its profile
        # (a shrink folds the orphans first)
        self._attach_device_profiles()
        # the lock and the tenant mode are cluster state, not proxy
        # state: they survive
        lock_uid = old_inners[0].lock_uid
        tenant_mode = old_inners[0].tenant_mode
        old_grv = self.grv_proxy
        self.commit_proxy, self.grv_proxy = self._build_txn_frontend()
        rec.phase("recruit")
        target = self._commit_target()
        target.lock_uid = lock_uid
        target.tenant_mode = tenant_mode
        target.update_resolver_ranges(fence=False)
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
        TraceEvent("TxnSystemRecovered").detail(
            generation=gen, version=recovered, trigger=trigger,
            recovery_ms=rec.record["total_ms"]).log()

    def _region_failover(self):
        """Promote the remote region after the loss of the whole primary
        (ref: ClusterRecovery recruiting from a remote region when the
        primary's logs are lost). The phases of ``_recover_txn_system``
        under trigger ``region_failover``, with two substitutions: the
        satellite log becomes the log (its frontier bounds what
        survives: every acked commit in sync mode, all but the measured
        lag in async), and a fresh storage fleet replays it from its
        seed snapshot, keeping what each storage owns under the shard
        map. The resolvers are respawned fenced at the frontier, taking
        their predecessors' history and compiled steps. The caller holds
        ``_recovery_mu``."""
        reg = self.regions
        rec = self.recovery_timeline.begin("region_failover",
                                           self.clock_advance)
        old_proxy = self.commit_proxy
        old_inners = self._inner_proxies()
        old_grv = self.grv_proxy
        old_storages = list(self.storages)
        for p in old_inners:
            p.kill()
        self.sequencer.kill()
        with contextlib.ExitStack() as stack:
            for p in old_inners:
                stack.enter_context(p._commit_mu)
            frontier = reg.position
        rec.phase("fence")
        # CoordinatorDown here: nothing is promoted yet, every role is
        # still dead, and the caller counts a failed attempt
        gen = self.generation = self._win_generation(frontier)
        rec.phase("cas")
        self.tlog = reg.promote_log()
        self.sequencer = Sequencer(
            version_clock=self.sequencer.version_clock,
            start_version=frontier)
        for i, r in enumerate(self.resolvers):
            self.resolvers[i] = r.respawn(frontier)
        self._attach_device_profiles()
        rec.phase("recruit")
        # the primary's engines are lost with the region: the new fleet
        # starts empty and swaps in place (DD, the router and the
        # proxies share the list); the fleet's shape is unchanged, so
        # the shard map stays valid
        records = self.tlog.peek(0)
        for sid in range(len(old_storages)):
            self._replay_storage(sid, None, records, reg.config.remote)
        for log in self._tlog_replicas():
            log.region = reg.config.remote
        self.commit_proxy, self.grv_proxy = self._build_txn_frontend()
        self._commit_target().update_resolver_ranges(fence=False)
        # the lock, the tenant mode and the quotas re-derive from the
        # replayed system keys (the seed and the stream carried them)
        self._restore_tenant_config()
        rec.phase("replay")
        if self.commit_pipeline != "sync":
            old_proxy.fail_pending(FDBError.from_name("commit_unknown_result"))
        old_proxy.close()
        if hasattr(old_grv, "close"):
            old_grv.close()
        for old in old_storages:
            old.engine.close()
            # watches parked on the lost storages fire: clients re-read
            for key in list(old._watches):
                for w in old._watches.pop(key):
                    w._fire()
        rec.phase("accept")
        rec.finish(gen, frontier)
        reg.note_failover(rec.record["total_ms"])
        TraceEvent("TxnSystemRecovered").detail(
            generation=gen, version=frontier, trigger="region_failover",
            recovery_ms=rec.record["total_ms"]).log()

    def _tlog_replicas(self):
        return (self.tlog.logs if isinstance(self.tlog, TLogSystem)
                else [self.tlog])

    def _recruit_storage(self, sid):
        """Replace a dead storage by rebooting on its durable engine and
        replaying the log from its durable version, keeping the
        mutations it owns under the shard map (ref: a storage process
        rejoining). The in-memory window died with it; the log covers
        the gap, as the pump never pops past a dead storage's durable
        version."""
        old = self.storages[sid]
        self._replay_storage(sid, old.engine,
                             self.tlog.peek(old.engine.stored_version()),
                             old.region)
        # watches parked on the dead instance fire: clients re-read
        for key in list(old._watches):
            for w in old._watches.pop(key):
                w._fire()

    def _replay_storage(self, sid, engine, records, region):
        """Install storage ``sid``'s replacement: ``engine`` (None: a
        fresh memory engine) replaying ``records``, keeping what ``sid``
        owns under the shard map, with its predecessor's registry and
        the cluster's heatmaps and its placement tag ``region``. The
        proxies, DD and the router share the list it is swapped into."""
        smap = self.dd.map if self.replication < len(self.storages) else None
        new = StorageServer(
            window_versions=self.knobs.max_read_transaction_life_versions,
            engine=engine)
        new.adopt_metrics(self.storages[sid].metrics)
        self._attach_heat(new, sid)
        for version, muts in records:
            if version > new.version:
                new.apply(version, muts if smap is None else
                          [m for m in muts if self._storage_owns(smap, sid, m)])
        new.region = region
        self.storages[sid] = new

    @staticmethod
    def _storage_owns(smap, sid, m):
        """Does storage ``sid`` own mutation ``m`` under ``smap`` (None:
        full replication)? System keys replicate everywhere."""
        if smap is None or m.key >= b"\xff":
            return True
        if m.op == Op.CLEAR_RANGE:
            return any(sid in smap.teams[i]
                       for i in smap.shards_overlapping(m.key, m.param))
        return sid in smap.team_for(m.key)

    def read_storage(self, key=b""):
        """The read surface: the router sends each read of a key or range
        to a live replica of its shard's team (ref: NativeAPI's
        getKeyLocation and LoadBalance)."""
        return self.router

    # ── data distribution ──
    # bumped by every rebalance: a tag-scoped storage worker learns of
    # ownership moves from its next log peek (rpc/storageworker.py)
    shard_epoch = 0

    def rebalance(self):
        """One data-distribution round (splits, merges, moves), then the
        new map persisted in the system keys and the host resolvers'
        ranges derived from it. Returns the moves."""
        moves = self.dd.rebalance()
        self.shard_epoch += 1
        self.persist_shard_map()
        self.commit_proxy.update_resolver_ranges()
        return moves

    def exclude_storage(self, sid):
        """Begin draining a storage (ref: fdbcli exclude): DD moves its
        shards away; poll ``storage_drained``."""
        self.dd.excluded.add(sid)
        return self.rebalance()

    def include_storage(self, sid):
        """Cancel an exclusion (ref: fdbcli include)."""
        self.dd.excluded.discard(sid)

    def list_excluded(self):
        return sorted(self.dd.excluded)

    def storage_drained(self, sid):
        return self.dd.storage_owns_nothing(sid)

    def storage_owned_ranges(self, sid):
        """The merged key ranges storage ``sid`` owns, with the system
        keys that every storage holds."""
        end_cap = b"\xff\xff"
        if self.replication >= len(self.storages):
            return [(b"", end_cap)]
        smap = self.dd.map
        owned = sorted(
            (smap.shard_range(i)[0], smap.shard_range(i)[1] or b"\xff")
            for i in range(len(smap)) if sid in smap.teams[i])
        merged = []
        for b, e in owned:
            if merged and b <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([b, e])
        merged.append([b"\xff", end_cap])
        return [tuple(r) for r in merged]

    def estimated_range_size_bytes(self, begin, end):
        """Ref: fdb_transaction_get_estimated_range_size_bytes — DD's
        sampled bytes per shard, a boundary shard prorated by the share
        of its keys the range covers (counted on a live replica)."""
        smap = self.dd.map
        total = 0
        for i in smap.shards_overlapping(begin, end):
            sb, se = smap.shard_range(i)
            size = smap.sizes[i]
            if size == 0:
                continue
            if sb >= begin and se is not None and se <= end:
                total += size
                continue
            owner = self.router._pick(smap.teams[i])
            lo = max(begin, sb)
            shard_end = se if se is not None else b"\xff\xff"
            hi = min(end, shard_end)
            n_all = n_cov = 0
            for k, _ in owner._iter_live(sb, shard_end, owner.version):
                n_all += 1
                if lo <= k < hi:
                    n_cov += 1
            total += size * n_cov // max(n_all, 1)
        return total

    def range_split_points(self, begin, end, chunk_size):
        """Ref: fdb_transaction_get_range_split_points — keys cutting
        [begin, end) into chunks of about ``chunk_size`` bytes, from a
        live replica's rows shard by shard; begin and end included."""
        if chunk_size <= 0:
            raise err("invalid_option_value")
        if begin > end:
            raise err("inverted_range")
        version = self.sequencer.committed_version
        points = [begin]
        acc = 0
        smap = self.dd.map
        for i in smap.shards_overlapping(begin, end):
            sb, se = smap.shard_range(i)
            lo = max(begin, sb)
            hi = min(end, se) if se is not None else end
            owner = self.router._pick(smap.teams[i])
            for k, v in owner._iter_live(lo, hi, min(version, owner.version)):
                acc += len(k) + len(v or b"")
                if acc >= chunk_size and k != points[-1]:
                    points.append(k)
                    acc = 0
        points.append(end)
        return points

    def _system_commit(self, mutations):
        """Commit system-key mutations through the commit path (durable
        in the log, restored by WAL recovery); True if it committed."""
        req = CommitRequest(read_version=self.sequencer.committed_version,
                            mutations=mutations, read_conflict_ranges=[],
                            write_conflict_ranges=[])
        return not isinstance(self.commit_proxy.commit(req), Exception)

    def persist_shard_map(self):
        """Write the shard map and the replication to the system keys
        (ref: keyServers commits). Best effort: a failed commit leaves
        the previous map, and the next round retries."""
        muts = [Mutation(Op.CLEAR_RANGE, systemdata.KEY_SERVERS_PREFIX,
                         systemdata.KEY_SERVERS_END)]
        muts += [Mutation(Op.SET, k, v)
                 for k, v in systemdata.encode_shard_map(self.dd.map)]
        muts.append(Mutation(Op.SET, systemdata.CONF_REPLICATION,
                             str(self.replication).encode()))
        return self._system_commit(muts)

    # ── the database lock and the ratekeeper ──
    def lock_database(self, uid=b"lock"):
        """Ref: ManagementAPI lockDatabase — commits without the
        lock_aware option fail 1038 until unlocked. The uid persists as
        \\xff/dbLocked; locking over another uid raises 1038 (the same
        uid is a no-op)."""
        uid = bytes(uid)

        def txn(tr):
            tr.options.set_lock_aware()
            held = tr.get(systemdata.DB_LOCKED)
            if held is not None and held != uid:
                raise err("database_locked")
            if held is None:
                tr.set(systemdata.DB_LOCKED, uid)

        self.database().run(txn)
        self._commit_target().lock_uid = uid

    def unlock_database(self):
        def txn(tr):
            tr.options.set_lock_aware()
            tr.clear(systemdata.DB_LOCKED)

        self.database().run(txn)
        self._commit_target().lock_uid = None

    def lock_uid(self):
        return self._commit_target().lock_uid

    def set_tenant_mode(self, mode):
        """Switch the proxies' enforcement (TenantManagement persists
        the system row)."""
        self._commit_target().tenant_mode = mode

    def tenant_mode(self):
        return self._commit_target().tenant_mode

    def set_tag_quota(self, tag, tps):
        """An operator's rate limit for a tag (None clears it; tenant
        quotas are tag quotas)."""
        self.ratekeeper.set_tag_quota(tag, tps)

    # ── live reconfiguration and regions ──
    def resolver_lanes(self):
        return sum(getattr(r, "n_lanes", 1) for r in self.resolvers)

    def configure(self, commit_proxies=None, resolvers=None, regions=None):
        """Live reconfiguration (ref: fdbcli ``configure proxies=N
        resolvers=N regions=<json>``, which forces a recovery): a change
        of the commit-proxy count, the resolver lanes or the regions
        rides a transaction-system recovery over the same storage and
        logs; the new resolvers open fenced at the recovered version.
        ``regions`` takes a RegionConfig, a dict or JSON, validated
        before the recovery, or ``"off"`` / ``{}`` to detach; a new
        region config attaches after the recovery and persists in
        ``\\xff/conf/regions``. A call that changes nothing recovers
        nothing: the lanes compare against the lanes last requested,
        and a region config against the current one. Returns the
        shape."""
        for v in (commit_proxies, resolvers):
            if v is not None and int(v) < 1:
                raise err("invalid_option_value")
        region_off = regions in ("off", b"off", "", {})
        new_region_cfg = None
        if regions is not None and not region_off:
            new_region_cfg = RegionConfig.parse(regions)
        with self._recovery_mu:
            changed = False
            lanes = None
            region_change = False
            if (commit_proxies is not None
                    and int(commit_proxies) != self.n_commit_proxies):
                self.n_commit_proxies = int(commit_proxies)
                changed = True
            if resolvers is not None:
                current = (getattr(self, "_requested_resolver_lanes", None)
                           or self.resolver_lanes())
                if int(resolvers) != current:
                    lanes = int(resolvers)
                    self._requested_resolver_lanes = lanes
                    changed = True
            if regions is not None:
                if region_off:
                    region_change = self.regions is not None
                else:
                    region_change = (self.regions is None
                                     or self.regions.config != new_region_cfg)
                changed = changed or region_change
            if changed:
                self._recover_txn_system(new_resolver_lanes=lanes,
                                         trigger="configure")
            if region_change:
                if new_region_cfg is None:
                    self._detach_regions()
                else:
                    self._attach_regions(new_region_cfg, persist=True)
        shape = {"commit_proxies": self.n_commit_proxies,
                 "resolver_lanes": self.resolver_lanes()}
        if regions is not None:
            shape["regions"] = (self.regions.config.to_json()
                                if self.regions is not None else None)
        return shape

    def _attach_regions(self, config, persist=True):
        """Install the RegionReplicator for ``config``: the satellite log
        at ``<wal_path>.satellite`` (in memory when the cluster is), the
        region tags on the primary's logs and storages, the live proxies
        given the replicator (sync mode gates their commits), and in a
        thread pipeline the streamer started. ``persist`` writes the
        \\xff/conf/regions row (False when a restart restores it)."""
        if self.regions is not None:
            self.regions.drop()
            self.regions.close()
        wal = getattr(self.tlog, "wal_path", None)
        self.regions = RegionReplicator(
            self, config, wal_path=f"{wal}.satellite" if wal else None)
        for s in self.storages:
            s.region = config.primary
        for log in self._tlog_replicas():
            log.region = config.primary
        self._commit_target().regions = self.regions  # a fleet fans out
        if persist:
            self._persist_region_config()
        if self.commit_pipeline == "thread":
            self.regions.start()
        return self.regions

    def _detach_regions(self):
        """``configure(regions="off")``: release the primary log's pin,
        stop the streamer, close the satellite, clear the tags and the
        persisted row."""
        reg, self.regions = self.regions, None
        if reg is not None:
            reg.drop()
            reg.close()
        for s in self.storages:
            s.region = None
        for log in self._tlog_replicas():
            log.region = None
        self._commit_target().regions = None
        self._persist_region_config()

    def _persist_region_config(self):
        """Write (or clear) the \\xff/conf/regions row through the commit
        path: durable in the log, restored by WAL recovery, streamed to
        the satellite. Best effort, as persist_shard_map."""
        if self.regions is not None:
            muts = [Mutation(Op.SET, systemdata.CONF_REGIONS,
                             self.regions.config.to_json().encode())]
        else:
            muts = [Mutation(Op.CLEAR, systemdata.CONF_REGIONS)]
        return self._system_commit(muts)

    def database(self):
        from foundationdb_tpu_torch.txn.database import Database

        return Database(self)

    def connection_string(self):
        """What \\xff\\xff/connection_string reports for an in-process
        cluster (a remote client reports its cluster-file body)."""
        return "local"

    # ── tracing and the consistency check ──
    TRACING_DEFAULT_RATE = 0.01  # set_tracing(enabled=True) without a rate

    def tracing_config(self):
        k = self.knobs
        return {"enabled": k.tracing_sample_rate > 0,
                "sample_rate": k.tracing_sample_rate,
                "slow_commit_ms": k.tracing_slow_commit_ms}

    def set_tracing(self, sample_rate=None, enabled=None):
        """Change the tracing sample rate live: the cluster's knobs are
        swapped for a copy with the new rate (DEFAULT_KNOBS is never
        mutated); new transactions and the live proxies take it at
        once."""
        k = self.knobs
        if enabled is not None:
            if enabled:
                sample_rate = (k.tracing_sample_rate
                               if k.tracing_sample_rate > 0
                               else self.TRACING_DEFAULT_RATE)
            else:
                sample_rate = 0.0
        if sample_rate is None:
            return self.tracing_config()
        rate = float(sample_rate)
        if not 0.0 <= rate <= 1.0:
            raise err("invalid_option_value")
        self.knobs = dataclasses.replace(k, tracing_sample_rate=rate)
        for p in self._inner_proxies():
            p.knobs = self.knobs
        TraceEvent("TracingConfigured").detail(sample_rate=rate).log()
        return self.tracing_config()

    def consistency_check(self, max_keys_per_shard=None):
        """Every replica of every shard compared at one version (ref:
        the ConsistencyCheck workload); returns the problems, [] when
        consistent."""
        from foundationdb_tpu_torch.server.consistency import (
            consistency_check,
        )

        return consistency_check(self, max_keys_per_shard)

    # ── the status document ──
    def _metacluster_status(self):
        """This cluster's metacluster membership from its registration
        row, "standalone" without one, "unknown" when no storage can be
        read."""
        s0 = next((s for s in self.storages if s.alive), None)
        if s0 is None:
            return {"cluster_type": "unknown"}
        try:
            row = s0.get(systemdata.METACLUSTER_REGISTRATION, s0.version)
        except FDBError:
            # a kill raced past the alive check: status never raises
            return {"cluster_type": "unknown"}
        if row is None:
            return {"cluster_type": "standalone"}
        meta = json.loads(row)
        return {"cluster_type": f"metacluster_{meta['role']}",
                "name": meta.get("name")}

    def _sum_counter(self, role, name):
        return sum(reg.counter(name).value
                   for reg in self._role_registries(role))

    def metrics_status(self):
        """The status document's metrics section (ref: Status.actor.cpp
        folding every role's stats): latency rollups merged across the
        fleets and the commit pipeline's hottest stage."""
        commit_regs = self._role_registries("commit_proxy")
        commit = metrics_mod.merged_bands_ms(
            [r.get_latency("commit_e2e") for r in commit_regs])
        grv = metrics_mod.merged_bands_ms(
            [r.get_latency("grv_grant")
             for r in self._role_registries("grv_proxy")])
        push = metrics_mod.merged_bands_ms(
            [log.metrics.get_latency("tlog_push")
             for log in self._tlog_replicas()])
        apply_ = metrics_mod.merged_bands_ms(
            [s.metrics.get_latency("storage_apply") for s in self.storages])
        rbatch = metrics_mod.merged_bands_ms(
            [s.metrics.get_latency("read_batch") for s in self.storages])
        rkeys = metrics_mod.merged_bands_ms(
            [s.metrics.get_latency("read_batch_keys") for s in self.storages])
        read_batches = sum(s.metrics.counter("read_batches").value
                           for s in self.storages)
        batched_reads = sum(s.metrics.counter("batched_reads").value
                            for s in self.storages)
        # the stage with the most wall time across the fleet
        stage_totals = {}
        for reg in commit_regs:
            for stage in ("pack", "dispatch", "resolve", "apply"):
                band = reg.get_latency(f"stage_{stage}")
                if band is not None and band.count:
                    stage_totals[stage] = (stage_totals.get(stage, 0.0)
                                           + band.total_seconds())
        hottest = (max(stage_totals, key=stage_totals.get)
                   if stage_totals else None)
        rollups = {
            "commit_latency_p50_ms": commit["p50_ms"],
            "commit_latency_p99_ms": commit["p99_ms"],
            "commit_latency_max_ms": commit["max_ms"],
            "commit_spans": commit["count"],
            "grv_latency_p99_ms": grv["p99_ms"],
            "tlog_push_p99_ms": push["p99_ms"],
            "storage_apply_p99_ms": apply_["p99_ms"],
            "read_batch_p99_ms": rbatch["p99_ms"],
            "read_batch_size_p50": round(rkeys["p50_ms"], 1),
            "read_batch_size_p99": round(rkeys["p99_ms"], 1),
            "read_batches": read_batches,
            "batched_reads": batched_reads,
            "read_batch_coalesce_rate": round(
                batched_reads / max(read_batches, 1), 2),
            "hottest_stage": hottest,
            "hottest_stage_totals_s": {
                k: round(v, 6) for k, v in stage_totals.items()},
        }
        for name in ("repair_attempts", "repair_commits", "repair_fallbacks",
                     "sched_reordered", "sched_deferred"):
            rollups[name] = self._sum_counter("commit_proxy", name)
        return {"rollups": rollups, "commit_latency_bands": commit,
                "grv_latency_bands": grv}

    def _tag_rollup(self):
        """Each tag's outcomes summed across the fleets (the registries'
        ``tag_{outcome}_{tag}`` counters), its busyness and its live
        admission limit."""
        out = {}
        scans = (("commit_proxy", "tag_committed_", "committed"),
                 ("commit_proxy", "tag_conflicted_", "conflicted"),
                 ("commit_proxy", "tag_too_old_", "too_old"),
                 ("grv_proxy", "tag_started_", "started"))
        snaps = {role: [r.snapshot()["counters"]
                        for r in self._role_registries(role)]
                 for role in ("commit_proxy", "grv_proxy")}
        for role, prefix, field in scans:
            for counters in snaps[role]:
                for name, v in counters.items():
                    if name.startswith(prefix):
                        row = out.setdefault(name[len(prefix):], {})
                        row[field] = row.get(field, 0) + v
        for tag, busy in self.ratekeeper.tag_busyness.items():
            out.setdefault(tag, {})["busyness"] = busy
        for tag, tps in self.ratekeeper.throttled_tags().items():
            out.setdefault(tag, {})["limit_tps"] = round(tps, 2)
        return {t: out[t] for t in sorted(out)}

    def hot_ranges_status(self, top=None):
        """The workload-attribution document: the fleet-merged conflict,
        read and write hot ranges (``top`` keeps the N hottest of each)
        and the per-tag rollup."""
        k = self.knobs
        bounds = dict(max_buckets=k.heatmap_max_buckets,
                      half_life_s=k.heatmap_half_life_s)
        dims = {
            "conflict": heatmap_mod.merged(
                self._role_heatmaps("commit_proxy"), name="conflict",
                decode=heatmap_mod.entry_key, **bounds),
            "read": heatmap_mod.merged(
                self._role_heatmaps("storage_read"), name="read", **bounds),
            "write": heatmap_mod.merged(
                self._role_heatmaps("storage_write"), name="write", **bounds),
        }
        return {
            "sampling": bool(k.workload_sampling) and heatmap_mod.enabled(),
            "hot_ranges": {name: hm.snapshot(top=top)
                           for name, hm in dims.items()},
            "totals": {name: {"heat": round(hm.total_heat(), 4),
                              "charges": hm.charges}
                       for name, hm in dims.items()},
            "tags": self._tag_rollup(),
        }

    def device_profile_status(self):
        """The device-path profile document: each resolver's profile and
        their aggregate, from the cluster's store (it survives
        recoveries and resizes)."""
        profs = [p for _, p in sorted(self._device_store.items())]
        return {"enabled": deviceprofile.enabled(),
                "resolvers": [p.snapshot() for p in profs],
                "aggregate": deviceprofile.merged_snapshot(profs)}

    def health_status(self):
        """The doctor's document (verdict, reasons, probes, the recovery
        timeline, lag and saturation); a pure read."""
        return health_mod.build_health(self)

    def history_status(self):
        """The metrics-history document and the flight recorder's
        summary; a pure read (no window is cut here)."""
        return self.history.status()

    def flight_status(self):
        """The flight recorder's summary and its newest artifact (None
        until a verdict change, a recovery or a probe-SLO breach)."""
        return {**self.history.recorder.summary(),
                "artifact": self.history.recorder.latest()}

    def consistency_scan_status(self):
        """The consistency scan's round, progress, volume and confirmed
        inconsistencies; a pure read."""
        return self.scanner.status()

    def set_consistency_scan(self, on):
        """Turn the scanner's module switch; the document stays
        readable, and is returned."""
        consistencyscan_mod.set_enabled(bool(on))
        return self.consistency_scan_status()

    def _trace_status(self):
        """The trace sink's per-type suppression and the tracing config
        and span gauges (process-wide)."""
        log = global_trace_log()
        return {"suppressed_events": log.suppressed_events,
                "suppressed_by_type": dict(log.suppressed_by_type),
                "tracing": self.tracing_config(),
                "spans_sampled": span_mod.spans_sampled(),
                "spans_emitted": span_mod.spans_emitted()}

    def _resolver_process(self, i, r):
        return {"id": i, "alive": r.alive,
                "backend": self.knobs.resolver_backend,
                "lanes": getattr(r, "n_lanes", 1),
                # "range": a lane fleet; "local": one lane or host
                # resolvers
                "sharding": getattr(r, "sharding", "local"),
                "metrics": r.metrics.snapshot(),
                "device": str(r.device) if r.device is not None else None,
                "graphs": r._steps.stats()}

    def status(self):
        """The status document (ref: fdbcli status json, Status.actor.cpp):
        the reference's keys at every level. The workload counters sum
        the cluster-held registries, so they survive recoveries. The
        port adds ``device`` and ``graphs`` to each resolver process."""
        rk = self.ratekeeper
        live_storages = sum(1 for s in self.storages if s.alive)
        tlog_info = {"count": 1, "live": 1, "quorum": 1, "replicated": False}
        if isinstance(self.tlog, TLogSystem):
            tlog_info = {"count": self.tlog.n, "live": self.tlog.live_count,
                         "quorum": self.tlog.quorum, "replicated": True}
        degraded = (live_storages < len(self.storages)
                    or tlog_info["live"] < tlog_info["count"]
                    or any(not r.alive for r in self.resolvers))
        hot = self.hot_ranges_status()
        return {"cluster": {
            "generation": self.generation,
            "coordinators": len(self.coordination.coordinators),
            "data": {"shards": len(self.dd.map),
                     "team_bytes": self.dd.team_bytes(),
                     "replication_factor": self.replication,
                     # a relocation copies, then flips the map, within
                     # one rebalance call: no move is ever in flight
                     "moving_data": False},
            "database_available": live_storages > 0,
            "database_lock_state": _lock_state(self.lock_uid()),
            "regions": (self.regions.status() if self.regions is not None
                        else {"configured": False}),
            "metacluster": self._metacluster_status(),
            "change_feeds": len(self.change_feeds),
            "degraded": degraded,
            "recruitments": self.recruitments,
            "qos": {
                "transactions_per_second_limit": rk.target_tps,
                "batch_transactions_per_second_limit": (
                    rk.target_tps * rk.batch_priority_fraction),
                "throttled_count": rk.throttled_count,
                "throttled_tags": rk.throttled_tags(),
                "tag_throttled_count": rk.tag_throttled_count},
            "workload": {
                "transactions": {
                    "committed": {"counter": self._sum_counter(
                        "commit_proxy", "txn_committed")},
                    "conflicted": {"counter": (
                        self._sum_counter("commit_proxy",
                                          "abort_not_committed")
                        + self._sum_counter("commit_proxy",
                                            "abort_transaction_too_old"))},
                    "started": {"counter": self._sum_counter(
                        "grv_proxy", "grv_grants")}},
                "hot_ranges": hot["hot_ranges"],
                "hot_range_totals": hot["totals"],
                "tags": hot["tags"]},
            "metrics": self.metrics_status(),
            "health": self.health_status(),
            "device": self.device_profile_status(),
            "history": self.history_status(),
            "consistency_scan": self.consistency_scan_status(),
            "trace": self._trace_status(),
            "latest_version": self.sequencer.committed_version,
            "oldest_readable_version": self.storage.oldest_version,
            "commit_pipeline": self.commit_pipeline,
            "processes": {
                "sequencer": {"alive": self.sequencer.alive},
                "commit_proxy": {
                    "alive": self._commit_target().alive,
                    "count": self.n_commit_proxies,
                    "members": [p.status() for p in self._inner_proxies()]},
                "grv_proxies": [{"id": reg.index, "metrics": reg.snapshot()}
                                for reg in self._role_registries("grv_proxy")],
                "resolvers": [
                    self._resolver_process(i, r)
                    for i, r in enumerate(self.resolvers)],
                "storage_servers": [
                    {"id": i, "alive": s.alive,
                     "durable_version": s.durable_version,
                     "oldest_version": s.oldest_version,
                     "versioned_engine": s.versioned_engine,
                     "metrics": s.status()["metrics"]}
                    for i, s in enumerate(self.storages)],
                "logs": {**tlog_info,
                         "replicas": [log.status()
                                      for log in self._tlog_replicas()]},
                "ratekeeper": rk.status(),
            },
            "resolvers": self.resolver_lanes(),
            "resolver_backend": self.knobs.resolver_backend,
            "storage_servers": len(self.storages),
        }}

    def close(self):
        """Stop the batcher and GRV threads (committing what is pending),
        release the resolvers' device history, then close the storage
        engine and the log files; later commits answer 1020 (the
        resolver is down). The prober, the history collector, the scanner
        and the region streamer stop first."""
        self.scanner.stop()
        self.prober.stop()
        self.history.stop()
        if self.regions is not None:
            self.regions.close()
        for frontend in (self.grv_proxy, self.commit_proxy):
            if hasattr(frontend, "close"):
                frontend.close()
        for r in self.resolvers:
            r.kill()
            r.release()
        for s in self.storages:
            s.engine.close()
        self.tlog.close()
