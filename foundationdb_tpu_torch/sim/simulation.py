"""Deterministic whole-cluster simulation with fault injection.

Ref parity: fdbrpc/sim2.actor.cpp + fdbserver/SimulatedCluster — the
whole cluster runs in one process under a seeded scheduler; workloads are
cooperative actors interleaved at yield points; BUGGIFY sites inject
faults (spurious commit_unknown_result, dropped batches, GRV rejections,
full crash/recovery); invariants are checked at the end. The same seed
replays the same history, so failures are debuggable.

Workload actors are generators: each ``yield`` is a scheduling point.
Real concurrency hazards (OCC conflicts, retry loops, fencing across
recovery) arise from the interleaving, exactly like the reference's
actor model — cooperative single-thread, adversarial schedule.

A copy of the JAX package's ``sim/simulation.py``, with two changes:

- The resolver backend is the cluster's own default, ``"cuda"`` on
  ``cuda:0`` (a ``Simulation`` raises without a card), where the
  reference's simulation defaults to its host skiplist
  (``resolver_backend="cpu"``). Pass ``resolver_backend="cpu"`` for the
  host set, or ``device="cpu"`` for the device step's plain version on
  the CPU; a same-seed run of either matches the reference's run on
  the same backend.
- A crash and ``close`` release the old incarnation's resolvers: their
  device history and captured CUDA graphs go with the cluster, and the
  next incarnation captures its steps anew.
"""

import os
import random
import tempfile

from foundationdb_tpu_torch.core import deterministic
from foundationdb_tpu_torch.core.errors import FDBError, err
from foundationdb_tpu_torch.server.cluster import Cluster
from foundationdb_tpu_torch.server.kvstore import open_engine
from foundationdb_tpu_torch.server.tlog import TLogSystem
from foundationdb_tpu_torch.sim.buggify import Buggify
from foundationdb_tpu_torch.sim.network import SimNetwork
from foundationdb_tpu_torch.utils.trace import TraceEvent


class FaultyCommitProxy:
    """Wraps the real commit proxy with BUGGIFY faults at the RPC edge
    (ref: sim2's FlowTransport-level fault injection).

    Injected faults and what they model:
      - commit_applied_then_unknown: reply lost after durability →
        commit_unknown_result with the batch actually committed.
      - commit_dropped: request lost before resolution → the batch is
        NOT committed; clients see commit_unknown_result.
    Both are legal outcomes of 1021 — clients must handle either.
    """

    def __init__(self, inner, buggify):
        self._inner = inner
        self._buggify = buggify

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def commit(self, request):
        if self._buggify("commit_dropped"):
            return err("commit_unknown_result")
        result = self._inner.commit(request)
        if not isinstance(result, FDBError) and self._buggify("commit_applied_then_unknown"):
            return err("commit_unknown_result")
        return result

    def submit(self, request):
        """Async path (BatchingCommitProxy): same two fault sites."""
        if self._buggify("commit_dropped"):
            from foundationdb_tpu_torch.server.batcher import CommitFuture

            fut = CommitFuture()
            fut.set(err("commit_unknown_result"))
            return fut
        fut = self._inner.submit(request)
        if self._buggify("commit_applied_then_unknown"):
            return _UnknownResultFuture(fut)
        return fut


class _UnknownResultFuture:
    """The batch committed (or will), but the reply was lost: the client
    sees commit_unknown_result either way — legal 1021 behavior."""

    def __init__(self, inner):
        self._inner = inner

    def done(self):
        return self._inner.done()

    def result(self, timeout=None):
        self._inner.result(timeout)  # propagate resolution ordering
        return err("commit_unknown_result")


class FaultyGrvProxy:
    def __init__(self, inner, buggify):
        self._inner = inner
        self._buggify = buggify

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def get_read_version(self, priority="default", tags=()):
        # tags passthrough (ride-along fix): without it a TAGGED sim
        # transaction would TypeError here instead of reaching the
        # ratekeeper's per-tag gate
        if self._buggify("grv_rejected"):
            raise err("process_behind")
        return self._inner.get_read_version(priority, tags=tags)


class Simulation:
    # Simulated seconds per scheduling step: the deterministic clock the
    # ratekeeper's token bucket refills from (ref: sim2's g_simulator time
    # advancing at task boundaries, never wall time).
    SIM_DT = 0.001

    def __init__(self, seed=0, buggify=True, crash_p=0.002, n_resolvers=1,
                 datadir=None, engine="memory", machines=0, corrupt_p=0.0,
                 **cluster_kwargs):
        self.seed = seed
        self.engine_kind = engine  # "memory" | "versioned" | "redwood" | "sqlite"
        self.rng = random.Random(seed)
        # silent-corruption fault arming (corrupt_replica): 0 keeps the
        # buggify site cold — existing seeds' fault schedules must not
        # shift — so chaos tests arm it explicitly, like crash_p
        self.corrupt_p = corrupt_p
        # seed the process-wide determinism registry: cluster-visible
        # entropy (proposer ids, directory HCA draws, idempotency ids,
        # cluster-file ids) replays identically for the same seed — the
        # registry is exactly the seam flowlint FL001 enforces
        deterministic.seed(seed)
        self.buggify = Buggify(seed=seed, enabled=buggify)
        self.crash_p = crash_p
        self.n_resolvers = n_resolvers
        # machines > 0 turns on the MACHINE fault model (ref: sim2's
        # machine abstraction): roles are placed onto simulated machines
        # and a reboot kills every co-located role TOGETHER + stalls the
        # network — the correlated-failure shape role-level kills can't
        # produce. 0 = role-level faults only (the historical model).
        self.n_machines = machines
        self.machine_reboots = 0
        self.cluster_kwargs = dict(cluster_kwargs)
        # alternate the commit pack path by seed (NOT an rng draw — that
        # would shift every schedule of existing seeds): half the sim
        # population commits through the flat columnar encode/wire path,
        # half through legacy, so both stay under fault injection. The
        # cpu sim backend resolves legacy either way; the flat half still
        # exercises client encode + the proxy's fallback decision.
        self.cluster_kwargs.setdefault(
            "commit_pack_path", "flat" if seed % 2 == 0 else "legacy"
        )
        self.datadir = datadir or tempfile.mkdtemp(prefix="fdbtpu-sim-")
        os.makedirs(self.datadir, exist_ok=True)
        self.recoveries = 0
        self.steps = 0
        # simulated-time skew consumed by recovery phase marks (the
        # cluster's clock_advance hook): deterministic.now() reads
        # steps*SIM_DT + skew, so phase durations are nonzero, bounded,
        # and identical under a seed — while the ratekeeper and trace
        # clocks stay on the pure step clock, leaving admission and
        # trace output of existing seeds untouched
        self.clock_skew = 0.0
        self.schedule_hash = 0  # order-sensitive digest of scheduling choices
        self._actors = []  # (name, generator)
        # message-level network (ref: sim2): workloads built on
        # net_exec/net_*_workload route every op through it; it survives
        # cluster crashes (infrastructure outlives incarnations) and
        # in-flight messages resolve against the new one via the Database
        self.net = SimNetwork(
            self.rng, self.buggify, clock=lambda: self.steps
        )
        self._build_cluster()
        self.db = self.cluster.database()

    # ───────────────────────── cluster lifecycle ──────────────────────────
    @property
    def _wal_path(self):
        return os.path.join(self.datadir, "wal")

    @property
    def _store_path(self):
        return os.path.join(self.datadir, "store")

    def _build_cluster(self):
        # deterministic traces: events are stamped with the step counter,
        # not wall time, so a seed replays byte-identical trace output
        from foundationdb_tpu_torch.utils.trace import global_trace_log

        global_trace_log().clock = lambda: self.steps
        # the registry's injected clock follows simulated time too, so
        # deterministic.now() readers replay with the schedule
        deterministic.set_clock(
            lambda: self.steps * self.SIM_DT + self.clock_skew
        )
        n_storage = self.cluster_kwargs.get("n_storage", 1)
        self.cluster = Cluster(
            wal_path=self._wal_path,
            storage_engines=[
                open_engine(self.engine_kind, f"{self._store_path}.{i}")
                for i in range(n_storage)
            ],
            n_resolvers=self.n_resolvers,
            # coordinators persist beside the WAL so crash_and_recover
            # exercises the real quorum-locking recovery path
            coordination_dir=self.datadir,
            # admission control ticks on simulated time: same seed, same
            # schedule, same throttling decisions
            rk_clock=lambda: self.steps * self.SIM_DT,
            **self.cluster_kwargs,
        )
        # recovery phase marks consume one simulated tick each: the
        # timeline's per-phase durations come out nonzero and replay
        # byte-identically under a seed
        self.cluster.clock_advance = self._advance_clock
        # the flight recorder's black-box artifacts carry WHICH buggify
        # sites the seed activated (the repro line): hand the cluster a
        # provider. Tests may swap self.buggify for a wrapper fn, so
        # the hookup is best-effort, like the SimBuggifySites event.
        sites = getattr(self.buggify, "activated_sites", None)
        if sites is not None:
            self.cluster.buggify_sites = sites
        self.cluster.commit_proxy = FaultyCommitProxy(
            self.cluster.commit_proxy, self.buggify
        )
        self.cluster.grv_proxy = FaultyGrvProxy(self.cluster.grv_proxy, self.buggify)
        # resolved once per incarnation: the scheduler pumps manual-mode
        # batching every step, and a per-step hasattr through the fault
        # wrapper's __getattr__ would pay an exception per miss
        self._pump = getattr(self.cluster.commit_proxy, "pump", None)

    def _advance_clock(self):
        self.clock_skew += self.SIM_DT

    def crash_and_recover(self):
        """Kill the cluster (losing all volatile state) and restart from
        the engine snapshot + WAL. In-flight transactions keep their old
        read versions and get fenced by the recovered resolver window."""
        if hasattr(self.cluster.commit_proxy, "fail_pending"):
            # queued-but-unbatched commits die with the proxy: clients
            # must see 1021, never hang on an orphaned future
            self.cluster.commit_proxy.fail_pending(
                err("commit_unknown_result")
            )
        self.cluster.commit_proxy.close()
        if self.cluster.regions is not None:
            # the satellite WAL handle must flush before the rebuilt
            # cluster's restored region config truncates and re-seeds it
            self.cluster.regions.close()
        self._close_roles()
        old_db = self.db
        self._build_cluster()
        # the Database handle survives; transactions resolve the cluster
        # through it, so in-flight txns now talk to the new incarnation
        old_db._cluster = self.cluster
        self.db = old_db
        self.recoveries += 1

    # ─────────────────────────── scheduling ───────────────────────────────
    def add_workload(self, name, gen):
        """gen: a generator object; each ``yield`` is a scheduling point."""
        self._actors.append((name, gen))

    def run(self, max_steps=1_000_000):
        """Interleave all actors to completion under the seeded schedule."""
        live = list(self._actors)
        while live:
            self.steps += 1
            if self.steps > max_steps:
                raise RuntimeError(f"simulation exceeded {max_steps} steps")
            if self.crash_p and self.buggify("cluster_crash", fire_p=self.crash_p):
                self.crash_and_recover()
            self._maybe_fault_roles()
            if self.n_machines:
                self._maybe_reboot_machine()
            if self.net.pending and self.buggify("net_partition", fire_p=0.0015):
                self.net.partition(self.rng.randint(5, 30))
            self.net.deliver_due(self.steps)
            i = self.rng.randrange(len(live))
            self.schedule_hash = (self.schedule_hash * 1000003 + i) & (2**64 - 1)
            name, gen = live[i]
            try:
                next(gen)
            except StopIteration:
                live.pop(i)
            # manual-mode batching: the scheduler is the batch clock
            # (deterministic analog of the proxy's commit interval)
            if self._pump is not None:
                self._pump(self.steps)
            # continuous region streamer: the sim scheduler drives the
            # satellite drain exactly where a thread deployment's
            # daemon loop would — cadence off the injected clock + the
            # "region-stream" deterministic stream, so same-seed runs
            # replicate at the same steps
            reg = self.cluster.regions
            if reg is not None:
                reg.maybe_stream()
            # metrics history: the sim scheduler drives the collector's
            # fixed-cadence windows exactly where a thread deployment's
            # daemon loop would — cadence off the injected clock + the
            # "history-cadence" deterministic stream, so same-seed runs
            # cut identical windows (and the flight recorder dumps
            # identical artifacts)
            self.cluster.history.maybe_collect()
            # continuous consistency scan: the sim scheduler drives the
            # bounded-batch auditor exactly where a thread deployment's
            # daemon loop would — cadence off the injected clock + the
            # "consistency-scan" deterministic stream, so same-seed
            # runs compare identical batches at identical steps
            self.cluster.scanner.maybe_scan()
            # buggify-keyed silent-corruption fault: flip one byte in
            # one replica's engine; the scan must catch it within a
            # round (chaos tests arm the site via corrupt_p)
            if self.corrupt_p and self.buggify(
                "corrupt_replica", fire_p=self.corrupt_p
            ):
                self.corrupt_replica()
        self._actors = []
        # surface WHICH buggify sites this seed activated: a failing
        # seed's repro starts from this line (and a same-seed rerun
        # must print the identical list — activation is seed-keyed).
        # Tests may swap self.buggify for a plain boosting wrapper fn;
        # the activation list is best-effort then, not an attribute err
        sites = getattr(self.buggify, "activated_sites", None)
        TraceEvent("SimBuggifySites").detail(
            seed=self.seed, steps=self.steps,
            activated=",".join(sites()) if sites else "(wrapped)",
        ).log()

    # steps between failure-monitor rounds: kills stay undetected for a
    # window, so clients really do hit (and retry through) dead roles
    MONITOR_EVERY = 7

    def _maybe_fault_roles(self):
        """Role-level fault sites (ref: sim2 killing individual
        processes, not whole clusters):

        - tlog replica kill — never below the ack quorum, so the cluster
          keeps committing on a degraded log tier;
        - storage kill — only when every shard it owns has another live
          owner, so recruitment can re-replicate (a real deployment's
          minimum-replication constraint);
        - resolver kill — any time; recruitment fences the old epoch.

        The failure monitor (cluster.detect_and_recruit) runs every
        MONITOR_EVERY steps; between death and detection clients see
        retryable errors and ride them out.
        """
        c = self.cluster
        tl = c.tlog
        self.role_kills = getattr(self, "role_kills", 0)
        self.tlog_kills = getattr(self, "tlog_kills", 0)
        if isinstance(tl, TLogSystem):
            if tl.live_count > tl.quorum and self.buggify("tlog_kill", fire_p=0.004):
                live = [i for i, l in enumerate(tl.logs) if l.alive]
                tl.kill(self.rng.choice(live))
                self.tlog_kills += 1
            dead = [i for i, l in enumerate(tl.logs) if not l.alive]
            if dead and self.buggify("tlog_revive", fire_p=0.01):
                tl.revive(self.rng.choice(dead))
        if len(c.storages) > 1 and self.buggify("storage_kill", fire_p=0.003):
            victims = [
                sid for sid, s in enumerate(c.storages)
                if s.alive and self._storage_killable(sid)
            ]
            if victims:
                c.storages[self.rng.choice(victims)].kill()
                self.role_kills += 1
        if self.buggify("resolver_kill", fire_p=0.002):
            live = [i for i, r in enumerate(c.resolvers) if r.alive]
            if live:
                c.resolvers[self.rng.choice(live)].kill()
                self.role_kills += 1
        # txn-system kills: a dead sequencer/proxy forces a full
        # recovery generation (resolvers fenced, storage untouched);
        # clients see 1021/1037 until the monitor's next round
        if self.buggify("proxy_kill", fire_p=0.0015):
            target = c._commit_target()
            if target.alive:
                target.kill()
                self.role_kills += 1
        if self.buggify("sequencer_kill", fire_p=0.001):
            if c.sequencer.alive:
                c.sequencer.kill()
                self.role_kills += 1
        if self.steps % self.MONITOR_EVERY == 0:
            events = c.detect_and_recruit()
            if any(role in ("txn-system", "region-failover")
                   for role, _ in events):
                # recovery recruited bare proxies: restore the sim's
                # fault-injection wrappers around the new incarnation
                # (and re-cache the manual-mode pump — the old one
                # would pump a dead batcher, stalling queued commits)
                c.commit_proxy = FaultyCommitProxy(
                    c.commit_proxy, self.buggify
                )
                c.grv_proxy = FaultyGrvProxy(c.grv_proxy, self.buggify)
                self._pump = getattr(c.commit_proxy, "pump", None)

    # ───────────────────── machine fault model ────────────────────────
    # Ref: fdbrpc/sim2.actor.cpp — the simulator models MACHINES hosting
    # several processes; killMachine takes every co-located role down in
    # one event and the machine's network stalls. Placement is offset
    # round-robin so a machine loss pairs DIFFERENT storage/tlog/
    # resolver indices (the correlated shapes a rack failure produces);
    # the txn-system roles (sequencer + commit proxy) live on machine 0.
    def machine_roles(self, mid):
        """(storages, tlog_replicas, resolvers, has_txn_system) hosted
        on machine ``mid`` under the current cluster incarnation."""
        c = self.cluster
        n = self.n_machines
        storages = [sid for sid in range(len(c.storages)) if sid % n == mid]
        tlogs = []
        if isinstance(c.tlog, TLogSystem):
            tlogs = [i for i in range(len(c.tlog.logs))
                     if (i + 1) % n == mid]
        resolvers = [i for i in range(len(c.resolvers)) if i % n == mid]
        return storages, tlogs, resolvers, mid == 0

    def _machine_killable(self, mid):
        """A reboot may not make the cluster unrecoverable: the log must
        keep its ack quorum OUTSIDE the machine, and every shard owned
        by a machine-hosted storage needs a live owner elsewhere (ref:
        sim2's canKillProcesses protection sets)."""
        c = self.cluster
        storages, tlogs, _, _ = self.machine_roles(mid)
        if isinstance(c.tlog, TLogSystem) and tlogs:
            surviving = sum(
                1 for i, log in enumerate(c.tlog.logs)
                if log.alive and i not in tlogs
            )
            if surviving < c.tlog.quorum:
                return False
        for sid in storages:
            if not c.storages[sid].alive:
                continue
            for team in c.dd.map.teams:
                if sid in team and not any(
                    t not in storages and c.storages[t].alive
                    for t in team
                ):
                    return False
        return True

    def reboot_machine(self, mid):
        """Kill every role the machine hosts, in one event, and stall
        the network briefly (its peers see timeouts while it boots).
        Recovery is the ordinary failure-monitor path: storages reboot
        onto their durable engines and replay the log, tlog replicas
        revive, resolvers respawn fenced, and a machine-0 loss forces a
        full txn-system recovery generation."""
        c = self.cluster
        storages, tlogs, resolvers, txn_system = self.machine_roles(mid)
        for sid in storages:
            if c.storages[sid].alive:
                c.storages[sid].kill()
        for i in tlogs:
            if c.tlog.logs[i].alive:
                c.tlog.kill(i)
        for i in resolvers:
            if c.resolvers[i].alive:
                c.resolvers[i].kill()
        if txn_system:
            if c.sequencer.alive:
                c.sequencer.kill()
            target = c._commit_target()
            if target.alive:
                target.kill()
        if self.net.pending:
            self.net.partition(self.rng.randint(3, 12))
        self.machine_reboots += 1
        TraceEvent("SimMachineReboot").detail(
            machine=mid, storages=storages, tlogs=tlogs,
            resolvers=resolvers, txn_system=txn_system).log()

    def kill_primary_region(self):
        """Regional disaster: every primary-region process dies in ONE
        event — the whole storage fleet, every tlog replica, the
        resolvers, and the txn system (ref: sim2 killing an entire
        datacenter). Deliberately ignores the killability protection
        sets: a region loss IS the unrecoverable-locally scenario. The
        failure monitor's next round detects whole-region loss and
        promotes the remote region (Cluster._region_failover); without
        a region config the cluster simply stays down."""
        c = self.cluster
        for s in c.storages:
            if s.alive:
                s.kill()
        if isinstance(c.tlog, TLogSystem):
            for i, log in enumerate(c.tlog.logs):
                if log.alive:
                    c.tlog.kill(i)
        else:
            c.tlog.kill()
        for r in c.resolvers:
            if r.alive:
                r.kill()
        if c.sequencer.alive:
            c.sequencer.kill()
        target = c._commit_target()
        if target.alive:
            target.kill()
        if self.net.pending:
            self.net.partition(self.rng.randint(3, 12))
        TraceEvent("SimRegionKill", severity=30).detail(
            step=self.steps,
            region=(c.regions.config.primary
                    if c.regions is not None else None)).log()

    def corrupt_replica(self):
        """Sim-only silent-corruption fault (ref: sim2's BUGGIFY disk
        corruption): flip one byte of one live key's value in exactly
        ONE replica's engine — below the storage server's overlay, via
        the engine's own write op, so it works on every engine kind
        (memory, sqlite, versioned, redwood) and survives a restart
        like real bit rot would. Only a shard with >=2 live replicas is
        eligible (a lone replica has nothing to diverge from). Returns
        (sid, key) or None if no eligible replica/key exists."""
        c = self.cluster
        smap = c.dd.map
        shard_order = list(range(len(smap)))
        self.rng.shuffle(shard_order)
        for i in shard_order:
            begin, end = smap.shard_range(i)
            end = b"\xff" if end is None or end > b"\xff" else end
            if begin >= end:
                continue  # user keys only: system rows self-heal on replay
            team = [sid for sid in smap.teams[i]
                    if 0 <= sid < len(c.storages) and c.storages[sid].alive]
            if len(team) < 2:
                continue
            sid = team[self.rng.randrange(len(team))]
            eng = c.storages[sid].engine
            rows = [(k, v) for k, v in eng.get_range(begin, end, limit=32)
                    if v]
            if not rows:
                continue
            key, value = rows[self.rng.randrange(len(rows))]
            eng.set(key, bytes([value[0] ^ 0x01]) + value[1:])
            TraceEvent("SimCorruptReplica", severity=30).detail(
                step=self.steps, storage=sid, key=key[:40]).log()
            return sid, key
        return None

    def _maybe_reboot_machine(self):
        if not self.buggify("machine_reboot", fire_p=0.0015):
            return
        victims = [m for m in range(self.n_machines)
                   if self._machine_killable(m)]
        if victims:
            self.reboot_machine(self.rng.choice(victims))

    def _storage_killable(self, sid):
        """Every shard sid owns must keep one other live owner."""
        c = self.cluster
        for team in c.dd.map.teams:
            if sid in team and not any(
                t != sid and c.storages[t].alive for t in team
            ):
                return False
        return True

    def metrics_snapshot(self):
        """The cluster's aggregated metrics section at the current step.
        Under one seed this is BYTE-IDENTICAL across runs: registry
        timestamps come off the sim's step clock and the reservoirs draw
        from the seeded ``metrics-reservoir`` stream (the determinism
        test diffs two same-seed sims' snapshots)."""
        return self.cluster.status()["cluster"]["metrics"]

    def quiesce(self):
        """Flush storage so everything is durable (end-of-run barrier);
        recruit any still-dead roles first so the final checks read a
        healed cluster."""
        self.cluster.detect_and_recruit()
        if hasattr(self.cluster.commit_proxy, "flush"):
            self.cluster.commit_proxy.flush()
        for s in self.cluster.storages:
            s.flush()

    def close(self):
        """Close WAL/engine handles (the datadir itself is left for
        inspection; callers own its lifetime)."""
        self.cluster.commit_proxy.close()
        if self.cluster.regions is not None:
            self.cluster.regions.close()
        self._close_roles()
        # restore the wall clock: leaving the step clock injected would
        # freeze every LATER (non-sim) cluster's metric spans at this
        # sim's final step (durations measured as now()-now() = 0)
        deterministic.registry().reset_clock()

    def _close_roles(self):
        """Close the incarnation's engines and log, and release its
        resolvers' device history and compiled steps."""
        for s in self.cluster.storages:
            s.engine.close()
        self.cluster.tlog.close()
        for r in self.cluster.resolvers:
            r.kill()
            r.release()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
