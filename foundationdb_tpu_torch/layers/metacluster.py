"""Metacluster-lite: one MANAGEMENT cluster coordinating tenants across
several DATA clusters.

Ref parity: upstream ``metacluster/`` (MetaclusterManagement.actor.cpp
and the fdbcli metacluster commands) — a management cluster holds the
registry of data clusters and the tenant→cluster assignment; tenants are
created on the least-loaded data cluster with capacity, and a tenant can
be MOVED between data clusters. This lite keeps the same shapes with the
machinery this codebase already has: assignments live in the management
cluster's system keyspace, tenant CRUD delegates to ``layers/tenant.py``
on the owning data cluster, and a move fences in-flight transactions
through the tenant-map row every TenantTransaction reads conflictingly.

Move protocol (crash-resumable; each step is one transaction):
  1. management: assignment → ``moving`` (new ``open_tenant`` calls are
     refused with retryable 2144 tenant_locked);
  2. source: DELETE the tenant-map row — every in-flight tenant txn
     conflicts with (or re-resolves and misses) the row and fails, so
     the copy that follows reads a quiesced keyspace;
  3. copy the raw prefix rows to the destination under a freshly
     created tenant there (quota + group rows ride along);
  4. source: clear the raw data;
  5. management: assignment → ``ready`` on the destination.
``resume_move`` re-drives a move found mid-flight after a crash (the
management row says which step committed last).

A copy of the JAX package's ``layers/metacluster.py`` over the port's
tenant layer. ``REGISTRATION_KEY`` is the system row that the cluster's
status document reads (``systemdata.METACLUSTER_REGISTRATION``). The
fdbcli ``metacluster`` commands wait for the port's ``tools/cli.py``.
"""

import json

from foundationdb_tpu_torch.core import systemdata
from foundationdb_tpu_torch.core.errors import FDBError, err
from foundationdb_tpu_torch.core.keys import strinc
from foundationdb_tpu_torch.layers.tenant import (
    TENANT_GROUP_PREFIX,
    TENANT_MAP_PREFIX,
    TENANT_QUOTA_PREFIX,
    Tenant,
    TenantManagement,
    tenant_tag,
)

REGISTRATION_KEY = systemdata.METACLUSTER_REGISTRATION
DATA_CLUSTER_PREFIX = b"\xff/metacluster/dataCluster/"
TENANT_ASSIGN_PREFIX = b"\xff/metacluster/tenant/"


def _assign_key(name):
    return TENANT_ASSIGN_PREFIX + name


class Metacluster:
    """The management-cluster handle (ref: MetaclusterManagement).

    ``databases`` is the connection registry: cluster name → Database —
    the lite analog of the connection strings the reference stores in
    its data-cluster metadata."""

    def __init__(self, mgmt_db):
        reg = mgmt_db.run(lambda tr: tr.get(REGISTRATION_KEY))
        if reg is None or json.loads(reg)["role"] != "management":
            raise err("invalid_metacluster_operation")
        self.db = mgmt_db
        self.databases = {}

    # ── registration (ref: metacluster create_experimental / register) ──
    @classmethod
    def create(cls, mgmt_db, name=b"meta"):
        def txn(tr):
            if tr.get(REGISTRATION_KEY) is not None:
                raise err("cluster_already_registered")
            tr.set(REGISTRATION_KEY, json.dumps(
                {"role": "management", "name": name.decode("latin-1")}
            ).encode())

        mgmt_db.run(txn)
        return cls(mgmt_db)

    def register_data_cluster(self, name, db, capacity=100):
        """A data cluster must be tenant-free and not already part of a
        metacluster (ref: registerCluster's emptiness check).

        Two transactions on two clusters cannot be atomic, so the
        registry row commits FIRST in state "registering" (mirroring
        create_tenant's state machine), the data-side mark commits
        second, and only then does the row flip to "ready". A crash in
        the window leaves a resumable "registering" row — re-calling
        register_data_cluster picks up where the crash left off instead
        of failing cluster_already_registered until an operator runs
        remove_data_cluster — and create_tenant never assigns onto a
        cluster that hasn't reached "ready". A data cluster that
        REFUSES its mark (it belongs to another metacluster) still
        rolls the row back: nothing is half-joined."""
        name = bytes(name)
        if TenantManagement.list_tenants(db):
            raise err("cluster_not_empty")

        def txn(tr):
            key = DATA_CLUSTER_PREFIX + name
            row = tr.get(key)
            if row is not None:
                meta = json.loads(row)
                # rows from before the state field are fully registered
                if meta.get("state", "ready") != "registering":
                    raise err("cluster_already_registered")
                # crashed registration: resume it (refresh capacity to
                # this call's request; tenants is still 0 — the cluster
                # was never assignable)
                meta["capacity"] = capacity
                tr.set(key, json.dumps(meta).encode())
                return
            tr.set(key, json.dumps(
                {"capacity": capacity, "tenants": 0,
                 "state": "registering"}).encode())

        self.db.run(txn)

        def mark(tr):
            reg = tr.get(REGISTRATION_KEY)
            if reg is not None:
                meta = json.loads(reg)
                if (meta.get("role") == "data" and
                        meta.get("name", "").encode("latin-1") == name):
                    return  # our own mark from a crashed attempt
                raise err("cluster_already_registered")
            tr.set(REGISTRATION_KEY, json.dumps(
                {"role": "data", "name": name.decode("latin-1")}
            ).encode())

        try:
            db.run(mark)
        except FDBError:
            # the data cluster REFUSED its mark (already part of a
            # metacluster): undo the registry row — nothing half-joined.
            # Non-FDB failures (crash/outage shapes) deliberately leave
            # the "registering" row: a retry resumes it, exactly like a
            # process crash would have.
            self.db.run(
                lambda tr: tr.clear(DATA_CLUSTER_PREFIX + name))
            raise

        def ready(tr):
            key = DATA_CLUSTER_PREFIX + name
            meta = json.loads(tr.get(key))
            meta["state"] = "ready"
            tr.set(key, json.dumps(meta).encode())

        self.db.run(ready)
        self.databases[name] = db

    def attach_data_cluster(self, name, db):
        """Re-attach an ALREADY-registered data cluster's connection in
        a fresh process (the in-memory ``databases`` registry dies with
        the process; the registration marks don't) — what makes
        ``resume_move`` actually drivable after a crash."""
        name = bytes(name)
        if self.db.run(
            lambda tr: tr.get(DATA_CLUSTER_PREFIX + name)
        ) is None:
            raise err("invalid_metacluster_operation")
        reg = db.run(lambda tr: tr.get(REGISTRATION_KEY))
        if reg is None:
            raise err("invalid_metacluster_operation")
        meta = json.loads(reg)
        if meta["role"] != "data" or \
                meta["name"].encode("latin-1") != name:
            raise err("invalid_metacluster_operation")
        self.databases[name] = db

    def remove_data_cluster(self, name):
        name = bytes(name)

        def txn(tr):
            key = DATA_CLUSTER_PREFIX + name
            meta = tr.get(key)
            if meta is None:
                raise err("invalid_metacluster_operation")
            if json.loads(meta)["tenants"]:
                raise err("cluster_not_empty")
            tr.clear(key)

        self.db.run(txn)
        db = self.databases.pop(name, None)
        if db is not None:
            db.run(lambda tr: tr.clear(REGISTRATION_KEY))

    def list_data_clusters(self):
        rows = self.db.run(lambda tr: list(tr.get_range(
            DATA_CLUSTER_PREFIX, strinc(DATA_CLUSTER_PREFIX))))
        return {
            k[len(DATA_CLUSTER_PREFIX):]: json.loads(v) for k, v in rows
        }

    # ── tenants (ref: MetaclusterTenantManagement) ──
    def _data_db(self, name):
        db = self.databases.get(name)
        if db is None:
            raise err("invalid_metacluster_operation")
        return db

    def create_tenant(self, tenant_name, group=None):
        """Assign to the least-loaded data cluster with free capacity
        (ref: the assignment choosing a cluster with available tenant
        groups), record the assignment, create on the data cluster."""
        tenant_name = bytes(tenant_name)

        def assign(tr):
            existing = tr.get(_assign_key(tenant_name))
            if existing is not None:
                prior = json.loads(existing)
                if prior["state"] == "registering":
                    # a crashed create: resume onto the recorded
                    # cluster (capacity was already consumed)
                    return prior["cluster"].encode("latin-1")
                raise err("tenant_already_exists")
            rows = list(tr.get_range(
                DATA_CLUSTER_PREFIX, strinc(DATA_CLUSTER_PREFIX)))
            best, best_meta, best_load = None, None, None
            for k, v in rows:
                meta = json.loads(v)
                if meta.get("state", "ready") != "ready":
                    # mid-registration: its data-side mark may not
                    # exist yet — never assign tenants onto it
                    continue
                if meta["tenants"] >= meta["capacity"]:
                    continue
                load = meta["tenants"] / meta["capacity"]
                if best is None or load < best_load:
                    best = k[len(DATA_CLUSTER_PREFIX):]
                    best_meta, best_load = meta, load
            if best is None:
                raise err("metacluster_no_capacity")
            best_meta["tenants"] += 1
            tr.set(DATA_CLUSTER_PREFIX + best,
                   json.dumps(best_meta).encode())
            # "registering" until the data-side create lands (ref: the
            # reference's tenant-creation state machine): a crash
            # between the two transactions is resumable by re-calling
            # create_tenant, and open_tenant refuses the half-created
            # tenant retryably instead of handing out a 2108 handle
            tr.set(_assign_key(tenant_name), json.dumps(
                {"cluster": best.decode("latin-1"),
                 "state": "registering"}
            ).encode())
            return best

        cluster = self.db.run(assign)
        try:
            TenantManagement.create_tenant(
                self._data_db(cluster), tenant_name, group=group)
        except Exception as e:
            if getattr(e, "description", "") != "tenant_already_exists":
                raise  # assignment stays "registering": resumable
        self._set_assignment(tenant_name, cluster, "ready")
        return cluster

    def delete_tenant(self, tenant_name):
        tenant_name = bytes(tenant_name)
        assignment = self._assignment(tenant_name)
        if assignment["state"] in ("moving", "copied"):
            # a mid-move tenant has TWO partial copies: deleting the
            # registry row now would leak the source rows and leave the
            # destination copy to be silently resurrected by a later
            # same-name create (round-5 review). Finish the move first.
            raise err("tenant_locked")
        cluster = assignment["cluster"].encode("latin-1")
        try:
            TenantManagement.delete_tenant(
                self._data_db(cluster), tenant_name)
        except Exception as e:
            # a crashed earlier delete already removed the data-side
            # tenant: still clear the registry so the capacity slot and
            # assignment don't leak
            if getattr(e, "description", "") != "tenant_not_found":
                raise

        def txn(tr):
            tr.clear(_assign_key(tenant_name))
            key = DATA_CLUSTER_PREFIX + cluster
            meta = json.loads(tr.get(key))
            meta["tenants"] = max(0, meta["tenants"] - 1)
            tr.set(key, json.dumps(meta).encode())

        self.db.run(txn)

    def list_tenants(self):
        rows = self.db.run(lambda tr: list(tr.get_range(
            TENANT_ASSIGN_PREFIX, strinc(TENANT_ASSIGN_PREFIX))))
        return {
            k[len(TENANT_ASSIGN_PREFIX):]: json.loads(v) for k, v in rows
        }

    def _assignment(self, tenant_name):
        raw = self.db.run(lambda tr: tr.get(_assign_key(tenant_name)))
        if raw is None:
            raise err("tenant_not_found")
        return json.loads(raw)

    def open_tenant(self, tenant_name):
        """A Tenant handle on the owning data cluster. Mid-move the
        tenant is LOCKED: retryable 2144, retry after the move lands
        (ref: tenant_locked during metacluster moves)."""
        tenant_name = bytes(tenant_name)
        assignment = self._assignment(tenant_name)
        if assignment["state"] != "ready":
            raise err("tenant_locked")
        db = self._data_db(assignment["cluster"].encode("latin-1"))
        return Tenant(db, tenant_name)

    # ── tenant move (ref: metacluster/TenantMove shapes) ──
    # State machine, persisted in the management assignment row so a
    # crashed move is resumable without data loss:
    #   ready → moving (src_prefix recorded) → copied → ready@dst
    # The source's raw rows survive until AFTER the "copied" mark, so
    # re-driving the copy step always re-reads intact data.
    def move_tenant(self, tenant_name, dst_cluster):
        tenant_name = bytes(tenant_name)
        dst_cluster = bytes(dst_cluster)
        assignment = self._assignment(tenant_name)
        src_cluster = assignment["cluster"].encode("latin-1")
        if src_cluster == dst_cluster:
            return
        if assignment["state"] != "ready":
            raise err("invalid_metacluster_operation")
        dcs = self.list_data_clusters()
        if dst_cluster not in dcs:
            raise err("invalid_metacluster_operation")
        if dcs[dst_cluster]["tenants"] >= dcs[dst_cluster]["capacity"]:
            # same invariant create_tenant enforces (ref: the upstream
            # move refusing a destination without capacity)
            raise err("metacluster_no_capacity")
        src = self._data_db(src_cluster)
        src_prefix = src.run(
            lambda tr: tr.get(TENANT_MAP_PREFIX + tenant_name))
        if src_prefix is None:
            raise err("tenant_not_found")
        # the DESTINATION persists with the state mark: a resume must
        # finish THIS move, never re-target (a dst switch mid-flight
        # would strand a full copy on the original destination)
        self._set_assignment(tenant_name, src_cluster, "moving",
                             src_prefix=src_prefix, dst=dst_cluster)
        self._drive_move(tenant_name, src_cluster, dst_cluster)

    def resume_move(self, tenant_name, dst_cluster=None):
        """Re-drive a move found mid-flight after a crash: every step
        is idempotent, and the recorded src_prefix + destination +
        state mark say where to pick up. ``dst_cluster``, if given,
        must MATCH the recorded destination."""
        tenant_name = bytes(tenant_name)
        assignment = self._assignment(tenant_name)
        if assignment["state"] not in ("moving", "copied"):
            raise err("invalid_metacluster_operation")
        recorded = assignment["dst"].encode("latin-1")
        if dst_cluster is not None and bytes(dst_cluster) != recorded:
            raise err("invalid_metacluster_operation")
        self._drive_move(
            tenant_name, assignment["cluster"].encode("latin-1"),
            recorded,
        )

    def _set_assignment(self, tenant_name, cluster, state,
                        src_prefix=None, dst=None):
        payload = {"cluster": cluster.decode("latin-1"), "state": state}
        if src_prefix is not None:
            payload["src_prefix"] = src_prefix.decode("latin-1")
        if dst is not None:
            payload["dst"] = dst.decode("latin-1")

        self.db.run(lambda tr: tr.set(
            _assign_key(tenant_name), json.dumps(payload).encode()))

    def _drive_move(self, tenant_name, src_cluster, dst_cluster):
        src = self._data_db(src_cluster)
        dst = self._data_db(dst_cluster)
        assignment = self._assignment(tenant_name)
        src_prefix = assignment["src_prefix"].encode("latin-1")

        if assignment["state"] == "moving":
            # 2. fence the source: deleting the map row makes every
            # in-flight TenantTransaction's conflicting map-read fail,
            # so the rows copied below are the tenant's final state.
            # (Idempotent: the row may already be gone on a re-drive.)
            state = {}

            def fence(tr):
                state["quota"] = tr.get(TENANT_QUOTA_PREFIX + tenant_name)
                state["group"] = tr.get(TENANT_GROUP_PREFIX + tenant_name)
                if tr.get(TENANT_MAP_PREFIX + tenant_name) is not None:
                    tr.clear(TENANT_MAP_PREFIX + tenant_name)

            src.run(fence)

            # 3. create on the destination (idempotent) + install rows
            try:
                dst_prefix = TenantManagement.create_tenant(
                    dst, tenant_name, group=state["group"])
            except Exception as e:
                if getattr(e, "description", "") != \
                        "tenant_already_exists":
                    raise
                dst_prefix = dst.run(
                    lambda tr: tr.get(TENANT_MAP_PREFIX + tenant_name))
            rows = src.run(lambda tr: list(tr.get_range(
                src_prefix, strinc(src_prefix))))

            def install(tr):
                tr.clear_range(dst_prefix, strinc(dst_prefix))
                for k, v in rows:
                    tr.set(dst_prefix + k[len(src_prefix):], v)

            dst.run(install)
            if state["quota"] is not None:
                # through the management API so the destination's LIVE
                # ratekeeper limit engages, not just the persisted row
                TenantManagement.set_tenant_quota(
                    dst, tenant_name, float(state["quota"]))
            self._set_assignment(tenant_name, src_cluster, "copied",
                                 src_prefix=src_prefix, dst=dst_cluster)

        # 4. scrub the source's raw data (+ leftover tenant rows) —
        # only after "copied" is durable at the management cluster
        def scrub(tr):
            tr.clear_range(src_prefix, strinc(src_prefix))
            tr.clear(TENANT_QUOTA_PREFIX + tenant_name)
            tr.clear(TENANT_GROUP_PREFIX + tenant_name)

        src.run(scrub)
        if hasattr(src, "_cluster"):
            # release the source's live ratekeeper limit for the tenant
            src._cluster.set_tag_quota(tenant_tag(tenant_name), None)

        # 5. flip the assignment + per-cluster tenant counts
        def finish(tr):
            tr.set(_assign_key(tenant_name), json.dumps(
                {"cluster": dst_cluster.decode("latin-1"),
                 "state": "ready"}).encode())
            for cname, delta in ((src_cluster, -1), (dst_cluster, +1)):
                key = DATA_CLUSTER_PREFIX + cname
                meta = json.loads(tr.get(key))
                meta["tenants"] = max(0, meta["tenants"] + delta)
                tr.set(key, json.dumps(meta).encode())

        self.db.run(finish)
