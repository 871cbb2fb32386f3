"""Tenants: named, prefix-isolated keyspaces.

Ref parity: fdbclient/Tenant.h + TenantManagement.actor.h behavior — a
tenant is a name mapped to a short unique prefix; transactions opened on
a tenant see only their prefixed keyspace, with keys transparently
translated at the API boundary. Metadata lives in the system keyspace at
``\\xff/tenant/map/<name>`` (value = prefix, tuple-encoded id).

Around the isolation, the reference's management surface:
- **tenant modes** (ref: TenantMode): ``optional`` (default), ``required``
  (non-tenant transactions may not touch user keys — 2130), ``disabled``
  (tenant-prefixed writes rejected — 2134); enforced structurally at the
  commit proxy by key prefix and persisted in ``\\xff/conf/tenant_mode``.
- **tenant quotas** (ref: the tenant quota system enforced through tag
  throttling): every tenant transaction auto-tags itself with a
  per-tenant transaction tag, so ``set_tenant_quota`` is exactly a
  ratekeeper tag quota — over-quota tenants see retryable 1213 while
  other tenants run at full rate. Quotas persist in
  ``\\xff/tenant/quota/<name>`` and are re-applied at recovery.
- **tenant groups** (ref: tenant groups in TenantMetadata): an optional
  label stored at ``\\xff/tenant/group/<name>`` for listing/placement.
"""

import hashlib

from foundationdb_tpu_torch.core.errors import err
from foundationdb_tpu_torch.core.keys import strinc
from foundationdb_tpu_torch.layers import tuple as fdbtuple
from foundationdb_tpu_torch.txn.database import retry_loop

TENANT_MAP_PREFIX = b"\xff/tenant/map/"
TENANT_ID_KEY = b"\xff/tenant/idcounter"
TENANT_DATA_PREFIX = b"\xfd"  # tenant content lives under \xfd<id>
TENANT_QUOTA_PREFIX = b"\xff/tenant/quota/"
TENANT_GROUP_PREFIX = b"\xff/tenant/group/"
TENANT_MODE_KEY = b"\xff/conf/tenant_mode"
TENANT_MODES = ("optional", "required", "disabled")


def tenant_tag(name):
    """The per-tenant transaction tag (stable, ≤16 bytes): quotas and
    busy-tenant throttling ride the ordinary tag throttler."""
    return "t/" + hashlib.sha256(bytes(name)).hexdigest()[:12]


class TenantManagement:
    """Static tenant CRUD (ref: TenantAPI in fdbclient)."""

    @staticmethod
    def create_tenant(db, name, group=None):
        name = bytes(name)
        if not name or name.startswith(b"\xff"):
            raise ValueError("tenant names must be non-empty and not start with \\xff")

        def txn(tr):
            # read the mode INSIDE the create txn: the conflicting read
            # serializes against a concurrent set_tenant_mode (no TOCTOU)
            if (tr.get(TENANT_MODE_KEY) or b"optional") == b"disabled":
                raise err("tenants_disabled")
            key = TENANT_MAP_PREFIX + name
            if tr.get(key) is not None:
                raise err("tenant_already_exists")
            raw = tr.get(TENANT_ID_KEY)
            tid = int.from_bytes(raw, "big") if raw else 0
            tr.set(TENANT_ID_KEY, (tid + 1).to_bytes(8, "big"))
            prefix = TENANT_DATA_PREFIX + fdbtuple.pack((tid,))
            tr.set(key, prefix)
            if group is not None:
                tr.set(TENANT_GROUP_PREFIX + name, bytes(group))
            return prefix

        return db.run(txn)

    @staticmethod
    def delete_tenant(db, name):
        name = bytes(name)

        def txn(tr):
            key = TENANT_MAP_PREFIX + name
            prefix = tr.get(key)
            if prefix is None:
                raise err("tenant_not_found")
            if tr.get_range(prefix, strinc(prefix), limit=1):
                raise err("tenant_not_empty")
            tr.clear(key)
            tr.clear(TENANT_GROUP_PREFIX + name)
            tr.clear(TENANT_QUOTA_PREFIX + name)

        db.run(txn)
        db._cluster.set_tag_quota(tenant_tag(name), None)

    @staticmethod
    def list_tenants(db, begin=b"", end=b"\xff", limit=0):
        def txn(tr):
            b = TENANT_MAP_PREFIX + bytes(begin)
            e = TENANT_MAP_PREFIX + bytes(end)
            return [
                (k[len(TENANT_MAP_PREFIX):], v)
                for k, v in tr.get_range(b, e, limit=limit)
            ]

        return db.run(txn)

    # ── modes (ref: TenantMode in DatabaseConfiguration) ──
    @staticmethod
    def set_tenant_mode(db, mode):
        if mode not in TENANT_MODES:
            raise err("invalid_option_value")

        def txn(tr):
            tr.set(TENANT_MODE_KEY, mode.encode())

        db.run(txn)
        db._cluster.set_tenant_mode(mode)  # live proxy enforcement

    @staticmethod
    def get_tenant_mode(db):
        raw = db.run(lambda tr: tr.get(TENANT_MODE_KEY))
        return raw.decode() if raw else "optional"

    # ── quotas (ref: the tenant quota keyspace + tag throttling) ──
    @staticmethod
    def set_tenant_quota(db, name, tps):
        """Per-tenant transaction rate limit; ``tps=None`` clears.
        Enforced by the ratekeeper's tag throttler against the tenant's
        auto-tag: over-quota tenant transactions see retryable 1213."""
        name = bytes(name)

        def txn(tr):
            if tr.get(TENANT_MAP_PREFIX + name) is None:
                raise err("tenant_not_found")
            if tps is None:
                tr.clear(TENANT_QUOTA_PREFIX + name)
            else:
                tr.set(TENANT_QUOTA_PREFIX + name, str(float(tps)).encode())

        db.run(txn)
        db._cluster.set_tag_quota(tenant_tag(name), tps)

    @staticmethod
    def get_tenant_quota(db, name):
        raw = db.run(lambda tr: tr.get(TENANT_QUOTA_PREFIX + bytes(name)))
        return float(raw) if raw else None

    # ── groups (ref: tenant groups in TenantMetadata) ──
    @staticmethod
    def get_tenant_group(db, name):
        return db.run(lambda tr: tr.get(TENANT_GROUP_PREFIX + bytes(name)))

    @staticmethod
    def list_tenant_groups(db):
        """{group: [tenant names]} for every grouped tenant."""
        rows = db.run(lambda tr: list(tr.get_range(
            TENANT_GROUP_PREFIX, strinc(TENANT_GROUP_PREFIX))))
        out = {}
        for k, g in rows:
            out.setdefault(g, []).append(k[len(TENANT_GROUP_PREFIX):])
        return out


class Tenant:
    """Handle to one tenant's keyspace (ref: Tenant in NativeAPI).

    The name→prefix mapping is resolved inside each transaction with a
    conflicting read of the tenant-map key, so a handle that outlives
    delete_tenant (or a delete+recreate) can never commit into a stale
    prefix — the map read either fails (tenant_not_found) or serializes
    against the management transaction."""

    def __init__(self, db, name):
        self._db = db
        self.name = bytes(name)

    def create_transaction(self):
        return TenantTransaction(self._db.create_transaction(), self.name)

    def run(self, fn):
        return retry_loop(self.create_transaction(), fn)

    transact = run

    def get(self, key):
        return self.run(lambda tr: tr.get(key))

    def set(self, key, value):
        self.run(lambda tr: tr.set(key, value))

    def clear(self, key):
        self.run(lambda tr: tr.clear(key))

    def get_range(self, begin, end, **kw):
        return self.run(lambda tr: tr.get_range(begin, end, **kw))

    def __getitem__(self, key):
        if isinstance(key, slice):
            return self.get_range(key.start, key.stop)
        return self.get(key)

    def __setitem__(self, key, value):
        self.set(key, value)


class TenantTransaction:
    """Key-translating view over a Transaction: user keys get the tenant
    prefix on the way in and lose it on the way out."""

    def __init__(self, tr, name):
        self._tr = tr
        self._name = name
        self._prefix = None  # resolved on first use, per txn attempt
        self.options = tr.options
        # auto-tag: quotas and busy-tenant throttling ride the ordinary
        # tag throttler (ref: tenant quotas enforced via tag throttling)
        self.options.set_tag(tenant_tag(name))

    @property
    def _p(self):
        if self._prefix is None:
            prefix = self._tr.get(TENANT_MAP_PREFIX + self._name)
            if prefix is None:
                raise err("tenant_not_found")
            self._prefix = prefix
        return self._prefix

    def _in(self, key):
        key = bytes(key)
        if key.startswith(b"\xff"):
            # system keys are not addressable through a tenant; allowing
            # them would also make the key invisible to full-range scans
            raise err("key_outside_legal_range")
        return self._p + key

    def _out(self, key):
        return bytes(key)[len(self._p):]

    def _in_end(self, key):
        """Exclusive end bound: clamp system-space ends to the tenant's
        upper edge instead of rejecting (an end bound is never accessed,
        and b'' .. b'\\xff' is the standard full-scan idiom)."""
        key = bytes(key)
        if key.startswith(b"\xff"):
            return strinc(self._p)
        return self._p + key

    def _range(self, begin, end):
        b = self._p if begin is None else self._in(begin)
        e = strinc(self._p) if end is None else self._in_end(end)
        return b, e

    # reads
    def get(self, key, snapshot=False):
        return self._tr.get(self._in(key), snapshot=snapshot)

    def get_range(self, begin, end, **kw):
        b, e = self._range(begin, end)
        return [(self._out(k), v) for k, v in self._tr.get_range(b, e, **kw)]

    def get_range_startswith(self, prefix, **kw):
        prefix = bytes(prefix)
        return self.get_range(prefix or None, strinc(prefix) if prefix else None, **kw)

    def get_read_version(self):
        return self._tr.get_read_version()

    def get_committed_version(self):
        return self._tr.get_committed_version()

    @property
    def snapshot(self):
        return _TenantSnapshot(self)

    # writes
    def set(self, key, value):
        self._tr.set(self._in(key), value)

    def clear(self, key):
        self._tr.clear(self._in(key))

    def clear_range(self, begin, end):
        b, e = self._range(begin, end)
        self._tr.clear_range(b, e)

    def add(self, key, param):
        self._tr.add(self._in(key), param)

    def min(self, key, param):
        self._tr.min(self._in(key), param)

    def max(self, key, param):
        self._tr.max(self._in(key), param)

    def byte_min(self, key, param):
        self._tr.byte_min(self._in(key), param)

    def byte_max(self, key, param):
        self._tr.byte_max(self._in(key), param)

    def bit_and(self, key, param):
        self._tr.bit_and(self._in(key), param)

    def bit_or(self, key, param):
        self._tr.bit_or(self._in(key), param)

    def bit_xor(self, key, param):
        self._tr.bit_xor(self._in(key), param)

    def compare_and_clear(self, key, param):
        self._tr.compare_and_clear(self._in(key), param)

    def append_if_fits(self, key, param):
        self._tr.append_if_fits(self._in(key), param)

    def add_read_conflict_key(self, key):
        self._tr.add_read_conflict_key(self._in(key))

    def add_write_conflict_key(self, key):
        self._tr.add_write_conflict_key(self._in(key))

    def add_read_conflict_range(self, begin, end):
        self._tr.add_read_conflict_range(self._in(begin), self._in_end(end))

    def add_write_conflict_range(self, begin, end):
        self._tr.add_write_conflict_range(self._in(begin), self._in_end(end))

    def watch(self, key):
        return self._tr.watch(self._in(key))

    # lifecycle
    def commit(self):
        self._tr.commit()

    def on_error(self, e):
        self._tr.on_error(e)
        self._prefix = None  # re-resolve after reset (mapping may change)
        self.options.set_tag(tenant_tag(self._name))  # reset drops tags

    def reset(self):
        self._tr.reset()
        self._prefix = None
        self.options.set_tag(tenant_tag(self._name))

    def cancel(self):
        self._tr.cancel()

    def __getitem__(self, key):
        if isinstance(key, slice):
            return self.get_range(key.start, key.stop)
        return self.get(key)

    def __setitem__(self, key, value):
        self.set(key, value)

    def __delitem__(self, key):
        if isinstance(key, slice):
            self.clear_range(key.start, key.stop)
        else:
            self.clear(key)


class _TenantSnapshot:
    def __init__(self, ttr):
        self._ttr = ttr

    def get(self, key):
        return self._ttr.get(key, snapshot=True)

    def get_range(self, begin, end, **kw):
        kw["snapshot"] = True
        return self._ttr.get_range(begin, end, **kw)
