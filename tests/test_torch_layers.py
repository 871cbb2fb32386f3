"""The layers of the port against the JAX package's, at tolerance 0: the
tuple encoding (``pack`` bytes equal on seeded random tuples, unpack,
ranges, versionstamped packs), subspaces, the directory layer with
partitions and the high-contention allocator on the seeded
"directory-hca" stream, and tenants (isolation, the management errors,
the modes' 2130 / 2134, a quota's 1213 for its tenant only, groups, and
the mode and quotas surviving a restart from the WAL and a region
failover).
"""

import os
import random
import struct
import uuid

import pytest

from foundationdb_tpu.core.versions import Versionstamp as JVersionstamp
from foundationdb_tpu_torch.core.versions import Versionstamp as TVersionstamp
from tests.conftest import TEST_KNOBS
from tests.torch_sides import JAX, PORT, outcome, rows

VERSIONSTAMP = {"jax": JVersionstamp, "port": TVersionstamp}


def _element(side, rng, depth=0):
    choices = ["null", "bytes", "str", "int", "float", "single", "bool",
               "uuid", "vs"]
    if depth < 2:
        choices.append("nested")
    kind = rng.choice(choices)
    if kind == "null":
        return None
    if kind == "bytes":
        return bytes(rng.randrange(256) for _ in range(rng.randrange(0, 12)))
    if kind == "str":
        return "".join(rng.choice("aé中\x01z0\x00")
                       for _ in range(rng.randrange(0, 8)))
    if kind == "int":
        mag = rng.choice([0, 1, 255, 256, 2**31, 2**63, 2**70, 2**2000])
        v = rng.randrange(mag + 1) if mag else 0
        return -v if rng.random() < 0.5 else v
    if kind == "float":
        return rng.choice([0.0, -0.0, 1.5, -2.25, 1e300, -1e-300,
                           float("inf"), float("-inf")])
    if kind == "single":
        return side.tuple.SingleFloat(rng.choice([0.5, -3.0, 1e30]))
    if kind == "bool":
        return rng.random() < 0.5
    if kind == "uuid":
        return uuid.UUID(bytes=bytes(rng.randrange(256) for _ in range(16)))
    if kind == "vs":
        return VERSIONSTAMP[side.name].from_version(
            rng.randrange(2**40), rng.randrange(2**16),
            rng.randrange(2**16))
    return tuple(_element(side, rng, depth + 1)
                 for _ in range(rng.randrange(0, 3)))


def _tuples(side, seed, n=300):
    rng = random.Random(seed)
    return [tuple(_element(side, rng) for _ in range(rng.randrange(0, 5)))
            for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tuple_pack_bytes_match_jax(seed):
    jt, tt = _tuples(JAX, seed), _tuples(PORT, seed)
    jp = [JAX.tuple.pack(t) for t in jt]
    tp = [PORT.tuple.pack(t) for t in tt]
    assert tp == jp
    # unpack inverts, and the order of the bytes is the order of both
    assert [PORT.tuple.unpack(b) for b in tp] == tt
    assert sorted(range(len(tp)), key=tp.__getitem__) == \
        sorted(range(len(jp)), key=jp.__getitem__)
    prefix = b"P\x00x"
    assert [PORT.tuple.pack(t, prefix=prefix) for t in tt] == \
        [JAX.tuple.pack(t, prefix=prefix) for t in jt]
    assert [PORT.tuple.range(t[:2], prefix=prefix) for t in tt] == \
        [JAX.tuple.range(t[:2], prefix=prefix) for t in jt]


def _versionstamp_packs(side):
    vs = VERSIONSTAMP[side.name]()
    t = side.tuple
    packed = t.pack_with_versionstamp(("k", vs, 7), prefix=b"PP")
    offset = struct.unpack("<I", packed[-4:])[0]
    return [packed, packed[offset:offset + 10],
            t.has_incomplete_versionstamp(("a", (vs,))),
            t.has_incomplete_versionstamp(("a",)),
            outcome(side, lambda: _raises(
                lambda: t.pack_with_versionstamp(("k", vs, vs)))),
            outcome(side, lambda: _raises(
                lambda: t.pack_with_versionstamp(("k",)))),
            t.pack(((None, b"\x00", None),)), t.pack(((None,),))]


def _raises(fn):
    try:
        fn()
    except ValueError:
        return "ValueError"
    return "no error"


def test_tuple_versionstamps_match_jax():
    got = _versionstamp_packs(PORT)
    assert got == _versionstamp_packs(JAX)
    assert got[1] == b"\xff" * 10 and got[4][1] == got[5][1] == "ValueError"


def _subspaces(side):
    S = side.subspace.Subspace
    s = S(("users",))
    nested = s["prefs"]
    key = s.pack((42, "bob"))
    return [s.key(), key, s.unpack(key), s.contains(key), nested.raw_prefix,
            nested.unpack(nested.pack((1,))), s.range((1,)),
            S(raw_prefix=b"\x02raw").pack((b"x", None)),
            s.subspace(("a", 2)).key(), s == S(("users",)),
            _raises(lambda: s.unpack(b"elsewhere"))]


def test_subspace_matches_jax():
    got = _subspaces(PORT)
    assert got == _subspaces(JAX)
    assert got[2] == (42, "bob") and got[-1] == "ValueError"


# ── the directory layer on a database ───────────────────────────────
def _db(side, **kw):
    c = side.cluster(**dict(TEST_KNOBS, resolver_backend="cpu", **kw))
    return c, c.database()


def _directories(side):
    side.deterministic.seed(5)
    c, db = _db(side)
    dl = side.directory.DirectoryLayer()
    out = []
    try:
        app = db.run(lambda tr: dl.create_or_open(tr, ("app",)))
        users = db.run(lambda tr: dl.create_or_open(tr, ("app", "users")))
        out += [app.key(), users.key(), users.get_path(),
                db.run(lambda tr: dl.list(tr, ("app",))),
                db.run(lambda tr: dl.exists(tr, ("nope",)))]
        db.run(lambda tr: dl.create(tr, ("q",), layer=b"queue"))
        out.append(db.run(lambda tr: dl.open(tr, ("q",),
                                             layer=b"queue")).get_layer())
        out.append(_raises(lambda: db.run(
            lambda tr: dl.open(tr, ("q",), layer=b"other"))))
        out.append(_raises(lambda: db.run(lambda tr: dl.create(tr, ("q",)))))
        d = db.run(lambda tr: dl.create(tr, ("old", "leaf")))
        db.set(d.pack(("k",)), b"v")
        moved = db.run(lambda tr: dl.move(tr, ("old", "leaf"), ("new",)))
        out += [moved.key() == d.key(), db.get(moved.pack(("k",))),
                db.run(lambda tr: dl.remove(tr, ("new",))),
                db.get(moved.pack(("k",))),
                db.run(lambda tr: dl.remove_if_exists(tr, ("new",)))]
        # the allocator: 40 prefixes drawn from the seeded stream
        dirs = [db.run(lambda tr, i=i: dl.create(tr, (f"d{i}",)))
                for i in range(40)]
        out.append([x.key() for x in dirs])

        def parts(tr):
            part = dl.create(tr, "tenant-a", layer=b"partition")
            inner = part.create_or_open(tr, "table")
            tr.set(inner.pack((1,)), b"row")
            nested = part.create_or_open(tr, "q", layer=b"partition")
            return part, inner, nested

        part, inner, nested = db.run(parts)
        out += [repr(part), part.raw_prefix, inner.raw_prefix,
                nested.raw_prefix, db.run(lambda tr: part.list(tr)),
                db.run(lambda tr: dl.list(tr))[:3],
                db.run(lambda tr: dl.open(tr, ("tenant-a", "table"))).key(),
                _raises(lambda: part.pack((1,)))]
        db.run(lambda tr: nested.move_to(tr, ("q2",)))
        out.append(db.run(lambda tr: part.list(tr)))
        out.append(_raises(lambda: db.run(
            lambda tr: dl.move(tr, ("tenant-a", "table"), ("out",)))))
        db.run(lambda tr: part.remove(tr))
        out += [db.get(inner.pack((1,))), rows(c.storage)]
    finally:
        side.deterministic.unseed()
        c.close()
    return out


def test_directory_layer_with_partitions_matches_jax():
    got = _directories(PORT)
    assert got == _directories(JAX)
    assert len(set(got[13])) == 40 and got[-2] is None


def _hca_race(side):
    """Two interleaved allocations drawing the same candidate: OCC lets
    one of them commit."""
    side.deterministic.seed(3)
    c, db = _db(side)
    dl = side.directory.DirectoryLayer()
    try:
        db.run(lambda tr: dl.create(tr, ("seed",)))
        tr1, tr2 = db.create_transaction(), db.create_transaction()
        p1 = dl._allocator.allocate(tr1)
        dl._allocator._rng.setstate(dl._allocator._rng.getstate())
        p2 = dl._allocator.allocate(tr2)
        tr1.commit()
        return [p1, p2, outcome(side, tr2.commit)]
    finally:
        side.deterministic.unseed()
        c.close()


def test_hca_concurrent_allocators_match_jax():
    assert _hca_race(PORT) == _hca_race(JAX)


# ── tenants ─────────────────────────────────────────────────────────
def _tenant_basics(side):
    TM = side.tenant.TenantManagement
    c, db = _db(side)
    out = [TM.create_tenant(db, b"alice"), TM.create_tenant(db, b"bob")]
    alice, bob = db.open_tenant(b"alice"), db.open_tenant(b"bob")
    alice[b"k"] = b"A"
    bob[b"k"] = b"B"
    out += [alice[b"k"], bob[b"k"], db.get(b"k"),
            alice.get_range(None, None),
            outcome(side, lambda: TM.create_tenant(db, b"alice")),
            outcome(side, lambda: TM.delete_tenant(db, b"alice")),
            outcome(side, lambda: alice.set(b"\xff\x01", b"v"))]
    alice.clear(b"k")
    TM.delete_tenant(db, b"alice")
    out += [outcome(side, lambda: db.open_tenant(b"alice").get(b"x")),
            TM.list_tenants(db)]
    # a stale handle after delete and re-create writes the new prefix
    stale = db.open_tenant(b"bob")
    stale.clear(b"k")
    TM.delete_tenant(db, b"bob")
    out.append(TM.create_tenant(db, b"bob"))
    stale[b"y"] = b"new"
    shop = db.open_tenant(b"bob")

    def bump(tr):
        cur = int.from_bytes(tr.get(b"n") or b"\x00", "little")
        tr.set(b"n", (cur + 1).to_bytes(8, "little"))

    for _ in range(5):
        shop.run(bump)
    out += [shop[b"y"], shop[b"n"], rows(c.storage)]
    c.close()
    return out


def test_tenant_isolation_and_errors_match_jax():
    got = _tenant_basics(PORT)
    assert got == _tenant_basics(JAX)
    assert got[6:9] == [("err", 2132), ("err", 2133), ("err", 2004)]
    assert got[9] == ("err", 2108)


def _tenant_modes(side):
    TM, Tenant = side.tenant.TenantManagement, side.tenant.Tenant
    c, db = _db(side)
    TM.create_tenant(db, b"acme")
    t = Tenant(db, b"acme")
    t[b"k"] = b"v"
    db[b"plain"] = b"p"

    def put(target, k):
        return outcome(side, lambda: target.__setitem__(k, b"x"))

    TM.set_tenant_mode(db, "required")
    out = [TM.get_tenant_mode(db), c.tenant_mode(), put(db, b"plain2"),
           put(t, b"k2"),
           outcome(side, lambda: db.run(
               lambda tr: tr.set(b"\xff/conf/custom", b"1"))),
           outcome(side, lambda: db.run(
               lambda tr: tr.clear_range(b"\xfd", b"\xfe\xff")))]
    TM.set_tenant_mode(db, "disabled")
    out += [put(t, b"k3"), put(db, b"plain3"),
            outcome(side, lambda: TM.create_tenant(db, b"nope")),
            outcome(side, lambda: db.run(
                lambda tr: tr.clear_range(b"a", b"\xfe")))]
    TM.set_tenant_mode(db, "optional")
    out.append(put(t, b"k3"))
    out.append(outcome(side, lambda: TM.set_tenant_mode(db, "sometimes")))
    out.append(rows(c.storage))
    c.close()
    return out


def test_tenant_modes_match_jax():
    got = _tenant_modes(PORT)
    assert got == _tenant_modes(JAX)
    assert got[2] == ("err", 2130) and got[5] == ("err", 2130)
    assert got[6] == ("err", 2134) and got[9] == ("err", 2134)
    assert got[11] == ("err", 2006)


def _tenant_mode_routes(side, route):
    """Tenant mode "required" on a batch, a backlog (the port sends a
    backlog batch by batch under a mode, as under the lock) and the
    thread pipeline: a plain write fails 2130, a tenant write commits."""
    from tests.torch_sides import request, results

    kw = dict(TEST_KNOBS)
    if route == "thread":
        kw.update(commit_pipeline="thread", commit_batch_max=2)
        if side is JAX:
            kw.update(health_probe_enabled=False, history_enabled=False,
                      consistency_scan_enabled=False)
    c = side.cluster(**kw)
    db = c.database()
    TM = side.tenant.TenantManagement
    prefix = TM.create_tenant(db, b"t")
    TM.set_tenant_mode(db, "required")
    rv = c.sequencer.committed_version
    plain = lambda k: request(side, rv, sets=[(k, b"p")])  # noqa: E731
    inside = lambda k: request(side, rv, sets=[(prefix + k, b"t")])  # noqa
    if route == "batch":
        out = results(c.commit_proxy.commit_batch(
            [plain(b"a"), inside(b"b"), plain(b"c")]))
    elif route == "backlog":
        out = [results(r) for r in c._commit_target().commit_batches(
            [[plain(b"a")], [inside(b"b"), plain(b"c")]])]
        out = [[r if isinstance(r, tuple) else "ok" for r in b] for b in out]
    else:
        t = db.open_tenant(b"t")
        out = [outcome(side, lambda: db.__setitem__(b"a", b"p"))]
        for i in range(8):
            t[b"k%d" % i] = b"v"
        out.append(t.get_range(None, None))
    c.close()
    return out


@pytest.mark.parametrize("route", ["batch", "thread"])
def test_tenant_mode_routes_match_jax(route):
    got = _tenant_mode_routes(PORT, route)
    assert got == _tenant_mode_routes(JAX, route)
    if route == "batch":
        assert got[0] == got[2] == ("err", 2130) and isinstance(got[1], int)


def test_tenant_mode_holds_a_backlog_batch_by_batch():
    """The reference checks only the lock before a backlog, so its
    ``commit_batches`` skips the tenant mode; the port sends a backlog
    under a mode batch by batch, where the mode applies, as it does
    under the lock."""
    got = _tenant_mode_routes(PORT, "backlog")
    assert got == [[("err", 2130)], ["ok", ("err", 2130)]]
    assert _tenant_mode_routes(JAX, "backlog") == [["ok"], ["ok", "ok"]]


def _tenant_quota(side):
    TM, Tenant = side.tenant.TenantManagement, side.tenant.Tenant
    t = [0.0]
    c = side.cluster(**dict(TEST_KNOBS, resolver_backend="cpu",
                            target_tps=10000.0, rk_clock=lambda: t[0]))
    db = c.database()
    TM.create_tenant(db, b"hog")
    TM.create_tenant(db, b"good")
    TM.set_tenant_quota(db, b"hog", 3.0)
    out = [TM.get_tenant_quota(db, b"hog")]
    hog, good = Tenant(db, b"hog"), Tenant(db, b"good")
    t[0] += 1.0
    codes = []
    for i in range(40):
        t[0] += 0.001
        tr = hog.create_transaction()
        try:
            tr[b"k%d" % i] = b"v"
            tr.commit()
            codes.append("ok")
        except side.error as e:
            codes.append(e.code)
        good[b"g%d" % i] = b"fine"
    out += [codes, len(good[b"g":b"h"])]
    TM.set_tenant_quota(db, b"hog", None)
    t[0] += 0.001
    hog[b"free"] = b"1"
    out += [hog[b"free"], TM.get_tenant_quota(db, b"hog")]
    c.close()
    return out


def test_tenant_quota_throttles_only_that_tenant_matches_jax():
    got = _tenant_quota(PORT)
    assert got == _tenant_quota(JAX)
    assert set(got[1]) == {"ok", 1213} and got[1].count(1213) > 30
    assert got[2] == 40


def _tenant_groups(side):
    TM = side.tenant.TenantManagement
    c, db = _db(side)
    TM.create_tenant(db, b"a1", group=b"teamA")
    TM.create_tenant(db, b"a2", group=b"teamA")
    TM.create_tenant(db, b"b1", group=b"teamB")
    TM.create_tenant(db, b"solo")
    out = [TM.list_tenant_groups(db), TM.get_tenant_group(db, b"a1"),
           TM.get_tenant_group(db, b"solo")]
    TM.delete_tenant(db, b"a1")
    out.append(TM.list_tenant_groups(db))
    c.close()
    return out


def test_tenant_groups_match_jax():
    got = _tenant_groups(PORT)
    assert got == _tenant_groups(JAX)
    assert got[0] == {b"teamA": [b"a1", b"a2"], b"teamB": [b"b1"]}


def _tenant_survives(side, d):
    """The mode and the quotas come back from the system keys after a
    restart from the WAL, after a transaction-system recovery and after
    a region failover."""
    os.makedirs(d)
    TM = side.tenant.TenantManagement
    tag = side.tenant.tenant_tag
    kw = dict(TEST_KNOBS, wal_path=os.path.join(d, "w.wal"),
              coordination_dir=os.path.join(d, "co"))
    c = side.cluster(**kw)
    db = c.database()
    TM.create_tenant(db, b"t1")
    TM.set_tenant_mode(db, "required")
    TM.set_tenant_quota(db, b"t1", 7.0)
    c.close()
    c = side.cluster(**kw)
    db = c.database()
    out = [c.tenant_mode(), c.ratekeeper.tag_quotas.get(tag(b"t1")),
           outcome(side, lambda: db.__setitem__(b"plain", b"x"))]
    c._commit_target().kill()
    out += [c.detect_and_recruit(), c.tenant_mode(),
            outcome(side, lambda: db.__setitem__(b"plain", b"x"))]
    c.close()
    # a region failover rebuilds the proxies and the ratekeeper's view
    # from the replayed system keys
    c = side.cluster(**dict(TEST_KNOBS, n_storage=2, n_tlogs=3,
                            regions=dict(satellite_mode="sync",
                                         primary="east", remote="west")))
    db = c.database()
    TM.create_tenant(db, b"t2")
    TM.set_tenant_mode(db, "required")
    TM.set_tenant_quota(db, b"t2", 9.0)
    c.ratekeeper.set_tag_quota(tag(b"t2"), None)
    c.set_tenant_mode("optional")  # enforcement state only: the row stays
    for s in c.storages:
        s.kill()
    for i in range(3):
        c.tlog.kill(i)
    c.sequencer.kill()
    c._commit_target().kill()
    out += [c.detect_and_recruit(), c.tenant_mode(),
            c.ratekeeper.tag_quotas.get(tag(b"t2")),
            outcome(side, lambda: db.__setitem__(b"plain", b"x"))]
    c.close()
    return out


def test_tenant_mode_and_quotas_survive_recovery_and_failover_match_jax(
        tmp_path):
    want = _tenant_survives(JAX, str(tmp_path / "jax"))
    got = _tenant_survives(PORT, str(tmp_path / "port"))
    assert got == want
    assert got[:3] == ["required", 7.0, ("err", 2130)]
    assert got[4:6] == ["required", ("err", 2130)]
    assert got[6] == [("region-failover", 0)]
    assert got[7:] == ["required", 9.0, ("err", 2130)]
