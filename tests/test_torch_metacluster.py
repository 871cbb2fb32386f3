"""The port's metacluster against the JAX package's, at tolerance 0.

Every case of the reference's ``tests/test_metacluster.py`` except
``test_fdbcli_metacluster_commands`` (``tools/cli.py`` is not ported)
runs one script on both packages: a management cluster and two data
clusters, each a ``Cluster`` on the host resolver. Each script returns
what every operation returned or raised, the registry and the
assignments, and every row of every cluster; the two must be equal.
The crash-resume cases patch the same step on both sides.
"""

import json

import pytest

from tests.conftest import TEST_KNOBS
from tests.torch_sides import JAX, PORT, outcome, rows


class Boom(Exception):
    pass


def _both(script, *args, **kw):
    return script(JAX, *args, **kw), script(PORT, *args, **kw)


def _clusters(side, n):
    return [side.cluster(resolver_backend="cpu", **TEST_KNOBS)
            for _ in range(n)]


class _Meta:
    """The reference test's fixture: management + dc1, dc2 of capacity 2."""

    def __init__(self, side):
        self.side = side
        self.clusters = _clusters(side, 3)
        self.mgmt, self.d1, self.d2 = (c.database() for c in self.clusters)
        self.mc = side.metacluster.Metacluster.create(self.mgmt)
        self.mc.register_data_cluster(b"dc1", self.d1, capacity=2)
        self.mc.register_data_cluster(b"dc2", self.d2, capacity=2)

    def extra(self):
        c = _clusters(self.side, 1)[0]
        self.clusters.append(c)
        return c.database()

    def state(self):
        """The registry, the assignments and every cluster's rows."""
        return dict(clusters=self.mc.list_data_clusters(),
                    tenants=self.mc.list_tenants(),
                    rows=[rows(c.storages[0]) for c in self.clusters])

    def close(self):
        for c in self.clusters:
            c.close()


def _run(side, body):
    m = _Meta(side)
    try:
        return body(m), m.state()
    finally:
        m.close()


def _tm(side):
    return side.tenant.TenantManagement


def _registration(m):
    side, mc = m.side, m.mc
    out = [outcome(side, lambda: mc.register_data_cluster(b"dc1-again",
                                                          m.d1)),
           outcome(side, lambda: mc.register_data_cluster(b"self", mc.db))]
    dirty = m.extra()
    _tm(side).create_tenant(dirty, b"squatter")
    out.append(outcome(side, lambda: mc.register_data_cluster(b"dirty",
                                                              dirty)))
    out.append(outcome(side, lambda: side.metacluster.Metacluster(m.d1)))
    out.append(outcome(side, lambda: side.metacluster.Metacluster.create(
        mc.db)))
    return out


def test_registration_guards_match_jax():
    want, got = _both(_run, _registration)
    assert got == want
    assert got[0][0] == ("err", 2161) and got[0][2] == ("err", 2165)
    assert got[0][1][0] == "err" and got[0][3] == ("err", 2160)


def _placement(m):
    side, mc = m.side, m.mc
    placed = [mc.create_tenant(b"t%d" % i) for i in range(4)]
    out = [placed, outcome(side, lambda: mc.create_tenant(b"t4")),
           [n for n, _ in _tm(side).list_tenants(m.d1)]]
    mc.delete_tenant(b"t0")
    out.append(mc.create_tenant(b"t4"))
    out.append(outcome(side, lambda: mc.create_tenant(b"t1")))
    out.append(outcome(side, lambda: mc.delete_tenant(b"nope")))
    return out


def test_tenant_assignment_balances_by_load_like_jax():
    want, got = _both(_run, _placement)
    assert got == want
    out = got[0]
    assert sorted(out[0]) == [b"dc1", b"dc1", b"dc2", b"dc2"]
    assert out[1] == ("err", 2166) and out[3] == b"dc1"
    assert out[4] == ("err", 2132) and out[5] == ("err", 2108)


def _routing(m):
    mc = m.mc
    placed = mc.create_tenant(b"alpha")
    t = mc.open_tenant(b"alpha")
    t[b"k"] = b"v"
    return [placed, t[b"k"], m.d1.get_range(b"\xfd", b"\xfe"),
            m.d2.get_range(b"\xfd", b"\xfe")]


def test_open_tenant_routes_to_owner_like_jax():
    want, got = _both(_run, _routing)
    assert got == want
    assert got[0][0] == b"dc1" and len(got[0][2]) == 1 and got[0][3] == []


def _move(m):
    side, mc, d1, d2 = m.side, m.mc, m.d1, m.d2
    TM = _tm(side)
    mc.create_tenant(b"mv", group=b"gold")
    TM.set_tenant_quota(d1, b"mv", 500.0)
    t = mc.open_tenant(b"mv")
    for i in range(20):
        t[b"row%02d" % i] = b"val%d" % i
    old = t
    mc.move_tenant(b"mv", b"dc2")
    t2 = mc.open_tenant(b"mv")
    t2[b"post"] = b"moved"
    tag = side.tenant.tenant_tag(b"mv")
    return [[t2[b"row%02d" % i] for i in range(20)], t2[b"post"],
            d1.get_range(b"\xfd", b"\xfe"),
            TM.get_tenant_quota(d2, b"mv"), TM.get_tenant_group(d2, b"mv"),
            tag in d2._cluster.ratekeeper.tag_quotas,
            TM.get_tenant_quota(d1, b"mv"),
            tag in d1._cluster.ratekeeper.tag_quotas,
            outcome(side, lambda: old[b"row00"]),
            outcome(side, lambda: mc.move_tenant(b"mv", b"dc2")),
            outcome(side, lambda: mc.move_tenant(b"mv", b"nowhere"))]


def test_move_tenant_between_clusters_like_jax():
    want, got = _both(_run, _move)
    assert got == want
    out, state = got
    assert out[0] == [b"val%d" % i for i in range(20)] and out[2] == []
    assert out[3] == 500.0 and out[4] == b"gold" and out[5]
    assert out[6] is None and not out[7] and out[8] == ("err", 2108)
    assert state["tenants"][b"mv"]["cluster"] == "dc2"
    assert state["clusters"][b"dc1"]["tenants"] == 0
    assert state["clusters"][b"dc2"]["tenants"] == 1


def _locked_during_move(m, delete):
    side, mc = m.side, m.mc
    mc.create_tenant(b"busy")
    src_prefix = m.d1.run(lambda tr: tr.get(b"\xff/tenant/map/busy"))
    mc._set_assignment(b"busy", b"dc1", "moving", src_prefix=src_prefix,
                       dst=b"dc2")
    out = [outcome(side, lambda: mc.open_tenant(b"busy")),
           outcome(side, lambda: mc.delete_tenant(b"busy")),
           outcome(side, lambda: mc.move_tenant(b"busy", b"dc2"))]
    mc.resume_move(b"busy", b"dc2" if not delete else None)
    if delete:
        mc.delete_tenant(b"busy")
    else:
        t = mc.open_tenant(b"busy")
        t[b"k"] = b"v"
        out.append(t[b"k"])
    out.append(outcome(side, lambda: mc.resume_move(b"busy")))
    return out


@pytest.mark.parametrize("delete", [False, True],
                         ids=["open-after-resume", "delete-after-resume"])
def test_mid_move_fence_matches_jax(delete):
    want, got = _both(_run, lambda m: _locked_during_move(m, delete))
    assert got == want
    out, state = got
    assert out[0] == out[1] == ("err", 2144)
    if delete:
        assert b"busy" not in state["tenants"]
    else:
        assert state["tenants"][b"busy"]["cluster"] == "dc2"


def _resume_after_crash(m, crash_after):
    side, mc, d1, d2 = m.side, m.mc, m.d1, m.d2
    mc.create_tenant(b"frag")
    t = mc.open_tenant(b"frag")
    for i in range(8):
        t[b"r%d" % i] = b"v%d" % i
    if crash_after == "moving":
        mc._drive_move = lambda *a: (_ for _ in ()).throw(Boom())
    else:
        orig_set = mc._set_assignment

        def set_then_boom(name, cluster, state, **kw):
            orig_set(name, cluster, state, **kw)
            if state == "copied":
                raise Boom()

        mc._set_assignment = set_then_boom
    try:
        mc.move_tenant(b"frag", b"dc2")
        crashed = False
    except Boom:
        crashed = True
    out = [crashed, mc.list_tenants()[b"frag"]["state"],
           outcome(side, lambda: mc.resume_move(b"frag", b"dc1"))]
    # a fresh handle re-attaches the registered data clusters and drives
    # the recorded move with no destination argument
    mc2 = side.metacluster.Metacluster(mc.db)
    out.append(outcome(side, lambda: mc2.attach_data_cluster(b"dc9", d1)))
    out.append(outcome(side, lambda: mc2.attach_data_cluster(b"dc2", d1)))
    mc2.attach_data_cluster(b"dc1", d1)
    mc2.attach_data_cluster(b"dc2", d2)
    mc2.resume_move(b"frag")
    t2 = mc2.open_tenant(b"frag")
    out += [[t2[b"r%d" % i] for i in range(8)],
            d1.get_range(b"\xfd", b"\xfe")]
    return out


@pytest.mark.parametrize("crash_after", ["moving", "copied"])
def test_move_resumes_after_crash_like_jax(crash_after):
    want, got = _both(_run, lambda m: _resume_after_crash(m, crash_after))
    assert got == want
    out, state = got
    assert out[0] and out[1] == crash_after
    assert out[2] == out[3] == out[4] == ("err", 2160)
    assert out[5] == [b"v%d" % i for i in range(8)] and out[6] == []
    assert state["tenants"][b"frag"]["cluster"] == "dc2"


def _full_destination(m):
    side, mc = m.side, m.mc
    placed = [mc.create_tenant(b"f%d" % i) for i in range(4)]
    victim = b"f%d" % placed.index(b"dc1")
    return [placed, outcome(side, lambda: mc.move_tenant(victim, b"dc2"))]


def test_move_refuses_full_destination_like_jax():
    want, got = _both(_run, _full_destination)
    assert got == want
    assert got[0][1] == ("err", 2166)


def _register_rolls_back(m):
    side, mc = m.side, m.mc
    return [outcome(side, lambda: mc.register_data_cluster(b"dc1-alias",
                                                           m.d1)),
            b"dc1-alias" in mc.list_data_clusters(),
            mc.create_tenant(b"still-works"),
            outcome(side, lambda: mc.remove_data_cluster(b"dc1")),
            outcome(side, lambda: mc.remove_data_cluster(b"dc9"))]


def test_register_failure_rolls_back_like_jax():
    want, got = _both(_run, _register_rolls_back)
    assert got == want
    assert got[0][0] == ("err", 2161) and not got[0][1]


def _remove(m):
    side, mc = m.side, m.mc
    mc.remove_data_cluster(b"dc2")
    return [list(mc.list_data_clusters()),
            m.d2.run(lambda tr: tr.get(
                side.metacluster.REGISTRATION_KEY)),
            mc.create_tenant(b"a"), mc.create_tenant(b"b"),
            outcome(side, lambda: mc.create_tenant(b"c"))]


def test_remove_data_cluster_like_jax():
    want, got = _both(_run, _remove)
    assert got == want
    assert got[0][0] == [b"dc1"] and got[0][1] is None
    assert got[0][4] == ("err", 2166)


def _register_crash_before_mark(m):
    side, mc = m.side, m.mc
    db = m.extra()
    db_type = type(db)
    real_run = db_type.run
    armed = {"on": True}

    def crashing_run(self, fn):
        if self is db and armed["on"] and \
                b"dc3" in mc.list_data_clusters():
            armed["on"] = False
            raise Boom()
        return real_run(self, fn)

    db_type.run = crashing_run
    try:
        try:
            mc.register_data_cluster(b"dc3", db, capacity=2)
        except Boom:
            pass
    finally:
        db_type.run = real_run
    out = [dict(mc.list_data_clusters()[b"dc3"]),
           mc.create_tenant(b"not-on-dc3")]
    mc.register_data_cluster(b"dc3", db, capacity=3)
    out.append(dict(mc.list_data_clusters()[b"dc3"]))
    out.append([mc.create_tenant(b"fill%d" % i) for i in range(5)])
    return out


def test_register_resumes_after_crash_like_jax():
    want, got = _both(_run, _register_crash_before_mark)
    assert got == want
    out = got[0]
    assert out[0]["state"] == "registering" and out[1] in (b"dc1", b"dc2")
    assert out[2]["state"] == "ready" and out[2]["capacity"] == 3
    assert b"dc3" in out[3]


def _register_crash_after_mark(m):
    side, mc = m.side, m.mc
    db = m.extra()
    db_type = type(mc.db)
    real_run = db_type.run
    calls = {"n": 0}

    def crashing_run(self, fn):
        if self is mc.db:
            calls["n"] += 1
            if calls["n"] == 2:  # the ready-flip transaction
                raise Boom()
        return real_run(self, fn)

    db_type.run = crashing_run
    try:
        try:
            mc.register_data_cluster(b"dc4", db, capacity=2)
        except Boom:
            pass
    finally:
        db_type.run = real_run
    out = [mc.list_data_clusters()[b"dc4"]["state"]]
    mc.register_data_cluster(b"dc4", db, capacity=2)
    out.append(mc.list_data_clusters()[b"dc4"]["state"])
    out.append(json.loads(db.run(
        lambda tr: tr.get(side.metacluster.REGISTRATION_KEY))))
    return out


def test_register_crash_after_mark_resumes_like_jax():
    want, got = _both(_run, _register_crash_after_mark)
    assert got == want
    assert got[0] == ["registering", "ready", {"role": "data",
                                              "name": "dc4"}]


def _create_resumes(m):
    side, mc = m.side, m.mc
    TM = _tm(side)
    orig = TM.create_tenant
    TM.create_tenant = staticmethod(
        lambda *a, **k: (_ for _ in ()).throw(Boom()))
    try:
        try:
            mc.create_tenant(b"half")
        except Boom:
            pass
    finally:
        TM.create_tenant = staticmethod(orig)
    out = [mc.list_tenants()[b"half"]["state"],
           outcome(side, lambda: mc.open_tenant(b"half"))]
    cluster = mc.create_tenant(b"half")
    t = mc.open_tenant(b"half")
    t[b"k"] = b"v"
    out += [cluster, mc.list_tenants()[b"half"]["state"], t[b"k"],
            mc.list_data_clusters()[cluster]["tenants"]]
    return out


def test_create_tenant_resumes_registering_state_like_jax():
    want, got = _both(_run, _create_resumes)
    assert got == want
    out = got[0]
    assert out[0] == "registering" and out[1] == ("err", 2144)
    assert out[3:] == ["ready", b"v", 1]


def _status_roles(side):
    m = _Meta(side)
    c = _clusters(side, 1)[0]
    try:
        out = [m.mgmt._cluster.status()["cluster"]["metacluster"],
               m.d1._cluster.status()["cluster"]["metacluster"],
               c.status()["cluster"]["metacluster"]]
        for s in c.storages:
            s.kill()
        out.append(c.status()["cluster"]["metacluster"])
        return out
    finally:
        c.close()
        m.close()


def test_status_reports_metacluster_role_like_jax():
    """The status section reads the row ``REGISTRATION_KEY`` writes."""
    want, got = _both(_status_roles)
    assert got == want == [
        {"cluster_type": "metacluster_management", "name": "meta"},
        {"cluster_type": "metacluster_data", "name": "dc1"},
        {"cluster_type": "standalone"}, {"cluster_type": "unknown"}]
    assert PORT.metacluster.REGISTRATION_KEY == \
        PORT.systemdata.METACLUSTER_REGISTRATION == \
        JAX.metacluster.REGISTRATION_KEY
