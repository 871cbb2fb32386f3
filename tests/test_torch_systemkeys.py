"""The database lock and idempotency ids of the port against the JAX
package's. The lock: ``lock_database`` persists ``\\xff/dbLocked`` and
every commit that is not lock-aware fails 1038, on every commit route
(a client commit, a batch, a backlog, the thread pipeline, each member
of a 3-proxy fleet), until ``unlock_database``; it survives a
transaction-system recovery and a restart from the WAL. Idempotency
ids: two requests with one id in one batch (OCC on the id row lets one
commit), a resubmission answered with the original version on the batch
and the backlog route, a 1021 resolved by looking the id's row up, and
the clean-up of expired rows. Outcomes, rows (system keys included) and,
on each package's default resolver, the 12 state fields must be equal
(tolerance 0).
"""

import os

import numpy as np
import pytest

from tests.conftest import TEST_KNOBS
from tests.torch_sides import JAX, PORT, outcome, request, results, rows

ROUTES = ("client", "batch", "backlog", "thread", "fleet")


def _cluster(side, route, **kw):
    kw.setdefault("resolver_backend", "cpu")
    if route == "thread":
        kw["commit_pipeline"] = "thread"
    elif route == "fleet":
        kw["n_commit_proxies"] = 3
    return side.cluster(**dict(TEST_KNOBS, **kw))


def _commits(side, c, route, key, lock_aware):
    """One write of ``key`` through ``route``: the outcomes."""
    db = c.database()
    if route in ("client", "thread"):
        def body():
            tr = db.create_transaction()
            if lock_aware:
                tr.options.set_lock_aware()
            tr[key] = b"v"
            tr.commit()
            return tr.get_committed_version()
        kind, value = outcome(side, body)
        return [value if kind == "ok" else (kind, value)]
    rv = c.sequencer.committed_version
    mk = lambda i: request(side, rv, sets=[(key + b"%d" % i, b"v")],  # noqa
                           lock_aware=lock_aware)
    if route == "batch":
        return results(c.commit_proxy.commit_batch([mk(0), mk(1)]))
    if route == "backlog":
        return [results(r) for r in c._commit_target().commit_batches(
            [[mk(0)], [mk(1), mk(2)]])]
    return [results([p.commit(mk(i))]) for i, p in
            enumerate(c.commit_proxy.inners)]


def _lock(side, route):
    c = _cluster(side, route)
    db = c.database()
    db[b"pre"] = b"x"
    out = [c.lock_uid()]
    c.lock_database(b"uid1")
    out += [c.lock_uid(), c.status()["cluster"]["database_lock_state"],
            _commits(side, c, route, b"plain", False),
            _commits(side, c, route, b"aware", True),
            outcome(side, lambda: c.lock_database(b"other")),
            outcome(side, lambda: c.lock_database(b"uid1")),
            db[b"pre"]]
    c.unlock_database()
    out += [c.lock_uid(), _commits(side, c, route, b"after", False),
            rows(c.storage)]
    c.close()
    return out


@pytest.mark.parametrize("route", ROUTES)
def test_lock_fails_every_route_with_1038_like_jax(route):
    want, got = _lock(JAX, route), _lock(PORT, route)
    assert got == want
    flat = lambda x: x if not isinstance(x[0], list) else [  # noqa: E731
        r for b in x for r in b]
    assert set(flat(got[3])) == {("err", 1038)}
    assert all(isinstance(r, int) for r in flat(got[4]))
    assert got[5] == ("err", 1038) and got[6] == ("ok", None)
    assert all(isinstance(r, int) for r in flat(got[9]))


def _lock_recovery(side, d):
    os.makedirs(d)
    wal = os.path.join(d, "wal")
    c = side.cluster(**dict(TEST_KNOBS, resolver_backend="cpu",
                            wal_path=wal))
    c.lock_database(b"keep")
    c._commit_target().kill()
    out = [c.detect_and_recruit(), c.lock_uid(),
           _commits(side, c, "client", b"k", False)]
    c.close()
    c = side.cluster(**dict(TEST_KNOBS, resolver_backend="cpu",
                            wal_path=wal))
    out += [c.lock_uid(), _commits(side, c, "client", b"k", False),
            _commits(side, c, "client", b"k", True)]
    c.unlock_database()
    c.close()
    c = side.cluster(**dict(TEST_KNOBS, resolver_backend="cpu",
                            wal_path=wal))
    out += [c.lock_uid(), _commits(side, c, "client", b"k", False),
            rows(c.storage)]
    c.close()
    return out


def test_lock_survives_recovery_and_restart_like_jax(tmp_path):
    want = _lock_recovery(JAX, str(tmp_path / "jax"))
    got = _lock_recovery(PORT, str(tmp_path / "port"))
    assert got == want
    assert got[1] == got[3] == b"keep" and got[6] is None
    assert got[2] == got[4] == [("err", 1038)]


def _dedupe(side, backend):
    """One id twice in one batch, a resubmission alone, a mixed batch,
    and a backlog carrying a resubmission, all built by clients (the
    flat conflict blobs included)."""
    c = side.cluster(**dict(TEST_KNOBS, resolver_backend=backend))
    db = c.database()
    out = []

    def req(key, value, iid, read=None):
        tr = db.create_transaction()
        tr.options.set_idempotency_id(iid)
        if read is not None:
            tr.get(read)
        tr[key] = value
        return tr._build_commit_request()

    out.append(results(c.commit_proxy.commit_batch([
        req(b"a", b"1", b"same"), req(b"a", b"2", b"same"),
        req(b"b", b"1", b"other", read=b"a")])))
    out.append(results(c.commit_proxy.commit_batch([
        req(b"a", b"3", b"same")])))
    out.append(results(c.commit_proxy.commit_batch([
        req(b"c", b"1", b"other"), req(b"d", b"1", b"fresh")])))
    out.append([results(r) for r in c._commit_target().commit_batches([
        [req(b"a", b"4", b"same")], [req(b"e", b"1", b"new", read=b"d")]])])
    p = c._commit_target()
    out.append(p.metrics.counter("idmp_dedupe_hits").value)
    out.append(rows(c.storage))
    state = side.state(c) if backend != "cpu" else None
    c.close()
    return out, state


@pytest.mark.parametrize("backend", ["cpu", "default"])
def test_idempotency_dedupe_matches_jax(backend):
    (want, wstate) = _dedupe(JAX, "tpu" if backend == "default" else "cpu")
    (got, gstate) = _dedupe(PORT, "cuda" if backend == "default" else "cpu")
    assert got == want
    first = got[0]
    assert isinstance(first[0], int) and first[1] == ("err", 1020)
    assert got[1] == [first[0]]  # the original version, nothing applied
    assert got[4] == 3
    if wstate is not None:
        for a, b in zip(wstate, gstate):
            np.testing.assert_array_equal(a, b)


def _unknown_result(side):
    """A reply lost after the commit applied: the client finds its id's
    row and returns the original version. A request lost before the
    proxy: the row is absent, the 1021 stands, and the retry loop
    resubmits the same id once."""
    side.deterministic.seed(1234)
    try:
        c = side.cluster(**dict(TEST_KNOBS, resolver_backend="cpu"))
        db = c.database()
        db[b"ctr"] = b"0"
        proxy = c.commit_proxy
        real = proxy.commit
        seen = []

        def applied_then_lost(req):
            res = real(req)
            if not seen:
                seen.append(res)
                return side.error(1021)
            return res

        proxy.commit = applied_then_lost
        tr = db.create_transaction()
        tr.options.set_automatic_idempotency()
        tr[b"ctr"] = b"%d" % (int(tr[b"ctr"]) + 1)
        tr.commit()
        out = [tr.get_committed_version() == seen[0], db[b"ctr"]]
        calls = []

        def lost_before(req):
            calls.append(req.idempotency_id)
            if len(calls) == 1:
                return side.error(1021)
            return real(req)

        proxy.commit = lost_before

        def bump(tr):
            tr.options.set_automatic_idempotency()
            tr[b"ctr"] = b"%d" % (int(tr[b"ctr"]) + 1)

        db.run(bump)
        proxy.commit = real
        out += [db[b"ctr"], len(calls), calls[0] == calls[1],
                rows(c.storage)]
        c.close()
        return out
    finally:
        side.deterministic.unseed()


def test_unknown_result_is_resolved_by_the_id_like_jax():
    want, got = _unknown_result(JAX), _unknown_result(PORT)
    # the id rows carry ids drawn from each package's seeded stream:
    # equal rows mean equal ids
    assert got == want
    assert got[:5] == [True, b"1", b"2", 2, True]


def _gc(side):
    c = side.cluster(**dict(TEST_KNOBS, resolver_backend="cpu",
                            max_read_transaction_life_versions=500))
    proxy = c._commit_target()
    proxy.pump_interval = 2
    db = c.database()
    tr = db.create_transaction()
    tr.options.set_idempotency_id(b"old-token")
    tr[b"x"] = b"1"
    tr.commit()
    key = c.storage.get(b"\xff\x02/idmp/old-token", c.storage.version)
    out = [key]
    for i in range(3):  # past the window, inside the retention
        db[b"fill%d" % i] = b"v"
    out.append(rows(c.storage))
    for i in range(proxy.IDMP_RETENTION_WINDOWS * 500 // 1000 + 4):
        db[b"more%d" % i] = b"v"
    out.append(rows(c.storage))
    c.close()
    return out


def test_expired_id_rows_are_cleared_like_jax():
    want, got = _gc(JAX), _gc(PORT)
    assert got == want
    assert any(k.startswith(b"\xff\x02/idmp/") for k, _ in got[1])
    assert not any(k.startswith(b"\xff\x02/idmp/") for k, _ in got[2])


def test_idempotency_id_option_limits_like_jax():
    def script(side):
        tr = side.cluster(**dict(TEST_KNOBS, resolver_backend="cpu")
                          ).database().create_transaction()
        return [outcome(side, lambda v=v: tr.options.set_idempotency_id(v))
                for v in (b"", b"x" * 256, b"x" * 255, b"tok")]

    assert script(PORT) == script(JAX) == [
        ("err", 2006), ("err", 2006), ("ok", None), ("ok", None)]
