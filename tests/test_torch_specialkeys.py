"""The port's special key space against the JAX package's, at tolerance 0.

Every case of the reference's ``tests/test_specialkeys.py`` except
``test_special_keys_over_rpc`` (RPC is not ported), and the special-key
cases of its lock and tracing tests, run one script on both packages
and compare what each read, wrote and raised. The views are read under
one seed and a clock that stands still (tests/torch_sides.py
``seeded``): every view's bytes must equal the reference's, except
that the status document and the device profile are compared as
documents, apart from the fields tests/test_torch_status.py's ``APART``
names: the backend's name, each resolver's ``device`` and ``graphs``
(the port's own), the staging reuse counts and the process-wide trace
counters, with the device routes renamed (``ROUTES``) and the port's
single-step captures taken out.
"""

import json

import pytest

from tests.conftest import TEST_KNOBS
from tests.test_torch_status import compare
from tests.torch_sides import JAX, PORT, doc_diff, outcome, seeded

BACKENDS = {"host": dict(resolver_backend="cpu"), "device": {}}


def _both(script, *args, **kw):
    return script(JAX, *args, **kw), script(PORT, *args, **kw)


def _cluster(side, **kw):
    return side.cluster(**{**TEST_KNOBS, **BACKENDS["host"], **kw})


def _views(side, backend):
    """Every view after writes, a conflict, a lock and the daemons'
    rounds pumped by hand: {key: bytes}, and the range read's keys."""
    SK = side.specialkeys
    with seeded(side) as clock:
        c = side.cluster(**{**TEST_KNOBS, **BACKENDS[backend]})
        try:
            db = c.database()
            for i in range(5):
                db[b"k%d" % i] = b"v%d" % i
            t1 = db.create_transaction()
            t1.get(b"k0")
            db[b"k0"] = b"w"
            t1[b"k0"] = b"lost"
            outcome(side, t1.commit)
            for _ in range(2):
                clock.tick()
                c.prober.maybe_probe()
                c.scanner.maybe_scan()
                c.history.maybe_collect()
            c.lock_database(b"uid")
            tr = db.create_transaction()
            views = {key: tr.get(key) for key in (
                SK.STATUS_JSON, SK.HEALTH, SK.METRICS_JSON, SK.HOT_RANGES,
                SK.DEVICE, SK.HISTORY, SK.FLIGHT, SK.CONSISTENCY_SCAN,
                SK.CONNECTION_STRING, SK.DB_LOCKED, SK.TRACING_TOKEN,
                SK.TRACING_RATE, SK.TRACING_ENABLED)}
            listed = [k for k, _ in tr.get_range(SK.PREFIX, SK.END)]
            c.unlock_database()
            return views, listed
        finally:
            c.close()


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_views_match_jax(backend):
    (want, wlisted), (got, glisted) = _both(_views, backend)
    SK = PORT.specialkeys
    assert glisted == wlisted
    assert set(got) == set(want)
    for key in want:
        if key == SK.STATUS_JSON:
            compare(json.loads(want[key])["cluster"],
                    json.loads(got[key])["cluster"])
        elif key == SK.DEVICE:
            compare({"device": json.loads(want[key])},
                    {"device": json.loads(got[key])})
        else:
            assert got[key] == want[key], key
    status = json.loads(got[SK.STATUS_JSON])["cluster"]
    assert status["database_available"]
    assert got[SK.CONNECTION_STRING] == b"local"
    assert got[SK.DB_LOCKED] == b"uid"
    for key in want:
        if key not in (SK.CONNECTION_STRING, SK.DB_LOCKED) \
                and not key.startswith(SK.TRACING):
            json.loads(got[key])


def _status_is_the_document(side):
    """``\\xff\\xff/status/json`` is ``db.status()`` at the same version,
    but for the storage's point-read counter: building the document
    reads the metacluster registration row, one point read a call."""
    with seeded(side):
        c = _cluster(side)
        try:
            db = c.database()
            db[b"a"] = b"1"
            tr = db.create_transaction()
            raw = tr.get(side.specialkeys.STATUS_JSON)
            doc = json.loads(json.dumps(db.status(), sort_keys=True))
            return doc_diff(json.loads(raw), doc)
        finally:
            c.close()


def test_status_json_equals_db_status():
    want, got = _both(_status_is_the_document)
    assert got == want == [
        ("/cluster/processes/storage_servers[0]/metrics/counters/"
         "point_reads", 1, 2)]


def _no_conflict_ranges(side):
    c = _cluster(side)
    try:
        tr = c.database().create_transaction()
        tr.get(side.specialkeys.STATUS_JSON)
        tr.get_range(b"\xff\xff/management/", b"\xff\xff/management0")
        out = [list(tr._read_conflicts), tr._read_version]
        tr[b"k"] = b"v"
        tr.commit()
        return out + [tr.get_committed_version() > 0]
    finally:
        c.close()


def test_special_reads_add_no_conflict_ranges():
    want, got = _both(_no_conflict_ranges)
    assert got == want == [[], None, True]


def _unknown_rejected(side):
    c = _cluster(side)
    try:
        tr = c.database().create_transaction()
        return [outcome(side, lambda: tr.get(b"\xff\xff/nope")),
                outcome(side, lambda: tr.set(b"\xff\xff/nope", b"x")),
                outcome(side, lambda: tr.clear(b"\xff\xff/nope")),
                outcome(side, lambda: tr.clear_range(
                    b"\xff\xff/a", b"\xff\xff/b")),
                outcome(side, lambda: tr.set(
                    side.specialkeys.EXCLUDED + b"x", b"")),
                outcome(side, lambda: tr.set(
                    side.specialkeys.TRACING_RATE, b"2"))]
    finally:
        c.close()


def test_unknown_special_key_rejected():
    want, got = _both(_unknown_rejected)
    assert got == want
    assert got[0] == ("err", 2004) and got[4] == ("err", 2006)


def _reported_conflict(side, backend):
    c = side.cluster(**{**TEST_KNOBS, **BACKENDS[backend]})
    try:
        db = c.database()
        db[b"a"] = b"1"
        db[b"b"] = b"2"
        tr = db.create_transaction()
        tr.options.set_report_conflicting_keys()
        _ = tr[b"a"]
        _ = tr[b"b"]
        tr.get_range(b"r0", b"r5")
        db[b"a"] = b"other"
        tr[b"c"] = b"3"
        code = outcome(side, tr.commit)
        CK = side.specialkeys.CONFLICTING_KEYS
        return code, tr.get_range(CK, CK + b"\xff"), tr.get(CK + b"a")
    finally:
        c.close()


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_conflicting_keys_match_jax(backend):
    """The Python host set reports the conflicting read exactly; the
    device step reports every read range of the transaction (the
    conservative contract of ref proxy.py:1294-1310). Each backend is
    compared with the same backend on the reference."""
    want, got = _both(_reported_conflict, backend)
    assert got == want
    code, rows, a = got
    CK = PORT.specialkeys.CONFLICTING_KEYS
    assert code == ("err", 1020) and a == b"1"
    opened = [k for k, v in rows if v == b"1"]
    if backend == "host":
        assert opened == [CK + b"a"]
    else:
        assert {CK + b"a", CK + b"b", CK + b"r0"} <= set(opened)


def _overlapping(side):
    c = _cluster(side)
    try:
        tr = c.database().create_transaction()
        tr._conflicting_ranges = [(b"a", b"c"), (b"b", b"d"), (b"f", b"g")]
        CK = side.specialkeys.CONFLICTING_KEYS
        return (tr.get_range(CK, CK + b"\xff"),
                tr.get_range(CK, CK + b"\xff", reverse=True, limit=3))
    finally:
        c.close()


def test_conflicting_keys_overlapping_ranges_merge():
    want, got = _both(_overlapping)
    assert got == want
    CK = PORT.specialkeys.CONFLICTING_KEYS
    assert got[0][:2] == [(CK + b"a", b"1"), (CK + b"d", b"0")]


def _exclusion(side):
    c = _cluster(side, n_storage=3, replication=2)
    db = c.database()
    EX = side.specialkeys.EXCLUDED
    try:
        for i in range(20):
            db[b"k%02d" % i] = b"v" * 50
        db.run(lambda tr: tr.set(EX + b"2", b""))
        out = [c.list_excluded(),
               db.run(lambda tr: tr.get_range(EX, EX + b"\xff")),
               db.run(lambda tr: tr.get(EX + b"2"))]
        db.run(lambda tr: tr.clear(EX + b"2"))
        out.append(c.list_excluded())
        db.run(lambda tr: [tr.set(EX + b"%d" % i, b"") for i in (0, 1)])
        db.run(lambda tr: tr.clear_range(EX, EX + b"\xff"))
        out.append(c.list_excluded())
        return out
    finally:
        c.close()


def test_exclusion_via_management_keys():
    want, got = _both(_exclusion)
    assert got == want
    EX = PORT.specialkeys.EXCLUDED
    assert got[0] == [2] and got[1] == [(EX + b"2", b"")]
    assert got[3] == got[4] == []


def _ryw(side):
    c = _cluster(side)
    EX = side.specialkeys.EXCLUDED
    try:
        tr = c.database().create_transaction()
        tr.set(EX + b"0", b"")
        rows = [tr.get_range(EX, EX + b"\xff")]
        tr.clear(EX + b"0")
        rows.append(tr.get_range(EX, EX + b"\xff"))
        tr.commit()
        return rows, c.list_excluded()
    finally:
        c.close()


def test_management_writes_are_ryw():
    want, got = _both(_ryw)
    assert got == want
    assert got == ([[(PORT.specialkeys.EXCLUDED + b"0", b"")], []], [])


def _atomics_and_selectors(side):
    SK = side.specialkeys
    c = _cluster(side)
    try:
        tr = c.database().create_transaction()
        return [
            outcome(side, lambda: tr.add(SK.EXCLUDED + b"1",
                                         (1).to_bytes(8, "little"))),
            outcome(side, lambda: tr.get_key(
                side.selector(SK.STATUS_JSON, True, 0))),
            outcome(side, lambda: tr.get_range(
                side.selector(SK.STATUS_JSON, True, 0), SK.END)),
            outcome(side, lambda: tr.get_range(
                SK.STATUS_JSON, side.selector(SK.END, True, 0))),
        ]
    finally:
        c.close()


def test_atomics_and_selectors_rejected_in_special_space():
    want, got = _both(_atomics_and_selectors)
    assert got == want == [("err", 2004)] * 4


def _lock(side):
    """The lock through ``db_locked``: a fenced client cannot unlock, a
    lock-aware one can (with RYW), and the range scan lists the row only
    while locked."""
    DL = side.specialkeys.DB_LOCKED
    c = _cluster(side)
    db = c.database()

    def scan(tr):
        return dict(tr.get_range(b"\xff\xff/management/",
                                 b"\xff\xff/management0"))

    try:
        out = [DL in db.run(scan)]
        db.run(lambda tr: tr.set(DL, b"mylock"))
        out.append(c.lock_uid())
        out.append(db.run(scan).get(DL))
        sneaky = db.create_transaction()
        sneaky.clear(DL)
        out.append(outcome(side, sneaky.commit))
        mixed = db.create_transaction()
        mixed[b"data"] = b"v"
        mixed.set(DL, b"other")
        out.append(outcome(side, mixed.commit))
        tr = db.create_transaction()
        tr.options.set_lock_aware()
        out.append(tr.get(DL))
        tr.clear(DL)
        out += [tr.get(DL), DL in scan(tr)]
        tr.commit()
        out += [c.lock_uid(), DL in db.run(scan), db[b"data"]]
        # a lock-aware mixed txn surfaces its management half's 1038
        c.lock_database(b"op-A")
        aware = db.create_transaction()
        aware.options.set_lock_aware()
        aware[b"data2"] = b"v"
        aware.set(DL, b"op-B")
        out.append(outcome(side, aware.commit))
        out.append(c.lock_uid())
        c.unlock_database()
        out.append(db[b"data2"])
        return out
    finally:
        c.close()


def test_lock_via_special_key_matches_jax():
    want, got = _both(_lock)
    assert got == want
    assert got == [False, b"mylock", b"mylock", ("err", 1038),
                   ("err", 1038), b"mylock", None, False, None, False, None,
                   ("err", 1038), b"op-A", b"v"]


def _tracing(side):
    SK = side.specialkeys
    c = _cluster(side)
    try:
        db = c.database()
        tr = db.create_transaction()
        out = [tr.get(SK.TRACING_ENABLED), tr.get(SK.TRACING_TOKEN),
               tr.get_range(SK.TRACING, SK.TRACING + b"\xff")]
        tr.set(SK.TRACING_RATE, b"0.25")
        out.append(tr.get(SK.TRACING_RATE))
        tr.commit()
        out.append(c.tracing_config())
        tr = db.create_transaction()
        tr.set(SK.TRACING_ENABLED, b"0")
        out.append(tr.get_range(SK.TRACING, SK.TRACING + b"\xff"))
        tr.commit()
        out.append(c.tracing_config())
        tr = db.create_transaction()
        tr.clear(SK.TRACING_ENABLED)
        tr.set(SK.TRACING_ENABLED, b"1")
        out.append(tr.get(SK.TRACING_RATE))
        tr.commit()
        out.append(c.tracing_config())
        tr = db.create_transaction()
        tr.set(SK.TRACING_TOKEN, b"1")
        forced = tr.get(SK.TRACING_TOKEN) != b"0"
        tr.clear(SK.TRACING_TOKEN)
        out += [forced, tr.get(SK.TRACING_TOKEN)]
        return out
    finally:
        c.close()


def test_tracing_keys_match_jax():
    want, got = _both(_tracing)
    assert got == want
    assert got[0] == got[1] == b"0" and got[3] == b"0.25"
    assert got[4]["sample_rate"] == 0.25 and got[6]["sample_rate"] == 0.0
    assert got[-2] is True and got[-1] == b"0"


def _token_forces_a_trace(side):
    log = side.trace.global_trace_log()
    log.clear()
    c = _cluster(side)
    try:
        db = c.database()
        tr = db.create_transaction()
        tr.set(side.specialkeys.TRACING_TOKEN, b"1")
        tr.set(b"tok", b"v")
        tr.commit()
        spans = [s["span"] for s in log.events("Span")]
        log.clear()
        db.set(b"tok2", b"v")
        return "transaction" in spans, log.events("Span")
    finally:
        c.close()


def test_tracing_token_forces_one_transaction():
    want, got = _both(_token_forces_a_trace)
    assert got == want == (True, [])


def _management_only_commit_async(side):
    """A management-only transaction applies its writes on the async
    path too (its future settles at once)."""
    EX = side.specialkeys.EXCLUDED
    c = _cluster(side, n_storage=3, replication=2,
                 commit_pipeline="manual")
    try:
        tr = c.database().create_transaction()
        tr.set(EX + b"1", b"")
        fut = tr.commit_async()
        tr.commit_finish(fut)
        return fut.done(), c.list_excluded()
    finally:
        c.close()


def test_management_writes_apply_on_the_async_path():
    want, got = _both(_management_only_commit_async)
    assert got == want == (True, [1])
