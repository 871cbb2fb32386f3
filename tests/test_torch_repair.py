"""Transaction repair in the port against the JAX package's.

The cluster-level cases of ``tests/test_repair.py`` and the fault the
port had before it ported repair (a 1020 without the conflicting ranges
or the rejecting version, and a backoff where the reference repairs):
each case runs the same client script on the JAX cluster and on the
port's (``device="cpu"``), with the exact host resolver and with the
device resolver, and returns what it observed — error codes,
``conflicting_key_ranges``, ``conflict_version``, whether the body ran
again, the verified read cache, the final rows and the commit proxy's
repair counters. The two must be equal.
"""

import struct

import pytest
import torch

from foundationdb_tpu.core.errors import FDBError as JError
from foundationdb_tpu.core.errors import err as jerr
from foundationdb_tpu.core.keys import KeySelector as JSelector
from foundationdb_tpu.server.cluster import Cluster as JCluster
from foundationdb_tpu_torch.core.errors import FDBError as TError
from foundationdb_tpu_torch.core.errors import err as terr
from foundationdb_tpu_torch.core.keys import KeySelector as TSelector
from foundationdb_tpu_torch.server.cluster import Cluster as TCluster

from tests.conftest import TEST_KNOBS

torch.set_num_threads(1)

COUNTERS = ("repair_attempts", "repair_commits", "repair_fallbacks")
# the thread clusters' probe, history and scan daemons commit or read on
# their own: off on both sides
THREAD_KW = dict(health_probe_enabled=False, history_enabled=False,
                     consistency_scan_enabled=False)


class Side:
    def __init__(self, name, make, error, err, selector, counters, storage):
        self.name = name
        self.make = make
        self.error = error
        self.err = err
        self.selector = selector
        self.counters = counters
        self.storage = storage  # the object a client's reads go through


def _jax_make(backend, **kw):
    be = "cpu" if backend == "host" else "tpu"
    if kw.get("commit_pipeline") == "thread":
        kw.update(THREAD_KW)
    return JCluster(resolver_backend=be, **TEST_KNOBS, **kw)


def _port_make(backend, **kw):
    be = "cpu" if backend == "host" else "cuda"
    if kw.get("commit_pipeline") == "thread":
        kw.update(THREAD_KW)
    return TCluster(device="cpu", resolver_backend=be, **TEST_KNOBS, **kw)


def _jax_counters(c):
    roll = c.metrics_status()["rollups"]
    return {k: roll.get(k, 0) for k in COUNTERS}


def _port_counters(c):
    return dict(c._inner_proxies()[0].repair_counts)


JAX = Side("jax", _jax_make, JError, jerr, JSelector, _jax_counters,
           lambda c: c.router)
PORT = Side("port", _port_make, TError, terr, TSelector, _port_counters,
            lambda c: c.storage)


def _conflict(s, db, tr, key=b"k", new_value=b"2"):
    """Make ``tr`` (which read ``key``) conflict with a concurrent write;
    the 1020 it raises."""
    db.set(key, new_value)
    with pytest.raises(s.error) as ei:
        tr.commit()
    assert ei.value.code == 1020
    return ei.value


def _report(e):
    return (e.code, e.conflicting_key_ranges, e.conflict_version)


# ───────────────────────── the cases ─────────────────────────
def _queue3_repro(c, s):
    """Commit k; A reads k; another txn rewrites k with the same value; A
    writes k and commits: a 1020 with k's range and the rejecting version,
    then a verbatim replay that commits without running the body again
    (and without a backoff: the test knobs' backoff would still pass)."""
    db = c.database()
    db[b"k"] = b"1"
    runs = []

    def body(tr):
        runs.append(tr.get(b"k"))
        tr[b"k"] = b"A"

    a = db.create_transaction()
    body(a)
    e = _conflict(s, db, a, new_value=b"1")
    a.on_error(e)
    ready = a.repair_ready
    if not ready:
        body(a)
    a.commit()
    return _report(e), ready, runs, db[b"k"], s.counters(c)


def _value_dependent_falls_back_seeded(c, s):
    db = c.database()
    db.set(b"k", b"1")
    db.set(b"c", b"const")
    tr = db.create_transaction()
    v = tr.get(b"k")
    assert tr.get(b"c") == b"const"
    tr.set(b"out", b"from-" + v)
    e = _conflict(s, db, tr)
    tr.on_error(e)
    seeded = (tr.repair_ready, tr._read_version == e.conflict_version,
              dict(tr._repair_cache))
    v = tr.get(b"k")
    tr.set(b"out", b"from-" + v)
    tr.commit()
    return _report(e), seeded, db.get(b"out"), s.counters(c)


def _spurious_replays_verbatim(c, s):
    db = c.database()
    db.set(b"k", b"1")
    tr = db.create_transaction()
    v = tr.get(b"k")
    tr.set(b"out", b"saw-" + v)
    e = _conflict(s, db, tr, new_value=b"1")
    tr.on_error(e)
    ready = tr.repair_ready
    tr.commit()
    return _report(e), ready, db.get(b"out"), s.counters(c)


def _retry_loop_skips_body_on_replay(c, s):
    db = c.database()
    db.set(b"k", b"1")
    calls = []

    def fn(tr):
        calls.append(1)
        tr.get(b"k")
        tr.add(b"ctr", struct.pack("<q", 1))
        if len(calls) == 1:
            db.set(b"k", b"1")  # a same-value rewrite after the read

    db.run(fn)
    return len(calls), struct.unpack("<q", db.get(b"ctr"))[0], s.counters(c)


def _cache_serves_reads_without_storage(c, s):
    db = c.database()
    db.set(b"k", b"1")
    db.set(b"c", b"const")
    tr = db.create_transaction()
    tr.get(b"k")
    tr.get(b"c")
    tr.set(b"out", b"x")
    tr.on_error(_conflict(s, db, tr))
    reads = []
    st = s.storage(c)
    orig = st.get

    def counting_get(key, rv):
        reads.append(key)
        return orig(key, rv)

    st.get = counting_get
    try:
        vals = (tr.get(b"c"), tr.get(b"k"))
    finally:
        del st.get  # the instance wrapper; the method is back
    return tr.repair_ready, vals, reads


def _range_reads_repair(c, s):
    """A range read in the op log: a same-value rewrite inside it
    replays; a changed row re-runs the body with the range refreshed."""
    db = c.database()
    for k in (b"ra", b"rb", b"rc"):
        db[k] = b"1"
    out = []
    for new in (b"1", b"2"):
        tr = db.create_transaction()
        rows = tr.get_range(b"ra", b"rz")
        tr[b"sum"] = b"%d" % len(rows)
        e = _conflict(s, db, tr, key=b"rb", new_value=new)
        tr.on_error(e)
        out.append((_report(e), tr.repair_ready))
        if not tr.repair_ready:
            rows = tr.get_range(b"ra", b"rz")
            tr[b"sum"] = b"%d" % len(rows)
        tr.commit()
        out.append(rows)
    return out, db[b"sum"], s.counters(c)


def _blanket_1020_restarts_cold(c, s):
    db = c.database()
    tr = db.create_transaction()
    tr.get(b"k")
    tr.set(b"o", b"x")
    return (tr.try_repair(s.err("not_committed")),
            tr.try_repair(s.err("commit_unknown_result")))


def _rounds_are_bounded(c, s):
    db = c.database()
    db.set(b"k", b"1")
    tr = db.create_transaction()
    tr.get(b"k")
    tr.set(b"o", b"x")
    first = tr.try_repair(_conflict(s, db, tr, new_value=b"2"))
    tr.get(b"k")
    tr.set(b"o", b"x")
    second = tr.try_repair(_conflict(s, db, tr, new_value=b"3"))
    return first, second, s.counters(c)


def _unreplayable_never_replays(c, s):
    db = c.database()
    db.set(b"k", b"1")
    db.set(b"a", b"x")
    tr = db.create_transaction()
    tr.get(b"k")
    tr.get_key(s.selector.first_greater_or_equal(b"a"))
    tr.set(b"o", b"x")
    tr.on_error(_conflict(s, db, tr, new_value=b"1"))
    return tr.repair_ready, s.counters(c)


def _watch_txn_restarts_cold(c, s):
    db = c.database()
    db.set(b"k", b"1")
    tr = db.create_transaction()
    tr.get(b"k")
    tr.watch(b"w")
    tr.set(b"o", b"x")
    return tr.try_repair(_conflict(s, db, tr, new_value=b"1")), s.counters(c)


CASES = {f.__name__[1:]: f for f in (
    _queue3_repro, _value_dependent_falls_back_seeded,
    _spurious_replays_verbatim, _retry_loop_skips_body_on_replay,
    _cache_serves_reads_without_storage, _range_reads_repair,
    _blanket_1020_restarts_cold, _unreplayable_never_replays,
    _watch_txn_restarts_cold)}


def _run(side, case, backend, **kw):
    c = side.make(backend, **kw)
    try:
        return case(c, side)
    finally:
        c.close()


@pytest.mark.parametrize("backend", ["host", "device"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_repair_case_matches_jax(name, backend):
    case = CASES[name]
    want = _run(JAX, case, backend)
    assert _run(PORT, case, backend) == want


def test_queue3_repro_gets_the_reference_error():
    """The fault as filed: the port's 1020 now carries the conflicting
    range and the rejecting commit version, and the replay commits with
    the body run once."""
    report, ready, runs, final, counters = _run(PORT, _queue3_repro, "device")
    assert report[0] == 1020 and report[1] == [(b"k", b"k\x00")]
    assert report[2] is not None
    assert ready and runs == [b"1"] and final == b"A"
    assert counters == {"repair_attempts": 1, "repair_commits": 1,
                        "repair_fallbacks": 0}
    assert report == _run(JAX, _queue3_repro, "device")[0]


@pytest.mark.parametrize("backend", ["host", "device"])
def test_repair_rounds_bound_matches_jax(backend):
    want = _run(JAX, _rounds_are_bounded, backend, txn_repair_max_rounds=1)
    got = _run(PORT, _rounds_are_bounded, backend, txn_repair_max_rounds=1)
    assert got == want and got[:2] == (True, False)


def test_queue3_repro_in_thread_mode_matches_jax():
    """Through the batching pipeline: the 1020 reaches the client only
    after its conflict version is readable, so the repair's re-read at
    that version succeeds, as in the JAX thread cluster."""
    want = _run(JAX, _queue3_repro, "device", commit_pipeline="thread")
    got = _run(PORT, _queue3_repro, "device", commit_pipeline="thread")
    assert got == want and got[1]


def test_repair_default_on_and_knob_opt_out():
    for side in (JAX, PORT):
        c = side.make("device")
        try:
            assert c.database().create_transaction()._repair is not None
        finally:
            c.close()
        c = side.make("device", txn_repair=False)
        try:
            tr = c.database().create_transaction()
            assert tr._repair is None
            tr.options.set_transaction_repair()
            assert tr._repair is not None
        finally:
            c.close()


def _route_results(side, route):
    """Eight requests at one read version through one commit route: each
    reads the hot key (or a range over it) and writes it, so the first
    commits and the rest conflict. Every 1020 must carry its ranges and
    the rejecting commit version."""
    from foundationdb_tpu.core import flatpack as jflat
    from foundationdb_tpu.core.commit import CommitRequest as JRequest
    from foundationdb_tpu.core.mutations import Mutation as JMutation
    from foundationdb_tpu.core.mutations import Op as JOp
    from foundationdb_tpu.server import batcher as jbatcher
    from foundationdb_tpu_torch.core import flatpack as tflat
    from foundationdb_tpu_torch.core.commit import CommitRequest as TRequest
    from foundationdb_tpu_torch.core.mutations import Mutation as TMutation
    from foundationdb_tpu_torch.core.mutations import Op as TOp
    from foundationdb_tpu_torch.server import batcher as tbatcher

    port = side is PORT
    request, flat, mutation, op, batcher = (
        (TRequest, tflat, TMutation, TOp, tbatcher) if port
        else (JRequest, jflat, JMutation, JOp, jbatcher))
    kw = dict(commit_pipeline="thread", commit_batch_max=2) \
        if route == "pipelined" else {}
    c = side.make("device", **kw)
    try:
        db = c.database()
        db[b"hot"] = b"0"
        rv = c.grv_proxy.get_read_version()
        reqs = []
        for i in range(8):
            reads = ([(b"hot", b"hot\x00")] if i % 2 else
                     [(b"ho", b"hp")])
            writes = [(b"hot", b"hot\x00")]
            reqs.append(request(
                rv, [mutation(op.SET, b"hot", b"%d" % i)], reads, writes,
                report_conflicting_keys=True,
                flat_conflicts=flat.encode_conflicts(
                    reads, writes, TEST_KNOBS["key_limbs"])))
        if route == "commit_batch":
            res = c.commit_proxy.commit_batch(reqs)
        elif route == "commit_batches":
            res = [r for b in c.commit_proxy.commit_batches(
                [reqs[:4], reqs[4:]]) for r in b]
        else:
            bp = c.commit_proxy
            bp._backlog_target = 2
            pairs = [(r, batcher.CommitFuture(bp)) for r in reqs]
            bp._run_batch(pairs)
            bp.drain_pipeline()
            assert bp.stages._count.get("apply", 0) > 0  # it pipelined
            res = [f.result(timeout=60) for _, f in pairs]
        return [_report(r) if isinstance(r, side.error) else "v" for r in res]
    finally:
        c.close()


@pytest.mark.parametrize("route", ["commit_batch", "commit_batches",
                                   "pipelined"])
def test_every_commit_route_reports_conflicts_like_jax(route):
    want = _route_results(JAX, route)
    got = _route_results(PORT, route)
    assert got == want
    conflicts = [r for r in got if r != "v"]
    assert conflicts and all(r[1] and r[2] is not None for r in conflicts)
