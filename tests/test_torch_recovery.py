"""Recovery of the port's cluster against the JAX package's, at tolerance
0: one script runs on both databases — a durable cluster (three WAL
replicas, the sqlite engine, coordinators on disk) is preloaded,
commits, loses a log, is dropped without a close and reopened on the
same files, fences a read version from before the crash, then loses its
commit proxy and its sequencer and is recovered by
``detect_and_recruit``. Outcomes, every row, the generations, the
recovered versions of each recovery and the resolver's 12 state fields
must be equal. Then the cases of ``tests/test_txn_recovery.py`` on both
(the thread pipeline's queued commits failing 1021, batched GRVs
stalling on a dead sequencer, a workload riding out a dead proxy), a
fleet wedged by a ``GateTimeout`` recovered instead of left dead, and
the resolver's history and compiled steps handed to its replacement.
"""

import numpy as np
import pytest
import torch

from foundationdb_tpu.core.errors import FDBError as JError
from foundationdb_tpu.server import kvstore as jkv
from foundationdb_tpu.server.cluster import Cluster as JCluster
from foundationdb_tpu_torch.convert import state_to_numpy
from foundationdb_tpu_torch.core.errors import FDBError as TError
from foundationdb_tpu_torch.core.options import Knobs
from foundationdb_tpu_torch.core.status import COMMITTED, TOO_OLD
from foundationdb_tpu_torch.ops import conflict as ck
from foundationdb_tpu_torch.resolver.resolver import Resolver, ResolverDown
from foundationdb_tpu_torch.resolver.skiplist import TxnRequest
from foundationdb_tpu_torch.server import kvstore as tkv
from foundationdb_tpu_torch.server.cluster import Cluster as TCluster

from tests.conftest import TEST_KNOBS

torch.set_num_threads(1)

# the JAX thread cluster's daemons (prober, history, scan) commit and
# read on their own schedule; the port has none, so parity turns them off
JAX_QUIET = dict(health_probe_enabled=False, history_enabled=False,
                 consistency_scan_enabled=False)

SIDES = {
    "jax": dict(name="jax", cluster=lambda **kw: JCluster(**kw, **JAX_QUIET),
                kv=jkv,
                error=JError,
                state=lambda c: [np.asarray(f) for f in c.resolvers[0].state]),
    "port": dict(name="port",
                 cluster=lambda **kw: TCluster(device="cpu", **kw), kv=tkv,
                 error=TError,
                 state=lambda c: list(state_to_numpy(c.resolvers[0].state))),
}


def _both(script, *args):
    """``script(side, *args)`` on both databases; its last item is the
    resolver state, compared field by field. Returns the port's rest."""
    out = {name: script(side, *args) for name, side in SIDES.items()}
    state = {name: out[name].pop() for name in out}
    assert out["port"] == out["jax"]
    for a, b in zip(state["port"], state["jax"]):
        assert np.array_equal(a, b)
    return out["port"]


def _code(error, fn):
    try:
        fn()
        return "ok"
    except error as e:
        return e.code


def _increment(db, key):
    def inc(tr):
        v = tr[key]
        tr[key] = b"%d" % ((int(v) if v is not None else 0) + 1)

    db.run(inc)


def _durable_script(s, root):
    err = s["error"]
    d = root / s["name"]
    d.mkdir()

    def open_cluster():
        return s["cluster"](
            wal_path=str(d / "wal"), n_tlogs=3, coordination_dir=str(d / "c"),
            storage_engines=[s["kv"].open_engine("sqlite", str(d / "kv"))],
            **TEST_KNOBS)

    c = open_cluster()
    db = c.database()
    for i in range(40):
        db[b"user%04d" % i] = b"v%d" % i
    c.storage.flush()  # the preload made durable in the engine
    for j in range(12):
        _increment(db, b"counter%d" % (j % 3))
    out = [c.generation, c.sequencer.committed_version]
    rv_old = c.sequencer.committed_version
    c.tlog.kill(0)
    for j in range(6):
        _increment(db, b"counter%d" % (j % 3))
        db[b"late%d" % j] = b"x"
    acked = db.get_range(b"", b"\xff")
    del db, c  # a crash: no close

    c = open_cluster()
    db = c.database()
    out += [c.generation, c.sequencer.committed_version,
            db.get_range(b"", b"\xff") == acked]
    stale = db.create_transaction()
    stale.set_read_version(rv_old)
    stale[b"stale"] = b"1"
    out.append(_code(err, stale.commit))
    _increment(db, b"counter0")

    c._commit_target().kill()
    tr = db.create_transaction()
    tr[b"during"] = b"x"
    out.append(_code(err, tr.commit))
    out.append(c.detect_and_recruit())
    tr.reset()
    tr[b"during"] = b"x"
    out.append(_code(err, tr.commit))

    c.sequencer.kill()
    out.append(_code(err, lambda: db.create_transaction().get_read_version()))
    out.append(c.detect_and_recruit())
    for j in range(6):
        _increment(db, b"counter%d" % (j % 3))
    out.append(db.get_range(b"", b"\xff"))
    out.append([(r["generation"], r["trigger"], r["recovered_version"],
                 sorted(r["phases"]))
                for r in c.recovery_timeline.snapshot()["records"]])
    out.append(s["state"](c))
    c.close()
    return out


def test_durable_cluster_reopen_and_recoveries_match_reference(tmp_path):
    out = _both(_durable_script, tmp_path)
    gen0, gen1 = out[0], out[2]
    assert gen1 == gen0 + 1 and out[4] is True  # every acked write back
    assert out[5] == 1007  # the pre-crash read version is fenced
    assert out[6] == 1021 and out[7] == [("txn-system", 0)] and out[8] == "ok"
    assert out[9] == 1037 and out[10] == [("txn-system", 0)]
    counters = dict(out[11])
    assert [int(counters[b"counter%d" % i]) for i in range(3)] == [9, 8, 8]
    assert [r[0] for r in out[12]] == [gen1 + 1, gen1 + 2]
    assert [r[1] for r in out[12]] == ["commit_proxy_failed",
                                       "sequencer_failed"]


def _thread_script(s):
    err = s["error"]
    c = s["cluster"](commit_pipeline="thread", **TEST_KNOBS)
    try:
        db = c.database()
        db[b"seed"] = b"s"
        c._commit_target().kill()
        tr = db.create_transaction()
        tr[b"x"] = b"y"
        res = tr.commit_async().result(timeout=10)
        out = [res.code if isinstance(res, err) else res]
        out.append(c.detect_and_recruit())
        db[b"after"] = b"z"
        c.sequencer.kill()
        out.append(_code(err, lambda: db.create_transaction()
                         .get_read_version()))
        out.append(c.detect_and_recruit())
        out.append(db.get_range(b"", b"\xff"))
        out.append(c.generation)
        out.append(s["state"](c))
        return out
    finally:
        c.close()


def test_thread_pipeline_recoveries_match_reference():
    out = _both(_thread_script)
    assert out[0] == 1021 and out[2] == 1037
    assert out[1] == out[3] == [("txn-system", 0)]


def _workload_script(s):
    err = s["error"]
    c = s["cluster"](**TEST_KNOBS)
    db = c.database()
    out = []
    for i in range(30):
        if i in (7, 19):
            c._commit_target().kill()
        if i == 13:
            c.sequencer.kill()
        for _ in range(20):
            tr = db.create_transaction()
            try:
                tr[b"w%03d" % i] = b"v%d" % i
                tr.commit()
                break
            except err as e:
                assert e.is_retryable
                out.append(e.code)
                out.append(c.detect_and_recruit())
        else:
            raise AssertionError(f"txn {i} never committed")
    out += [db.get_range(b"w", b"x"), c.generation, s["state"](c)]
    c.close()
    return out


def test_workload_rides_out_proxy_and_sequencer_deaths():
    out = _both(_workload_script)
    assert len(out[-2]) == 30
    assert out.count([("txn-system", 0)]) == 3


def _wedge_script(s):
    """A 2-proxy fleet whose gate turn is stolen: the member that waits
    on it times out, answers 1021 and dies; the monitor recovers the
    fleet with fresh gates."""
    err = s["error"]
    c = s["cluster"](n_commit_proxies=2, gate_timeout_s=0.2, **TEST_KNOBS)
    try:
        db = c.database()
        db[b"a"] = b"1"
        c.sequencer.next_commit_versions(1)  # a grant no one advances
        tr = db.create_transaction()
        tr[b"b"] = b"2"
        out = [_code(err, tr.commit), c._commit_target().alive]
        out.append(c.detect_and_recruit())
        out.append(c._commit_target().alive)
        db[b"b"] = b"3"
        out += [db.get_range(b"", b"\xff"), s["state"](c)]
        return out
    finally:
        c.close()


def test_gate_timeout_leaves_a_dead_proxy_that_is_recovered():
    out = _both(_wedge_script)
    assert out[:4] == [1021, False, [("txn-system", 0)], True]


def test_respawn_hands_history_and_steps_to_the_replacement():
    """A device resolver's replacement takes its state tensors and
    compiled steps, zeroed: its first batch captures nothing new, the
    state equals a fresh resolver's, and the old one is dead and
    holding neither."""
    knobs = Knobs(**TEST_KNOBS)
    r = Resolver(knobs, device="cpu")
    r.resolve([TxnRequest(read_version=0, point_writes=[b"a"],
                          range_writes=[(b"b", b"c")])], 1000, 0)
    state_ids = [id(t) for t in r.state]
    steps, captures = r._steps, dict(r._steps.captures)
    new = r.respawn(5000)
    assert [id(t) for t in new.state] == state_ids and new._steps is steps
    fresh = Resolver(knobs, base_version=5000, device="cpu")
    for a, b in zip(state_to_numpy(new.state), state_to_numpy(fresh.state)):
        assert np.array_equal(a, b)
    assert not r.alive and r.state is None and r._steps is not steps
    with pytest.raises(ResolverDown):
        r.resolve([], 6000, 0)
    batch = [TxnRequest(read_version=4000, point_reads=[b"a"]),
             TxnRequest(read_version=5000, point_reads=[b"a"],
                        range_writes=[(b"b", b"c")])]
    assert new.resolve(batch, 6000, 0) == [TOO_OLD, COMMITTED]
    assert fresh.resolve(batch, 6000, 0) == [TOO_OLD, COMMITTED]
    assert new._steps.captures == captures  # replayed, nothing captured
    for a, b in zip(state_to_numpy(new.state), state_to_numpy(fresh.state)):
        assert np.array_equal(a, b)


def test_recovery_keeps_the_cluster_resolver_steps():
    c = TCluster(device="cpu", **TEST_KNOBS)
    try:
        db = c.database()
        db[b"a"] = b"1"
        db.run(lambda tr: tr.get_range(b"a", b"z") and tr.set(b"b", b"2"))
        steps = c.resolvers[0]._steps
        keys = set(steps.captures)
        ck.reset_graph_counts()
        c._commit_target().kill()
        c.detect_and_recruit()
        db.run(lambda tr: tr.get_range(b"a", b"z") and tr.set(b"c", b"3"))
        assert c.resolvers[0]._steps is steps
        assert set(steps.captures) == keys
        assert c.status()["cluster"]["recovery"]["count"] == 1
    finally:
        c.close()
