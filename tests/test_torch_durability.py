"""The port's durability against the JAX package's, at tolerance 0: the
same scripts run on both packages' logs (``TLog`` with its WAL, torn
tails and abort markers; ``TLogSystem`` with minority death, quorum loss
and revive), storage engines (every engine reopened, torn op logs,
snapshots, sqlite rolling back what was never committed), the storage
server on a versioned engine, the coordinators (and their generation
CAS under competing proposers), and the cluster on replicated logs. WAL
bytes differ (they pickle each package's own classes), so recovered
records compare as ``(version, [(op, key, param)])``; no test reads a
file the other package wrote. fsync stays off.
"""

import sys
import threading

import pytest

from foundationdb_tpu.core.errors import FDBError as JError
from foundationdb_tpu.core.mutations import Mutation as JMutation
from foundationdb_tpu.core.mutations import Op as JOp
from foundationdb_tpu.server import coordination as jcoord
from foundationdb_tpu.server import kvstore as jkv
from foundationdb_tpu.server import storage as jstorage
from foundationdb_tpu.server import tlog as jtlog
from foundationdb_tpu.server.cluster import Cluster as JCluster
from foundationdb_tpu_torch.core.errors import FDBError as TError
from foundationdb_tpu_torch.core.mutations import Mutation as TMutation
from foundationdb_tpu_torch.core.mutations import Op as TOp
from foundationdb_tpu_torch.server import coordination as tcoord
from foundationdb_tpu_torch.server import kvstore as tkv
from foundationdb_tpu_torch.server import storage as tstorage
from foundationdb_tpu_torch.server import tlog as ttlog
from foundationdb_tpu_torch.server.cluster import Cluster as TCluster

from tests.conftest import TEST_KNOBS

SIDES = {
    "jax": dict(tlog=jtlog, kv=jkv, storage=jstorage, coord=jcoord,
                M=JMutation, Op=JOp, cluster=JCluster, error=JError),
    "port": dict(tlog=ttlog, kv=tkv, storage=tstorage, coord=tcoord,
                 M=TMutation, Op=TOp,
                 cluster=lambda **kw: TCluster(device="cpu", **kw),
                 error=TError),
}


def _norm(records):
    return [(v, [(m.op.name, m.key, m.param) for m in muts])
            for v, muts in records]


def _both(script, tmp_path):
    """``script(side, dir)`` on each package in its own directory; the
    two results must be equal. Returns the port's."""
    out = {}
    for name, side in SIDES.items():
        d = tmp_path / name
        d.mkdir()
        out[name] = script(side, d)
    assert out["port"] == out["jax"]
    return out["port"]


# ── the log ──

def _tlog_script(s, d):
    M, Op, TLog = s["M"], s["Op"], s["tlog"].TLog
    path = str(d / "wal")
    log = TLog(wal_path=path)
    log.push(10, [M(Op.SET, b"a", b"1")])
    log.push(20, [M(Op.SET, b"b", b"2"), M(Op.CLEAR_RANGE, b"c", b"d")])
    log.push(30, [M(Op.ADD, b"n", b"\x01")])
    log.rollback(30)  # missed its quorum: an abort marker
    log.push(30, [M(Op.SET, b"c", b"4")])  # the version granted again
    log.hold_pop("cursor", 10)
    log.pop(20)  # clamped by the cursor
    held = _norm(log.peek(0))
    log.release_pop("cursor")
    log.pop(20)
    out = [held, _norm(log.peek(0)), log.last_version]
    with pytest.raises(ValueError):
        log.push(25, [])
    log.close()
    out.append(_norm(TLog.recover(path)))
    raw = open(path, "rb").read()
    for cut in (len(raw) - 3, len(raw) - 20, 9):  # torn tails
        open(path, "wb").write(raw[:cut])
        out.append(_norm(TLog.recover(path)))
    bad = bytearray(raw)
    bad[12] ^= 0xFF  # a corrupt first record: nothing after it counts
    open(path, "wb").write(bytes(bad))
    out.append(_norm(TLog.recover(path)))
    out.append(TLog.recover(str(d / "missing")))
    return out


def test_tlog_wal_torn_tails_and_abort_markers(tmp_path):
    out = _both(_tlog_script, tmp_path)
    assert out[3] == [(10, [("SET", b"a", b"1")]),
                      (20, [("SET", b"b", b"2"),
                            ("CLEAR_RANGE", b"c", b"d")]),
                      (30, [("SET", b"c", b"4")])]
    assert out[-2] == [] and out[-1] == []


def _tlog_system_script(s, d):
    M, Op, mod = s["M"], s["Op"], s["tlog"]
    base = str(d / "w")
    ts = mod.TLogSystem(3, wal_path=base)
    out = []
    ts.push(10, [M(Op.SET, b"a", b"1")])
    ts.kill(0)  # a minority dies: pushes still ack
    ts.push(20, [M(Op.SET, b"b", b"2")])
    out.append(_norm(ts.peek(0)))
    ts.kill(1)  # the quorum is lost: the partial push rolls back
    with pytest.raises(mod.TLogDown):
        ts.push(30, [M(Op.SET, b"limbo", b"x")])
    out.append(_norm(ts.logs[2].peek(0)))
    out.append(ts.revive(0) is not None)
    ts.push(40, [M(Op.SET, b"c", b"3")])
    out.append([_norm(log.peek(0)) if log.alive else None for log in ts.logs])
    ts.pop(20)
    out.append((_norm(ts.peek(0)), ts.last_version))
    ts.close()
    out.append(_norm(mod.TLogSystem.recover(base, 3)))
    out.append([_norm(mod.TLog.recover(p))
                for p in mod.TLogSystem.replica_paths(base, 3)])
    dead = mod.TLogSystem(2)
    dead.kill(0)
    dead.kill(1)
    out.append(dead.revive(0))  # no live donor: stays dead
    return out


def test_tlog_system_minority_death_quorum_loss_and_revive(tmp_path):
    out = _both(_tlog_system_script, tmp_path)
    assert [v for v, _ in out[-3]] == [10, 20, 40]  # 30 never acked


def test_wait_for_version_wakes_on_push():
    for log in (ttlog.TLog(), ttlog.TLogSystem(3)):
        assert log.wait_for_version(1, timeout=0.01) is False
        woke = []
        th = threading.Thread(
            target=lambda log=log: woke.append(
                log.wait_for_version(1, timeout=5.0)))
        th.start()
        log.push(1, [])
        th.join(timeout=5)
        assert woke == [True]


# ── the storage engines ──

def _engine_ops(e, M, versioned):
    """Sets, clears and commits; a versioned engine also takes versioned
    writes and a prune."""
    for i in range(12):
        e.set(b"k%02d" % i, b"v%d" % i)
    e.commit(100)
    e.clear_range(b"k03", b"k06")
    e.set(b"k20", b"x")
    e.commit(200)
    if versioned:
        e.set_versioned(b"k01", 300, b"new")
        e.set_versioned(b"k02", 300, None)
        e.commit(300)
        e.prune(250)


def _engine_view(e, versioned):
    out = [e.stored_version(), e.get_range(b"", b"\xff"),
           e.get_range(b"k", b"l", limit=3, reverse=True), len(e)]
    if versioned:
        out += [e.oldest_retained,
                [list(e.iter_range_at(b"", None, v)) for v in (200, 300)],
                list(e.iter_chains(b"k00", b"k05"))]
    return out


ENGINES = [("memory", {}), ("memory", {"snapshot_every_ops": 5}),
           ("versioned", {}), ("versioned", {"snapshot_every_ops": 5}),
           ("redwood", {}), ("sqlite", {})]


@pytest.mark.parametrize("kind,kw", ENGINES,
                         ids=[f"{k}{'-snap' if kw else ''}" for k, kw in ENGINES])
def test_every_engine_reopens_to_what_it_committed(tmp_path, kind, kw):
    versioned = kind in ("versioned", "redwood")

    def script(s, d):
        path = str(d / "db")
        e = s["kv"].open_engine(kind, path, **kw)
        _engine_ops(e, s["M"], versioned)
        before = _engine_view(e, versioned)
        e.close()
        again = s["kv"].open_engine(kind, path, **kw)
        after = _engine_view(again, versioned)
        again.close()
        assert after == before
        return after

    out = _both(script, tmp_path)
    assert out[0] == (300 if versioned else 200)


def test_torn_oplog_and_uncommitted_sqlite_writes(tmp_path):
    def script(s, d):
        kv = s["kv"]
        path = str(d / "mem")
        e = kv.open_engine("memory", path)
        e.set(b"a", b"1")
        e.commit(10)
        e.set(b"b", b"2")
        e.commit(20)
        e.close()
        raw = open(path + ".oplog", "rb").read()
        open(path + ".oplog", "wb").write(raw[:-4])  # a torn last record
        torn = kv.open_engine("memory", path)
        out = [torn.stored_version(), torn.get_range(b"", b"\xff")]
        torn.close()
        sq = kv.open_engine("sqlite", str(d / "sq"))
        sq.set(b"a", b"1")
        sq.commit(10)
        sq.set(b"lost", b"x")  # never committed: a crash drops it
        sq._conn.rollback()
        sq._conn.close()
        again = kv.open_engine("sqlite", str(d / "sq"))
        out += [again.stored_version(), again.get_range(b"", b"\xff")]
        again.close()
        return out

    out = _both(script, tmp_path)
    assert out[2:] == [10, [(b"a", b"1")]]


def test_storage_on_a_versioned_engine_reads_below_durable(tmp_path):
    """The storage server flushes every version into a versioned engine,
    serves reads below its durable version from the chains, prunes as
    the window moves, and recovers from the engine plus log records."""
    def script(s, d):
        M, Op = s["M"], s["Op"]
        eng = s["kv"].open_engine("versioned", str(d / "v"))
        st = s["storage"].StorageServer(engine=eng)
        records = []
        for v in range(1, 9):
            muts = [M(Op.SET, b"k", b"%d" % v), M(Op.ADD, b"n", b"\x01")]
            if v == 5:
                muts.append(M(Op.CLEAR_RANGE, b"k", b"l"))
            st.apply(v * 10, muts)
            records.append((v * 10, muts))
        st.flush(60)
        out = [st.durable_version, st.oldest_version,
               [st.get(b"k", v) for v in (10, 40, 50, 60, 80)],
               st.get_range(b"", b"\xff", 30)]
        st.advance_window(40)
        out += [st.oldest_version, eng.oldest_retained,
                list(eng.iter_chains(b"", None))]
        eng.close()
        again = s["kv"].open_engine("versioned", str(d / "v"))
        rec = s["storage"].StorageServer.recover(again, records)
        out += [rec.durable_version, rec.version,
                [rec.get(b"k", v) for v in (40, 60, 80)], rec.get(b"n", 80)]
        again.close()
        return out

    out = _both(script, tmp_path)
    assert out[2] == [b"1", b"4", None, b"6", b"8"]


# ── the coordinators ──

def _coord_script(s, d):
    C = s["coord"]
    q = C.CoordinationQuorum.local(3, str(d))
    out = [q.read_quorum()]
    q.write_quorum({"generation": 1})
    q.write_quorum({"generation": 2, "recovered_version": 42},
                   expect_generation=1)
    with pytest.raises(C.GenerationConflict):
        q.write_quorum({"generation": 9}, expect_generation=1)
    out.append(C.CoordinationQuorum.local(3, str(d)).read_quorum())
    q.coordinators[0].alive = False  # a minority down: still served
    q.write_quorum({"generation": 3})
    out.append(q.read_quorum())
    q.coordinators[1].alive = False
    with pytest.raises(C.CoordinatorDown):
        q.write_quorum({"generation": 4})
    with pytest.raises(C.CoordinatorDown):
        q.read_quorum()
    coords = [C.Coordinator() for _ in range(3)]
    a = C.CoordinationQuorum(coords, proposer_id=0, n_proposers=2)
    b = C.CoordinationQuorum(coords, proposer_id=1, n_proposers=2)
    for g in range(5):
        b.write_quorum({"generation": g})
    a.write_quorum({"generation": 99})  # a's stale ballot jumps ahead
    out.append(b.read_quorum())
    return out


def test_coordination_matches_reference(tmp_path):
    out = _both(_coord_script, tmp_path)
    assert out == [None, {"generation": 2, "recovered_version": 42},
                   {"generation": 3}, {"generation": 99}]


def test_generation_cas_under_competing_proposers():
    """Six proposers on three shared coordinators, each winning
    generations by read + CAS in its own thread: every generation is won
    exactly once, and they run 1..N with no gap."""
    coords = [tcoord.Coordinator() for _ in range(3)]
    won, errors = [], []

    def proposer(pid):
        q = tcoord.CoordinationQuorum(coords, proposer_id=pid, n_proposers=6)
        try:
            for _ in range(4):
                while True:
                    g = (q.read_quorum() or {}).get("generation", 0) + 1
                    try:
                        q.write_quorum({"generation": g, "who": pid},
                                       expect_generation=g - 1)
                        won.append(g)
                        break
                    except tcoord.GenerationConflict:
                        continue
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    ts = [threading.Thread(target=proposer, args=(i,)) for i in range(6)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # interleave the proposers finely
    try:
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in ts)
    assert not errors
    assert sorted(won) == list(range(1, 25))
    assert tcoord.CoordinationQuorum(coords).read_quorum()["generation"] == 24


# ── the cluster on replicated logs ──

def test_cluster_replicated_logs_match_reference(tmp_path):
    """Kill one of three logs: no acked write lost across a restart;
    lose the quorum: the commit answers 1021, is not applied, and never
    comes back after a restart; revive and commit again."""
    def script(s, d):
        wal = str(d / "wal")
        kw = dict(wal_path=wal, n_tlogs=3, coordination_dir=str(d / "c"),
                  **TEST_KNOBS)
        c = s["cluster"](**kw)
        db = c.database()
        db[b"pre"] = b"1"
        c.tlog.kill(0)
        for i in range(5):
            db[b"k%d" % i] = b"v"  # acked by 2 of 3
        c.tlog.kill(1)
        tr = db.create_transaction()
        tr[b"limbo"] = b"x"
        with pytest.raises(s["error"]) as ei:
            tr.commit()
        out = [ei.value.code, db[b"limbo"], c.tlog.revive(0) is not None]
        db[b"later"] = b"y"
        out.append(c.generation)
        c.tlog.close()
        c2 = s["cluster"](**kw)
        db2 = c2.database()
        out += [db2.get_range(b"", b"\xff"), c2.generation,
                c2.sequencer.committed_version]
        db2[b"post"] = b"z"
        out.append(db2[b"post"])
        c2.close()
        return out

    out = _both(script, tmp_path)
    assert out[:3] == [1021, None, True]
    assert (b"limbo", b"x") not in out[4] and (b"later", b"y") in out[4]
    assert out[5] == out[3] + 1
