"""Replication and data distribution of the port against the JAX
package's: ``Cluster(n_storage=3, replication=2)`` on both, the same
seeded commits, and each side's shard map (boundaries, teams, sizes),
the moves of every ``rebalance()`` round, the rows each storage holds,
reads through the storage router, exclusion and drain, tagged log
peeks, size estimates and split points, the shard map restored from the
WAL (and its fleet-mismatch fallback), a recruited storage, and the
host resolvers' ranges derived from the map must be equal (tolerance
0). The host resolvers (``resolver_backend="cpu"``) serve where the
resolver is not the subject; the last case runs each package's default
resolver and compares its 12 state fields too.
"""

import os
import struct

import numpy as np
import pytest
import torch

from foundationdb_tpu_torch.utils.trace import trace_events
from tests.conftest import TEST_KNOBS
from tests.torch_sides import (
    JAX,
    PORT,
    muts,
    outcome,
    request,
    results,
    rows,
    shard_map,
)

torch.set_num_threads(1)

NKEYS = 400


def _key(i):
    return b"u%05d" % i


def _value(rng):
    return bytes(rng.integers(0, 256, int(rng.integers(50, 400)),
                              dtype=np.uint8))


def _cluster(side, **kw):
    kw = dict(dict(n_storage=3, replication=2, resolver_backend="cpu"), **kw)
    c = side.cluster(**dict(TEST_KNOBS, **kw))
    # small shards, so a few hundred rows split into many
    c.dd.max_shard_bytes = 8000
    c.dd.min_shard_bytes = 1000
    return c


def _batch(side, c, rng, n=16, clear_p=0.04):
    """``n`` blind-write requests (1-4 sets of 50-400 bytes, sometimes a
    clear range) at the committed version."""
    rv = c.sequencer.committed_version
    out = []
    for _ in range(n):
        sets = [(_key(rng.integers(NKEYS)), _value(rng))
                for _ in range(int(rng.integers(1, 5)))]
        clears = []
        if rng.random() < clear_p:
            a = int(rng.integers(NKEYS))
            clears = [(_key(a), _key(a + int(rng.integers(1, 20))))]
        out.append(request(side, rv, sets=sets, clears=clears))
    return out


def _reads(side, c, rng, n=24):
    """Seeded point, range and selector reads through the router, each
    in a fresh transaction and without a retry loop (a dead team's 1037
    is retryable: a loop would wait for its recruitment)."""
    db = c.database()
    out = []
    for _ in range(n):
        tr = db.create_transaction()
        kind = rng.integers(3)
        k = _key(rng.integers(NKEYS + 10))
        if kind == 0:
            out.append(outcome(side, lambda: tr.get(k)))
        elif kind == 1:
            e = _key(int(rng.integers(NKEYS + 10)) + 40)
            lim, rev = int(rng.integers(0, 30)), bool(rng.integers(2))
            out.append(outcome(side, lambda: tr.get_range(
                k, e, limit=lim, reverse=rev)))
        else:
            sel = side.selector(k, bool(rng.integers(2)),
                                int(rng.integers(-3, 4)))
            out.append(outcome(side, lambda: tr.get_key(sel)))
    return out


def _distribute(side, seed, rounds=6):
    rng = np.random.default_rng(seed)
    c = _cluster(side)
    out = []
    for _ in range(rounds):
        out.append(results(c.commit_proxy.commit_batch(_batch(side, c, rng))))
        out.append(c.rebalance())
        out.append(shard_map(c))
        out.append([rows(s) for s in c.storages])
        out.append(c.dd.team_bytes())
    out.append(_reads(side, c, rng))
    out.append(c.status()["cluster"]["data"])
    c.close()
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_shard_map_and_moves_match_jax(seed):
    want, got = _distribute(JAX, seed), _distribute(PORT, seed)
    assert got == want
    assert len(got[-5][0]) > 3  # the map split into several shards
    assert any(got[i] for i in range(1, len(got) - 2, 5))  # shards moved


def _dead_replicas(side, seed):
    """Reads with one storage dead (its teams served by the other
    replica), then with a whole team dead (retryable 1037)."""
    rng = np.random.default_rng(seed)
    c = _cluster(side)
    for _ in range(4):
        c.commit_proxy.commit_batch(_batch(side, c, rng, clear_p=0))
        c.rebalance()
    out = [_reads(side, c, rng)]
    c.storages[0].kill()
    out.append(_reads(side, c, rng))
    team = next(t for t in c.dd.map.teams if 0 in t)
    for sid in team:
        c.storages[sid].kill()
    out.append(_reads(side, c, rng))
    out.append([outcome(side, lambda k=k: c.router.get(k, c.router.version))
                for k in (_key(0), _key(NKEYS // 2), _key(NKEYS - 1))])
    # the router's batched serve: a dead team fails only its own slots
    v = c.router.version
    ops = [("g", _key(i), v) for i in range(0, NKEYS, 37)]
    ops += [("r", _key(10), _key(60), v, 5, False),
            ("s", side.selector(_key(90), False, 2), v), ("x",)]
    out.append([("err", r.code) if isinstance(r, side.error) else r
                for r in c.router.read_batch(ops)])
    c.close()
    return out


def test_router_reads_with_dead_replicas_match_jax():
    want, got = _dead_replicas(JAX, 3), _dead_replicas(PORT, 3)
    assert got == want
    assert ("err", 1037) in got[2]  # a team with no live replica raises
    assert ("err", 1037) in got[4] and any(
        not isinstance(r, tuple) for r in got[4])


def _exclusion(side, seed):
    rng = np.random.default_rng(seed)
    c = _cluster(side)
    for _ in range(3):
        c.commit_proxy.commit_batch(_batch(side, c, rng))
        c.rebalance()
    out = [c.exclude_storage(2), c.list_excluded()]
    for _ in range(10):
        if c.storage_drained(2):
            break
        out.append(c.rebalance())
    out += [c.storage_drained(2), shard_map(c),
            [c.storage_owned_ranges(sid) for sid in range(3)],
            _reads(side, c, rng)]
    # writes after the drain reach only the two remaining storages
    c.commit_proxy.commit_batch(_batch(side, c, rng))
    out.append([rows(s) for s in c.storages])
    c.include_storage(2)
    out += [c.list_excluded(), c.rebalance(), shard_map(c)]
    c.close()
    return out


def test_exclusion_and_drain_match_jax():
    want, got = _exclusion(JAX, 4), _exclusion(PORT, 4)
    assert got == want
    i = got.index(True)  # drained
    assert all(2 not in t for t in got[i + 1][1])


def _tag_peeks(side):
    """TLog and TLogSystem tag streams: tagged and untagged pushes, a
    rollback, a pop, a revived replica."""
    m = lambda k: side.mutation(side.op.SET, k, b"v")  # noqa: E731
    out = []
    for log in (side.tlog.TLog(), side.tlog.TLogSystem(3)):
        log.push(10, [m(b"a"), m(b"b")], tags={0: [m(b"a")], 1: [m(b"b")]})
        log.push(20, [m(b"c")])  # untagged: every tag sees the batch
        log.push(30, [m(b"d")], tags={1: [m(b"d")]})
        if isinstance(log, side.tlog.TLogSystem):
            log.kill(2)
            log.push(40, [m(b"e")], tags={0: [m(b"e")]})
            log.revive(2)
        else:
            log.push(40, [m(b"e")], tags={0: [m(b"e")]})
            log.rollback(40)
        for tag in (None, 0, 1, 2):
            out.append([(v, muts(ms)) for v, ms in log.peek(0, tag=tag)])
        log.pop(20)
        out.append([(v, muts(ms)) for v, ms in log.peek(0, tag=1)])
    return out


def test_tlog_tag_peeks_match_jax():
    want, got = _tag_peeks(JAX), _tag_peeks(PORT)
    assert got == want
    # tag 0 of the single log: its own split, the untagged batch whole,
    # an empty record for another tag's batch, the rollback gone
    assert got[1] == [(10, [("set", b"a", b"v")]), (20, [("set", b"c", b"v")]),
                      (30, [])]


def _cluster_peeks(side, seed):
    """The proxy's tagged pushes on a partitioned cluster, and none on a
    fully replicated one."""
    out = []
    for n, rep in ((3, 2), (2, None)):
        rng = np.random.default_rng(seed)
        c = _cluster(side, n_storage=n, replication=rep)
        for _ in range(3):
            c.commit_proxy.commit_batch(_batch(side, c, rng))
            c.rebalance()
        out.append([[(v, muts(ms)) for v, ms in c.tlog.peek(0, tag=t)]
                     for t in range(n)])
        out.append(sorted(c.tlog._tags))
        c.close()
    return out


def test_proxy_tagged_pushes_match_jax():
    want, got = _cluster_peeks(JAX, 5), _cluster_peeks(PORT, 5)
    assert got == want
    assert got[1] and not got[3]  # tags only where replication < n


def _estimates(side, seed):
    rng = np.random.default_rng(seed)
    c = _cluster(side)
    for _ in range(4):
        c.commit_proxy.commit_batch(_batch(side, c, rng, n=12))
        c.rebalance()
    tr = c.database().create_transaction()
    spans = [(b"", b"\xff"), (_key(0), _key(NKEYS)), (_key(37), _key(211)),
             (_key(150), _key(151)), (_key(390), b"\xff")]
    out = [c.estimated_range_size_bytes(b, e) for b, e in spans]
    out += [tr.get_estimated_range_size_bytes(b, e) for b, e in spans]
    for chunk in (1, 2000, 10_000, 10**9):
        out.append([tr.get_range_split_points(b, e, chunk) for b, e in spans])
    out.append(outcome(side, lambda: tr.get_range_split_points(
        b"", b"\xff", 0)))
    out.append(outcome(side, lambda: tr.get_range_split_points(
        b"z", b"a", 100)))
    c.close()
    return out


def test_size_estimates_and_split_points_match_jax():
    want, got = _estimates(JAX, 6), _estimates(PORT, 6)
    assert got == want
    assert got[0] > 0 and len(got[11][0]) > 3


def _restart(side, d, seed):
    """A partitioned cluster on a WAL, rebalanced and dropped; reopened
    with the same fleet (the map and replication restored from
    \\xff/keyServers/ and \\xff/conf/replication), then with a smaller
    fleet (the map names a storage it lacks: full placement)."""
    os.makedirs(d)
    wal = os.path.join(d, "wal")
    rng = np.random.default_rng(seed)
    c = _cluster(side, wal_path=wal)
    for _ in range(4):
        c.commit_proxy.commit_batch(_batch(side, c, rng))
        c.rebalance()
    before = shard_map(c)
    c.close()
    out = [before]
    c = _cluster(side, wal_path=wal)
    out += [shard_map(c), c.replication, c.dd.replication,
            _reads(side, c, rng), [rows(s) for s in c.storages]]
    c.close()
    c = side.cluster(**dict(TEST_KNOBS, resolver_backend="cpu",
                            wal_path=wal, n_storage=2))
    out += [shard_map(c), c.replication, _reads(side, c, rng)]
    c.close()
    return out


def test_shard_map_restored_after_wal_restart_matches_jax(tmp_path):
    want = _restart(JAX, str(tmp_path / "jax"), 7)
    got = _restart(PORT, str(tmp_path / "port"), 7)
    assert got == want
    assert got[1] == got[0] and got[2] == 2  # restored as persisted
    assert got[6][1] == [[0, 1]] and got[7] == 2  # the fallback
    assert trace_events("ShardMapFleetMismatch")


def _recruit(side, seed):
    """Storage 1 dies mid-stream, misses batches and a rebalance, and is
    recruited: it replays the log keeping only the mutations it owns."""
    rng = np.random.default_rng(seed)
    c = _cluster(side)
    for _ in range(3):
        c.commit_proxy.commit_batch(_batch(side, c, rng))
        c.rebalance()
    c.storages[1].kill()
    for _ in range(2):
        c.commit_proxy.commit_batch(_batch(side, c, rng))
    out = [c.detect_and_recruit(), rows(c.storages[1]), shard_map(c),
           _reads(side, c, rng)]
    c.commit_proxy.commit_batch(_batch(side, c, rng))
    out.append([rows(s) for s in c.storages])
    c.close()
    return out, c


def test_recruited_storage_holds_only_owned_rows_matches_jax():
    want, _ = _recruit(JAX, 8)
    got, c = _recruit(PORT, 8)
    assert got == want
    assert got[0] == [("storage", 1)]
    smap = c.dd.map
    user = [k for k, _ in got[1] if k < b"\xff"]
    assert user and all(1 in smap.team_for(k) for k in user)
    # and every row of the shards it owns
    owned = [k for k, _ in got[-1][0] + got[-1][2]
             if k < b"\xff" and 1 in smap.team_for(k)]
    assert set(owned) <= {k for k, _ in got[-1][1]}


def _resolver_ranges(side, seed):
    """A "cpu" 3-resolver fleet: the bounds follow the shard map's bytes,
    and a move of a bound fences the resolvers at the committed
    version (a read from before it answers TOO_OLD)."""
    rng = np.random.default_rng(seed)
    c = _cluster(side, n_resolvers=3)
    proxy = c._commit_target()
    out = [proxy.resolver_bounds]
    for _ in range(4):
        rv_old = c.sequencer.committed_version
        out.append(results(c.commit_proxy.commit_batch(
            _batch(side, c, rng))))
        c.rebalance()
        out.append(proxy.resolver_bounds)
        k = _key(rng.integers(NKEYS))
        stale = request(side, rv_old, sets=[(k, b"x")], reads=[k])
        fresh = request(side, c.sequencer.committed_version,
                        sets=[(k + b"!", b"y")], reads=[k])
        out.append(results(c.commit_proxy.commit_batch([stale, fresh])))
    c.close()
    return out


def test_update_resolver_ranges_matches_jax():
    want, got = _resolver_ranges(JAX, 9), _resolver_ranges(PORT, 9)
    assert got == want
    bounds = got[2::3]
    assert bounds[-1] is not None and len(bounds[-1]) == 2
    assert any(r[0] == ("err", 1007) for r in got[3::3])  # fenced


def _end_to_end(side, seed):
    """Each package's default resolver under a partitioned cluster:
    range reads and clear ranges over the routed tier."""
    rng = np.random.default_rng(seed)
    c = _cluster(side, resolver_backend=("tpu" if side is JAX else "cuda"))
    out = []
    for i in range(5):
        rv = c.sequencer.committed_version
        reqs = _batch(side, c, rng)
        for _ in range(4):
            a = int(rng.integers(NKEYS))
            reqs.append(side.request(
                read_version=max(0, rv - 1000 * int(rng.integers(3))),
                mutations=[side.mutation(side.op.SET, _key(a + 1), b"w")],
                read_conflict_ranges=[(_key(a), _key(a + 30))],
                write_conflict_ranges=[(_key(a + 1), _key(a + 1) + b"\x00")]))
        out.append(results(c.commit_proxy.commit_batch(reqs)))
        out.append(c.rebalance())
    out += [shard_map(c), [rows(s) for s in c.storages],
            _reads(side, c, rng)]
    state = side.state(c)
    c.close()
    return out, state


def test_replicated_cluster_matches_jax_end_to_end():
    (want, wstate), (got, gstate) = _end_to_end(JAX, 10), _end_to_end(PORT, 10)
    assert got == want
    assert len(wstate) == len(gstate) == 12
    for a, b in zip(wstate, gstate):
        np.testing.assert_array_equal(a, b)
    assert any(r == ("err", 1020) for b in got[0:10:2] for r in b)



def _mixed_rounds(side, route, seed, rounds=8, txns=40):
    """Rounds of ``db.run`` transactions mixing sets, ``add``,
    ``byte_max``, versionstamped keys and 2% clear ranges, each with a
    read, on ``double`` replication over 3 storages, with a rebalance
    after each round: through the sync proxy, a 3-proxy fleet or the
    thread pipeline (one client, so the batches are the same on both)."""
    kw = dict(n_storage=3, replication=2, resolver_backend="cpu")
    if route == "fleet":
        kw["n_commit_proxies"] = 3
    elif route == "thread":
        kw["commit_pipeline"] = "thread"
        # the thread-mode daemons (prober, history, scan) commit and
        # read on their own schedule: off on both sides
        kw.update(health_probe_enabled=False, history_enabled=False,
                  consistency_scan_enabled=False)
    c = side.cluster(**dict(TEST_KNOBS, **kw))
    c.dd.max_shard_bytes = 2000
    c.dd.min_shard_bytes = 300
    db = c.database()
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(rounds):
        for _ in range(txns):
            plan = [(int(rng.integers(0, 6)), int(rng.integers(0, NKEYS)),
                     int(rng.integers(20, 200))) for _ in range(3)]
            clear = rng.random() < 0.02
            read = _key(int(rng.integers(0, NKEYS)))

            def body(tr, plan=plan, clear=clear, read=read):
                seen = tr.get(read)
                for op, k, n in plan:
                    key = _key(k)
                    if op <= 2:
                        tr.set(key, bytes([k % 251]) * n)
                    elif op == 3:
                        tr.add(b"ctr" + key[-2:], struct.pack("<q", n))
                    elif op == 4:
                        tr.byte_max(key, bytes([n % 256]) * 4)
                    else:
                        tr.set_versionstamped_key(
                            b"vs" + b"\x00" * 10 + struct.pack("<I", 2),
                            b"%d" % k)
                if clear:
                    lo = plan[0][1]
                    tr.clear_range(_key(lo), _key(lo + 5))
                return seen

            out.append(db.run(body))
        out.append(len(c.rebalance()))
    out += [shard_map(c), [rows(s) for s in c.storages],
            db.run(lambda tr: tr.get_range(b"", b"\xff", limit=50,
                                           reverse=True))]
    c.close()
    return out


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("route", ["sync", "fleet", "thread"])
def test_mixed_atomic_versionstamp_rounds_match_jax(route, seed):
    want = _mixed_rounds(JAX, route, seed)
    got = _mixed_rounds(PORT, route, seed)
    assert got == want
    assert len(got[-3][0]) > 3  # the map split into several shards
    assert any(k.startswith(b"vs") for k, _ in got[-2][0])
