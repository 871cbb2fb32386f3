"""Multi-region replication and ``configure`` of the port against the JAX
package's, at tolerance 0: ``RegionConfig.parse``; sync and async
satellites attached at construction (the seed, the lag in versions and
in milliseconds under one injected clock, a WAN partition and its heal,
the gap that marks the link ``broken``, the seed carrying the system
keys); the whole-region failover in sync mode (nothing acknowledged is
lost) and in async mode (nothing at or below the frontier is lost); a
failover whose generation CAS fails, retried on the next round; the
manual ``SecondaryRegion`` (pump, partition, failover into a new
cluster); ``configure`` resizing the resolvers 1 -> 3 -> 1 and the
proxies 1 -> 3, its no-op rule, regions on and off, and a restart that
restores the ``\\xff/conf/regions`` row. Every case compares outcomes,
rows, the ``regions`` status section and, on each package's default
resolver, the 12 state fields.
"""

import json
import os
import time

import numpy as np
import pytest

from tests.conftest import TEST_KNOBS
from tests.torch_sides import JAX, PORT, muts, outcome, request, results, rows

REGIONS = {"primary": "east", "remote": "west", "satellites": 1}


@pytest.fixture
def clock():
    """One manual clock for both packages' injected ``now()`` (the
    streamer's cadence and the lag in ms read it) and one seed for their
    named streams; both restored after."""
    t = [1000.0]
    for side in (JAX, PORT):
        side.deterministic.set_clock(lambda: t[0])
        side.deterministic.seed(11)
    yield t
    for side in (JAX, PORT):
        side.deterministic.set_clock(time.time)
        side.deterministic.unseed()


def _status(c):
    """The ``regions`` status section without the failover's duration
    (the port times it on the wall clock, the reference on the injected
    one, which the tests freeze)."""
    st = dict(c.status()["cluster"]["regions"])
    st.pop("last_failover_ms", None)
    return st


def _records(log):
    return [(v, muts(m)) for v, m in log.peek(0)]


def _tags(c):
    logs = c.tlog.logs if hasattr(c.tlog, "logs") else [c.tlog]
    return [log.region for log in logs], [s.region for s in c.storages]


def _region_cluster(side, mode, **kw):
    kw = dict(TEST_KNOBS, n_storage=2, n_tlogs=3,
              regions=dict(REGIONS, satellite_mode=mode),
              region_stream_interval_s=0.005, **kw)
    return side.cluster(**kw)


def _stale(side, c, rv):
    """A read-write commit at an old read version: its outcome."""
    return results([c.commit_proxy.commit(
        request(side, rv, sets=[(b"stale", b"s")], reads=[b"stale"]))])[0]


def _kill_primary_region(c):
    """Every primary process dies in one event: the storages, every log
    replica, the resolvers and the transaction system."""
    for s in c.storages:
        s.kill()
    for i in range(len(c.tlog.logs)):
        c.tlog.kill(i)
    for r in c.resolvers:
        r.kill()
    c.sequencer.kill()
    c._commit_target().kill()


# ── RegionConfig.parse ──────────────────────────────────────────────
SPECS = {
    "dict_sync": dict(REGIONS, satellite_mode="sync"),
    "dict_default_mode": {"primary": "a", "remote": "b"},
    "json": json.dumps(dict(REGIONS, satellites=2)),
    "bytes": json.dumps({"primary": "p", "remote": "r",
                         "satellite_mode": "async"}).encode(),
    "missing_remote": {"primary": "east"},
    "same_regions": {"primary": "east", "remote": "east"},
    "zero_satellites": dict(REGIONS, satellites=0),
    "bad_satellites": dict(REGIONS, satellites="x"),
    "bad_mode": dict(REGIONS, satellite_mode="semi"),
    "unknown_key": dict(REGIONS, usable_regions=2),
    "not_a_dict": "[1, 2]",
    "bad_json": "{primary",
    "empty": {},
}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_region_config_parse_matches_jax(name):
    def parse(side):
        return outcome(side, lambda: side.region.RegionConfig.parse(
            SPECS[name]).to_json())

    want, got = parse(JAX), parse(PORT)
    assert got == want
    if name.startswith(("dict", "json", "bytes")):
        assert got[0] == "ok"
    else:
        assert got == ("err", 2006)


# ── attach, lag, partition and heal ─────────────────────────────────
def _attach_script(side, mode, clock):
    c = _region_cluster(side, mode)
    db = c.database()
    reg = c.regions
    out = [_status(c), _records(reg.satellite), _tags(c)]
    for i in range(10):
        db[b"pre%02d" % i] = b"x"
    clock[0] += 0.5
    out += [reg.lag_versions(), _status(c), reg.stream_now(),
            reg.lag_versions()]
    # the streamer's cadence: the first call arms a jittered deadline
    db[b"tick"] = b"t"
    out.append(reg.maybe_stream())
    clock[0] += 1.0
    out += [reg.maybe_stream(), reg.lag_versions()]
    reg.partition()
    for i in range(6):
        db[b"cut%02d" % i] = b"y"
    clock[0] += 0.25
    out += [reg.stream_now(), reg.lag_versions(), _status(c)]
    reg.heal()
    db[b"heal"] = b"z"  # sync: the first push after the heal backfills
    clock[0] += 0.1
    out += [reg.stream_now(), reg.lag_versions(), _status(c),
            _records(reg.satellite), [rows(s) for s in c.storages]]
    state = side.state(c)
    c.close()
    return out, state


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_attach_lag_partition_heal_matches_jax(mode, clock):
    t0 = clock[0]
    want, wstate = _attach_script(JAX, mode, clock)
    clock[0] = t0
    got, gstate = _attach_script(PORT, mode, clock)
    assert got == want
    for a, b in zip(gstate, wstate):
        assert np.array_equal(a, b)
    st = got[15]
    assert st["replication_lag_versions"] == 0 and st["connected"]
    assert got[12]["connected"] is False and got[12]["replication_lag_ms"] > 0
    if mode == "sync":
        assert got[3] == 0 and st["sync_misses"] >= 6
    else:
        assert got[3] > 0 and got[11] > 0 and st["sync_misses"] == 0
    assert got[2] == (["east"] * 3, ["east"] * 2)


def _gap_script(side, d):
    """A lagging satellite across a primary restart marks itself broken
    (failover refuses); a caught-up one reattaches and promotes."""
    os.makedirs(d)
    kw = dict(TEST_KNOBS, resolver_backend="cpu",
              wal_path=os.path.join(d, "p.wal"),
              coordination_dir=os.path.join(d, "co"))
    primary = side.cluster(**kw)
    db = primary.database()
    for i in range(4):
        db[b"g%d" % i] = b"%d" % i
    dr = side.region.SecondaryRegion(primary, os.path.join(d, "sat.wal"))
    out = [dr.pump()]
    for i in range(5):
        db[b"lag%d" % i] = b"l"
    out.append(dr.lag_versions())
    primary.close()
    primary2 = side.cluster(**kw)
    dr.reattach(primary2)
    out += [dr.pump(), dr.broken]
    try:
        dr.failover(**dict(TEST_KNOBS, resolver_backend="cpu"))
        out.append("promoted")
    except RuntimeError as e:
        out.append("replication gap" in str(e))
    dr2 = side.region.SecondaryRegion(primary2, os.path.join(d, "sat2.wal"))
    primary2.database()[b"after"] = b"a"
    out.append(dr2.pump())
    primary2.close()
    primary3 = side.cluster(**kw)
    dr2.reattach(primary3)
    primary3.database()[b"third"] = b"3"
    out += [dr2.pump(), dr2.broken]
    promoted = dr2.failover(**dict(TEST_KNOBS, resolver_backend="cpu"))
    out.append(rows(promoted.storage))
    promoted.close()
    primary3.close()
    return out


def test_primary_restart_gap_marks_broken_matches_jax(tmp_path):
    want = _gap_script(JAX, str(tmp_path / "jax"))
    got = _gap_script(PORT, str(tmp_path / "port"))
    assert got == want
    assert got[3] is True and got[4] is True and got[7] is False


def _seed_script(side, d, clock):
    """The seed snapshot scans through the system keys: a tenant, its
    quota, the lock and the shard map set before the attach arrive in
    the satellite and on the promoted cluster."""
    tenant = side.tenant
    c = side.cluster(**dict(TEST_KNOBS, n_storage=3, replication=2))
    db = c.database()
    tenant.TenantManagement.create_tenant(db, b"acme", group=b"g1")
    tenant.TenantManagement.set_tenant_quota(db, b"acme", 500.0)
    tenant.Tenant(db, b"acme").set(b"k", b"pre-attach")
    for i in range(20):
        db[b"row%02d" % i] = b"r" * 40
    c.dd.max_shard_bytes = 400
    c.rebalance()
    c.lock_database(b"seeded")
    c.configure(regions=dict(REGIONS, satellite_mode="async"))
    sat = _records(c.regions.satellite)
    out = [sat[0][1], _status(c)]
    dr = side.region.SecondaryRegion(c, os.path.join(d, "sat.wal"))
    out.append(dr.pump())
    promoted = dr.failover(**dict(TEST_KNOBS, resolver_backend="cpu"))
    pdb = promoted.database()
    out += [tenant.Tenant(pdb, b"acme").get(b"k"),
            tenant.TenantManagement.list_tenants(pdb),
            tenant.TenantManagement.get_tenant_quota(pdb, b"acme"),
            promoted.lock_uid(), promoted.replication, rows(promoted.storage)]
    promoted.close()
    c.close()
    return out


def test_seed_carries_the_system_keys_matches_jax(tmp_path, clock):
    want = _seed_script(JAX, str(tmp_path / "jax"), clock)
    got = _seed_script(PORT, str(tmp_path / "port"), clock)
    assert got == want
    keys = [k for _, k, _ in got[0]]
    assert any(k.startswith(b"\xff/tenant/map/") for k in keys)
    assert any(k.startswith(b"\xff/keyServers/") for k in keys)
    assert got[3] == b"pre-attach" and got[5] == 500.0
    assert got[6] == b"seeded"


# ── whole-region failover ───────────────────────────────────────────
def _failover_script(side, mode, clock):
    c = _region_cluster(side, mode)
    db = c.database()
    reg = c.regions
    acked = {}

    def write(k, v):
        tr = db.create_transaction()
        tr[k] = v
        tr.commit()
        acked[k] = tr.get_committed_version()

    for i in range(12):
        write(b"load%02d" % i, b"v%02d" % i)
        if i == 1:
            rv_old = c.sequencer.committed_version
    reg.stream_now()
    for i in range(5):  # async: past the frontier at the disaster
        write(b"late%02d" % i, b"w")
    clock[0] += 0.2
    out = [_status(c)]
    gen0 = c.generation
    _kill_primary_region(c)
    events = c.detect_and_recruit()
    frontier = reg.position
    lost = sorted(k for k in acked if db[k] is None)
    below = [k for k in lost if acked[k] <= frontier]
    out += [events, c.generation - gen0, frontier, lost, below, _status(c),
            _tags(c), _stale(side, c, rv_old)]
    db[b"post-failover"] = b"alive"
    out += [db[b"post-failover"], [rows(s) for s in c.storages],
            [r["trigger"] for r in
             c.recovery_timeline.snapshot()["records"]],
            c.detect_and_recruit()]
    state = side.state(c)
    c.close()
    return out, state


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_whole_region_failover_matches_jax(mode, clock):
    t0 = clock[0]
    want, wstate = _failover_script(JAX, mode, clock)
    clock[0] = t0
    got, gstate = _failover_script(PORT, mode, clock)
    assert got == want
    for a, b in zip(gstate, wstate):
        assert np.array_equal(a, b)
    assert got[1] == [("region-failover", 0)] and got[2] == 1
    assert got[5] == []  # nothing at or below the frontier lost
    if mode == "sync":
        assert got[4] == []  # sync: no acknowledged commit lost
    else:
        assert len(got[4]) == 5
    assert got[6]["active"] == "west" and got[6]["failovers"] == 1
    assert got[7] == (["west"], ["west"] * 2)
    assert got[8] == ("err", 1007)
    assert got[11] == ["region_failover"]


def _retry_script(side, clock):
    c = _region_cluster(side, "sync")
    db = c.database()
    for i in range(15):
        db[b"k%02d" % i] = b"v%02d" % i
    orig = c._win_generation
    state = {"failed": 0}

    def flaky(recovered):
        if state["failed"] == 0:
            state["failed"] = 1
            raise side.coordination.CoordinatorDown("injected quorum loss")
        return orig(recovered)

    c._win_generation = flaky
    _kill_primary_region(c)
    out = [c.detect_and_recruit(), c.regions.failed_attempts,
           c.regions.failovers, c.detect_and_recruit(), _status(c),
           [db[b"k%02d" % i] for i in range(15)],
           [rows(s) for s in c.storages]]
    state = side.state(c)
    c.close()
    return out, state


def test_failed_failover_retries_on_the_next_round_matches_jax(clock):
    want, wstate = _retry_script(JAX, clock)
    got, gstate = _retry_script(PORT, clock)
    assert got == want
    for a, b in zip(gstate, wstate):
        assert np.array_equal(a, b)
    assert got[:3] == [[], 1, 0]
    assert got[3] == [("region-failover", 0)]
    assert got[4]["failed_failover_attempts"] == 1


# ── the manual SecondaryRegion ──────────────────────────────────────
def _secondary_script(side, d):
    """The DR cycle: pump, a partition the primary commits through, a
    failover that equals the primary at the frontier."""
    os.makedirs(d)
    primary = side.cluster(**dict(TEST_KNOBS, n_storage=2,
                                  resolver_backend="cpu"))
    db = primary.database()
    for i in range(8):
        db[b"c%03d" % i] = b"%d" % ((i + 1) % 8)
    dr = side.region.SecondaryRegion(primary, os.path.join(d, "sat.wal"))
    out = [dr.pump()]
    for step in range(12):
        i, j = step % 8, (3 * step + 1) % 8

        def swap(tr, i=i, j=j):
            a, b = tr[b"c%03d" % i], tr[b"c%03d" % j]
            tr[b"c%03d" % i], tr[b"c%03d" % j] = b, a

        db.run(swap)
        if step == 5:
            primary.storages[1].kill()
            out.append(primary.detect_and_recruit())
        if step % 4 == 3:
            out.append(dr.pump())
    frontier_rows = db.get_range(b"c", b"d")
    dr.partition()
    for i in range(4):
        db[b"c%03d" % i] = b"lost"
    out += [dr.pump(), dr.lag_versions() > 0]
    primary.commit_proxy._pump_durability(primary.sequencer.committed_version)
    out.append(len(primary.tlog.peek(dr.position)))
    promoted = dr.failover(**dict(TEST_KNOBS, resolver_backend="cpu"))
    pdb = promoted.database()
    out += [pdb.get_range(b"c", b"d") == frontier_rows,
            rows(promoted.storage), promoted.generation]
    pdb[b"post"] = b"alive"
    out.append(pdb[b"post"])
    promoted.close()
    dr.drop()
    primary.close()
    return out


def test_secondary_region_pump_and_failover_matches_jax(tmp_path):
    want = _secondary_script(JAX, str(tmp_path / "jax"))
    got = _secondary_script(PORT, str(tmp_path / "port"))
    assert got == want
    assert got[-5] > 0 and got[-4] is True and got[-1] == b"alive"


# ── configure ───────────────────────────────────────────────────────
def _batch(side, c, tag):
    """A batch with an OCC pair, a range read against a clear range and
    blind writes: its outcomes."""
    rv = c.sequencer.committed_version
    reqs = [request(side, rv, sets=[(b"occ", tag)], reads=[b"occ"]),
            request(side, rv, sets=[(b"occ", tag + b"2")], reads=[b"occ"]),
            request(side, rv, clears=[(b"r" + tag, b"r" + tag + b"\xff")]),
            request(side, rv, sets=[(b"w" + tag, b"v")])]
    reqs[2].read_conflict_ranges.append((b"a", b"z"))
    return results(c.commit_proxy.commit_batch(reqs))


def _configure_script(side, d, clock):
    os.makedirs(d)
    kw = dict(TEST_KNOBS, wal_path=os.path.join(d, "wal"),
              coordination_dir=os.path.join(d, "co"))
    c = side.cluster(**kw)
    db = c.database()
    for i in range(6):
        db[b"k%d" % i] = b"%d" % i
    out = [_batch(side, c, b"0")]
    g = [c.generation]

    def step(**cfg):
        res = outcome(side, lambda: c.configure(**cfg))
        g.append(c.generation)
        out.extend([res, g[-1] - g[-2], _batch(side, c, b"%d" % len(g))])

    step(resolvers=3)
    out.append([getattr(r, "n_lanes", 1) for r in c.resolvers])
    step(resolvers=3)  # the same call again: no recovery
    step(resolvers=1)
    state1 = side.state(c)
    step(commit_proxies=3)
    step(commit_proxies=3)
    step(regions=dict(REGIONS, satellite_mode="sync"))
    out += [_status(c), _tags(c)]
    step(regions=json.dumps(dict(REGIONS, satellite_mode="sync")))
    step(regions={"primary": "x"})  # invalid: 2006, nothing changes
    out.append(_status(c))
    db[b"before-restart"] = b"1"
    out.append([r["trigger"] for r in
                c.recovery_timeline.snapshot()["records"]])
    c.close()
    c = side.cluster(**kw)  # the row re-attaches the regions
    db = c.database()
    out += [_status(c), db[b"before-restart"], _records(c.regions.satellite)]
    g = [c.generation]
    step(regions="off")
    out += [_status(c), c.storage.get(b"\xff/conf/regions",
                                      c.storage.version)]
    c.close()
    c = side.cluster(**kw)
    out += [_status(c), rows(c.storage)]
    state = side.state(c)
    c.close()
    return out, state1, state


def test_configure_resizes_and_regions_match_jax(tmp_path, clock):
    t0 = clock[0]
    want = _configure_script(JAX, str(tmp_path / "jax"), clock)
    clock[0] = t0
    got = _configure_script(PORT, str(tmp_path / "port"), clock)
    assert got[0] == want[0]
    for gs, ws in zip(got[1:], want[1:]):
        for a, b in zip(gs, ws):
            assert np.array_equal(a, b)
    out = got[0]
    ok = [isinstance(r, int) for r in out[0]]
    assert ok == [True, False, True, True] and out[0][1] == ("err", 1020)
    assert out[1] == ("ok", {"commit_proxies": 1, "resolver_lanes": 3})
    assert out[2] == 1 and out[4] == [3]
    assert out[6] == 0  # resolvers=3 again: no recovery
    assert out[8:10] == [("ok", {"commit_proxies": 1, "resolver_lanes": 1}),
                         1]
    assert out[15] == 0  # commit_proxies=3 again
    assert out[23] == 0 and out[25] == ("err", 2006)
    assert out[29] == ["configure"] * 4
    assert out[30]["configured"] and out[30]["satellite_mode"] == "sync"
    assert out[36] == out[38] == {"configured": False} and out[37] is None


def _thread_script(side, **extra):
    """An async satellite on a thread pipeline: the streamer runs as a
    daemon, 8 client threads commit, one drain catches it up; close()
    stops the streamer."""
    import threading

    c = _region_cluster(side, "async", commit_pipeline="thread",
                        commit_batch_max=4, **extra)
    db = c.database()
    reg = c.regions

    def client(t):
        for i in range(6):
            db[b"t%d-%d" % (t, i)] = b"v%d" % i

    ts = [threading.Thread(target=client, args=(t,)) for t in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    running = reg._thread is not None and reg._thread.is_alive()
    reg.stream_now()
    sat = sorted(m for _, ms in _records(reg.satellite) for m in ms)
    out = [running, reg.lag_versions(), sat, [rows(s) for s in c.storages]]
    thread = reg._thread
    c.close()
    return out + [thread is not None and thread.is_alive()]


def test_thread_pipeline_streamer_matches_jax():
    want = _thread_script(JAX, health_probe_enabled=False,
                          history_enabled=False,
                          consistency_scan_enabled=False)
    got = _thread_script(PORT, health_probe_enabled=False,
                         history_enabled=False,
                         consistency_scan_enabled=False)
    assert got == want
    assert got[0] is True and got[1] == 0 and got[-1] is False
    assert len([m for m in got[2] if m[1].startswith(b"t")]) == 48


def test_regions_and_configure_raise_without_a_card(tmp_path):
    """No fallback: with no card visible, Cluster(regions=...),
    open(regions=...) and SecondaryRegion.failover() raise; a cluster on
    device="cpu" takes regions, a failover and configure's resizes on
    the CPU. In a subprocess with CUDA_VISIBLE_DEVICES="", so it holds
    on any machine."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import threading\n"
        "import foundationdb_tpu_torch as fdb\n"
        "from foundationdb_tpu_torch.server.cluster import Cluster\n"
        "from foundationdb_tpu_torch.server.region import SecondaryRegion\n"
        "R = {'primary': 'east', 'remote': 'west', 'satellite_mode': 'sync'}\n"
        "K = dict(batch_txn_capacity=8, hash_table_bits=10,\n"
        "         range_ring_capacity=16, coarse_buckets_bits=6)\n"
        "for f in (lambda: Cluster(regions=R),\n"
        "          lambda: fdb.open(regions=R, commit_pipeline='thread')):\n"
        "    try:\n"
        "        f()\n"
        "    except RuntimeError as e:\n"
        "        assert 'no CUDA device' in str(e), e\n"
        "    else:\n"
        "        raise SystemExit('no error without a card')\n"
        "assert threading.active_count() == 1, threading.enumerate()\n"
        "c = Cluster(device='cpu', regions=R, n_storage=2, **K)\n"
        "db = c.database()\n"
        "db[b'k'] = b'v'\n"
        "for s in c.storages: s.kill()\n"
        "c.tlog.kill(); c.sequencer.kill(); c._commit_target().kill()\n"
        "for r in c.resolvers: r.kill()\n"
        "assert c.detect_and_recruit() == [('region-failover', 0)]\n"
        "assert db[b'k'] == b'v'\n"
        f"dr = SecondaryRegion(c, {str(tmp_path / 'sat.wal')!r})\n"
        "dr.pump()\n"
        "try:\n"
        "    dr.failover(**K)\n"
        "except RuntimeError as e:\n"
        "    assert 'no CUDA device' in str(e), e\n"
        "else:\n"
        "    raise SystemExit('no error without a card')\n"
        "assert c.configure(resolvers=3)['resolver_lanes'] == 3\n"
        "assert str(c.resolvers[0].device) == 'cpu'\n"
        "db[b'k2'] = b'v2'\n"
        "c.close()\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=root, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def _off_after_failover(side):
    c = _region_cluster(side, "sync")
    db = c.database()
    db[b"k"] = b"v"
    _kill_primary_region(c)
    c.detect_and_recruit()
    shape = c.configure(regions="off")
    out = [shape, c.tlog.alive]
    res = c.commit_proxy.commit(request(side, c.sequencer.committed_version,
                                        sets=[(b"after", b"a")]))
    out.append(results([res])[0] if isinstance(res, Exception) else "ok")
    c.close()
    return out


def test_regions_off_after_a_failover_keeps_the_promoted_log():
    """After a failover the promoted satellite log is the cluster's log:
    the port's ``configure(regions="off")`` detaches the replicator and
    keeps that log, so commits go on. The reference closes it with the
    replicator, and its later commits answer 1021."""
    got, want = _off_after_failover(PORT), _off_after_failover(JAX)
    assert got[0] == want[0] == {"commit_proxies": 1, "resolver_lanes": 1,
                                 "regions": None}
    assert got[1:] == [True, "ok"]
    assert want[1:] == [False, ("err", 1021)]
