"""The cluster doctor, the consistency scan and the consistency check of
the port against the JAX package's, at tolerance 0.

Both sides run under one ``deterministic.seed`` and a clock that moves
only when the test ticks it (tests/torch_sides.py ``seeded``), so the
probe and scan cadences (the "latency-probe" and "consistency-scan"
streams) fire at the same ticks and every measured wall is 0.0. A
divergence is planted as a storage-level apply on one replica that
bypasses the commit pipeline.
"""

import pytest

from tests.conftest import TEST_KNOBS
from tests.torch_sides import JAX, PORT, doc_diff, seeded

SIDES = (JAX, PORT)


def _pump(c, clock, n, dt=0.3):
    for _ in range(n):
        clock.tick(dt)
        c.prober.maybe_probe()
        c.scanner.maybe_scan()


def _health_script(side, kill):
    with seeded(side) as clock:
        c = side.cluster(**TEST_KNOBS, n_storage=2, n_tlogs=3,
                         health_probe_interval_s=0.5)
        try:
            db = c.database()
            for i in range(6):
                db.run(lambda tr, i=i: tr.set(b"k%d" % i, b"v"))
            _pump(c, clock, 8)
            docs = [c.health_status()]
            if kill == "storage":
                c.storages[1].kill()
            elif kill == "log":
                c.tlog.logs[0].kill()
            elif kill == "sequencer":
                c.sequencer.kill()
                c.prober.probe_now()  # a failing probe counts as one
            elif kill == "saturated":
                c.ratekeeper.target_tps = c.ratekeeper.max_tps * 0.25
            docs.append(c.health_status())
            c.detect_and_recruit()
            _pump(c, clock, 4)
            docs.append(c.health_status())
            return docs
        finally:
            c.close()


@pytest.mark.parametrize("kill", ["none", "storage", "log", "sequencer",
                                  "saturated"])
def test_health_document_matches_jax(kill):
    """``build_health`` with the prober pumped by hand: the verdict, the
    sorted reasons and messages, the probe bands and counts, the
    recovery timeline, the lag rollups and the ratekeeper section, before
    a fault, under it and after the recruitment."""
    want = _health_script(JAX, kill)
    got = _health_script(PORT, kill)
    assert doc_diff(want, got) == []
    before, during, _ = got
    assert before["verdict"] == "healthy" and before["probe"]["probes"] > 0
    assert before["probe"]["commit"]["count"] > 0
    assert before["rpc"] == {"failed": {}, "endpoints_failed": 0,
                             "rpc_timeouts": 0}
    expect = {"none": "healthy", "storage": "degraded", "log": "degraded",
              "sequencer": "unavailable", "saturated": "degraded"}[kill]
    assert during["verdict"] == expect


def _scan_script(side, tmp, restart):
    kw = dict(TEST_KNOBS, n_storage=3, replication=2,
              consistency_scan_batch_keys=8, scan_rate_bytes_per_s=0)
    if restart:
        kw.update(wal_path=f"{tmp}/{side.name}.wal",
                  coordination_dir=f"{tmp}/{side.name}.coord")
    with seeded(side) as clock:
        c = side.cluster(**kw)
        docs = []
        try:
            db = c.database()
            for i in range(40):
                db.run(lambda tr, i=i: tr.set(b"r%03d" % i, b"v" * (i % 9)))
            c.dd.max_shard_bytes = 300
            c.rebalance()
            _pump(c, clock, 5)
            docs.append(c.consistency_scan_status())
            if restart:
                # a crash mid-round: the cursor and the round count come
                # back from \xff/consistencyScan/
                c.tlog.close()
                c = side.cluster(**kw)
                docs.append(c.consistency_scan_status())
            _pump(c, clock, 30)
            docs.append(c.consistency_scan_status())
            docs.append(c.consistency_check())
            return docs
        finally:
            c.close()


@pytest.mark.parametrize("restart", [False, True],
                         ids=["rounds", "restored-cursor"])
def test_scan_rounds_match_jax(tmp_path, restart):
    """Bounded scan batches over a sharded double-replicated map: the
    rounds, progress, cursor and volume, and across a restart the
    restored cursor (the round resumes, it does not rewind)."""
    want = _scan_script(JAX, tmp_path, restart)
    got = _scan_script(PORT, tmp_path, restart)
    assert doc_diff(want, got) == []
    assert got[-2]["round"] >= 1 and got[-2]["inconsistencies"] == 0
    assert got[-1] == []
    if restart:
        assert got[1]["cursor"] == got[0]["cursor"] != ""


def _plant_script(side):
    with seeded(side) as clock:
        c = side.cluster(**TEST_KNOBS, n_storage=2,
                         consistency_scan_batch_keys=4,
                         scan_rate_bytes_per_s=0)
        try:
            db = c.database()
            for i in range(10):
                db.run(lambda tr, i=i: tr.set(b"p%02d" % i, b"v"))
            clean = (c.consistency_check(), c.health_status()["verdict"])
            _pump(c, clock, 12)
            before = c.consistency_scan_status()
            # one replica takes a write no commit made
            s = c.storages[1]
            s.apply(s.version + 1,
                    [side.mutation(side.op.SET, b"p03", b"corrupt")])
            db.run(lambda tr: tr.set(b"zz", b"1"))  # moves the version on
            _pump(c, clock, 20)
            health = c.health_status()
            return (clean, before, c.consistency_scan_status(),
                    health["verdict"], health["reasons"],
                    c.consistency_check())
        finally:
            c.close()


def test_planted_divergence_is_caught_like_jax():
    """A storage-level apply on one replica: before it both the check
    and the scan are clean; after it the scanner confirms the
    divergence, the verdict turns degraded with ``data_inconsistent``,
    and ``consistency_check()`` lists it."""
    want = _plant_script(JAX)
    got = _plant_script(PORT)
    assert doc_diff(list(want), list(got)) == []
    clean, before, after, verdict, reasons, problems = got
    assert clean == ([], "healthy") and before["inconsistencies"] == 0
    assert after["inconsistencies"] >= 1
    assert verdict == "degraded" and "data_inconsistent" in reasons
    assert problems and "p03" in problems[0]


def test_scan_switch_and_probe_switch_match_jax():
    """The module switches stop the cadences and leave the documents
    readable."""
    out = {}
    for side in SIDES:
        with seeded(side) as clock:
            c = side.cluster(**TEST_KNOBS)
            try:
                c.database().run(lambda tr: tr.set(b"a", b"1"))
                off = c.set_consistency_scan(False)
                side.health.set_enabled(False)
                _pump(c, clock, 10)
                stopped = (c.consistency_scan_status(),
                           c.health_status()["probe"])
                on = c.set_consistency_scan(True)
                side.health.set_enabled(True)
                _pump(c, clock, 10)
                out[side.name] = (off, stopped, on,
                                  c.consistency_scan_status(),
                                  c.health_status()["probe"])
            finally:
                side.health.set_enabled(True)
                side.consistencyscan.set_enabled(True)
                c.close()
    assert doc_diff(out["jax"], out["port"]) == []
    off, stopped, _, after, probe = out["port"]
    assert not off["enabled"] and stopped[0]["batches"] == 0
    assert stopped[1]["probes"] == 0
    assert after["batches"] > 0 and probe["probes"] > 0
