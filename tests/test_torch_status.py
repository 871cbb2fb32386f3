"""The port's status document against the JAX package's, at tolerance 0.

Both clusters run one script under one ``deterministic.seed`` and a
clock that stands still (tests/torch_sides.py ``seeded``), so every wall
is 0.0 and every draw is shared. ``status()["cluster"]`` must carry the
reference's keys at every level and equal values, except the fields
listed in ``APART`` (each with the reason it differs) and those that
``mapped`` renames.

The committed-counter repro: five ``db.run`` sets, the sequencer killed,
``detect_and_recruit()``, one more set. The reference's counter reads
6; a counter read from the live proxy would read 1, because a
transaction-system recovery builds a fresh proxy. The workload counters
sum cluster-held registries, which every incarnation continues.
"""

import json
import re

import pytest

from tests.conftest import TEST_KNOBS
from tests.torch_sides import JAX, PORT, QUIET, doc_diff, seeded

# fields compared apart, by path pattern
APART = (
    # the backend's name: "tpu" in the reference, "cuda" in the port
    r"/resolver_backend$",
    r"/processes/resolvers\[\d+\]/backend$",
    # the port's own: the resolver's device and its compiled steps
    r"/processes/resolvers\[\d+\]/(device|graphs)$",
    # the staging sets: the reference keeps a ring of them per shape
    # (JAX dispatches asynchronously), the port one (its batch is copied
    # out before the next pack), so reuse counts differ by design
    r"/device/(resolvers\[\d+\]|aggregate)/staging_reuse_(hits|misses|rate)$",
    # process-wide, cumulative over every cluster this process built
    r"/trace/(suppressed_events|suppressed_by_type|spans_sampled|"
    r"spans_emitted)$",
)

# the device profile's route names: the reference names its step bodies
# after its Pallas kernels, the port after its CUDA kernels
ROUTES = {"jit": "plain", "pallas_scan": "fused_accept",
          "pallas_ring": "ring_hits"}


def mapped(doc):
    """The JAX document in the port's terms: the routes renamed, and
    nothing else."""
    for prof in doc["device"]["resolvers"] + [doc["device"]["aggregate"]]:
        prof["kernel_routes"] = {ROUTES[k]: v
                                 for k, v in prof["kernel_routes"].items()}
    return doc


def single_step_compiles(doc):
    """The port's device profile with its single-step captures taken
    out: the reference counts compiles of its backlog scans only (its
    single step is a plain jitted call), the port every capture, keyed
    (variant, B), B = 1 for the single step."""
    for prof in doc["device"]["resolvers"] + [doc["device"]["aggregate"]]:
        single = {k: v for k, v in prof["compile_keys"].items()
                  if k.endswith(", 1)")}
        for k in single:
            del prof["compile_keys"][k]
        prof["recompiles"] -= sum(single.values())
    return doc


def compare(want, got):
    bad = [(p, w, g) for p, w, g in doc_diff(mapped(want),
                                             single_step_compiles(got))
           if not any(re.search(a, p) for a in APART)]
    assert not bad, bad[:10]


def _rmw(tr, i):
    v = tr.get(b"ctr")
    tr.get_range(b"k", b"l")
    tr.set(b"ctr", b"%d" % (int(v or b"0") + i))


def _script(side, cluster_kw=(), resize=None):
    """Writes, a read-modify-write, a conflict, a recovery and (when
    ``resize`` is given) a configure() resize, with the prober, the
    history and the scanner pumped by hand; returns the status after
    each step."""
    with seeded(side) as clock:
        c = side.cluster(**TEST_KNOBS, **dict(cluster_kw))
        try:
            db = c.database()
            docs = []
            for i in range(5):
                db.run(lambda tr, i=i: tr.set(b"k%d" % i, b"v%d" % i))
            db.run(lambda tr: _rmw(tr, 1))
            # an OCC pair: t1 reads ctr, t2 writes it, t1's commit 1020s
            t1 = db.create_transaction()
            t1.get(b"ctr")
            db.run(lambda tr: _rmw(tr, 2))
            t1.set(b"ctr", b"lost")
            try:
                t1.commit()
            except side.error as e:
                assert e.code == 1020
            docs.append(c.status()["cluster"])
            c.sequencer.kill()
            c.detect_and_recruit()
            db.run(lambda tr: tr.set(b"x", b"y"))
            docs.append(c.status()["cluster"])
            if resize is not None:
                c.configure(**resize)
                db.run(lambda tr: _rmw(tr, 3))
                docs.append(c.status()["cluster"])
            for _ in range(3):
                clock.tick(1.0)
                c.prober.maybe_probe()
                c.scanner.maybe_scan()
                c.history.maybe_collect()
            db.run(lambda tr: _rmw(tr, 4))
            docs.append(c.status()["cluster"])
            return docs
        finally:
            c.close()


def test_committed_counter_survives_recovery_matches_jax():
    """The repro: 5 then 6 on both packages (a counter read from the
    live proxy would read 1 after the recovery)."""
    out = {}
    for side in (JAX, PORT):
        with seeded(side):
            kw = dict(TEST_KNOBS)
            if side is JAX:
                kw.update(QUIET)
            c = side.cluster(**kw)
            try:
                db = c.database()
                for i in range(5):
                    db.run(lambda tr, i=i: tr.set(b"k%d" % i, b"v"))
                counts = [c.status()["cluster"]["workload"]["transactions"]
                          ["committed"]["counter"]]
                c.sequencer.kill()
                c.detect_and_recruit()
                db.run(lambda tr: tr.set(b"k5", b"v"))
                counts.append(c.status()["cluster"]["workload"]
                              ["transactions"]["committed"]["counter"])
                out[side.name] = counts
            finally:
                c.close()
    assert out["port"] == out["jax"] == [5, 6]


@pytest.mark.parametrize("resize", [dict(commit_proxies=3),
                                    dict(commit_proxies=1),
                                    dict(resolvers=3)],
                         ids=["grow-proxies", "shrink-proxies",
                              "resolver-lanes"])
def test_workload_counters_hold_across_recovery_and_resize(resize):
    """committed, conflicted and started across a recovery and a
    configure() resize: equal to the reference's at each step and never
    backwards (a shrinking fleet folds its members into member 0)."""
    kw = dict(n_commit_proxies=2 if resize.get("commit_proxies") == 1 else 1)
    want = _script(JAX, kw, resize)
    got = _script(PORT, kw, resize)

    def counters(docs):
        return [{k: v["counter"] for k, v in
                 d["workload"]["transactions"].items()} for d in docs]

    assert counters(got) == counters(want)
    for a, b in zip(counters(got), counters(got)[1:]):
        assert all(b[k] >= a[k] for k in a), (a, b)
    assert counters(got)[0]["conflicted"] == 1
    for w, g in zip(want, got):
        compare(w, g)


CLUSTERS = {
    "default": {},
    "double": dict(n_storage=3, replication=2, n_tlogs=3),
    "fleet": dict(n_commit_proxies=3),
    "host": dict(resolver_backend="cpu"),
}


@pytest.mark.parametrize("name", sorted(CLUSTERS))
def test_status_document_matches_jax(name):
    """The whole document after the same script, every key at every
    level, values at tolerance 0 apart from ``APART``."""
    want = _script(JAX, CLUSTERS[name])
    got = _script(PORT, CLUSTERS[name])
    for w, g in zip(want, got):
        compare(w, g)
    last = got[-1]
    assert last["health"]["verdict"] == "healthy"
    assert last["health"]["recovery"]["count"] == 1
    assert last["metacluster"] == {"cluster_type": "standalone"}
    assert last["database_available"] is True
    assert len(last) == 25


def test_availability_follows_the_live_storages():
    """``database_available`` is ``live storages > 0`` (the reference's
    rule): a dead sequencer leaves the data readable."""
    docs = {}
    for side in (JAX, PORT):
        with seeded(side):
            c = side.cluster(**TEST_KNOBS, n_storage=2)
            try:
                c.database().run(lambda tr: tr.set(b"a", b"1"))
                c.sequencer.kill()
                seq_dead = c.status()["cluster"]
                for s in c.storages:
                    s.kill()
                all_dead = c.status()["cluster"]
                docs[side.name] = [
                    (d["database_available"], d["degraded"],
                     d["health"]["verdict"], d["health"]["reasons"],
                     d["metacluster"]) for d in (seq_dead, all_dead)]
            finally:
                c.close()
    assert docs["port"] == docs["jax"]
    assert docs["port"][0][:3] == (True, False, "unavailable")
    assert docs["port"][1][0] is False


# the port's own lock: each resolver's dispatch lock (a handed-over
# resolver raises ResolverDown under it); the reference has none
PORT_ONLY_LOCKS = ("Resolver._mu",)


def _contract(edges, node):
    """The order ``edges`` record with ``node`` taken out: a -> node -> b
    becomes a -> b."""
    ins = {a for a, b in edges if b == node}
    outs = {b for a, b in edges if a == node}
    return ({(a, b) for a, b in edges if node not in (a, b)}
            | {(a, b) for a in ins for b in outs if a != b})


def _witness(side, cluster_kw):
    side.lockdep.reset()
    side.lockdep.enable()
    try:
        _script(side, cluster_kw, dict(commit_proxies=3))
        return json.loads(side.lockdep.witness_doc())
    finally:
        side.lockdep.disable()
        side.lockdep.reset()


@pytest.mark.parametrize("name", sorted(CLUSTERS))
def test_lock_order_witness_matches_jax(name):
    """The lock witness on, the same script (a recovery and a resize
    included) on both packages: the same acquisition-order edges, once
    the port's own resolver lock is contracted out, and no cycle."""
    want = _witness(JAX, CLUSTERS[name])
    got = _witness(PORT, CLUSTERS[name])
    edges = {tuple(e) for e in got["edges"]}
    for node in PORT_ONLY_LOCKS:
        edges = _contract(edges, node)
    assert sorted(edges) == sorted(tuple(e) for e in want["edges"])
    assert got["cycles"] == want["cycles"] == []
    assert ("CommitProxy._commit_mu", "KeyRangeHeatmap._lock") in edges
