"""Change feeds of the port against the JAX package's, at tolerance 0:
each case of tests/test_changefeed.py (an in-range stream, a clear range
meeting the feed, windowed reads and pops, the retention trim, duplicate
and unknown ids) runs on both databases and returns the same entries and
errors; then one script through a batch, a backlog, the thread pipeline
and a 3-proxy fleet, whose members share the cluster's registry.
"""

import pytest

from tests.conftest import TEST_KNOBS
from tests.torch_sides import JAX, PORT, muts, outcome, request, results


def _feed(entries):
    return [(v, muts(ms)) for v, ms in entries]


def _streams_in_range(side, db):
    db.register_change_feed(b"f1", b"a", b"m")
    db[b"apple"] = b"1"
    db[b"zebra"] = b"out"  # outside [a, m)
    db[b"banana"] = b"2"
    db.clear(b"apple")
    entries = db.read_change_feed(b"f1", 0)
    flat = [(m.op, m.key) for _, ms in entries for m in ms]
    assert (side.op.SET, b"apple") in flat
    assert (side.op.SET, b"banana") in flat
    assert not any(k == b"zebra" for _, k in flat)
    versions = [v for v, _ in entries]
    assert versions == sorted(versions) and len(set(versions)) == len(versions)
    assert any(m.op is side.op.CLEAR_RANGE and m.key == b"apple"
               for _, ms in entries for m in ms)
    return _feed(entries)


def _clear_range_intersection(side, db):
    db.register_change_feed(b"f", b"k3", b"k6")
    db.clear_range(b"k0", b"k9")  # overlaps the feed range
    db.clear_range(b"x", b"z")  # disjoint
    entries = db.read_change_feed(b"f", 0)
    assert len(entries) == 1
    assert entries[0][1][0].op is side.op.CLEAR_RANGE
    return _feed(entries)


def _windowed_read_and_pop(side, db):
    db.register_change_feed(b"f", b"", b"\xff")
    db[b"k1"] = b"a"
    v1 = db.read_change_feed(b"f", 0)[-1][0]
    db[b"k2"] = b"b"
    db[b"k3"] = b"c"
    later = db.read_change_feed(b"f", v1)
    assert all(v > v1 for v, _ in later) and len(later) == 2
    db.pop_change_feed(b"f", v1)
    assert db.read_change_feed(b"f", v1) == later
    code = outcome(side, lambda: db.read_change_feed(b"f", 0))
    assert code == ("err", 1007)
    return [_feed(later), code,
            _feed(db.read_change_feed(b"f", v1, limit=1))]


def _retention_trims(side, db):
    db._cluster.change_feeds.retention = 5
    db.register_change_feed(b"f", b"", b"\xff")
    for i in range(12):
        db[b"r%02d" % i] = b"x"
    listing = db._cluster.change_feeds.list()
    entries = db.read_change_feed(b"f", listing[b"f"]["pop_version"])
    assert len(entries) == 5
    code = outcome(side, lambda: db.read_change_feed(b"f", 0))
    assert code == ("err", 1007)
    return [listing, _feed(entries), code]


def _duplicate_and_unknown(side, db):
    db.register_change_feed(b"f", b"a", b"b")
    out = [outcome(side, lambda: db.register_change_feed(b"f", b"a", b"b")),
           outcome(side, lambda: db.read_change_feed(b"nope", 0)),
           outcome(side, lambda: db.register_change_feed(b"g", b"b", b"a"))]
    db.deregister_change_feed(b"f")
    db.register_change_feed(b"f", b"a", b"b")  # reusable after deregister
    out.append(db._cluster.status()["cluster"]["change_feeds"])
    assert out[:3] == [("err", 2000), ("err", 2000), ("err", 2005)]
    return out


CASES = {f.__name__[1:]: f for f in (
    _streams_in_range, _clear_range_intersection, _windowed_read_and_pop,
    _retention_trims, _duplicate_and_unknown)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_change_feed_case_matches_jax(name):
    def run(side):
        c = side.cluster(**dict(TEST_KNOBS, resolver_backend="cpu"))
        try:
            return CASES[name](side, c.database())
        finally:
            c.close()

    assert run(PORT) == run(JAX)


def _routes_script(side, route):
    kw = dict(TEST_KNOBS)
    if route == "thread":
        kw["commit_pipeline"] = "thread"
        if side is JAX:
            kw.update(health_probe_enabled=False, history_enabled=False,
                      consistency_scan_enabled=False)
    elif route == "fleet":
        kw["n_commit_proxies"] = 3
    c = side.cluster(**kw)
    db = c.database()
    db.register_change_feed(b"f", b"b", b"m")
    rv = c.sequencer.committed_version
    out = []
    if route == "backlog":
        out.append([results(r) for r in c._commit_target().commit_batches(
            [[request(side, rv, sets=[(b"b%d" % i, b"x")])] for i in range(4)]
            + [[request(side, rv, clears=[(b"a", b"c")])]])])
    elif route == "fleet":
        for i, p in enumerate(c.commit_proxy.inners):
            out.append(results([p.commit(request(
                side, rv, sets=[(b"f%d" % i, b"x"), (b"z%d" % i, b"o")]))]))
    else:
        out.append(results(c.commit_proxy.commit_batch(
            [request(side, rv, sets=[(b"c%d" % i, b"y")])
             for i in range(3)]
            + [request(side, rv, sets=[(b"q", b"out")])])))
    for i in range(3):
        db[b"d%d" % i] = b"%d" % i
    out.append(_feed(db.read_change_feed(b"f", 0)))
    c.close()
    return out


@pytest.mark.parametrize("route", ["batch", "backlog", "thread", "fleet"])
def test_change_feed_routes_match_jax(route):
    want, got = _routes_script(JAX, route), _routes_script(PORT, route)
    if route == "thread":
        # the batcher may cut the client commits into different batches:
        # the same mutations must arrive, in commit order
        flat = lambda o: [m for _, ms in o[-1] for m in ms]  # noqa: E731
        assert got[:-1] == want[:-1] and flat(got) == flat(want)
    else:
        assert got == want
    assert len([m for _, ms in got[-1] for m in ms]) >= 6
