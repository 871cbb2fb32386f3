"""The generator: YCSB's key names and scrambled Zipfian, each mix's
transaction shapes, determinism under the seed, no read-only
transaction, and blobs that decode to the reference's rank runs."""

import json
import os

import numpy as np
import pytest

from fdbbench import spec, traffic

N = 20_000  # records: the real model's generator at a test's size


@pytest.fixture(scope="module")
def keys():
    return traffic.KeySpace(N, 8)


# ranges in the generator's op model: no mix of a cell sends them yet
RANGE_MIX = {"draws": 2, "request_distribution": "zipfian",
             "ops": [{"side": "read", "shape": "range", "draw": 0, "span": 8},
                     {"side": "write", "shape": "range", "draw": 1,
                      "span": 4}],
             "group_batches": 1}


def _mix(name):
    if name == "range":
        return RANGE_MIX
    with open(os.path.join(spec.HERE, "mixes", name + ".json")) as f:
        return json.load(f)


def test_fnvhash64_matches_ycsb():
    # YCSB's Utils.fnvhash64 of 0 and 1, and CoreWorkload's first keys
    assert traffic.fnvhash64([0]).tolist() == [6284781860667377211]
    assert traffic.key_names(2)[0] == b"user6284781860667377211"
    assert all(k.startswith(b"user") and 5 <= len(k) <= 23
               for k in traffic.key_names(1000))


def test_keyspace_entries_are_flat_entries(keys):
    names = traffic.key_names(N)
    assert sorted(names) == [keys.key(r) for r in range(N)]
    for r in (0, 17, N - 1):
        k = keys.key(r)
        ent = keys.entries[r].tobytes()
        assert ent == k + b"\x00" * (32 - len(k)) + len(k).to_bytes(4, "big")
        assert names.index(k) == int(np.flatnonzero(keys.rank_of == r)[0])


def test_scrambled_zipfian_spreads_hot_records(keys):
    rng = np.random.default_rng(3)
    d = traffic.draw_records(rng, 400_000, N, "zipfian")
    assert d.min() >= 0 and d.max() < N
    ids, counts = np.unique(d, return_counts=True)
    hot = ids[np.argsort(-counts)[:20]]
    # YCSB's hottest item takes 1/zetan of the draws (here ~3.8%)
    assert 0.03 < counts.max() / len(d) < 0.05
    ranks = np.sort(keys.rank_of[hot])
    # the hottest records are not neighbours in key order
    assert np.diff(ranks).min() > 1
    assert ranks[-1] - ranks[0] > N // 2


def test_unknown_request_distribution_is_refused():
    rng = np.random.default_rng(4)
    for dist in ("hotspot", "latest", {"kind": "zipfian"}):
        with pytest.raises(ValueError):
            traffic.draw_records(rng, 10, 1000, dist)


@pytest.mark.parametrize("mix,shape", [
    ("ycsb_a", {"pr": 1, "pw": 1, "rr": 0, "rw": 0}),
    ("range", {"pr": 0, "pw": 0, "rr": 1, "rw": 1}),
    ("ycsb_a_backlog12", {"pr": 1, "pw": 1, "rr": 0, "rw": 0}),
])
def test_mix_shapes_and_blobs(keys, mix, shape):
    m = _mix(mix)
    pool = traffic.Pool(keys, m, 3, 64, (0, 4999), seed=9)
    for name, n in shape.items():
        assert pool.counts[name].tolist() == [n] * 64
    # every transaction writes: none is read-only
    assert (pool.write_hi > pool.write_lo).all(axis=2).all()
    b = pool.blobs(1)
    E = 36
    if shape["pr"]:
        pr = [b["pr"][i:i + E] for i in range(0, len(b["pr"]), E)]
        pw = [b["pw"][i:i + E] for i in range(0, len(b["pw"]), E)]
        lo = pool.read_lo[1, :, 0]
        assert pr == [keys.entries[r].tobytes() for r in lo]
        # an update reads and writes the same record
        assert pr == pw
        assert (pool.read_hi - pool.read_lo == 1).all()
    else:
        rr = b["rr"]
        for t in (0, 5, 63):
            lo, hi = pool.read_lo[1, t, 0], pool.read_hi[1, t, 0]
            assert hi - lo == 8
            assert rr[2 * E * t:2 * E * t + E] == keys.entries[lo].tobytes()
            assert rr[2 * E * t + E:2 * E * (t + 1)] == \
                keys.entries[hi].tobytes()
        assert (pool.write_hi - pool.write_lo == 4).all()
    assert m["group_batches"] == (12 if mix.endswith("12") else 1)


def test_pool_is_determined_by_the_seed(keys):
    m = _mix("range")
    a = traffic.Pool(keys, m, 2, 32, (0, 4999), seed=2 ** 33 + 5)
    b = traffic.Pool(keys, m, 2, 32, (0, 4999), seed=2 ** 33 + 5)
    c = traffic.Pool(keys, m, 2, 32, (0, 4999), seed=2 ** 33 + 6)
    assert a.blobs(1) == b.blobs(1) and np.array_equal(a.lags, b.lags)
    assert a.blobs(1) != c.blobs(1)
    assert 0 <= a.lags.min() and a.lags.max() <= 4999


def test_read_only_mix_is_refused(keys):
    m = dict(_mix("ycsb_a"), ops=[{"side": "read", "shape": "point",
                                   "draw": 0}])
    with pytest.raises(ValueError):
        traffic.Pool(keys, m, 1, 8, (0, 10), seed=1)


def test_versions_clock():
    v = traffic.Versions(10_000_000, 1024, 5_000_000)
    assert v.commit(0) == 10_001_024 and v.commit(1) - v.commit(0) == 1024
    assert v.window_start(0) == 5_001_024
    assert v.read_versions(0, np.array([0, 999])).tolist() == [
        10_001_023, 10_000_024]
