"""The database of the port against the JAX package's: the same seeded
client script runs on ``foundationdb_tpu``'s ``Cluster(**TEST_KNOBS)``
and on the port's ``Cluster(device="cpu", **TEST_KNOBS)``, on the flat
and the legacy commit path, with the port's accept kernel on and off (on
the CPU, its plain version). Per-transaction outcomes (commit version or
error code), every value read, the final rows and the resolver's 12
state fields must be identical (tolerance 0). Then the client API cases
of ``tests/test_cluster.py``, each run on both databases.
"""

import functools
import struct

import numpy as np
import pytest
import torch

import foundationdb_tpu as jfdb
import foundationdb_tpu_torch as tfdb
from foundationdb_tpu.core import flatpack as jflat
from foundationdb_tpu.core.commit import CommitRequest as JRequest
from foundationdb_tpu.core.errors import FDBError as JError
from foundationdb_tpu.core.keys import KeySelector as JSelector
from foundationdb_tpu.core.mutations import Mutation as JMutation
from foundationdb_tpu.core.mutations import Op as JOp
from foundationdb_tpu.server.cluster import Cluster as JCluster
from foundationdb_tpu_torch.convert import state_to_numpy
from foundationdb_tpu_torch.core import flatpack as tflat
from foundationdb_tpu_torch.core.commit import CommitRequest as TRequest
from foundationdb_tpu_torch.core.errors import FDBError as TError
from foundationdb_tpu_torch.core.keys import KeySelector as TSelector
from foundationdb_tpu_torch.core.mutations import Mutation as TMutation
from foundationdb_tpu_torch.core.mutations import Op as TOp
from foundationdb_tpu_torch.server.cluster import Cluster as TCluster

from tests.conftest import TEST_KNOBS

torch.set_num_threads(1)


class Side:
    """One package's names, so the script is written once."""

    def __init__(self, name, cluster, fdb, request, flat, mutation, op,
                 error, selector, state):
        self.name = name
        self.cluster = cluster
        self.fdb = fdb
        self.request = request
        self.flat = flat
        self.mutation = mutation
        self.op = op
        self.error = error
        self.selector = selector
        self.state = state


JAX = Side("jax", JCluster, jfdb, JRequest, jflat, JMutation, JOp, JError,
           JSelector, lambda c: [np.asarray(f) for f in c.resolvers[0].state])
PORT = Side("port", functools.partial(TCluster, device="cpu"), tfdb, TRequest,
            tflat, TMutation, TOp, TError, TSelector,
            lambda c: list(state_to_numpy(c.resolvers[0].state)))

NKEYS = 48
WINDOW = 9000  # max_read_transaction_life_versions: nine batches


def _key(rng):
    return b"k%03d" % rng.integers(NKEYS)


def _span(rng):
    a, b = sorted((_key(rng), _key(rng)))
    return a, b + b"\xff"


def _outcome(side, fn):
    """("ok", value) or ("err", code) of ``fn()``."""
    try:
        return ("ok", fn())
    except side.error as e:
        return ("err", e.code)


def _client_op(side, tr, rng, log):
    """One random client operation on ``tr``; reads go to ``log``."""
    k = _key(rng)
    kind = rng.integers(10)
    if kind == 0:
        log.append(_outcome(side, lambda: tr.get(k)))
    elif kind == 1:
        log.append(_outcome(side, lambda: tr.snapshot.get(k)))
    elif kind == 2:
        b, e = _span(rng)
        lim, rev = int(rng.integers(4)), bool(rng.integers(2))
        log.append(_outcome(side, lambda: tr.get_range(b, e, limit=lim,
                                                       reverse=rev)))
    elif kind == 3:
        sel = side.selector(k, bool(rng.integers(2)), int(rng.integers(-1, 3)))
        log.append(_outcome(side, lambda: tr.get_key(sel)))
    elif kind in (4, 5):
        tr.set(k, b"v%d" % rng.integers(1000))
    elif kind == 6:
        tr.clear(k)
    elif kind == 7:
        tr.clear_range(*_span(rng))
    elif kind == 8:
        tr.add(k, int(rng.integers(1, 50)).to_bytes(4, "little"))
    else:
        tr.byte_max(k, b"v%d" % rng.integers(1000))


def _requests(side, c, rng, knobs, n):
    """``n`` CommitRequests as a client would send them, some read-free
    (read_version None), some with more point reads than the packed
    lanes or a key past the limb capacity (both leave the flat lane)."""
    out = []
    for _ in range(n):
        reads = [(k, k + b"\x00") for k in
                 {_key(rng) for _ in range(rng.integers(4))}]
        reads += [_span(rng) for _ in range(rng.integers(2))]
        muts, writes = [], []
        for _ in range(rng.integers(1, 4)):
            if rng.integers(4):
                k = _key(rng)
                if rng.integers(20) == 0:
                    k = k + b"-past-the-limb-capacity"
                muts.append(side.mutation(side.op.SET, k, b"b%d" % rng.integers(99)))
                writes.append((k, k + b"\x00"))
            else:
                b, e = _span(rng)
                muts.append(side.mutation(side.op.CLEAR_RANGE, b, e))
                writes.append((b, e))
        rv = None
        if reads:
            rv = max(0, c.sequencer.committed_version - int(rng.integers(3000)))
        flat = None
        if knobs["commit_pack_path"] == "flat":
            flat = side.flat.encode_conflicts(sorted(reads), sorted(writes),
                                              knobs["key_limbs"])
        out.append(side.request(rv, muts, sorted(reads), sorted(writes),
                                flat_conflicts=flat))
    return out


def _results(side, results):
    return [("err", r.code) if isinstance(r, side.error) else ("ok", r)
            for r in results]


def run_script(side, knobs, seed=7):
    """One cluster life. Returns (outcomes, final rows, resolver state)."""
    rng = np.random.default_rng(seed)
    c = side.cluster(**knobs)
    db = c.database()
    log = []
    db.run(lambda tr: [tr.set(b"k%03d" % i, b"base%d" % i)
                       for i in range(0, NKEYS, 2)])
    # interleaved client transactions: each issues its reads and writes
    # between the others', then all commit in a shuffled order
    for rnd in range(14):
        trs = [db.create_transaction() for _ in range(int(rng.integers(2, 5)))]
        for _ in range(int(rng.integers(2, 7))):
            for tr in trs:
                _client_op(side, tr, rng, log)
        if rnd == 5:
            trs[0].set_versionstamped_value(
                b"k-stamped", b"at:" + b"\x00" * 10 + struct.pack("<I", 3))
            trs[1].set_versionstamped_key(
                b"k-log/" + b"\x00" * 10 + struct.pack("<I", 6), b"entry")
        for i in rng.permutation(len(trs)):
            log.append(_outcome(side, trs[i].commit))
            log.append(_outcome(side, trs[i].get_committed_version))
    # a backlog of 10 batches through one resolve_many
    batches = [_requests(side, c, rng, knobs, int(rng.integers(1, 13)))
               for _ in range(10)]
    for res in c.commit_proxy.commit_batches(batches):
        log.append(_results(side, res))
    # single batches, then a read version left behind the window: its
    # read fails at storage and its commit at the resolver, both 1007
    old = db.create_transaction()
    log.append(_outcome(side, lambda: old.get(b"k000")))
    for _ in range(12):
        log.append(_results(side, c.commit_proxy.commit_batch(
            _requests(side, c, rng, knobs, int(rng.integers(1, 17))))))
    old.set(b"k001", b"late")
    log.append(_outcome(side, old.commit))
    late = db.create_transaction()
    late.set_read_version(old.get_read_version())
    log.append(_outcome(side, lambda: late.get(b"k002")))
    rows = db.get_range(b"", b"\xff")
    return log, rows, side.state(c), c


# the resolver's counters that the port keeps with the reference's meaning
COUNTERS = ("resolve_batches", "resolve_txns", "backlog_dispatches",
            "flat_fallbacks")


@functools.lru_cache(maxsize=None)
def _jax_run(pack_path):
    knobs = dict(TEST_KNOBS, commit_pack_path=pack_path,
                 max_read_transaction_life_versions=WINDOW)
    log, rows, state, c = run_script(JAX, knobs)
    counters = c.resolvers[0].metrics.snapshot()["counters"]
    return log, rows, state, {k: counters.get(k, 0) for k in COUNTERS}


@pytest.mark.parametrize("accept_kernel", ["on", "off"])
@pytest.mark.parametrize("pack_path", ["flat", "legacy"])
def test_cluster_script_matches_jax(pack_path, accept_kernel):
    want_log, want_rows, want_state, want_counters = _jax_run(pack_path)
    knobs = dict(TEST_KNOBS, commit_pack_path=pack_path,
                 max_read_transaction_life_versions=WINDOW,
                 accept_kernel=accept_kernel)
    log, rows, state, c = run_script(PORT, knobs)
    assert log == want_log
    assert rows == want_rows
    for i, (a, b) in enumerate(zip(state, want_state)):
        assert a.dtype == b.dtype and np.array_equal(a, b), f"state field {i}"
    codes = {o[1] for entry in log
             for o in (entry if isinstance(entry, list) else [entry])
             if o[0] == "err"}
    assert {1007, 1020} <= codes  # the script reaches both
    cp, r = c.commit_proxy, c.resolvers[0]
    assert {k: r.counters[k] for k in COUNTERS} == want_counters
    if pack_path == "flat":
        assert cp.pack_flat_batches > 0 and cp.pack_legacy_batches > 0
        assert r.counters["flat_fallbacks"] > 0  # over-capacity batches
    else:
        assert cp.pack_flat_batches == 0
    assert r.counters["backlog_dispatches"] == 1


# ── the client API cases of tests/test_cluster.py, on both databases ──

def _get_set_clear(db, s):
    db[b"foo"] = b"bar"
    assert db[b"foo"] == b"bar"
    assert db[b"missing"] is None
    del db[b"foo"]
    assert db[b"foo"] is None


def _read_your_writes(db, s):
    def fn(tr):
        tr[b"a"] = b"1"
        assert tr[b"a"] == b"1"
        tr.clear(b"a")
        assert tr[b"a"] is None
        tr[b"a"] = b"2"
        return tr[b"a"]

    assert db.run(fn) == b"2"
    return db[b"a"]


def _conflict_and_retry(db, s):
    db[b"k"] = b"0"
    t1 = db.create_transaction()
    _ = t1[b"k"]
    t2 = db.create_transaction()
    t2[b"k"] = b"t2"
    t2.commit()
    t1[b"other"] = b"x"
    with pytest.raises(s.error) as ei:
        t1.commit()
    assert ei.value.code == 1020
    t1.on_error(ei.value)
    _ = t1[b"k"]
    t1[b"other"] = b"x"
    t1.commit()
    return db[b"other"], t1.get_committed_version()


def _blind_writes_dont_conflict(db, s):
    t1 = db.create_transaction()
    t2 = db.create_transaction()
    t1[b"k"] = b"1"
    t2[b"k"] = b"2"
    t1.commit()
    t2.commit()
    return db[b"k"]


def _snapshot_read_no_conflict(db, s):
    db[b"k"] = b"0"
    t1 = db.create_transaction()
    _ = t1.snapshot[b"k"]
    t2 = db.create_transaction()
    t2[b"k"] = b"new"
    t2.commit()
    t1[b"out"] = b"1"
    t1.commit()
    return db[b"out"]


def _atomic_ops(db, s):
    db.add(b"ctr", (5).to_bytes(8, "little"))
    db.add(b"ctr", (7).to_bytes(8, "little"))
    assert int.from_bytes(db[b"ctr"], "little") == 12

    def fn(tr):
        tr.add(b"ctr", (1).to_bytes(8, "little"))
        return tr[b"ctr"]

    assert int.from_bytes(db.run(fn), "little") == 13
    db.run(lambda tr: tr.byte_max(b"bm", b"abc"))
    db.run(lambda tr: tr.byte_max(b"bm", b"abd"))
    assert db[b"bm"] == b"abd"
    db.run(lambda tr: tr.compare_and_clear(b"bm", b"abd"))
    assert db[b"bm"] is None
    for op in ("bit_and", "bit_or", "bit_xor", "min", "max", "byte_min",
               "append_if_fits"):
        db.run(lambda tr, op=op: getattr(tr, op)(b"op-" + op.encode(),
                                                 b"\x0f\xf0"))
        db.run(lambda tr, op=op: getattr(tr, op)(b"op-" + op.encode(),
                                                 b"\x3c\x3c"))
    return db.get_range(b"", b"\xff")


def _get_range_merges_writes(db, s):
    for i in range(5):
        db[b"r%02d" % i] = b"v%d" % i

    def fn(tr):
        tr[b"r01x"] = b"new"
        tr.clear(b"r03")
        return tr.get_range(b"r00", b"r99")

    rows = db.run(fn)
    assert [k for k, _ in rows] == [b"r00", b"r01", b"r01x", b"r02", b"r04"]
    rows = db.get_range(b"r00", b"r99", limit=2, reverse=True)
    assert [k for k, _ in rows] == [b"r04", b"r02"]
    return rows


def _clear_range_and_startswith(db, s):
    for i in range(5):
        db[b"p/%d" % i] = b"x"
    db[b"q"] = b"keep"
    db.clear_range(b"p/0", b"p/3")
    assert [k for k, _ in db.get_range_startswith(b"p/")] == [b"p/3", b"p/4"]
    db.run(lambda tr: tr.clear_range_startswith(b"p/"))
    assert db.get_range_startswith(b"p/") == []
    assert db[b"q"] == b"keep"


def _key_selectors(db, s):
    for k in [b"a", b"c", b"e"]:
        db[k] = b"1"
    sel = s.selector
    assert db.get_key(sel.first_greater_or_equal(b"b")) == b"c"
    assert db.get_key(sel.first_greater_than(b"c")) == b"e"
    assert db.get_key(sel.last_less_than(b"c")) == b"a"
    assert db.get_key(sel.last_less_or_equal(b"c")) == b"c"
    assert db.get_key(sel.first_greater_or_equal(b"z")) == b"\xff"
    return [db.get_key(sel(b"c", eq, off)) for eq in (False, True)
            for off in (-2, -1, 0, 1, 2, 3)]


def _watch_fires_on_change(db, s):
    db[b"w"] = b"0"
    handle = db.watch(b"w")
    assert handle.active and not handle.is_set()
    db[b"w"] = b"1"
    assert handle.is_set()
    assert handle.wait(timeout=0.1)


def _watch_no_fire_on_same_value(db, s):
    db[b"w"] = b"0"
    handle = db.watch(b"w")
    db[b"w"] = b"0"
    assert not handle.is_set()


def _versionstamp(db, s):
    tr = db.create_transaction()
    tr[b"k"] = b"v"
    vsf = tr.get_versionstamp()
    tr.commit()
    stamp = vsf()
    assert len(stamp) == 10
    assert int.from_bytes(stamp[:8], "big") == tr.get_committed_version()
    return stamp


def _versionstamped_key(db, s):
    def fn(tr):
        key = b"log/" + b"\xff" * 10 + struct.pack("<I", 4)
        tr.set_versionstamped_key(key, b"entry")

    db.run(fn)
    rows = db.get_range_startswith(b"log/")
    assert len(rows) == 1 and rows[0][1] == b"entry"
    return rows


def _transactional_decorator(db, s):
    @s.fdb.transactional
    def bump(tr, key):
        n = int(tr[key] or b"0") + 1
        tr[key] = b"%d" % n
        return n

    assert bump(db, b"n") == 1
    assert bump(db, b"n") == 2
    tr = db.create_transaction()
    assert bump(tr, b"n") == 3


def _read_only_commit_and_status(db, s):
    db[b"x"] = b"1"
    tr = db.create_transaction()
    _ = tr[b"x"]
    tr.commit()
    st = db.status()
    assert st["cluster"]["database_available"]
    return st["cluster"]["workload"]["transactions"]["committed"]["counter"]


def _size_limits(db, s):
    with pytest.raises(s.error) as ei:
        db.set(b"k" * 20_000, b"v")
    assert ei.value.code == 2102
    with pytest.raises(s.error) as ei:
        db.set(b"k", b"v" * 200_000)
    assert ei.value.code == 2103


def _dead_roles(db, s):
    """A dead log answers 1021 (the outcome is unknown), a dead resolver
    1020 (never resolved)."""
    c = db._cluster
    db[b"a"] = b"1"
    out = []
    for kill in (c.tlog.kill, c.resolvers[0].kill):
        kill()
        tr = db.create_transaction()
        tr[b"a"] = b"2"
        with pytest.raises(s.error) as ei:
            tr.commit()
        out.append(ei.value.code)
    assert out == [1021, 1020]
    return out


API_CASES = {f.__name__[1:]: f for f in (
    _get_set_clear, _read_your_writes, _conflict_and_retry,
    _blind_writes_dont_conflict, _snapshot_read_no_conflict, _atomic_ops,
    _get_range_merges_writes, _clear_range_and_startswith, _key_selectors,
    _watch_fires_on_change, _watch_no_fire_on_same_value, _versionstamp,
    _versionstamped_key, _transactional_decorator,
    _read_only_commit_and_status, _size_limits, _dead_roles)}


@pytest.mark.parametrize("name", sorted(API_CASES))
def test_api_case_matches_jax(name):
    """Each case asserts what tests/test_cluster.py asserts, on both
    databases, and returns the same value from both."""
    case = API_CASES[name]
    want = case(JCluster(**TEST_KNOBS).database(), JAX)
    got = case(tfdb.open(device="cpu", **TEST_KNOBS), PORT)
    assert got == want


def test_open_paths_the_port_does_not_take():
    with pytest.raises(NotImplementedError):
        tfdb.open(cluster_file="fdb.cluster", device="cpu")
    # an empty region config is refused before any role starts, as the
    # reference refuses it (valid configs: test_torch_regions; the commit
    # pipeline and proxy count: test_torch_pipeline; the resolver count:
    # test_torch_sharded; the log count and the durability arguments:
    # test_torch_durability; the storage count and the replication:
    # test_torch_datadistribution)
    codes = []
    for make, error in ((JCluster, JError),
                        (functools.partial(TCluster, device="cpu"), TError)):
        with pytest.raises(error) as ei:
            make(regions={}, **TEST_KNOBS)
        codes.append(ei.value.code)
    assert codes == [2006, 2006]
    # nor are an injected coordination quorum (the reference's remote
    # coordinators) and a coordinator count: three local ones serve
    with pytest.raises(TypeError):
        TCluster(device="cpu", n_coordinators=5, **TEST_KNOBS)
    # one engine a storage: a count that disagrees with n_storage
    with pytest.raises(ValueError):
        TCluster(device="cpu", n_storage=3, storage_engines=[None, None],
                 **TEST_KNOBS)
    with pytest.raises(ValueError):
        TCluster(device="cpu", n_resolvers=0, **TEST_KNOBS)
    with pytest.raises(ValueError):
        TCluster(device="cpu", n_resolvers=2, resolver_sharding="bytes",
                 **TEST_KNOBS)
    with pytest.raises(ValueError):
        tfdb.open(device="cpu", commit_pipeline="async", **TEST_KNOBS)



def test_sorted_dict_walks_like_a_sorted_list():
    """The port's SortedDict (chunked, 4-key chunks here so they split
    and empty) against a sorted list of the same keys."""
    import bisect
    import random

    from foundationdb_tpu_torch.utils import sorteddict

    rng = random.Random(5)
    old, sorteddict.LOAD = sorteddict.LOAD, 2
    try:
        d, ref = sorteddict.SortedDict(), {}
        keys = [bytes([rng.randrange(30), rng.randrange(4)]) for _ in range(300)]
        for step in range(6000):
            k = rng.choice(keys)
            if rng.random() < 0.55:
                d[k] = ref[k] = step
            elif k in ref:
                del d[k], ref[k]
            ks = sorted(ref)
            lo, hi = sorted((rng.choice(keys), rng.choice(keys)))
            inc = (rng.random() < 0.5, rng.random() < 0.5)
            a = (bisect.bisect_left if inc[0] else bisect.bisect_right)(ks, lo)
            b = (bisect.bisect_right if inc[1] else bisect.bisect_left)(ks, hi)
            rev = rng.random() < 0.5
            want = ks[a:b][::-1] if rev else ks[a:b]
            assert list(d.irange(lo, hi, inc, rev)) == want
            assert list(d.irange()) == ks and len(d) == len(ref)
            assert all(d[x] == ref[x] and x in d for x in ks[:2])
    finally:
        sorteddict.LOAD = old
