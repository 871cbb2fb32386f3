"""The port's native host code against the JAX package's, at tolerance 0:
the g++-built batch packer (``BatchPacker(use_native=True)``, the
default) and the numpy packer against ``foundationdb_tpu``'s native
packer on the same seeded batches, at the default width T=1024 on the
``workloads.py`` streams and on the overflow, long-key, empty and
bytearray cases; the C++ ConflictSet (``NativeConflictSet``) against the
reference's and against the exact ``CpuConflictSet``, through
``resolve`` and ``resolve_flat``, with fencing and prune; and
``resolver_backend="native"`` behind the cluster, one resolver and three
on the proxy's sub-resolve pool. A failed build raises.
"""

import random
import subprocess

import numpy as np
import pytest

from foundationdb_tpu.core.errors import FDBError as JError
from foundationdb_tpu.native import NativeConflictSet as JNativeSet
from foundationdb_tpu.ops.conflict import ResolverParams as JParams
from foundationdb_tpu.resolver.packing import BatchPacker as JPacker
from foundationdb_tpu.resolver.skiplist import TxnRequest as JTxn
from foundationdb_tpu.server.cluster import Cluster as JCluster
from foundationdb_tpu_torch import native, workloads
from foundationdb_tpu_torch.core import flatpack
from foundationdb_tpu_torch.core.commit import CommitRequest
from foundationdb_tpu_torch.core.errors import FDBError as TError
from foundationdb_tpu_torch.core.status import COMMITTED, CONFLICT, TOO_OLD
from foundationdb_tpu_torch.ops.conflict import ResolverParams
from foundationdb_tpu_torch.resolver.packing import BatchPacker
from foundationdb_tpu_torch.resolver.skiplist import CpuConflictSet, TxnRequest
from foundationdb_tpu_torch.server.cluster import Cluster as TCluster

from tests.conftest import TEST_KNOBS

DEFAULT = ResolverParams()  # T=1024, PR=PW=4, RR=RW=2, W=9
NARROW = ResolverParams(txns=64, point_reads=2, point_writes=2,
                        range_reads=2, range_writes=2, key_width=5,
                        hash_bits=12, ring_capacity=128, bucket_bits=8)


def _jparams(p):
    return JParams(txns=p.txns, point_reads=p.point_reads,
                   point_writes=p.point_writes, range_reads=p.range_reads,
                   range_writes=p.range_writes, key_width=p.key_width,
                   hash_bits=p.hash_bits, ring_capacity=p.ring_capacity,
                   bucket_bits=p.bucket_bits)


def _jtxns(txns):
    return [JTxn(**vars(t)) for t in txns]


def _packs(params, txns, base, cv, ws, c_pass="packs"):
    """The port's native and numpy packs and the reference's native
    pack of the same batch, as lists of arrays in field order, then the
    port's C pass alone. ``c_pass`` says what that pass must do: pack
    the batch itself ("packs"), decline it on a lane overflow
    ("declines") or raise TypeError on keys that are not bytes
    ("raises"); only the last two hand the batch to numpy."""
    tn, tp = BatchPacker(params), BatchPacker(params, use_native=False)
    jn = JPacker(_jparams(params), use_native=True)
    assert tn._native is not None and jn._native is not None
    if c_pass == "raises":
        with pytest.raises(TypeError):
            tn._pack_native(txns, base, cv, ws)
        direct = None
    else:
        direct = tn._pack_native(txns, base, cv, ws)
        assert (direct is None) == (c_pass == "declines")
    packs = [tn.pack(txns, base, cv, ws), tp.pack(txns, base, cv, ws),
             jn.pack(_jtxns(txns), base, cv, ws)]
    return [[np.asarray(a) for a in b] for b in packs + [direct or packs[0]]]


def _assert_equal(packs):
    got_native, got_numpy, want, got_c = packs
    assert len(want) == 22
    for i, (a, b, c, d) in enumerate(zip(got_native, got_numpy, want, got_c)):
        assert a.dtype == b.dtype == c.dtype == d.dtype, i
        assert np.array_equal(a, c) and np.array_equal(b, c), i
        assert np.array_equal(d, c), i


@pytest.mark.parametrize("name", sorted(workloads.STREAMS))
def test_packer_matches_reference_on_streams_at_default_width(name):
    stream = workloads.STREAMS[name](2, seed=3)
    base = workloads.FIRST_VERSION - 5000
    for txns, cv, ws in stream:
        _assert_equal(_packs(DEFAULT, txns, base, cv, ws))


def _rand_key(rng, max_len=30):
    return bytes(rng.randrange(256) for _ in range(rng.randrange(max_len)))


def _rand_range(rng):
    return tuple(sorted((_rand_key(rng), _rand_key(rng))))


CASES = {
    "random": None,
    "overflow": [TxnRequest(read_version=10,
                            point_reads=[b"k%d" % i for i in range(7)],
                            range_reads=[(b"a", b"b"), (b"c", b"d"),
                                         (b"e", b"f")])],
    "long_keys": [TxnRequest(read_version=5,
                             range_writes=[(bytes(range(25)),
                                            bytes(range(25)) + b"\xff" * 8)],
                             range_reads=[(b"\xff" * 20, b"\xff" * 24)],
                             point_writes=[b"\x01" * 40])],
    "empty": [],
    "bytearray": [TxnRequest(read_version=1,
                             point_reads=[bytearray(b"abc")])],
}


# the cases the C pass hands to numpy, and how
C_PASS = {"overflow": "declines", "bytearray": "raises"}


@pytest.mark.parametrize("case", sorted(CASES))
def test_packer_edge_cases_match_reference(case):
    if case == "random":
        rng = random.Random(1234)
        for _ in range(8):
            txns = [TxnRequest(
                read_version=rng.randrange(0, 5000),
                point_reads=[_rand_key(rng) for _ in range(rng.randrange(3))],
                point_writes=[_rand_key(rng) for _ in range(rng.randrange(3))],
                range_reads=[_rand_range(rng) for _ in range(rng.randrange(3))],
                range_writes=[_rand_range(rng)
                              for _ in range(rng.randrange(3))],
            ) for _ in range(rng.randrange(0, NARROW.txns + 1))]
            base = rng.randrange(0, 100)
            _assert_equal(_packs(NARROW, txns, base,
                                 base + rng.randrange(1, 10_000), base + 10))
    else:
        _assert_equal(_packs(NARROW, CASES[case], 0, 100, 0,
                             C_PASS.get(case, "packs")))


def test_library_name_carries_the_abi_and_lands_in_build():
    so = native._so_path("packer", ("-Ifoo",))
    assert so.endswith(native.EXT_SUFFIX) and "cpython" in native.EXT_SUFFIX
    assert so.startswith(native.BUILD_DIR)
    # the include path and the flags are part of the name
    assert so != native._so_path("packer", ("-Ibar",))
    assert so != native._so_path("conflict_set", ("-Ifoo",))


def test_failed_build_raises_and_numpy_is_asked_for(monkeypatch, tmp_path):
    """A build that fails raises NativeBuildError from BatchPacker and
    from the conflict set; only use_native=False selects numpy."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_packer_mod", None)
    monkeypatch.setattr(native, "_lib", None)

    def failing(cmd, **kw):
        raise subprocess.CalledProcessError(1, cmd, stderr="no compiler")

    monkeypatch.setattr(native.subprocess, "run", failing)
    with pytest.raises(native.NativeBuildError, match="no compiler"):
        BatchPacker(NARROW)
    with pytest.raises(native.NativeBuildError):
        native.NativeConflictSet()
    with pytest.raises(native.NativeBuildError):
        TCluster(device="cpu", **TEST_KNOBS)
    assert BatchPacker(NARROW, use_native=False)._native is None


# ── the conflict set ──

def _mk_key(rng, n=50):
    return b"k%03d" % rng.randrange(n)


def _mk_range(rng, n=50):
    a, b = sorted(rng.sample(range(n), 2))
    return (b"k%03d" % a, b"k%03d" % b)


def _random_txn(rng, read_version):
    return TxnRequest(
        read_version=read_version,
        point_reads=[_mk_key(rng) for _ in range(rng.randrange(3))],
        point_writes=[_mk_key(rng) for _ in range(rng.randrange(3))],
        range_reads=[_mk_range(rng) for _ in range(rng.randrange(2))],
        range_writes=[_mk_range(rng) for _ in range(rng.randrange(2))])


def _flat(txns, num_limbs=4):
    reqs = [CommitRequest(t.read_version, [], list(t.read_ranges()),
                          list(t.write_ranges())) for t in txns]
    for r in reqs:
        r.flat_conflicts = flatpack.encode_conflicts(
            r.read_conflict_ranges, r.write_conflict_ranges, num_limbs)
    return flatpack.build_flat_batch(reqs, num_limbs)


@pytest.mark.parametrize("seed", range(4))
def test_conflict_set_matches_reference_and_oracle(seed):
    """resolve and resolve_flat on the port's set, the reference's
    native set and the exact Python set: the same statuses, the TOO_OLD
    path included (read versions dip below the window)."""
    rng = random.Random(seed)
    port, port_flat = native.NativeConflictSet(), native.NativeConflictSet()
    ref, oracle = JNativeSet(), CpuConflictSet()
    cv = 100
    for _ in range(30):
        cv += 10
        window = max(0, cv - 200)
        txns = [_random_txn(rng, rng.randrange(max(1, cv - 280), cv))
                for _ in range(rng.randrange(1, 12))]
        want = oracle.resolve(txns, cv, window)
        assert port.resolve(txns, cv, window) == want
        assert port_flat.resolve_flat(_flat(txns), cv, window) == want
        assert ref.resolve(_jtxns(txns), cv, window) == want
    assert port.window_start == ref.window_start == oracle.window_start
    assert port.segment_count == ref.segment_count


def test_conflict_set_fencing_prune_and_order():
    cs = native.NativeConflictSet()
    t1 = TxnRequest(read_version=5, point_writes=[b"x"])
    t2 = TxnRequest(read_version=5, point_reads=[b"x"], point_writes=[b"z"])
    assert cs.resolve([t1, t2], 10) == [COMMITTED, CONFLICT]
    # the conflicted txn's write of z never entered history
    assert cs.resolve([TxnRequest(read_version=8, point_reads=[b"z"])],
                      20) == [COMMITTED]
    cs.resolve([], 21, new_window_start=50)
    assert cs.window_start == 50
    cs.prune()
    assert cs.segment_count == 0
    assert cs.resolve([TxnRequest(read_version=40, point_reads=[b"x"])],
                      60) == [TOO_OLD]


# ── the native backend behind the cluster ──

def _script(c, error):
    """Blind writes, an OCC pair, read-modify-writes and a range clear
    through ``c``; returns outcomes and the final rows."""
    db = c.database()
    out = []
    for i in range(24):
        db[b"k%02d" % i] = b"v%d" % i
    t1, t2 = db.create_transaction(), db.create_transaction()
    t1.get(b"k03")
    t2.get(b"k03")
    t1[b"k03"] = b"t1"
    t2[b"k03"] = b"t2"
    t1.commit()
    try:
        t2.commit()
        out.append("committed")
    except error as e:
        out.append(e.code)
    rng = random.Random(7)
    for _ in range(30):
        a = rng.randrange(24)
        tr = db.create_transaction()
        rows = tr.get_range(b"k%02d" % a, b"k%02d" % (a + 3))
        tr[b"k%02d" % rng.randrange(24)] = b"%d" % len(rows)
        if rng.random() < 0.2:
            tr.clear_range(b"k%02d" % a, b"k%02d" % (a + 1))
        try:
            tr.commit()
            out.append("committed")
        except error as e:
            out.append(e.code)
    return out, db.get_range(b"", b"\xff")


@pytest.mark.parametrize("n_resolvers", [1, 3])
@pytest.mark.parametrize("pack_path", ["flat", "legacy"])
def test_native_cluster_matches_reference(n_resolvers, pack_path):
    kw = dict(TEST_KNOBS, resolver_backend="native",
              commit_pack_path=pack_path)
    jc = JCluster(n_resolvers=n_resolvers, **kw)
    tc = TCluster(n_resolvers=n_resolvers, **kw)
    try:
        want, got = _script(jc, JError), _script(tc, TError)
        assert got == want
        assert want[0][0] == 1020
        r = tc.resolvers[0]
        assert r.backend == "native" and r.device is None
        assert tc.resolvers[-1].window_start() == \
            jc.resolvers[-1].window_start()
        proxy = tc._commit_target()
        # three sets resolve on the proxy's pool, one set inline
        assert (proxy._pool is not None) == (n_resolvers > 1)
    finally:
        jc.close()
        tc.close()
    assert proxy._pool is None  # close released the pool


def test_native_resolver_fences_its_base_version():
    from foundationdb_tpu_torch.core.options import Knobs
    from foundationdb_tpu_torch.resolver.resolver import Resolver

    r = Resolver(Knobs(resolver_backend="native"), base_version=100)
    assert r.window_start() == 100 and r.precompile() == []
    assert r.resolve([TxnRequest(read_version=99),
                      TxnRequest(read_version=100)], 200, 100) == \
        [TOO_OLD, COMMITTED]
    new = r.respawn(300)
    assert new.window_start() == 300 and new.counters["respawns"] == 1
