"""The port's lane-sharded resolver against the JAX package's mesh.

The JAX fleet runs one lane per device of a ``shard_map`` mesh (the 8
virtual CPU devices ``tests/conftest.py`` sets up); the port's runs the
lanes as a leading tensor axis of one state with the mesh's global
shapes. Both take the same numpy-seeded batches; the port starts from the
JAX fleet's state mid-stream (``convert.state_from_numpy``), and after
every batch the statuses and all 12 state fields must be equal:
tolerance 0, every value is an integer or a bit.

- the presharded ("range") step at n = 2, 3 and 8 on the fixtures of
  ``tests/test_shard_split.py``, and a fixture that overflows the
  router's slots into k > 1 txn slices, where the two must agree too;
- the "hash" step at n = 2 and 3;
- ``MeshResolver`` in both modes, ``resolve`` and ``resolve_many``;
- ``Cluster(n_resolvers=3)`` in both modes against the JAX cluster on
  ``tests/test_meshresolver.py``'s scripted workload, the host fan-out of
  three exact sets, and a dead fleet's recruit fencing.
"""

import random

import jax
import numpy as np
import pytest
import torch

from foundationdb_tpu.core.errors import FDBError as JError
from foundationdb_tpu.core.options import Knobs as JKnobs
from foundationdb_tpu.ops import conflict as jck
from foundationdb_tpu.parallel import mesh as jpm
from foundationdb_tpu.resolver.meshresolver import MeshResolver as JMesh
from foundationdb_tpu.resolver.packing import BatchPacker as JPacker
from foundationdb_tpu.resolver.packing import ShardRouter as JRouter
from foundationdb_tpu.resolver.skiplist import TxnRequest as JTxn
from foundationdb_tpu.server.cluster import Cluster as JCluster
from foundationdb_tpu_torch.convert import (
    batch_from_numpy,
    shard_batch_from_numpy,
    shard_batch_to_numpy,
    state_from_numpy,
    state_to_numpy,
)
from foundationdb_tpu_torch.core.errors import FDBError as TError
from foundationdb_tpu_torch.core.options import Knobs as TKnobs
from foundationdb_tpu_torch.ops import conflict as tck
from foundationdb_tpu_torch.parallel import mesh as tpm
from foundationdb_tpu_torch.resolver.meshresolver import MeshResolver
from foundationdb_tpu_torch.resolver.packing import ShardRouter
from foundationdb_tpu_torch.resolver.skiplist import TxnRequest as TTxn
from foundationdb_tpu_torch.server.cluster import Cluster as TCluster

from tests.conftest import TEST_KNOBS

torch.set_num_threads(1)

# tests/test_shard_split.py's PARAMS
SHAPE = dict(txns=16, point_reads=2, point_writes=2, range_reads=2,
             range_writes=2, key_width=5, hash_bits=14, ring_capacity=128,
             bucket_bits=8)
JPARAMS = jck.ResolverParams(**SHAPE)
TPARAMS = tck.ResolverParams(**SHAPE)
FIXTURES = ("point", "range", "mixed", "empty", "backlog_pad")
KNOBS = {k: v for k, v in TEST_KNOBS.items() if k != "initial_backoff_s"}


def _key(rng):
    # byte-uniform keys: every lane's key range gets traffic
    return int(rng.integers(2 ** 32)).to_bytes(4, "big")


def _rng_pair(rng):
    a = int(rng.integers(2 ** 32 - 4096))
    return (a.to_bytes(4, "big"),
            (a + int(rng.integers(1, 4096))).to_bytes(4, "big"))


def _fixture(kind, rng, n_txns=16):
    """test_shard_split's fixture shapes, as TxnRequest fields."""
    txns = []
    for _ in range(n_txns):
        pr = pw = rr = rw = []
        if kind in ("point", "mixed"):
            pr = [_key(rng) for _ in range(int(rng.integers(0, 3)))]
            pw = [_key(rng) for _ in range(int(rng.integers(0, 3)))]
        if kind in ("range", "mixed"):
            rr = [_rng_pair(rng) for _ in range(int(rng.integers(0, 3)))]
            rw = [_rng_pair(rng) for _ in range(int(rng.integers(0, 3)))]
        txns.append(dict(read_version=int(rng.integers(1, 40)),
                         point_reads=pr, point_writes=pw,
                         range_reads=rr, range_writes=rw))
    if kind == "empty":
        txns = [dict(read_version=1) for _ in range(n_txns)]
    if kind == "backlog_pad":
        txns = txns[: max(2, n_txns // 3)]
    return txns


def _packed(seed, kinds):
    """One packed numpy batch per kind, the history advancing."""
    packer = JPacker(JPARAMS, use_native=False)
    rng = np.random.default_rng(seed)
    out = []
    for i, kind in enumerate(kinds):
        cv = 100 + 20 * i
        out.append(packer.pack([JTxn(**t) for t in _fixture(kind, rng)],
                               0, cv, max(0, cv - 90)))
    return out


def _stack(batches, cls):
    return cls(*(np.stack([np.asarray(getattr(b, f)) for b in batches])
                 for f in cls._fields))


def _same_state(jstate, tstate):
    for name, a, b in zip(tck.ResolverState._fields,
                          [np.asarray(f) for f in jstate],
                          state_to_numpy(tstate)):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def _seeded(jkern, step, jbatches, tbatches, warm):
    """Run the JAX fleet over ``warm`` batches, seed the port from its
    state, then run both over the rest: statuses and state after each."""
    js = jkern.state
    for b in jbatches[:warm]:
        _, _, js = jkern._step(js, b)
    ts = state_from_numpy([np.asarray(f) for f in js])
    for jb, tb in zip(jbatches[warm:], tbatches[warm:]):
        jst, jacc, js = jkern._step(js, jb)
        tst, tacc, ts = step(ts, tb)
        np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
        np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
        _same_state(js, ts)
    return ts


@pytest.mark.parametrize("n", [2, 3, 8])
def test_presharded_step_matches_jax(n):
    """The router's ShardBatches through the JAX presharded fleet and the
    port's, the port seeded from the JAX state after the first batch."""
    assert len(jax.devices()) >= n
    jkern = jpm.PreshardedResolverKernel(
        JPARAMS, mesh=jpm.default_mesh(n), donate=False)
    tkern = tpm.PreshardedResolverKernel(TPARAMS, n)
    jrouter, trouter = JRouter(JPARAMS, n), ShardRouter(TPARAMS, n)
    jsbs, sbs = [], []
    for b in _packed(23, FIXTURES + ("mixed", "range", "point")):
        stacked = _stack([b], jck.ResolveBatch)
        sb, k, counts = trouter.split(stacked)
        jsb, jk, jcounts = jrouter.split(stacked)
        assert k == jk == 1
        np.testing.assert_array_equal(counts, jcounts)
        for name, a, c in zip(tck.ShardBatch._fields, sb, jsb):
            assert a.dtype == c.dtype, name
            np.testing.assert_array_equal(a, c, err_msg=name)
        sbs.append(tck.ShardBatch(*(f[0] for f in sb)))
        jsbs.append(jck.ShardBatch(*(f[0] for f in jsb)))
    assert (counts > 0).sum() > 1  # the router spread the work
    _seeded(jkern, lambda s, b: tkern._step(s, shard_batch_from_numpy(b)),
            jsbs, sbs, warm=1)


def test_presharded_chunked_split_matches_jax():
    """Every key the same and a tight headroom: the router overflows a
    lane and the batch runs as k > 1 txn slices. The port and the JAX
    fleet must agree there too, not only conservatively."""
    n = 8
    txns = [JTxn(read_version=1, point_reads=[b"same"], point_writes=[b"same"],
                 range_reads=[(b"same", b"same2")],
                 range_writes=[(b"same", b"same2")])
            for _ in range(JPARAMS.txns)]
    b0 = JPacker(JPARAMS, use_native=False).pack(txns, 0, 50, 0)
    stacked = _stack([b0, b0._replace(cv=np.uint32(70),
                                      new_window_start=np.uint32(5))],
                     jck.ResolveBatch)
    jrouter = JRouter(JPARAMS, n, headroom=0.5)
    trouter = ShardRouter(TPARAMS, n, headroom=0.5)
    sb, k, _ = trouter.split(stacked)
    jsb, jk, _ = jrouter.split(stacked)
    assert k == jk and k > 1
    jkern = jpm.PreshardedResolverKernel(
        JPARAMS, mesh=jpm.default_mesh(n), donate=False)
    js, jst = jkern._scan_step(jkern.state, jsb)
    tkern = tpm.PreshardedResolverKernel(TPARAMS, n)
    ts, tst = tkern._scan_step(tkern.state, shard_batch_from_numpy(sb))
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
    np.testing.assert_array_equal(
        trouter.reassemble(tst, k).numpy(),
        np.asarray(jrouter.reassemble(np.asarray(jst), k)))
    _same_state(js, ts)


@pytest.mark.parametrize("n", [2, 3])
def test_hash_step_matches_jax(n):
    """The "hash" step: the batch to every lane, ownership carved in the
    step; full and point-specialized params over one history."""
    jkern = jpm.ShardedResolverKernel(
        JPARAMS, mesh=jpm.default_mesh(n), donate=False)
    tkern = tpm.ShardedResolverKernel(TPARAMS, n)
    packed = _packed(5, FIXTURES + ("mixed", "range"))
    ts = _seeded(jkern, lambda s, b: tkern._step(s, batch_from_numpy(b)),
                 packed, packed, warm=2)
    assert ts.ring_head.shape == (n,) and ts.ht.shape == (n << 14,)


def test_mesh_state_and_shard_batch_round_trip():
    """A JAX mesh state and a ShardBatch go to the port's tensors and
    back unchanged."""
    jkern = jpm.PreshardedResolverKernel(
        JPARAMS, mesh=jpm.default_mesh(3), donate=False)
    js = jkern.state
    stacked = _stack(_packed(9, ("mixed",)), jck.ResolveBatch)
    jsb, _, _ = JRouter(JPARAMS, 3).split(stacked)
    _, _, js = jkern._step(js, jck.ShardBatch(*(f[0] for f in jsb)))
    _same_state(js, state_from_numpy([np.asarray(f) for f in js]))
    back = shard_batch_to_numpy(shard_batch_from_numpy(jsb))
    for name, a, b in zip(tck.ShardBatch._fields, back, jsb):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    init = tck.init_state(TPARAMS, n_lanes=3)
    _same_state(jpm.ShardedResolverKernel(
        JPARAMS, mesh=jpm.default_mesh(3), donate=False).state, init)


def _stream(seed, n_batches):
    """Batches of mixed txns with keys across the whole byte range, the
    read versions trailing the commit versions."""
    rng = random.Random(seed)

    def key():
        return bytes([rng.randrange(256)]) + b"k%d" % rng.randrange(6)

    def span():
        a, b = sorted((key(), key()))
        return a, b + b"\xff"

    out, v = [], 100
    for _ in range(n_batches):
        txns = [dict(read_version=v - rng.randrange(12),
                     point_reads=[key() for _ in range(rng.randrange(3))],
                     point_writes=[key() for _ in range(rng.randrange(3))],
                     range_reads=[span() for _ in range(rng.randrange(3))],
                     range_writes=[span() for _ in range(rng.randrange(3))])
                for _ in range(rng.randrange(1, 17))]
        v += 5
        out.append((txns, v, max(0, v - 40)))
    return out


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("mode", ["range", "hash"])
def test_mesh_resolver_matches_jax(mode, n):
    """MeshResolver through resolve() and a resolve_many backlog, the
    port seeded from the JAX fleet's state after three batches: the same
    statuses and the same 12 state fields."""
    jr = JMesh(JKnobs(resolver_backend="tpu", resolver_sharding=mode,
                      **KNOBS), n_lanes=n)
    tr = MeshResolver(TKnobs(resolver_sharding=mode, **KNOBS), n_lanes=n,
                      device="cpu")
    stream = _stream(n, 14)
    for txns, cv, ws in stream[:3]:  # the JAX fleet alone first
        jr.resolve([JTxn(**t) for t in txns], cv, ws)
    tr.load_state(state_from_numpy([np.asarray(f) for f in jr.state]))
    tr._range_history = jr._range_history
    for txns, cv, ws in stream[3:9]:
        assert tr.resolve([TTxn(**t) for t in txns], cv, ws) == \
            jr.resolve([JTxn(**t) for t in txns], cv, ws)
    back = stream[9:]
    assert tr.resolve_many([([TTxn(**t) for t in b], cv, ws)
                            for b, cv, ws in back]) == \
        jr.resolve_many([([JTxn(**t) for t in b], cv, ws)
                         for b, cv, ws in back])
    _same_state(jr.state, tr.state)
    assert tr.status()["lanes"] == n and tr.status()["sharding"] == mode
    if mode == "range":
        assert (tr.lane_entries > 0).all() and tr.split_chunks == {1: 7}


def _scripted(c, error):
    """tests/test_meshresolver.py's scripted workload: sets, swaps and
    clear_ranges of 40 keys, and a transaction held open across ten
    commits that then writes its pinned key."""
    rng = random.Random(11)
    script = []
    for i in range(120):
        kind = rng.random()
        key = b"key%03d" % rng.randrange(40)
        if kind < 0.55:
            script.append(("set", key, b"v%d" % i))
        elif kind < 0.8:
            script.append(("swap", key, b"key%03d" % rng.randrange(40)))
        else:
            lo, hi = sorted([b"key%03d" % rng.randrange(40),
                             b"key%03d" % rng.randrange(40)])
            script.append(("clear_range", lo, hi + b"\xff"))
    db = c.database()
    outcomes, stale = [], None
    for step, (op, a, b) in enumerate(script):
        if stale is None:
            stale = db.create_transaction()
            stale.get(a)
            stale_key = a
        tr = db.create_transaction()
        if op == "set":
            tr.get(a)
            tr[a] = b
        elif op == "swap":
            va, vb = tr.get(a), tr.get(b)
            tr[a], tr[b] = vb or b"x", va or b"y"
        else:
            list(tr.get_range(a, b))
            tr.clear_range(a, b)
        tr.commit()
        if step % 10 == 9:
            stale[stale_key] = b"stale"
            try:
                stale.commit()
                outcomes.append("ok")
            except error as e:
                outcomes.append((e.code, e.conflicting_key_ranges,
                                 e.conflict_version))
            stale = None
    rows = db.run(lambda tr: list(tr.get_range(b"key", b"kez")))
    return outcomes, rows


@pytest.mark.parametrize("mode", ["range", "hash"])
def test_sharded_cluster_matches_jax(mode):
    """Cluster(n_resolvers=3): one fleet of 3 lanes behind the proxy's
    single-resolver path, against the JAX cluster's mesh fleet."""
    jc = JCluster(n_resolvers=3, resolver_backend="tpu",
                  resolver_sharding=mode, **TEST_KNOBS)
    tc = TCluster(device="cpu", n_resolvers=3, resolver_sharding=mode,
                  **TEST_KNOBS)
    try:
        (tr,) = tc.resolvers
        assert isinstance(tr, MeshResolver) and tr.n_lanes == 3
        assert tc.status()["cluster"]["resolvers"] == 3
        want = _scripted(jc, JError)
        got = _scripted(tc, TError)
        assert got == want
        assert any(o != "ok" for o in got[0])
        _same_state(jc.resolvers[0].state, tr.state)
    finally:
        jc.close()
        tc.close()


def test_host_fan_out_matches_jax():
    """Three exact host sets behind the proxy's clipped fan-out."""
    jc = JCluster(n_resolvers=3, resolver_backend="cpu", **TEST_KNOBS)
    tc = TCluster(n_resolvers=3, resolver_backend="cpu", **TEST_KNOBS)
    try:
        assert len(tc.resolvers) == 3
        assert _scripted(tc, TError) == _scripted(jc, JError)
        assert tc.commit_proxy.pack_flat_batches == 0
    finally:
        jc.close()
        tc.close()


@pytest.mark.parametrize("side", ["jax", "port"])
def test_dead_fleet_recruits_fenced(side):
    """A dead fleet answers 1020; its recruit has 3 lanes and fences the
    pre-death read version (TOO_OLD), and a fresh retry commits."""
    if side == "jax":
        c = JCluster(n_resolvers=3, resolver_backend="tpu", **TEST_KNOBS)
        error, recruit = JError, lambda: c.detect_and_recruit()
    else:
        c = TCluster(device="cpu", n_resolvers=3, **TEST_KNOBS)
        error, recruit = TError, c.recruit_resolvers
    try:
        db = c.database()
        db[b"a"] = b"1"
        tr = db.create_transaction()
        tr.get(b"a")
        tr[b"a"] = b"2"
        c.resolvers[0].kill()
        with pytest.raises(error) as ei:
            tr.commit()
        assert ei.value.code == 1020
        recruit()
        (r,) = c.resolvers
        assert r.alive and r.n_lanes == 3
        old = db.create_transaction()
        old.set_read_version(1)
        old.get(b"a")
        old[b"b"] = b"x"
        with pytest.raises(error) as e2:
            old.commit()
        assert e2.value.code == 1007  # fenced below the recruit's base
        tr.on_error(ei.value)
        tr.get(b"a")
        tr[b"a"] = b"2"
        tr.commit()
        assert db[b"a"] == b"2"
    finally:
        c.close()
