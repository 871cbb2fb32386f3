"""The CUDA kernels on the card, each against its plain PyTorch version,
the Resolver and the database on the card against the CPU, and the
compiled step (CUDA graph replays) against the eager step on the card.

Every case is marked ``gpu`` and asks for the ``cuda`` fixture, which
skips where no card is present: the decision is made when the test runs,
never at import. This file imports neither JAX nor the JAX package, so it
runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Outputs are bits and statuses, so the tolerance is 0.
"""

import os
import queue
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import foundationdb_tpu_torch as tfdb
from foundationdb_tpu_torch.convert import (
    shard_batch_from_numpy,
    state_to_numpy,
    tensor_from_numpy,
)
from foundationdb_tpu_torch.core.options import Knobs
from foundationdb_tpu_torch.core.status import CONFLICT
from foundationdb_tpu_torch.ops import _kernels
from foundationdb_tpu_torch.ops import conflict as ck
from foundationdb_tpu_torch.ops.accept import (
    LANE_P_RR,
    LANE_PP,
    LANE_PR_RING,
    LANE_RR_RING,
    LANE_RW_P,
    LANE_RW_RR,
    conflict_matrix,
    fused_accept,
    fused_accept_plain,
    jacobi_accept,
    launch_fused_accept,
    sweep_accept,
)
from foundationdb_tpu_torch.ops.lanes import lane_pairs, lane_pairs_plain
from foundationdb_tpu_torch.ops.ring import (
    ring_hits,
    ring_hits_lanes,
    ring_hits_plain,
    ring_slot_hits,
)
from foundationdb_tpu_torch.parallel.mesh import (
    _SHARD_REPLICATED,
    PreshardedResolverKernel,
    lane_view,
)
from foundationdb_tpu_torch.resolver.packing import BatchPacker, ShardRouter
from foundationdb_tpu_torch.resolver.resolver import Resolver
from foundationdb_tpu_torch.resolver.skiplist import TxnRequest
from foundationdb_tpu_torch.server.cluster import Cluster
from foundationdb_tpu_torch import workloads
from foundationdb_tpu_torch.workloads import STREAMS

from torch_ring_cases import (
    LANE_RINGS,
    RING_SCENARIOS,
    V0,
    lane_ring_case,
    ring_scenario,
)
from torch_ring_cases import keys as _keys
from torch_ring_cases import versions as _versions

HASHES = np.array([5, 6, 0xFFFFFFFE, 0xFFFFFFFF], np.uint32)


@pytest.fixture
def cuda():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _t(a, dev):
    return tensor_from_numpy(a, dev)


@pytest.mark.gpu
@pytest.mark.parametrize("point_mode", [True, False])
@pytest.mark.parametrize("Q,KR,W", [
    (77, 37, 3), (300, 600, 5), (4096, 4096, 9),
    # Q not a multiple of the walk's 128-query tile; KR below one
    # FDB_RING_TILE (32) ring tile, and one past a multiple of it
    (129, 5, 3), (1000, 255, 4), (383, 769, 9)])
def test_ring_kernel_matches_plain(cuda, point_mode, Q, KR, W):
    rng = np.random.default_rng(Q + KR)
    args = [_t(a, cuda) for a in (
        _keys(rng, Q, W), _keys(rng, Q, W), _versions(rng, Q),
        _keys(rng, KR, W), _keys(rng, KR, W), _versions(rng, KR),
        rng.random(KR) < 0.8)]
    _kernels.reset_launches()
    got = ring_hits(*args, point_mode=point_mode)
    torch.cuda.synchronize()
    assert _kernels.launches["ring_hits"] == 1
    want = ring_hits_plain(*args, point_mode=point_mode)
    assert torch.equal(got, want)
    assert 0 < int(want.sum()) < Q


@pytest.mark.gpu
@pytest.mark.parametrize("point_mode", [True, False])
@pytest.mark.parametrize("name", RING_SCENARIOS)
def test_ring_walk_edges(cuda, name, point_mode):
    arrays, want = ring_scenario(name, np.random.default_rng(11))
    args = [_t(a, cuda) for a in arrays]
    got = ring_hits(*args, point_mode=point_mode)
    plain = ring_hits_plain(*args, point_mode=point_mode)
    assert torch.equal(got, plain)
    if want is None:
        assert 0 < int(plain.sum()) < len(plain)
    else:
        np.testing.assert_array_equal(plain.cpu().numpy(), want)


LANE_SETS = [(2, 2, 1, 1), (2, 2, 0, 0), (0, 0, 2, 2), (2, 0, 0, 1),
             (0, 2, 1, 0), (4, 4, 2, 2)]


def _accept_case(rng, T, PR, PW, RR, RW, W, KR, dev, live="full"):
    """A random (state, batch, params, a0). ``live`` as in
    tests/test_torch_kernels.py LIVENESS; the slot masks of dead txns
    stay drawn."""
    params = ck.ResolverParams(
        txns=T, point_reads=PR, point_writes=PW, range_reads=RR,
        range_writes=RW, key_width=W, hash_bits=8, ring_capacity=KR,
        bucket_bits=4)

    def m(*s):
        return _t(rng.random(s) < 0.7, dev)

    txn_mask = rng.random(T) < 0.9
    z = np.zeros
    batch = ck.ResolveBatch(
        rv=_t(_versions(rng, T), dev), txn_mask=_t(txn_mask, dev),
        pr_hash=_t(HASHES[rng.integers(0, 4, (T, PR))], dev),
        pr_key=_t(_keys(rng, T, PR, W), dev),
        pr_bucket=_t(z((T, PR), np.int32), dev), pr_mask=m(T, PR),
        pw_hash=_t(HASHES[rng.integers(0, 4, (T, PW))], dev),
        pw_key=_t(_keys(rng, T, PW, W), dev),
        pw_bucket=_t(z((T, PW), np.int32), dev), pw_mask=m(T, PW),
        rr_b=_t(_keys(rng, T, RR, W), dev), rr_e=_t(_keys(rng, T, RR, W), dev),
        rr_lo=_t(z((T, RR), np.int32), dev), rr_hi=_t(z((T, RR), np.int32), dev),
        rr_mask=m(T, RR),
        rw_b=_t(_keys(rng, T, RW, W), dev), rw_e=_t(_keys(rng, T, RW, W), dev),
        rw_lo=_t(z((T, RW), np.int32), dev), rw_hi=_t(z((T, RW), np.int32), dev),
        rw_mask=m(T, RW),
        cv=_t(np.uint32(V0 + 40), dev), new_window_start=_t(np.uint32(0), dev),
    )
    state = ck.init_state(params, dev)._replace(
        ring_b=_t(_keys(rng, KR, W), dev), ring_e=_t(_keys(rng, KR, W), dev),
        ring_v=_t(_versions(rng, KR), dev), ring_mask=m(KR))
    # a0 implies a live slot, as resolve_batch builds it
    a0 = (rng.random(T) < 0.8) & txn_mask
    if live.startswith("prefix"):
        a0 = np.arange(T) < int(live[len("prefix"):])
    elif live == "scattered":
        a0 = rng.random(T) < 0.1
    elif live == "holes":
        a0 = rng.random(T) < 0.5
    if live != "full":
        batch = batch._replace(txn_mask=_t(a0 | (live == "holes"), dev))
    return state, batch, params, _t(a0, dev)


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", LANE_SETS)
@pytest.mark.parametrize("T,W,KR", [(8, 3, 16), (130, 3, 150),
                                    (1024, 9, 4096)])
def test_accept_kernel_matches_plain(cuda, T, W, KR, lanes):
    rng = np.random.default_rng(T + sum(lanes))
    case = _accept_case(rng, T, *lanes, W=W, KR=KR, dev=cuda)
    _kernels.reset_launches()
    got = fused_accept(*case)
    torch.cuda.synchronize()
    assert _kernels.launches["fused_accept"] == 1
    assert torch.equal(got, fused_accept_plain(*case))


@pytest.mark.gpu
@pytest.mark.parametrize("live", ["prefix0", "prefix1", "prefix33",
                                  "scattered", "holes"])
def test_accept_kernel_on_sparse_batches(cuda, live):
    """The batches whose dead tiles and words the kernels skip, at the
    default widths: a live prefix (a pipeline batch, a one-txn commit, a
    pad batch), scattered live txns, and a0 with holes."""
    rng = np.random.default_rng(len(live))
    case = _accept_case(rng, 1024, 4, 4, 2, 2, W=9, KR=4096, dev=cuda,
                        live=live)
    got = fused_accept(*case)
    want = fused_accept_plain(*case)
    assert torch.equal(got, want)
    assert not (got & ~case[3]).any()


SMALL = dict(batch_txn_capacity=64, key_limbs=3, hash_table_bits=12,
             range_ring_capacity=256, coarse_buckets_bits=8)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(STREAMS))
@pytest.mark.parametrize("route", [
    dict(), dict(accept_kernel="off", ring_kernel="on"),
    dict(accept_kernel="off", ring_kernel="off")])
def test_resolver_on_card_equals_cpu(cuda, name, route):
    stream = STREAMS[name](8, txns=64, seed=1, nkeys=5000, lag=300)
    gpu = Resolver(Knobs(**SMALL, **route))
    cpu = Resolver(Knobs(**SMALL), device="cpu")
    got = [gpu.resolve(*b) for b in stream[:4]] + gpu.resolve_many(stream[4:])
    want = [cpu.resolve(*b) for b in stream[:4]] + cpu.resolve_many(stream[4:])
    assert got == want
    for f, a, b in zip(ck.ResolverState._fields, state_to_numpy(gpu.state),
                       state_to_numpy(cpu.state)):
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.gpu
def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = torch.zeros((4, 3), dtype=torch.int32, device=cuda)
    v = torch.zeros((4,), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        ring_hits(q, q, v, q, q, v, v.bool())


ALL_PAIR_LANES = LANE_PP | LANE_P_RR | LANE_RW_P | LANE_RW_RR


@pytest.mark.gpu
@pytest.mark.parametrize("ring_lanes", [LANE_PR_RING, LANE_RR_RING, 0])
def test_accept_ring_lanes_gate_qhit(cuda, ring_lanes):
    """Each ring lane fills only its own slots of qhit, and qhit is
    cleared where no ring lane runs: it starts at 0xFF here."""
    rng = np.random.default_rng(21)
    state, batch, params, a0 = _accept_case(rng, 300, 2, 2, 2, 1, W=5,
                                            KR=700, dev=cuda)
    T, b = params.txns, batch
    qhit = torch.full((T * 4,), 0xFF, dtype=torch.uint8, device=cuda)
    got = launch_fused_accept(state, batch, params, a0,
                              ALL_PAIR_LANES | ring_lanes, qhit)
    ring = (state.ring_b, state.ring_e, state.ring_v, state.ring_mask)
    want_p = ring_slot_hits(b.pr_key, b.pr_key, b.rv, b.pr_mask, ring, True)
    want_r = ring_slot_hits(b.rr_b, b.rr_e, b.rv, b.rr_mask, ring, False)
    want_p &= ring_lanes == LANE_PR_RING
    want_r &= ring_lanes == LANE_RR_RING
    assert torch.equal(qhit[:T * 2].view(T, 2), want_p.to(torch.uint8))
    assert torch.equal(qhit[T * 2:].view(T, 2), want_r.to(torch.uint8))
    kill = want_p.any(dim=1) | want_r.any(dim=1)
    assert torch.equal(got, jacobi_accept(a0 & ~kill,
                                          conflict_matrix(batch, params)))
    assert int(want_p.sum() + want_r.sum()) > 0 or ring_lanes == 0


@pytest.mark.gpu
def test_wrappers_do_not_sync_with_the_host(cuda):
    rng = np.random.default_rng(31)
    args = [_t(a, cuda) for a in ring_scenario("non-monotone across 2^31",
                                                rng)[0]]
    case = _accept_case(rng, 300, 2, 2, 2, 1, W=5, KR=700, dev=cuda)
    ring_hits(*args)  # builds the libraries outside the check
    fused_accept(*case)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got_r = ring_hits(*args)
        got_a = fused_accept(*case)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got_r, ring_hits_plain(*args))
    assert torch.equal(got_a, fused_accept_plain(*case))


CLUSTER_KNOBS = dict(batch_txn_capacity=64, key_limbs=4, hash_table_bits=14,
                     range_ring_capacity=256, coarse_buckets_bits=10)


def _drive_cluster(c, name):
    """A small preload, client transactions (a range read and a set, and
    an OCC pair), then a stream's batches as client commit requests:
    three through commit_batch, ten through one commit_batches. Returns
    every outcome, the rows and the resolver state."""
    results = []
    for reqs in workloads.preload_requests(300, c.knobs.key_limbs, batch=64,
                                           record_bytes=16):
        results.append(c.commit_proxy.commit_batch(reqs))
    db = c.database()
    rng = np.random.default_rng(4)
    for i in rng.integers(0, 290, 8).tolist():
        def txn(tr, i=i):
            rows = tr.get_range(workloads.user_key(i), workloads.user_key(i + 8))
            tr.set(workloads.user_key(i), b"%d" % len(rows))
            return rows
        results.append(db.run(txn))
    t1, t2 = db.create_transaction(), db.create_transaction()
    t1.get(b"user00000001")
    t2.set(b"user00000001", b"t2")
    t2.commit()
    t1.set(b"user00000002", b"t1")
    try:
        t1.commit()
    except tfdb.FDBError as e:
        results.append(e.code)
    stream = STREAMS[name](13, txns=64, seed=2, nkeys=300, lag=900)

    def reqs(b):
        txns, cv, _ = b
        return workloads.commit_requests(txns, cv, c.sequencer.committed_version,
                                         c.knobs.key_limbs, b"w")

    for b in stream[:3]:
        results.append(c.commit_proxy.commit_batch(reqs(b)))
    backlog = c.commit_proxy.commit_batches([reqs(b) for b in stream[3:]])
    results.extend(backlog)
    out = [[r.code if isinstance(r, tfdb.FDBError) else r for r in res]
           if isinstance(res, list) else res for res in results]
    return out, db.get_range(b"", b"\xff"), state_to_numpy(c.resolvers[0].state)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["range_heavy", "mixed"])
@pytest.mark.parametrize("pack_path", ["flat", "legacy"])
def test_cluster_on_card_equals_cpu(cuda, name, pack_path):
    """The database on cuda:0 (its default device) and with device="cpu"
    give the same outcomes, rows and resolver state."""
    gpu = Cluster(commit_pack_path=pack_path, **CLUSTER_KNOBS)
    assert gpu.device == torch.device("cuda:0")
    cpu = Cluster(device="cpu", commit_pack_path=pack_path, **CLUSTER_KNOBS)
    got, want = _drive_cluster(gpu, name), _drive_cluster(cpu, name)
    assert got[0] == want[0]
    assert 1020 in got[0]
    assert got[1] == want[1]
    for f, a, b in zip(ck.ResolverState._fields, got[2], want[2]):
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (gpu.commit_proxy.pack_flat_batches > 0) == (pack_path == "flat")


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["range"])
def test_sharded_cluster_on_card_equals_cpu(cuda, mode):
    """Cluster(n_resolvers=3): the lane fleet on the card and on the CPU
    give the same outcomes, rows and state, and launch neither the accept
    kernel nor the one-ring walk (ring_hits), only the sweep that accepts
    over their conflict matrix, lane_pairs, which builds it, and
    ring_hits_lanes, their rings' walk."""
    from foundationdb_tpu_torch.resolver.meshresolver import MeshResolver

    gpu = Cluster(n_resolvers=3, resolver_sharding=mode, **CLUSTER_KNOBS)
    cpu = Cluster(device="cpu", n_resolvers=3, resolver_sharding=mode,
                  **CLUSTER_KNOBS)
    (r,) = gpu.resolvers
    assert isinstance(r, MeshResolver) and r.n_lanes == 3
    assert r.state.ht.device.type == "cuda"
    _kernels.reset_launches()
    got, want = _drive_cluster(gpu, "mixed"), _drive_cluster(cpu, "mixed")
    assert _kernels.launches["fused_accept"] == 0
    assert _kernels.launches["ring_hits"] == 0
    assert _kernels.launches["accept_sweep"] > 0
    assert _kernels.launches["lane_pairs"] > 0
    assert _kernels.launches["ring_hits_lanes"] > 0
    assert got[0] == want[0] and 1020 in got[0]
    assert got[1] == want[1]
    for f, a, b in zip(ck.ResolverState._fields, got[2], want[2]):
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.gpu
@pytest.mark.parametrize("knobs", [dict(resolver_sharding="range")])
def test_lane_and_partitioned_resolvers_on_card_equal_cpu(cuda, knobs):
    """MeshResolver (3 lanes sharded by key range) on the card against
    the CPU, resolve and resolve_many."""
    from foundationdb_tpu_torch.resolver.meshresolver import MeshResolver

    stream = STREAMS["mixed"](8, txns=64, seed=1, nkeys=5000, lag=300)
    gpu = MeshResolver(Knobs(**SMALL, **knobs), n_lanes=3)
    cpu = MeshResolver(Knobs(**SMALL, **knobs), n_lanes=3, device="cpu")
    got = [gpu.resolve(*b) for b in stream[:4]] + gpu.resolve_many(stream[4:])
    want = [cpu.resolve(*b) for b in stream[:4]] + cpu.resolve_many(stream[4:])
    assert got == want
    for f, a, b in zip(ck.ResolverState._fields, state_to_numpy(gpu.state),
                       state_to_numpy(cpu.state)):
        np.testing.assert_array_equal(a, b, err_msg=f)


# the presharded lanes' shapes: T and the slot capacities vary by case
LANE_SHAPE = dict(point_reads=2, point_writes=2, range_reads=2,
                  range_writes=2, key_width=5, hash_bits=14,
                  ring_capacity=1024, bucket_bits=8)


def _lane_txns(kind, T, rng):
    """T txns. "spread": keys over the whole byte range from a pool of
    64, so slots of every lane meet, and ranges between two of them,
    most spanning lanes; "one_lane": YCSB-A's shape, one point read and
    one point write of a user key each, every key in lane 1 of the
    uniform first-limb split; "same": every txn one key and range."""
    if kind == "one_lane":
        ids = rng.integers(0, 2000, (T, 2))
        return [TxnRequest(read_version=1,
                           point_reads=[workloads.user_key(int(a))],
                           point_writes=[workloads.user_key(int(b))])
                for a, b in ids]
    if kind == "same":
        return [TxnRequest(read_version=1, point_reads=[b"same"],
                           point_writes=[b"same"],
                           range_reads=[(b"same", b"same2")],
                           range_writes=[(b"same", b"same2")])
                for _ in range(T)]
    pool = sorted(bytes([int(b)]) + b"k%d" % i
                  for i, b in enumerate(rng.integers(0, 256, 64)))

    def some(f):
        return [f() for _ in range(int(rng.integers(0, 3)))]

    def key():
        return pool[int(rng.integers(64))]

    def span():
        a, b = sorted(rng.choice(64, 2, replace=False))
        return pool[a], pool[b]

    return [TxnRequest(read_version=1, point_reads=some(key),
                       point_writes=some(key), range_reads=some(span),
                       range_writes=some(span)) for _ in range(T)]


def _lane_views(kind, T, n, headroom, seed, dev):
    """The router's ShardBatch of one packed batch of ``kind``, each txn
    slice viewed [n, Q, ...] on ``dev``; and the chunk factor k."""
    params = ck.ResolverParams(txns=T, **LANE_SHAPE)
    txns = _lane_txns(kind, T, np.random.default_rng(seed))
    b = BatchPacker(params, use_native=False).pack(txns, 0, 50, 0)
    stacked = ck.ResolveBatch(*(np.stack([np.asarray(f)]) for f in b))
    sb, k, _ = ShardRouter(params, n, headroom=headroom).split(stacked)
    sb = shard_batch_from_numpy(sb, dev)
    return [lane_view(ck.ShardBatch(*(f[i] for f in sb)), n)
            for i in range(sb.rv.shape[0])], k


def _per_lane(v, j):
    """Lane j of a lane view alone, as a view of one lane."""
    return ck.ShardBatch(*(f if name in _SHARD_REPLICATED else f[j:j + 1]
                           for name, f in zip(ck.ShardBatch._fields, v)))


@pytest.mark.gpu
@pytest.mark.parametrize("kind,T,n,headroom", [
    ("spread", 1024, 1, 1.75), ("spread", 1024, 3, 1.75),
    ("spread", 1024, 8, 1.75),
    # T and every slot capacity off the kernel's 128-slot tile
    ("spread", 1000, 3, 1.75),
    # YCSB-A's shape: lanes 0 and 2 all padding
    ("one_lane", 1024, 3, 1.75),
    # the router overflows a lane: k > 1 txn slices
    ("spread", 256, 3, 0.3), ("same", 64, 8, 0.5)])
def test_lane_pairs_kernel_matches_plain(cuda, kind, T, n, headroom):
    """csrc/lanes.cu against lane_pairs_plain (the index_add_ pair
    counts, > 0, upper, masks) on the router's ShardBatches, bit for bit;
    a pair that ranges spanning lanes meet on two lanes is one mark."""
    views, k = _lane_views(kind, T, n, headroom, seed=T + n, dev=cuda)
    assert k > 1 or headroom > 1
    _kernels.reset_launches()
    twice = 0
    for v in views:
        want = lane_pairs_plain(v, T)
        got = lane_pairs(v, T)
        assert got.dtype == torch.bool and got.shape == (T, T)
        assert torch.equal(got, want)
        assert want.any()
        if n > 1:
            twice += int((sum(lane_pairs_plain(_per_lane(v, j), T).int()
                              for j in range(n)) > 1).sum())
    assert _kernels.launches["lane_pairs"] == len(views)
    if kind == "one_lane":
        assert not views[0].pw_mask[0].any() and not views[0].pw_mask[2].any()
        assert views[0].pw_mask[1].sum() == T
    if kind == "spread" and n > 1:
        assert twice > 0


def _synthetic_lanes(seed, n, T, Qpw, Qpr, Qrr, Qrw, W, live, dev):
    """A ShardBatch lane view with random slots: txns anywhere in [0, T),
    masks live with probability ``live``, point hashes from {1, 2, 3} and
    both masked-slot sentinels, keys whose limbs 0-2 tie often and long
    keys (nonzero middle limbs, some last limbs 0xFFFFFFFF), so the
    kernel's prefix compares reach their full-key fallback."""
    g = np.random.default_rng(seed)

    def keys(N):
        k = np.zeros((N, W), np.int64)
        k[:, 0] = g.integers(0, 4, N)
        if W > 1:
            k[:, 1] = g.integers(0, 3, N)
        if W > 3:
            longk = g.random(N) < 0.3
            k[longk, 3:W - 1] = g.integers(0, 3, (int(longk.sum()), W - 4))
            k[:, W - 1] = g.integers(0, 3, N)
            k[g.random(N) < 0.05, W - 1] = 0xFFFFFFFF
        return torch.tensor(k.reshape(n, N // n, W), device=dev)

    def side(Q):
        N = n * Q
        return (torch.tensor(g.integers(0, T, N).reshape(n, Q),
                             dtype=torch.int32, device=dev),
                torch.tensor(g.random(N).reshape(n, Q) < live, device=dev))

    def hashes(Q):
        h = g.choice(np.array([1, 2, 3, 0xFFFFFFFE, 0xFFFFFFFF]), n * Q)
        return torch.tensor(h.reshape(n, Q), dtype=torch.int64, device=dev)

    def z(Q):
        return torch.zeros((n, Q), dtype=torch.int32, device=dev)

    (pwt, pwm), (prt, prm) = side(Qpw), side(Qpr)
    (rrt, rrm), (rwt, rwm) = side(Qrr), side(Qrw)
    return ck.ShardBatch(
        rv=torch.zeros(T, dtype=torch.int64, device=dev),
        txn_mask=torch.tensor(g.random(T) < 0.9, device=dev),
        pr_hash=hashes(Qpr), pr_key=keys(n * Qpr), pr_bucket=z(Qpr),
        pr_txn=prt, pr_mask=prm,
        pw_hash=hashes(Qpw), pw_key=keys(n * Qpw), pw_bucket=z(Qpw),
        pw_txn=pwt, pw_mask=pwm,
        rr_b=keys(n * Qrr), rr_e=keys(n * Qrr), rr_lo=z(Qrr), rr_hi=z(Qrr),
        rr_txn=rrt, rr_mask=rrm,
        rw_b=keys(n * Qrw), rw_e=keys(n * Qrw), rw_lo=z(Qrw), rw_hi=z(Qrw),
        rw_txn=rwt, rw_mask=rwm,
        cv=torch.zeros((), dtype=torch.int64, device=dev),
        new_window_start=torch.zeros((), dtype=torch.int64, device=dev))


@pytest.mark.gpu
@pytest.mark.parametrize("shape,live", [
    ((1, 64, 130, 129, 40, 200, 9), 0.5),
    ((3, 100, 300, 257, 150, 131, 9), 0.5),
    ((2, 50, 5, 7, 0, 3, 3), 0.5),
    ((2, 40, 20, 20, 20, 20, 4), 0.5),
    ((2, 200, 600, 600, 260, 260, 9), 0.01),
    ((3, 1024, 2392, 2392, 1200, 1200, 9), 0.2)])
def test_lane_pairs_kernel_on_random_slots(cuda, shape, live):
    """csrc/lanes.cu against lane_pairs_plain on random slot arrays: the
    sentinel hashes of masked slots (a live read hashing 0xFFFFFFFF meets
    every masked write slot, in tiles with no live writer too), long keys
    that tie on their prefixes, dead txns, zero-width sides."""
    v = _synthetic_lanes(sum(shape), *shape, live, cuda)
    T = shape[1]
    want = lane_pairs_plain(v, T)
    assert torch.equal(lane_pairs(v, T), want)
    assert want.any()


@pytest.mark.gpu
@pytest.mark.parametrize("ring", LANE_RINGS)
@pytest.mark.parametrize("point_mode,n,Q,KR,W", [
    # resolvers3.ycsb_a's shapes: 2,392 point-read and 1,200 range-read
    # slots a lane, a 4,096-entry ring a lane, 9 limbs
    (True, 3, 2392, 4096, 9), (False, 3, 1200, 4096, 9),
    # Q off the walk's 128-query tile, KR off its 32-entry ring tile
    (True, 2, 129, 37, 3), (False, 8, 300, 785, 5)])
def test_ring_hits_lanes_matches_plain(cuda, ring, point_mode, n, Q, KR, W):
    """csrc/ring.cu's lane walk against the broadcast form
    (ring_hits_plain over the lanes), bit for bit, on the ring states of
    the CPU tests (tests/torch_ring_cases.py lane_ring_case); one launch
    a call."""
    args = [_t(a, cuda) for a in lane_ring_case(
        ring, np.random.default_rng(n + Q + LANE_RINGS.index(ring)), n, Q,
        KR, W)]
    _kernels.reset_launches()
    got = ring_hits_lanes(*args, point_mode=point_mode)
    torch.cuda.synchronize()
    assert _kernels.launches["ring_hits_lanes"] == 1
    want = ring_hits_plain(*args, point_mode=point_mode)
    assert got.dtype == torch.bool and got.shape == (n, Q)
    assert torch.equal(got, want)
    if ring == "empty":
        assert not want.any()
    else:
        assert 0 < int(want.sum()) < n * Q


@pytest.mark.gpu
def test_ring_hits_lanes_rejects_what_the_kernel_does_not_take(cuda):
    args = [_t(a, cuda) for a in lane_ring_case(
        "wrapped", np.random.default_rng(0), 3, 40, 64, 5)]
    for i, t in {0: args[0].cpu(), 2: args[2][:, :39],
                 6: args[6].to(torch.int64)}.items():
        with pytest.raises(ValueError, match="ring_hits_lanes"):
            ring_hits_lanes(*args[:i], t, *args[i + 1:])


def _presharded_stream(params, n, seed, dev):
    """250 ShardBatches of the router (lists of txn slices on the card):
    YCSB-A's shape (every key in lane 1) and, every fifth batch, the
    spread range mix, whose range writes fill the lanes' rings; read
    versions lag up to 300 versions of 64-version batches."""
    rng = np.random.default_rng(seed)
    packer = BatchPacker(params, use_native=False)
    router = ShardRouter(params, n)
    out, cv = [], 1000
    for i in range(250):
        cv += 64
        txns = _lane_txns("spread" if i % 5 == 4 else "one_lane",
                          params.txns, rng)
        for t in txns:
            t.read_version = cv - 1 - int(rng.integers(0, 300))
        b = packer.pack(txns, 0, cv, max(0, cv - 5000))
        sb, _, _ = router.split(
            ck.ResolveBatch(*(np.stack([np.asarray(f)]) for f in b)))
        sb = shard_batch_from_numpy(sb, dev)
        out.append([ck.ShardBatch(*(f[j] for f in sb))
                    for j in range(sb.rv.shape[0])])
    return out


@pytest.mark.gpu
def test_presharded_step_on_card_equals_cpu(cuda):
    """The presharded step on the card, whose ring checks are
    ring_hits_lanes' walk, and on the CPU, whose are the broadcast form,
    each on its own state, over 200 YCSB-A-shaped batches and 50 of the
    range mix interleaved: the same statuses, accepted bits and state
    after every batch."""
    base = ck.ResolverParams(txns=256, **LANE_SHAPE)
    card = PreshardedResolverKernel(base, 3, cuda)
    cpu = PreshardedResolverKernel(base, 3, torch.device("cpu"))
    _kernels.reset_launches()
    slices = conflicts = 0
    for got_b, want_b in zip(_presharded_stream(base, 3, 5, cuda),
                             _presharded_stream(base, 3, 5, "cpu")):
        for sb, sb_cpu in zip(got_b, want_b):
            got = card._step(card.state, sb)
            want = cpu._step(cpu.state, sb_cpu)
            assert torch.equal(got[0].cpu(), want[0])
            assert torch.equal(got[1].cpu(), want[1])
            conflicts += int((want[0] == CONFLICT).sum())
            slices += 1
        for f, a, b in zip(ck.ResolverState._fields, card.state, cpu.state):
            assert torch.equal(a.cpu(), b), f
    assert _kernels.launches["ring_hits_lanes"] == 2 * slices
    assert conflicts > 0 and int(cpu.state.ring_mask.sum()) > 0


@pytest.mark.gpu
def test_range_lanes_capture_the_ring_walk_once_per_query_kind(cuda):
    """MeshResolver("range") on the card: each captured step holds one
    ring_hits_lanes launch per query kind (point reads, range reads) a
    txn slice, and every replay adds them."""
    from foundationdb_tpu_torch.resolver.meshresolver import MeshResolver

    stream = STREAMS["mixed"](6, txns=64, seed=3, nkeys=5000, lag=300)
    r = MeshResolver(Knobs(**SMALL, resolver_sharding="range"), n_lanes=3)
    r.resolve(*stream[0])
    runs = {sig: step.runs for sig, step in r._steps._steps.items()}
    _kernels.reset_launches()
    for b in stream[1:]:
        r.resolve(*b)
    want = 0
    for sig, step in r._steps._steps.items():
        _fast, k, B = sig[0]
        assert step.held["ring_hits_lanes"] == 2 * k * B, (sig[0], step.held)
        assert step.held["lane_pairs"] == k * B, (sig[0], step.held)
        # each replay, and the warm-up of a step captured in the loop
        replays = step.runs - runs.get(sig, 0)
        want += (replays + (sig not in runs)) * step.held["ring_hits_lanes"]
    assert _kernels.launches["ring_hits_lanes"] == want >= 2 * 5


@pytest.mark.gpu
def test_range_lanes_on_card_equal_cpu_over_a_long_stream(cuda):
    """MeshResolver in "range" mode on the card against the CPU over 300
    batches of keys spread over the lanes (resolve, then resolve_many
    backlogs): the same statuses and state; every batch launches
    lane_pairs."""
    from foundationdb_tpu_torch.resolver.meshresolver import MeshResolver

    rng = np.random.default_rng(9)
    stream, cv = [], 1000
    for _ in range(300):
        cv += 64
        txns = _lane_txns("spread", 64, rng)
        for t in txns:
            t.read_version = cv - 1 - int(rng.integers(0, 300))
        stream.append((txns, cv, max(0, cv - 5000)))
    knobs = Knobs(**SMALL, resolver_sharding="range")
    gpu = MeshResolver(knobs, n_lanes=3)
    cpu = MeshResolver(knobs, n_lanes=3, device="cpu")
    _kernels.reset_launches()
    got = [gpu.resolve(*b) for b in stream[:200]]
    want = [cpu.resolve(*b) for b in stream[:200]]
    assert _kernels.launches["lane_pairs"] >= 200
    for i in range(200, 300, 10):
        got += gpu.resolve_many(stream[i:i + 10])
        want += cpu.resolve_many(stream[i:i + 10])
    assert got == want
    statuses = [x for s in got for x in s]
    assert statuses.count(0) > 0 and statuses.count(1) > 0  # both verdicts
    for f, a, b in zip(ck.ResolverState._fields, state_to_numpy(gpu.state),
                       state_to_numpy(cpu.state)):
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.gpu
def test_proxy_range_traffic_launches_fused_accept(cuda):
    """Point-only commits take the fast variant (no kernel); a range read
    through a client transaction, and range writes through commit_batch,
    launch fused_accept."""
    c = Cluster(**CLUSTER_KNOBS)
    db = c.database()
    _kernels.reset_launches()
    db[b"user00000001"] = b"a"
    assert _kernels.launches["fused_accept"] == 0
    db.run(lambda tr: (tr.get_range(b"user", b"userz"), tr.set(b"x", b"1")))
    # the full variant's step is captured at this first use: its warm-up
    # launches once on a scratch state, then the replay
    assert _kernels.launches["fused_accept"] == 2
    stream = STREAMS["range_heavy"](1, txns=64, seed=3, nkeys=300)
    txns, cv, _ = stream[0]
    c.commit_proxy.commit_batch(workloads.commit_requests(
        txns, cv, c.sequencer.committed_version, c.knobs.key_limbs, b"w"))
    assert _kernels.launches["fused_accept"] == 3  # a replay
    assert _kernels.launches["ring_hits"] == 0


@pytest.mark.gpu
def test_replicated_cluster_on_card_equals_cpu(cuda):
    """Cluster(n_storage=3, replication=2) on the card: the range-heavy
    stream commits with fused_accept launched, and its outcomes, each
    storage's rows, the shard map and the resolver state equal a CPU
    twin's."""
    def drive(c):
        c.dd.max_shard_bytes = 4000  # the preload splits into shards
        db = c.database()
        for i in range(0, 300, 30):
            db.run(lambda tr, i=i: [tr.set(workloads.user_key(j), b"p" * 100)
                                    for j in range(i, i + 30)])
        moves = c.rebalance()
        out = _drive_cluster(c, "range_heavy")
        rows = [s.get_range(b"", b"\xff\xff", s.version) for s in c.storages]
        return out, moves, rows, (c.dd.map.boundaries, c.dd.map.teams)

    gpu = Cluster(n_storage=3, replication=2, **CLUSTER_KNOBS)
    cpu = Cluster(device="cpu", n_storage=3, replication=2, **CLUSTER_KNOBS)
    _kernels.reset_launches()
    got = drive(gpu)
    assert _kernels.launches["fused_accept"] > 0
    want = drive(cpu)
    assert got[0][0] == want[0][0] and 1020 in got[0][0]
    assert got[0][1] == want[0][1]
    for f, a, b in zip(ck.ResolverState._fields, got[0][2], want[0][2]):
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert got[1:] == want[1:]
    assert len(got[3][0]) > 1  # the map split


def test_cluster_and_open_raise_without_a_card():
    """With no card visible, Cluster() and open() raise; only
    device="cpu" runs on the CPU. In a subprocess with
    CUDA_VISIBLE_DEVICES="", so it holds on any machine."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import foundationdb_tpu_torch as fdb\n"
        "from foundationdb_tpu_torch.server.cluster import Cluster\n"
        "for f in (Cluster, fdb.open, lambda: Cluster(n_resolvers=3)):\n"
        "    try:\n"
        "        f()\n"
        "    except RuntimeError as e:\n"
        "        assert 'no CUDA device' in str(e), e\n"
        "    else:\n"
        "        raise SystemExit('no error without a card')\n"
        "db = fdb.open(device='cpu', batch_txn_capacity=8,\n"
        "              hash_table_bits=10, range_ring_capacity=16,\n"
        "              coarse_buckets_bits=6)\n"
        "db[b'k'] = b'v'\n"
        "assert db[b'k'] == b'v'\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=root, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_faultcov_probe_raises_without_a_card():
    """With no card visible, the chaos probe (``run_probe()`` and the
    CLI's ``--probe``) raises: it runs on cuda:0 unless asked for the
    CPU. In a subprocess with CUDA_VISIBLE_DEVICES="", so it holds on
    any machine."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "from foundationdb_tpu_torch.tools import faultcov\n"
        "for f in (faultcov.run_probe,\n"
        "          lambda: faultcov.main(['--probe', '--json'])):\n"
        "    try:\n"
        "        f()\n"
        "    except RuntimeError as e:\n"
        "        assert 'no CUDA device' in str(e), e\n"
        "    else:\n"
        "        raise SystemExit('no error without a card')\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=root, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.gpu
def test_faultcov_probe_runs_on_the_card_by_default(cuda):
    """``run_probe()`` with no device argument resolves on cuda:0: its
    steps are captured and replayed as CUDA graphs there, and every site
    it fires is in the port's table."""
    import json

    from foundationdb_tpu_torch.tools import faultcov

    devices = []
    orig = Resolver.__init__

    def spy(self, *a, **kw):
        orig(self, *a, **kw)
        devices.append(self.device)

    Resolver.__init__ = spy
    ck.reset_graph_counts()
    try:
        doc = faultcov.run_probe()
    finally:
        Resolver.__init__ = orig
    assert devices and all(d == cuda for d in devices), devices
    assert ck.graph_counts["replays"] > 0
    assert ck.graph_counts["replays"] == ck.graph_counts["dispatches"]
    rep = faultcov.coverage_report(json.loads(doc)["fired"],
                                   faultcov.load_table())
    assert rep["violations"] == [] and rep["sites_fired"] > 0


# ── the batching commit pipeline on the card ──

def _range_requests(c, n, seed):
    """``n`` flat client requests of the range-heavy stream (range reads
    and clear ranges over user keys) at the cluster's current version."""
    stream = STREAMS["range_heavy"](1, txns=n, seed=seed, nkeys=300)
    txns, cv, _ = stream[0]
    return workloads.commit_requests(txns, cv, c.sequencer.committed_version,
                                     c.knobs.key_limbs, b"w")


@pytest.mark.gpu
def test_commit_batches_begin_makes_no_host_sync(cuda):
    """Stages A+B of the pipeline (grant, pack, the batch copy and the
    lazy scan with fused_accept) enqueue on the card without a single
    host sync; the one sync is the apply stage's status copy."""
    c = Cluster(**CLUSTER_KNOBS)
    cp = c.commit_proxy
    for reqs in workloads.preload_requests(300, c.knobs.key_limbs, batch=64,
                                           record_bytes=16):
        cp.commit_batch(reqs)
    # warm: kernels built, scan shapes and allocator pools in place
    cp.commit_batches_finish(cp.commit_batches_begin(
        [_range_requests(c, 64, s) for s in range(3)]))
    torch.cuda.synchronize()
    batches = [_range_requests(c, 64, s) for s in range(3, 6)]
    _kernels.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        group = cp.commit_batches_begin(batches)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert group.results_list is None and group.handle is not None
    # one launch per scan step: 3 batches padded to the 4-wide bucket
    assert _kernels.launches["fused_accept"] == c.resolvers[0]._pad_bucket(3)
    results = cp.commit_batches_finish(group)
    assert [len(r) for r in results] == [64] * 3
    assert c.storage.version == c.sequencer.committed_version


@pytest.mark.gpu
def test_dispatch_and_materialise_on_different_threads(cuda):
    """A backlog dispatched lazily on one thread and materialised on
    another gives the statuses of a same-thread resolve_many, and the
    next dispatch does not overwrite an unread group's statuses."""
    knobs = Knobs(**CLUSTER_KNOBS)
    stream = STREAMS["mixed"](12, txns=64, seed=8, nkeys=300, lag=900)
    same = Resolver(knobs)
    want = same.resolve_many(stream[:6]) + same.resolve_many(stream[6:])
    split = Resolver(knobs)
    handles, got = [], []

    def dispatch():
        handles.append(split.resolve_many(stream[:6], lazy=True))
        handles.append(split.resolve_many(stream[6:], lazy=True))

    def materialise():
        for h in handles:
            got.extend(h.wait())

    for fn in (dispatch, materialise):
        t = threading.Thread(target=fn, daemon=True)
        t.start()
        t.join(120)
        assert not t.is_alive()
    assert got == want
    for f, a, b in zip(ck.ResolverState._fields, state_to_numpy(same.state),
                       state_to_numpy(split.state)):
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.gpu
def test_sixty_four_chunk_backlog_settles_in_grant_order(cuda):
    """A group of 64 one-request chunks (past the widest pad bucket, so
    the resolver splits it into scans of 32) commits every chunk at its
    own version in submission order, as the CPU cluster does."""
    from foundationdb_tpu_torch.server.batcher import CommitFuture

    def drive(c):
        bp = c.commit_proxy
        reqs = _range_requests(c, 64, 5)
        bp._backlog_target = 64
        pairs = [(r, CommitFuture(bp)) for r in reqs]
        bp._run_batch(pairs)
        bp.drain_pipeline()
        out = [f.result(timeout=60) for _, f in pairs]
        return ([("err", r.code) if isinstance(r, tfdb.FDBError) else
                 ("v", r) for r in out],
                bp.stages.count("apply"), c.database().get_range(b"", b"\xff"))

    # the prober, history and scan daemons commit on their own clock:
    # off, so both clusters grant the same versions
    clusters = [Cluster(device=d, commit_pipeline="thread", commit_batch_max=1,
                        health_probe_enabled=False, history_enabled=False,
                        consistency_scan_enabled=False, **CLUSTER_KNOBS)
                for d in (None, "cpu")]
    try:
        for c in clusters:
            for reqs in workloads.preload_requests(
                    300, c.knobs.key_limbs, batch=64, record_bytes=16):
                c.commit_proxy.inner.commit_batch(reqs)
        got, want = drive(clusters[0]), drive(clusters[1])
    finally:
        for c in clusters:
            c.close()
    assert got == want
    assert got[1] == 1  # one pipelined group
    versions = [v for kind, v in got[0] if kind == "v"]
    assert versions == sorted(versions) and len(set(versions)) == len(versions)
    ok = [i for i, (kind, _) in enumerate(got[0]) if kind == "v"]
    assert min(ok) < 32 <= max(ok)  # commits in both halves of the split


# ── greedy acceptance on the card, and the compiled step ──

def _upper_relation(rng, T, density, dev):
    """A strictly upper-triangular conflict relation and admissible bits."""
    O = np.triu(rng.random((T, T)) < density, 1)
    a0 = rng.random(T) < 0.85
    return _t(a0, dev), _t(O, dev)


@pytest.mark.gpu
@pytest.mark.parametrize("T,density", [
    (1, 0.5), (8, 0.3), (130, 0.05), (1024, 0.002), (1024, 0.05),
    # past 32 words: the rows come from device memory, not shared
    (1025, 0.003), (2048, 0.001), (4096, 0.0005)])
def test_accept_sweep_matches_jacobi(cuda, T, density):
    rng = np.random.default_rng(T)
    a0, O = _upper_relation(rng, T, density, cuda)
    _kernels.reset_launches()
    got = sweep_accept(a0, O)
    torch.cuda.synchronize()
    assert _kernels.launches["accept_sweep"] == 1
    want = jacobi_accept(a0, O)
    assert torch.equal(got, want)
    if T > 8:
        assert 0 < int(want.sum()) < int(a0.sum())  # chains really killed


@pytest.mark.gpu
@pytest.mark.parametrize("kind,T", [("chain", 1024), ("chain", 4096),
                                    ("dense", 1024), ("dense", 2048)])
def test_accept_sweep_chains_and_dense(cuda, kind, T):
    """A chain O[t, t+1] through every word border (every other txn is
    accepted) and a dense high-conflict relation, on both sides of 32
    words."""
    rng = np.random.default_rng(T + len(kind))
    if kind == "chain":
        O = np.zeros((T, T), bool)
        O[np.arange(T - 1), np.arange(1, T)] = True
        a0 = np.ones(T, bool)
    else:
        O = np.triu(rng.random((T, T)) < 0.5, 1)
        a0 = rng.random(T) < 0.85
    a0, O = _t(a0, cuda), _t(O, cuda)
    got = sweep_accept(a0, O)
    want = jacobi_accept(a0, O)
    assert torch.equal(got, want)
    if kind == "chain":
        assert int(want.sum()) == T // 2


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [(2, 2, 1, 1), (4, 4, 2, 2)])
def test_accept_sweep_on_the_batch_conflict_matrix(cuda, lanes):
    """The plain routes' use: O from conflict_matrix of a batch."""
    rng = np.random.default_rng(sum(lanes))
    state, batch, params, a0 = _accept_case(rng, 1024, *lanes, W=9, KR=64,
                                            dev=cuda)
    O = conflict_matrix(batch, params)
    assert torch.equal(sweep_accept(a0, O), jacobi_accept(a0, O))


class _EagerSteps:
    """A Resolver's compiled steps swapped for ck.resolve_batch run
    eagerly on the card, batch by batch, on that Resolver's own state."""

    def __init__(self, r):
        self.r = r

    def step(self, key, batch, make_step):
        return _EagerStep(self.r, key)

    def stats(self):
        return {}


class _EagerStep:
    """One key's eager step, in a StaticStep's two halves: ``stage_in``
    copies the batch to the card, ``replay`` runs the step on it."""

    def __init__(self, r, key):
        self.r = r
        self.use_fast, self.B = key

    def stage_in(self, batch):
        from foundationdb_tpu_torch.convert import batch_from_numpy

        return batch_from_numpy(batch, self.r.device)

    def replay(self, b):
        params = self.r._fast_params if self.use_fast else self.r.params
        if self.B == 1:
            return ck.resolve_batch(self.r.state, b, params)[0]
        return torch.stack([ck.resolve_batch(
            self.r.state, type(b)(*(f[i] for f in b)), params)[0]
            for i in range(self.B)])


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(STREAMS))
@pytest.mark.parametrize("route", [
    dict(), dict(accept_kernel="off", ring_kernel="on"),
    dict(accept_kernel="off", ring_kernel="off")])
def test_captured_step_equals_eager_step_on_the_card(cuda, name, route):
    """Every step a graph replay: the same statuses and state as the
    eager step on a second state on the card."""
    stream = STREAMS[name](14, txns=64, seed=6, nkeys=5000, lag=300)
    cap = Resolver(Knobs(**SMALL, **route))
    eager = Resolver(Knobs(**SMALL, **route))
    eager._steps = _EagerSteps(eager)
    ck.reset_graph_counts()
    got = ([cap.resolve(*b) for b in stream[:4]] + cap.resolve_many(stream[4:7])
           + cap.resolve_many(stream[7:]))
    counts = dict(ck.graph_counts)
    want = ([eager.resolve(*b) for b in stream[:4]]
            + eager.resolve_many(stream[4:7]) + eager.resolve_many(stream[7:]))
    assert got == want
    for f, a, b in zip(ck.ResolverState._fields, state_to_numpy(cap.state),
                       state_to_numpy(eager.state)):
        np.testing.assert_array_equal(a, b, err_msg=f)
    graphs = cap.status()["graphs"]
    assert counts["replays"] == counts["dispatches"] == graphs["runs"] == 6
    assert counts["captures"] == graphs["graphs"] == sum(
        graphs["captures"].values()) >= 2


@pytest.mark.gpu
def test_launches_are_counted_on_every_replay(cuda):
    """A graph holds its wrappers' launches; each replay adds them, and
    the capture itself adds none (its warm-up launches once, for real)."""
    stream = STREAMS["mixed"](5, txns=64, seed=2, nkeys=5000, lag=300)
    r = Resolver(Knobs(**SMALL, accept_kernel="off", ring_kernel="on"))
    _kernels.reset_launches()
    r.resolve(*stream[0])
    first = dict(_kernels.launches)
    # the full variant on the ring route: ring_hits for point and range
    # reads, then accept_sweep; warm-up + replay
    assert first == {"ring_hits": 4, "fused_accept": 0, "accept_sweep": 2,
                     "lane_pairs": 0, "ring_hits_lanes": 0}
    for b in stream[1:]:
        r.resolve(*b)
    assert _kernels.launches == {"ring_hits": 2 * 6, "fused_accept": 0,
                                 "accept_sweep": 1 + 5, "lane_pairs": 0,
                                 "ring_hits_lanes": 0}
    _kernels.reset_launches()
    r.resolve_many(stream[:3])  # pads to BACKLOG_B: 8 steps in one graph
    assert _kernels.launches == {"ring_hits": 2 * 8 * 2, "fused_accept": 0,
                                 "accept_sweep": 8 * 2, "lane_pairs": 0,
                                 "ring_hits_lanes": 0}


@pytest.mark.gpu
def test_capture_under_a_concurrent_status_reader(cuda):
    """The batcher's pattern: one thread dispatches lazy backlogs of new
    pad widths (each a capture) while another waits on earlier handles
    and copies tensors off the card in a loop. No capture fails and every
    status equals a CPU resolver's."""
    import queue

    depths = (2, 3, 5, 9, 17, 2, 3, 5, 9)  # 2, 4, 8, 16, 32, then replays
    stream = STREAMS["mixed"](sum(depths), txns=64, seed=12, nkeys=5000,
                              lag=300)
    gpu = Resolver(Knobs(**SMALL))
    cpu = Resolver(Knobs(**SMALL), device="cpu")
    groups, i = [], 0
    for d in depths:
        groups.append(stream[i:i + d])
        i += d
    handles, got, errors = queue.Queue(), [], []
    done = threading.Event()
    probe = torch.arange(1024, device=cuda)

    def dispatch():
        try:
            for g in groups:
                handles.put(gpu.resolve_many(g, lazy=True))
        except BaseException as e:
            errors.append(e)
        finally:
            handles.put(None)
            done.set()

    def read():
        try:
            while True:
                h = handles.get()
                if h is None:
                    break
                while not done.is_set() and handles.empty():
                    assert int(probe.cpu()[-1]) == 1023
                got.extend(h.wait())
        except BaseException as e:
            errors.append(e)

    threads = [threading.Thread(target=f, daemon=True)
               for f in (read, dispatch)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
        assert not t.is_alive()
    assert not errors, errors
    want = [s for g in groups for s in cpu.resolve_many(g)]
    assert got == want
    for f, a, b in zip(ck.ResolverState._fields, state_to_numpy(gpu.state),
                       state_to_numpy(cpu.state)):
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert gpu.status()["graphs"]["graphs"] == 5


@pytest.mark.gpu
@pytest.mark.parametrize("knobs", [dict(), dict(accept_kernel="off",
                                                ring_kernel="on")])
def test_replayed_resolve_many_dispatch_makes_no_host_sync(cuda, knobs):
    """A resolve_many dispatch whose scan is already captured enqueues
    the batch copy, the replay and the statuses' copy with no host sync
    until ``wait()``."""
    stream = STREAMS["mixed"](9, txns=64, seed=3, nkeys=5000, lag=300)
    gpu = Resolver(Knobs(**SMALL, **knobs))
    cpu = Resolver(Knobs(**SMALL, **knobs), device="cpu")
    want = cpu.resolve_many(stream[:3]) + cpu.resolve_many(stream[3:6])
    got = gpu.resolve_many(stream[:3])  # captures the scan
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        h = gpu.resolve_many(stream[3:6], lazy=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    got += h.wait()
    assert got == want
    assert gpu.status()["graphs"]["runs"] == 2


@pytest.mark.gpu
@pytest.mark.parametrize("knobs", [dict()])
def test_precompiled_resolver_only_replays(cuda, knobs):
    """After precompile() every dispatch is a replay of a graph captured
    before the first batch: no capture, no host sync in the first lazy
    dispatch, the statuses and state of the CPU."""
    stream = STREAMS["mixed"](7, txns=64, seed=4, nkeys=5000, lag=300)
    gpu = Resolver(Knobs(**SMALL, **knobs))
    cpu = Resolver(Knobs(**SMALL, **knobs), device="cpu")
    keys = gpu.precompile()
    torch.cuda.synchronize()
    ck.reset_graph_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        h = gpu.resolve_many(stream[:3], lazy=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    got = h.wait() + [gpu.resolve(*b) for b in stream[3:5]] + \
        gpu.resolve_many(stream[5:])
    want = cpu.resolve_many(stream[:3]) + [cpu.resolve(*b) for b in
                                           stream[3:5]] + cpu.resolve_many(
        stream[5:])
    assert got == want
    for f, a, b in zip(ck.ResolverState._fields, state_to_numpy(gpu.state),
                       state_to_numpy(cpu.state)):
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert ck.graph_counts["captures"] == 0
    assert ck.graph_counts["replays"] == ck.graph_counts["dispatches"] == 4
    assert gpu.status()["graphs"]["graphs"] == len(keys)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(STREAMS))
def test_native_packer_batches_staged_to_the_card_equal_numpy(cuda, name):
    """The default (native) packer's arrays, staged to the card, equal
    the numpy packer's, at the default widths."""
    from foundationdb_tpu_torch.convert import batch_from_numpy
    from foundationdb_tpu_torch.resolver.packing import BatchPacker

    r = Resolver()
    assert r.packer._native is not None
    numpy_packer = BatchPacker(r.params, use_native=False)
    for txns, cv, ws in STREAMS[name](3, seed=11):
        got = batch_from_numpy(r.packer.pack(txns, r.base_version, cv, ws),
                               cuda)
        want = numpy_packer.pack(txns, r.base_version, cv, ws)
        for f, t, a in zip(ck.ResolveBatch._fields, got, want):
            assert t.device == cuda
            np.testing.assert_array_equal(t.cpu().numpy(), np.asarray(a),
                                          err_msg=f)


def _durable_drive(device, d):
    """A durable cluster (three WAL replicas, the sqlite engine) on
    ``device``: preload, range-heavy batches, a dead log, a drop without
    a close and a reopen, a fenced read version, more batches."""
    from foundationdb_tpu_torch.server.kvstore import open_engine

    def open_cluster():
        return Cluster(device=device, wal_path=str(d / "wal"), n_tlogs=3,
                       storage_engines=[open_engine("sqlite", str(d / "kv"))],
                       coordination_dir=str(d / "coord"), **CLUSTER_KNOBS)

    def reqs(c, b):
        txns, cv, _ = b
        return workloads.commit_requests(txns, cv, c.sequencer.committed_version,
                                         c.knobs.key_limbs, b"w")

    stream = STREAMS["range_heavy"](6, txns=64, seed=5, nkeys=300, lag=900)
    c = open_cluster()
    out = []
    for pre in workloads.preload_requests(300, c.knobs.key_limbs, batch=64,
                                          record_bytes=16):
        out.append(c.commit_proxy.commit_batch(pre))
    for b in stream[:2]:
        out.append(c.commit_proxy.commit_batch(reqs(c, b)))
    rv_old = c.sequencer.committed_version
    c.tlog.kill(0)
    out.append(c.commit_proxy.commit_batch(reqs(c, stream[2])))
    del c
    c = open_cluster()
    tr = c.database().create_transaction()
    tr.set_read_version(rv_old)
    tr.set(b"stale", b"x")
    try:
        tr.commit()
    except tfdb.FDBError as e:
        out.append(e.code)
    for b in stream[3:]:
        out.append(c.commit_proxy.commit_batch(reqs(c, b)))
    out = [[r.code if isinstance(r, tfdb.FDBError) else r for r in res]
           if isinstance(res, list) else res for res in out]
    result = (out, c.generation, c.database().get_range(b"", b"\xff"),
              state_to_numpy(c.resolvers[0].state))
    c.close()
    return result


@pytest.mark.gpu
def test_wal_reopen_on_the_card_equals_cpu(cuda, tmp_path):
    (tmp_path / "card").mkdir()
    (tmp_path / "cpu").mkdir()
    got = _durable_drive(None, tmp_path / "card")
    want = _durable_drive("cpu", tmp_path / "cpu")
    assert got[0] == want[0] and 1007 in got[0]
    assert got[1] == want[1] == 2
    assert got[2] == want[2]
    for f, a, b in zip(ck.ResolverState._fields, got[3], want[3]):
        np.testing.assert_array_equal(a, b, err_msg=f)


def _fdbserver(args, timeout=180.0):
    """A ``tools.fdbserver`` child and its address, read (bounded) from
    its "FDBD listening" line by a draining thread."""
    import queue

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = subprocess.Popen(
        [sys.executable, "-u", "-m", "foundationdb_tpu_torch.tools.fdbserver",
         *args], cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    up, lines = queue.Queue(), []

    def drain():
        for line in p.stdout:
            lines.append(line)
            if "FDBD listening on " in line:
                up.put(line.split("listening on ")[1].split()[0])
        up.put(None)

    threading.Thread(target=drain, daemon=True).start()
    try:
        addr = up.get(timeout=timeout)
    except queue.Empty:
        addr = None
    return p, addr, lines


@pytest.mark.gpu
def test_fdbserver_serves_from_the_card(cuda, tmp_path):
    """The server process with its resolver on cuda:0 (the default), a
    client through open(cluster_file=): range-carrying commits reach
    fused_accept in the server, as its device profile shows."""
    cf = str(tmp_path / "fdb.cluster")
    p, addr, lines = _fdbserver(["--listen", "127.0.0.1:0", "--cluster-file",
                                 cf, "--dir", str(tmp_path / "db")])
    db = None
    try:
        assert addr is not None, "".join(lines[-20:])
        db = tfdb.open(cluster_file=cf)
        st = db._cluster.status()["cluster"]
        assert st["processes"]["resolvers"][0]["device"].startswith("cuda")
        for i in range(8):
            db[b"k%d" % i] = b"v%d" % i

        def txn(tr):
            rows = tr.get_range(b"k0", b"k9")
            tr.clear_range(b"k2", b"k4")
            return rows

        assert len(db.run(txn)) == 8
        assert [k for k, _ in db.get_range(b"k0", b"k9")] == \
            [b"k0", b"k1", b"k4", b"k5", b"k6", b"k7"]
        prof = db._cluster.device_profile_status()["aggregate"]
        assert prof["kernel_routes"].get("fused_accept", 0) > 0
        assert all(v == 0 for v in prof["fallback_causes"].values())
    finally:
        if db is not None:
            db._cluster.close()
        p.terminate()
        try:
            p.wait(timeout=30)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(timeout=30)
