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
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import foundationdb_tpu_torch as tfdb
from foundationdb_tpu_torch.convert import state_to_numpy, tensor_from_numpy
from foundationdb_tpu_torch.core.options import Knobs
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
from foundationdb_tpu_torch.ops.ring import (
    ring_hits,
    ring_hits_plain,
    ring_slot_hits,
)
from foundationdb_tpu_torch.resolver.resolver import Resolver
from foundationdb_tpu_torch.server.cluster import Cluster
from foundationdb_tpu_torch import workloads
from foundationdb_tpu_torch.workloads import STREAMS

from torch_ring_cases import RING_SCENARIOS, V0, ring_scenario
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
@pytest.mark.parametrize("mode", ["range", "hash"])
def test_sharded_cluster_on_card_equals_cpu(cuda, mode):
    """Cluster(n_resolvers=3): the lane fleet on the card and on the CPU
    give the same outcomes, rows and state, and launch neither ported
    TPU kernel (the lanes run the plain torch step, as the JAX mesh runs
    jnp), only the sweep that accepts over their conflict matrix."""
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
    assert got[0] == want[0] and 1020 in got[0]
    assert got[1] == want[1]
    for f, a, b in zip(ck.ResolverState._fields, got[2], want[2]):
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.gpu
@pytest.mark.parametrize("knobs", [dict(resolver_sharding="range"),
                                   dict(resolver_sharding="hash"),
                                   dict(ring_partition_bits=2)])
def test_lane_and_partitioned_resolvers_on_card_equal_cpu(cuda, knobs):
    """MeshResolver (3 lanes, both modes) and the partitioned ring on the
    card against the CPU, resolve and resolve_many."""
    from foundationdb_tpu_torch.resolver.meshresolver import MeshResolver

    stream = STREAMS["mixed"](8, txns=64, seed=1, nkeys=5000, lag=300)
    if "resolver_sharding" in knobs:
        gpu = MeshResolver(Knobs(**SMALL, **knobs), n_lanes=3)
        cpu = MeshResolver(Knobs(**SMALL, **knobs), n_lanes=3, device="cpu")
    else:
        gpu = Resolver(Knobs(**SMALL, **knobs))
        cpu = Resolver(Knobs(**SMALL, **knobs), device="cpu")
    got = [gpu.resolve(*b) for b in stream[:4]] + gpu.resolve_many(stream[4:])
    want = [cpu.resolve(*b) for b in stream[:4]] + cpu.resolve_many(stream[4:])
    assert got == want
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

    clusters = [Cluster(device=d, commit_pipeline="thread", commit_batch_max=1,
                        **CLUSTER_KNOBS) for d in (None, "cpu")]
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

    def run(self, key, batch, make_step):
        from foundationdb_tpu_torch.convert import batch_from_numpy

        use_fast, B = key
        params = self.r._fast_params if use_fast else self.r.params
        b = batch_from_numpy(batch, self.r.device)
        if B == 1:
            return ck.resolve_batch(self.r.state, b, params)[0]
        return torch.stack([ck.resolve_batch(
            self.r.state, type(b)(*(f[i] for f in b)), params)[0]
            for i in range(B)])

    def stats(self):
        return {}


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
    assert first == {"ring_hits": 4, "fused_accept": 0, "accept_sweep": 2}
    for b in stream[1:]:
        r.resolve(*b)
    assert _kernels.launches == {"ring_hits": 2 * 6, "fused_accept": 0,
                                 "accept_sweep": 1 + 5}
    _kernels.reset_launches()
    r.resolve_many(stream[:3])  # pads to BACKLOG_B: 8 steps in one graph
    assert _kernels.launches == {"ring_hits": 2 * 8 * 2, "fused_accept": 0,
                                 "accept_sweep": 8 * 2}


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
@pytest.mark.parametrize("knobs", [dict(), dict(resolver_sharding="hash")])
def test_precompiled_resolver_only_replays(cuda, knobs):
    """After precompile() every dispatch is a replay of a graph captured
    before the first batch: no capture, no host sync in the first lazy
    dispatch, the statuses and state of the CPU. (The "range" lanes
    precompile k = 1; a batch the router splits into k > 1 slices
    compiles at its first use.)"""
    from foundationdb_tpu_torch.resolver.meshresolver import MeshResolver

    stream = STREAMS["mixed"](7, txns=64, seed=4, nkeys=5000, lag=300)
    if knobs:
        gpu = MeshResolver(Knobs(**SMALL, **knobs), n_lanes=3)
        cpu = MeshResolver(Knobs(**SMALL, **knobs), n_lanes=3, device="cpu")
    else:
        gpu, cpu = Resolver(Knobs(**SMALL)), Resolver(Knobs(**SMALL),
                                                      device="cpu")
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
