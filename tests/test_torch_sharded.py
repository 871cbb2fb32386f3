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
- the presharded step's pair relation (``ops/lanes.lane_pairs_plain``)
  against a brute-force loop over each lane's live slot pairs, at n = 1,
  2, 3 and 8 and with k > 1 txn slices;
- the lanes' ring check (``ops/ring.ring_hits_lanes``, whose CPU form
  is ``ring_hits_plain`` over the lane axis) against ``ring_hits_plain``
  lane by lane, n = 1 and 3, on empty, partly full, wrapped and
  differing rings;
- ``MeshResolver`` (lanes sharded by key range, the one layout),
  ``resolve`` and ``resolve_many``, and the one value each of
  ``ring_partition_bits`` and ``resolver_sharding`` that ``Resolver``,
  ``MeshResolver`` and a 3-resolver ``Cluster`` accept;
- ``Cluster(n_resolvers=3)`` against the JAX cluster on
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
    shard_batch_from_numpy,
    shard_batch_to_numpy,
    state_from_numpy,
    state_to_numpy,
    tensor_from_numpy,
)
from foundationdb_tpu_torch.core.errors import FDBError as TError
from foundationdb_tpu_torch.core.status import COMMITTED
from foundationdb_tpu_torch.core.options import Knobs as TKnobs
from foundationdb_tpu_torch.ops import conflict as tck
from foundationdb_tpu_torch.ops.accept import READ_SENTINEL, WRITE_SENTINEL
from foundationdb_tpu_torch.ops.intervals import point_in, ranges_overlap
from foundationdb_tpu_torch.ops.lanes import lane_pairs_plain
from foundationdb_tpu_torch.ops.ring import ring_hits_lanes, ring_hits_plain
from foundationdb_tpu_torch.parallel import mesh as tpm
from foundationdb_tpu_torch.resolver.meshresolver import MeshResolver
from foundationdb_tpu_torch.resolver.packing import ShardRouter
from foundationdb_tpu_torch.resolver.skiplist import TxnRequest as TTxn
from foundationdb_tpu_torch.server.cluster import Cluster as TCluster

from tests.conftest import TEST_KNOBS
from tests.torch_ring_cases import LANE_RINGS, lane_ring_case

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


def _lane_txns(seed):
    """JPARAMS.txns txns over eight keys spread across the byte range,
    each side 0-2 entries; ranges between two of the keys, so most span
    lanes."""
    rng = np.random.default_rng(seed)
    pool = [bytes([32 * i + 5]) + b"key" for i in range(8)]

    def key():
        return pool[int(rng.integers(8))]

    def span():
        a, b = sorted(rng.choice(8, 2, replace=False))
        return pool[a], pool[b]

    def some(f):
        return [f() for _ in range(int(rng.integers(0, 3)))]

    return [dict(read_version=1, point_reads=some(key),
                 point_writes=some(key), range_reads=some(span),
                 range_writes=some(span)) for _ in range(JPARAMS.txns)]


def _brute_pairs(v, T):
    """O[w, r] of a ShardBatch viewed [n, Q, ...], by a loop over each
    lane's live slot pairs with ops/intervals' tests, one pair at a
    time; and, per pair (w, r), the lanes that mark it."""
    O = torch.zeros((T, T), dtype=torch.bool)
    seen = {}

    def live(mask):
        return mask.nonzero().flatten().tolist()

    def mark(lane, w, r):
        w, r = int(w), int(r)
        if w < r and v.txn_mask[w] and v.txn_mask[r]:
            O[w, r] = True
            seen.setdefault((w, r), set()).add(lane)

    for j in range(v.pr_txn.shape[0]):
        pr, pw = live(v.pr_mask[j]), live(v.pw_mask[j])
        rr, rw = live(v.rr_mask[j]), live(v.rw_mask[j])
        for a in pw:
            for b in pr:
                if v.pw_hash[j, a] == v.pr_hash[j, b]:
                    mark(j, v.pw_txn[j, a], v.pr_txn[j, b])
            for b in rr:
                if point_in(v.pw_key[j, a], v.rr_b[j, b], v.rr_e[j, b]):
                    mark(j, v.pw_txn[j, a], v.rr_txn[j, b])
        for a in rw:
            for b in pr:
                if point_in(v.pr_key[j, b], v.rw_b[j, a], v.rw_e[j, a]):
                    mark(j, v.rw_txn[j, a], v.pr_txn[j, b])
            for b in rr:
                if ranges_overlap(v.rr_b[j, b], v.rr_e[j, b], v.rw_b[j, a],
                                  v.rw_e[j, a]):
                    mark(j, v.rw_txn[j, a], v.rr_txn[j, b])
    return O, seen


@pytest.mark.parametrize("n,headroom", [(1, 1.75), (2, 1.75), (3, 1.75),
                                        (8, 1.75), (3, 0.3)])
def test_lane_pairs_plain_matches_brute_force(n, headroom):
    """ops/lanes.lane_pairs_plain (the CPU version of the presharded
    step's pair relation) against a relation built slot pair by slot
    pair over each lane's live slots, on the router's ShardBatches:
    n = 1, 2, 3, 8, and a tight headroom that splits the batch into
    k > 1 txn slices. A masked slot compares as its sentinel hash in the
    plain version; no live hash here equals one, so only live pairs
    mark."""
    T = TPARAMS.txns
    b = JPacker(JPARAMS, use_native=False).pack(
        [JTxn(**t) for t in _lane_txns(n)], 0, 50, 0)
    sb, k, _ = ShardRouter(TPARAMS, n, headroom=headroom).split(
        _stack([b], jck.ResolveBatch))
    assert k > 1 or headroom > 1
    tsb = shard_batch_from_numpy(sb)
    spanned = 0
    for i in range(tsb.rv.shape[0]):
        v = tpm.lane_view(tck.ShardBatch(*(f[i] for f in tsb)), n)
        for h, m in ((v.pw_hash, v.pw_mask), (v.pr_hash, v.pr_mask)):
            assert not torch.isin(h[m], torch.tensor(
                [READ_SENTINEL, WRITE_SENTINEL])).any()
        want, seen = _brute_pairs(v, T)
        assert want.any()
        assert torch.equal(lane_pairs_plain(v, T), want)
        spanned += sum(len(lanes) > 1 for lanes in seen.values())
    # ranges that span lanes: a pair marked on two lanes is one mark
    assert (spanned > 0) == (n > 1)


def test_chip_smoke_lane_cases_at_the_cell_shapes():
    """chip_smoke.py's lane_pairs cases, built on the CPU at the default
    widths: three lanes of 2,392 point and 1,200 range slots a side, the
    YCSB-A batch live on lane 1 alone and the spread batch live on every
    lane in all four relations (lane_batches asserts both); each case's
    bound counts at least the T*T marks' bytes and one compare a pair
    the plain version marks on one lane."""
    import chip_smoke
    from foundationdb_tpu_torch.resolver.resolver import params_from_knobs

    params = params_from_knobs(TKnobs())
    T = params.txns
    cases = chip_smoke.lane_batches(params, "cpu")
    assert list(cases) == ["ycsb_a", "spread"]
    for label, views in cases.items():
        for v in views:
            assert (v.pw_txn.shape[1], v.pr_txn.shape[1], v.rr_txn.shape[1],
                    v.rw_txn.shape[1]) == (2392, 2392, 1200, 1200)
            nb, ops = chip_smoke.lane_pairs_cost(v, T)
            marks = int(lane_pairs_plain(v, T).sum())
            assert nb > T * T and ops >= marks > 0
    (v,) = cases["ycsb_a"]
    assert chip_smoke.lane_pairs_cost(v, T)[1] == T * T


@pytest.mark.parametrize("point_mode", [True, False])
@pytest.mark.parametrize("ring", LANE_RINGS)
@pytest.mark.parametrize("n", [1, 3])
def test_ring_hits_lanes_matches_ring_hits_plain_lane_by_lane(
        n, ring, point_mode):
    """The lanes' ring check on CPU tensors against ring_hits_plain run
    lane by lane, each lane's slots against its own ring: the same
    bits."""
    Q, KR = 300, 200
    args = [tensor_from_numpy(a) for a in lane_ring_case(
        ring, np.random.default_rng(n + LANE_RINGS.index(ring)), n, Q, KR,
        5)]
    want = torch.stack([ring_hits_plain(*(a[j] for a in args),
                                        point_mode=point_mode)
                        for j in range(n)])
    got = ring_hits_lanes(*args, point_mode=point_mode)
    assert got.dtype == torch.bool and got.shape == (n, Q)
    assert torch.equal(got, want)
    if ring == "empty" or (ring == "lanes differ" and n > 1):
        assert not want[0].any()
    if ring != "empty":
        assert 0 < int(want.sum()) < n * Q
    if ring == "read versions filter":
        # the read versions hide live entries that would hit
        older = ring_hits_lanes(*args[:2], torch.zeros_like(args[2]),
                                *args[3:], point_mode=point_mode)
        assert (older & ~want).any()


def test_ring_hits_lanes_rejects_what_the_kernel_does_not_take():
    """The wrapper checks shapes and dtypes on the CPU too, before its
    plain form runs."""
    args = [tensor_from_numpy(a) for a in lane_ring_case(
        "wrapped", np.random.default_rng(0), 3, 40, 64, 5)]
    bad = {0: args[0][:, :, :4],          # qlo narrower than qhi
           2: args[2].to(torch.int32),    # rv int32
           3: args[3][:2],                # ring_b of two lanes
           5: args[5][:, :63],            # ring_v one entry short
           6: args[6].to(torch.int64)}    # ring_mask not bool
    for i, t in bad.items():
        with pytest.raises(ValueError, match="ring_hits_lanes"):
            ring_hits_lanes(*args[:i], t, *args[i + 1:])
    wide = [a.repeat_interleave(4, dim=-1) if a.dim() == 3 else a
            for a in args]  # 20 limbs: wider than the kernels take
    with pytest.raises(ValueError, match="key width"):
        ring_hits_lanes(*wide)


def test_presharded_params_refuse_both_kernel_flags():
    """validate_presharded_params refuses the ring and accept kernels'
    flags (the lanes' ring walk runs on a card without one), and
    MeshResolver("range") leaves them off whatever ring_kernel says."""
    for bad in (dict(use_ring_kernel=True), dict(use_accept_kernel=True)):
        with pytest.raises(ValueError, match="presharded"):
            tck.validate_presharded_params(TPARAMS._replace(**bad))
    for ring_kernel in ("on", "off", "auto"):
        r = MeshResolver(TKnobs(resolver_sharding="range",
                                ring_kernel=ring_kernel, **KNOBS),
                         n_lanes=3, device="cpu")
        assert not r.params.use_ring_kernel, ring_kernel


def test_chip_smoke_ring_lane_cases():
    """chip_smoke.py's ring_hits_lanes cases, built on the CPU at small
    widths (T = 64, KR = 256): the YCSB-A lane view's point-read slots
    and the spread view's range-read slots against a fresh ring a lane,
    where nothing hits and the bound charges only the masks and the hit
    bits, and against a full ring rolled and cut differently in each
    lane, where some slots hit and others do not. Each case's call
    equals its plain version, and in the full-ring cases a walk of lane
    0's ring for every lane (a kernel that lost its lane offset) gives
    other bits."""
    import chip_smoke
    from foundationdb_tpu_torch.resolver.resolver import params_from_knobs

    params = params_from_knobs(TKnobs(
        batch_txn_capacity=64, key_limbs=3, hash_table_bits=12,
        range_ring_capacity=256, coarse_buckets_bits=8))
    T, W, KR = params.txns, params.key_width, params.ring_capacity
    views = chip_smoke.lane_batches(params, "cpu")
    g = np.random.default_rng(4)
    full = tck.init_state(params, "cpu")
    # user keys' ranges: YCSB-A's live keys as begins, one limb step on
    live = views["ycsb_a"][0].pr_key[1, :T]
    full.ring_b.copy_(live[torch.tensor(g.integers(0, T, KR))])
    full.ring_e.copy_(full.ring_b)
    full.ring_e[:, W - 2] += 1
    full.ring_v.copy_(torch.tensor(g.integers(100, 200, KR)))
    full.ring_mask.fill_(True)
    rv = torch.tensor(g.integers(0, 200, T))
    cases = chip_smoke.ring_lane_cases(params, views, full, rv)
    n = chip_smoke.SHARDED_LANES
    Qpr = views["ycsb_a"][0].pr_txn.shape[1]
    Qrr = views["spread"][0].rr_txn.shape[1]
    assert [c["case"] for c in cases] == [
        f"{m} n={n} Q={q} KR={KR} W={W}, {r}"
        for r in ("empty ring", "full ring, rolled and cut by lane")
        for m, q in (("point", Qpr), ("range", Qrr))]
    for c in cases:
        got = c["fn"]()
        assert torch.equal(got, c["plain"]())
        nb, ops = c["cost"]()
        hits = int(got.sum())
        if not c["some_hits"]:
            assert hits == 0 and ops == 0
            assert nb == n * KR + 2 * got.numel()  # the masks, the hit bits
            continue
        assert 0 < hits < got.numel() and ops > 0
        qlo, qhi, rvq, rb, re, rvv, rm = c["fn"].__defaults__[0]
        lane0 = [t[:1].expand_as(t) for t in (rb, re, rvv, rm)]
        point = c["case"].startswith("point")
        assert not torch.equal(
            got, ring_hits_plain(qlo, qhi, rvq, *lane0, point_mode=point))
    assert int(cases[2]["fn"]()[1:].sum()) > 0  # range hits past lane 0


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
    _same_state(jpm.PreshardedResolverKernel(
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
@pytest.mark.parametrize("mode", ["range"])
def test_mesh_resolver_matches_jax(mode, n):
    """MeshResolver through resolve() and a resolve_many backlog, the
    port seeded from the JAX fleet's state after three batches: the same
    statuses and the same 12 state fields."""
    jr = JMesh(JKnobs(resolver_backend="tpu", resolver_sharding=mode,
                      **KNOBS), n_lanes=n)
    tr = MeshResolver(TKnobs(**KNOBS), n_lanes=n, device="cpu")
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
    assert (tr.lane_entries > 0).all() and tr.split_chunks == {1: 7}


@pytest.mark.parametrize("knob,one,other", [
    ("ring_partition_bits", 0, 2), ("resolver_sharding", "range", "hash")])
@pytest.mark.parametrize("kind", ["Resolver", "MeshResolver", "Cluster"])
def test_layout_knobs_accept_one_value(kind, knob, one, other):
    """Each resolver step has one layout: Resolver, MeshResolver and a
    3-resolver Cluster on the device backend build with the flat ring and
    lanes sharded by key range, and refuse a bucket-partitioned ring and
    "hash" lanes with a ValueError that names the one value."""
    from foundationdb_tpu_torch.resolver.resolver import Resolver

    def build(value):
        knobs = {knob: value, **KNOBS}
        if kind == "Resolver":
            return Resolver(TKnobs(**knobs), device="cpu")
        if kind == "MeshResolver":
            return MeshResolver(TKnobs(**knobs), n_lanes=3, device="cpu")
        return TCluster(device="cpu", n_resolvers=3, **knobs)

    r = build(one)
    if kind == "Cluster":
        try:
            r.database()[b"k"] = b"v"
            assert r.status()["cluster"]["resolvers"] == 3
        finally:
            r.close()
    else:
        assert r.resolve([TTxn(read_version=1, point_writes=[b"k"])], 10,
                         0) == [COMMITTED]
    with pytest.raises(ValueError, match=f"{knob} accepts {one!r} only"):
        build(other)


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


@pytest.mark.parametrize("mode", ["range"])
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
