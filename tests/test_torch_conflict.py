"""The port's resolver step against the JAX package's, field by field.

Both steps start from the same history (the port's by ``state_from_numpy``
of the JAX state, mid-life) and take the same packed batches. After every
batch the statuses, the accepted bits and all 12 state fields must be
equal: tolerance 0, since every value is an integer or a bit. Batches are
point, range, mixed, empty and zero-txn; the ring is small enough to wrap
many times; version offsets cross 2^31 and a ``rebase_state`` step shifts
them back down. The JAX step runs its Pallas kernels in interpret mode.
"""

import random

import jax
import numpy as np
import pytest
import torch

from foundationdb_tpu.ops import conflict as jck
from foundationdb_tpu.resolver.packing import BatchPacker as JPacker
from foundationdb_tpu.resolver.skiplist import TxnRequest
from foundationdb_tpu_torch.convert import (
    batch_from_numpy,
    state_from_numpy,
    state_to_numpy,
)
from foundationdb_tpu_torch.ops import conflict as tck

# one intra-op thread per test process: the suite runs under pytest-xdist,
# where torch's default of a thread per core in every worker oversubscribes
# the CPU and slows the timed tests of the other workers
torch.set_num_threads(1)

SHAPE = dict(txns=8, point_reads=2, point_writes=2, range_reads=1,
             range_writes=2, key_width=3, hash_bits=6, ring_capacity=16,
             bucket_bits=4)
V0 = 0x7FFFFF00  # offsets cross 2^31 during the run

# (JAX kernel flags, port kernel flags): the route pairs held together
ROUTES = {
    "accept_kernel": (dict(use_pallas_scan=True), dict(use_accept_kernel=True)),
    "plain": ({}, {}),
    "ring_kernel": (dict(use_pallas=True), dict(use_ring_kernel=True)),
}


def _key(rng):
    return b"k%03d" % rng.randrange(24)


def _span(rng, key=_key):
    a, b = sorted((key(rng), key(rng)))
    return (a, b + b"\xff")


def _txn(rng, v, kind, key=_key):
    pt = kind in ("point", "mixed")
    rg = kind in ("range", "mixed")
    return TxnRequest(
        # now and then older than the 40-version window: TOO_OLD
        read_version=v - (60 if rng.random() < 0.1 else rng.randrange(12)),
        point_reads=[key(rng) for _ in range(rng.randrange(3))] if pt else [],
        point_writes=[key(rng) for _ in range(rng.randrange(3))] if pt else [],
        range_reads=[_span(rng, key) for _ in range(rng.randrange(2))] if rg else [],
        range_writes=[_span(rng, key) for _ in range(rng.randrange(3))] if rg else [],
    )


def _batches(seed, n, T, key=_key, shape=SHAPE):
    """n packed numpy batches cycling through every kind."""
    rng = random.Random(seed)
    packer = JPacker(jck.ResolverParams(**shape), use_native=False)
    kinds = ("mixed", "range", "point", "mixed", "empty", "zero", "range")
    out = []
    v = V0
    for i in range(n):
        kind = kinds[i % len(kinds)]
        cnt = 0 if kind == "zero" else rng.randrange(1, T + 1)
        txns = [_txn(rng, v, kind, key) for _ in range(cnt)]
        v += rng.randrange(1, 6)
        out.append(packer.pack(txns, 0, v, max(0, v - 40)))
    return out


def _assert_same_state(jstate, tstate):
    for name, j, t in zip(jck.ResolverState._fields, jstate,
                          state_to_numpy(tstate)):
        j = np.asarray(j)
        assert j.dtype == t.dtype and j.shape == t.shape, name
        np.testing.assert_array_equal(t, j, err_msg=name)


def _drive_pair(route, seed, n=24, rebase_at=14):
    jflags, tflags = ROUTES[route]
    jp = jck.ResolverParams(**SHAPE, **jflags)
    tp = tck.ResolverParams(**SHAPE, **tflags)
    jck.validate_params(jp)
    tck.validate_params(tp)
    jstep = jax.jit(lambda s, b: jck.resolve_batch(s, b, jp))
    batches = _batches(seed, n, SHAPE["txns"])
    js = jck.init_state(jp)
    for b in batches[:3]:  # the port starts from the JAX mid-life history
        _, _, js = jstep(js, b)
    ts = state_from_numpy([np.asarray(f) for f in js])
    _assert_same_state(js, ts)
    base = 0
    for i, b in enumerate(batches[3:], 3):
        if i == rebase_at:
            delta = int(np.asarray(js.window_start)) // 2
            js = jck.rebase_state(js, delta)
            tck.rebase_state(ts, delta)
            base += delta
            _assert_same_state(js, ts)
        if base:  # the packer's offsets follow the rebased base
            b = b._replace(
                rv=np.maximum(b.rv.astype(np.int64) - base, 0).astype(np.uint32),
                cv=np.uint32(int(b.cv) - base),
                new_window_start=np.uint32(max(0, int(b.new_window_start) - base)))
        jst, jacc, js = jstep(js, b)
        tst, tacc, ts = tck.resolve_batch(ts, batch_from_numpy(b), tp)
        np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
        np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
        _assert_same_state(js, ts)
    return ts


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("seed", [1, 2])
def test_resolve_batch_matches_jax_field_by_field(route, seed):
    ts = _drive_pair(route, seed)
    assert int(ts.ring_head) != 0 or bool(ts.ring_mask.any())


def test_ring_wraps_and_evictions_fold_like_jax():
    """Range-only traffic fills the 16-slot ring many times over: the
    eviction fold into the coarse summaries must match the JAX step."""
    ts = _drive_pair("plain", seed=7, n=30, rebase_at=-1)
    assert bool(ts.ring_mask.all())
    assert int(ts.range_L.max()) > 0 and int(ts.range_R.max()) > 0


@pytest.mark.parametrize("route", ["accept_kernel", "ring_kernel"])
def test_ring_wraps_under_each_kernel_route(route):
    """The same wrapping range-only traffic through the kernels' routes
    (their plain versions on the CPU): the accept step's and the ring
    check's reads of a ring that wraps many times, and the eviction fold,
    equal to the JAX step's Pallas routes."""
    ts = _drive_pair(route, seed=7, n=30, rebase_at=-1)
    assert bool(ts.ring_mask.all())
    assert int(ts.range_L.max()) > 0 and int(ts.range_R.max()) > 0


@pytest.mark.parametrize("route", ["accept_kernel", "plain"])
def test_scan_equals_single_steps(route):
    tp = tck.ResolverParams(**SHAPE, **ROUTES[route][1])
    batches = _batches(3, 6, SHAPE["txns"])
    s1 = tck.init_state(tp)
    rows = []
    for b in batches:
        st, _, s1 = tck.resolve_batch(s1, batch_from_numpy(b), tp)
        rows.append(st)
    stacked = jck.ResolveBatch(*(np.stack(f) for f in zip(*batches)))
    # the compiled scan runs on the state it was made over, in place
    s2 = tck.init_state(tp)
    st2 = tck.make_resolve_scan_fn(tp, s2).run(stacked)
    assert torch.equal(st2, torch.stack(rows))
    for a, b in zip(s1, s2):
        assert torch.equal(a, b)


def test_rebase_saturates_at_zero_like_jax():
    jp = jck.ResolverParams(**SHAPE)
    js = jck.init_state(jp)
    rng = np.random.default_rng(0)
    fields = [np.asarray(f).copy() for f in js]
    for i in (0, 1, 4, 9, 10, 11):  # the version fields
        fields[i] = rng.integers(0, 1 << 32, fields[i].shape,
                                 dtype=np.uint64).astype(np.uint32)
    js = jck.ResolverState(*(jax.numpy.asarray(f) for f in fields))
    ts = state_from_numpy(fields)
    delta = 0x90000000
    _assert_same_state(jck.rebase_state(js, delta), tck.rebase_state(ts, delta))


def test_sharded_and_partitioned_paths_raise():
    """What the steps refuse, as the JAX package refuses it: a kernel
    flag on the presharded step, a lane count the state was not built
    for, and a flat ring one batch could wrap (T*RW > KR)."""
    from foundationdb_tpu_torch.convert import shard_batch_from_numpy
    from foundationdb_tpu_torch.parallel import mesh as tpm
    from foundationdb_tpu_torch.resolver.packing import ShardRouter

    tp = tck.ResolverParams(**SHAPE)
    for bad in (dict(use_accept_kernel=True), dict(use_ring_kernel=True)):
        with pytest.raises(ValueError):
            tck.validate_presharded_params(tp._replace(**bad))
    b = _batches(0, 1, 8)[0]
    sb, _, _ = ShardRouter(tp, 2).split(
        jck.ResolveBatch(*(np.asarray(f)[None] for f in b)))
    kern = tpm.PreshardedResolverKernel(tp, 2, make_state=False)
    with pytest.raises(ValueError):  # a one-device state under 2 lanes
        kern._scan_step(tck.init_state(tp), shard_batch_from_numpy(sb))
    with pytest.raises(ValueError):
        tck.validate_params(tp._replace(ring_capacity=8))  # T*RW > KR


def test_range_max_level_matches_float_log2():
    """The integer level of _range_max equals JAX's float32 floor(log2)
    for every length a 2^14-bucket table can give."""
    n = 1 << 14
    lengths = np.arange(1, n + 1)
    want = np.floor(np.log2(lengths.astype(np.float32))).astype(np.int64)
    np.testing.assert_array_equal(
        np.array([int(x).bit_length() - 1 for x in lengths]), want)
    vals = torch.randint(0, 1 << 32, (n,), generator=torch.Generator().manual_seed(0))
    levels = tck._sparse_table(vals)
    lo = torch.randint(0, n, (500,), generator=torch.Generator().manual_seed(1))
    hi = torch.minimum(lo + torch.randint(0, 3000, (500,)), torch.tensor(n - 1))
    got = tck._range_max(levels, lo.to(torch.int32), hi.to(torch.int32))
    want_max = torch.stack([vals[a:b + 1].max() for a, b in zip(lo.tolist(),
                                                               hi.tolist())])
    assert torch.equal(got, want_max)
