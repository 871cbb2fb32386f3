"""The CUDA kernels on the card, each against its plain PyTorch version.

Every case is marked ``gpu`` and asks for the ``cuda`` fixture, which
skips where no card is present: the decision is made when the test runs,
never at import. This file imports neither JAX nor the JAX package, so it
runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Outputs are bits and statuses, so the tolerance is 0.
"""

import numpy as np
import pytest
import torch

from foundationdb_tpu_torch.convert import state_to_numpy, tensor_from_numpy
from foundationdb_tpu_torch.core.options import Knobs
from foundationdb_tpu_torch.ops import _kernels
from foundationdb_tpu_torch.ops import conflict as ck
from foundationdb_tpu_torch.ops.accept import fused_accept, fused_accept_plain
from foundationdb_tpu_torch.ops.ring import ring_hits, ring_hits_plain
from foundationdb_tpu_torch.resolver.resolver import Resolver
from foundationdb_tpu_torch.workloads import STREAMS

ALPHABET = np.array([0, 3, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint32)
HASHES = np.array([5, 6, 0xFFFFFFFE, 0xFFFFFFFF], np.uint32)
V0 = 0x7FFFFFF0  # versions straddle 2^31


@pytest.fixture
def cuda():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _t(a, dev):
    return tensor_from_numpy(a, dev)


def _keys(rng, *shape):
    return ALPHABET[rng.integers(0, len(ALPHABET), shape)]


def _versions(rng, n):
    return (V0 + rng.integers(0, 30, n)).astype(np.uint32)


@pytest.mark.gpu
@pytest.mark.parametrize("point_mode", [True, False])
@pytest.mark.parametrize("Q,KR,W", [(77, 37, 3), (300, 600, 5),
                                    (4096, 4096, 9)])
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


LANE_SETS = [(2, 2, 1, 1), (2, 2, 0, 0), (0, 0, 2, 2), (2, 0, 0, 1),
             (0, 2, 1, 0), (4, 4, 2, 2)]


def _accept_case(rng, T, PR, PW, RR, RW, W, KR, dev):
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
    a0 = _t((rng.random(T) < 0.8) & txn_mask, dev)
    return state, batch, params, a0


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
