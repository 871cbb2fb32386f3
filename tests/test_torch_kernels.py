"""The port's two kernel modules against the JAX package's Pallas kernels.

``ring_hits_plain`` is held against ``pallas_ring.ring_hits`` and
``fused_accept_plain`` against ``pallas_scan.fused_accept``, both Pallas
kernels run in interpret mode on the CPU as the JAX suite runs them. Every
output is a bit, so the tolerance is 0. Inputs come from numpy seeds, with
limbs, hashes and versions at and above 2^31.

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationdb_tpu.ops import conflict as jck
from foundationdb_tpu.ops import pallas_ring, pallas_scan
from foundationdb_tpu_torch.convert import (
    batch_from_numpy,
    state_from_numpy,
    tensor_from_numpy,
)
from foundationdb_tpu_torch.ops import _kernels
from foundationdb_tpu_torch.ops import conflict as tck
from foundationdb_tpu_torch.ops.accept import fused_accept, fused_accept_plain
from foundationdb_tpu_torch.ops.ring import ring_hits, ring_hits_plain

# one intra-op thread per test process: the suite runs under pytest-xdist,
# where torch's default of a thread per core in every worker oversubscribes
# the CPU and slows the timed tests of the other workers
torch.set_num_threads(1)

ALPHABET = np.array([0, 3, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint32)
# hashes collide often, and include both sentinels of masked slots
HASHES = np.array([5, 6, 0xFFFFFFFE, 0xFFFFFFFF], np.uint32)
V0 = 0x7FFFFFF0  # versions straddle 2^31


def _keys(rng, *shape):
    return ALPHABET[rng.integers(0, len(ALPHABET), shape)]


def _ring_case(rng, Q, KR, W):
    qlo, qhi = _keys(rng, Q, W), _keys(rng, Q, W)
    rb, re = _keys(rng, KR, W), _keys(rng, KR, W)
    rv = (V0 + rng.integers(0, 30, Q)).astype(np.uint32)
    ring_v = (V0 + rng.integers(0, 30, KR)).astype(np.uint32)
    mask = rng.random(KR) < 0.8
    return qlo, qhi, rv, rb, re, ring_v, mask


def _tensors(arrays, device="cpu"):
    return [tensor_from_numpy(a, device) for a in arrays]


@pytest.mark.parametrize("point_mode", [True, False])
@pytest.mark.parametrize("Q,KR", [(77, 37), (300, 600), (1, 129)])
def test_ring_hits_plain_matches_pallas(point_mode, Q, KR):
    rng = np.random.default_rng(Q * 7 + KR)
    case = _ring_case(rng, Q, KR, W=3)
    want = np.asarray(pallas_ring.ring_hits(
        *(jnp.asarray(a) for a in case), point_mode=point_mode,
        interpret=True))
    got = ring_hits_plain(*_tensors(case), point_mode=point_mode)
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper takes the plain version for CPU tensors, uncounted
    _kernels.reset_launches()
    got_w = ring_hits(*_tensors(case), point_mode=point_mode)
    np.testing.assert_array_equal(got_w.numpy(), want)
    assert _kernels.launches["ring_hits"] == 0


# (PR, PW, RR, RW): every lane on, each side alone, and mixed gaps
LANE_SETS = [(2, 2, 1, 1), (2, 2, 0, 0), (0, 0, 2, 2), (2, 0, 0, 1),
             (0, 2, 1, 0), (1, 1, 1, 0)]


def _accept_case(rng, T, PR, PW, RR, RW, W, KR):
    """A numpy (params, state fields, batch, a0) for fused_accept."""
    params = jck.ResolverParams(
        txns=T, point_reads=PR, point_writes=PW, range_reads=RR,
        range_writes=RW, key_width=W, hash_bits=8, ring_capacity=KR,
        bucket_bits=4)
    u32 = np.uint32

    def masks(*s):
        return rng.random(s) < 0.7

    txn_mask = rng.random(T) < 0.9
    batch = jck.ResolveBatch(
        rv=(V0 + rng.integers(0, 30, T)).astype(u32), txn_mask=txn_mask,
        pr_hash=HASHES[rng.integers(0, 4, (T, PR))], pr_key=_keys(rng, T, PR, W),
        pr_bucket=np.zeros((T, PR), np.int32), pr_mask=masks(T, PR),
        pw_hash=HASHES[rng.integers(0, 4, (T, PW))], pw_key=_keys(rng, T, PW, W),
        pw_bucket=np.zeros((T, PW), np.int32), pw_mask=masks(T, PW),
        rr_b=_keys(rng, T, RR, W), rr_e=_keys(rng, T, RR, W),
        rr_lo=np.zeros((T, RR), np.int32), rr_hi=np.zeros((T, RR), np.int32),
        rr_mask=masks(T, RR),
        rw_b=_keys(rng, T, RW, W), rw_e=_keys(rng, T, RW, W),
        rw_lo=np.zeros((T, RW), np.int32), rw_hi=np.zeros((T, RW), np.int32),
        rw_mask=masks(T, RW),
        cv=u32(V0 + 40), new_window_start=u32(0),
    )
    state = [np.asarray(f) for f in jck.init_state(params)]
    state[2], state[3] = _keys(rng, KR, W), _keys(rng, KR, W)  # ring_b/e
    state[4] = (V0 + rng.integers(0, 30, KR)).astype(u32)  # ring_v
    state[7] = rng.random(KR) < 0.8  # ring_mask
    # a0 implies a live slot, as resolve_batch builds it
    a0 = (rng.random(T) < 0.8) & txn_mask
    return params, jck.ResolverState(*state), batch, a0


def _port(params, state, batch, a0, device="cpu"):
    tp = tck.ResolverParams(*params[:9])
    return (state_from_numpy(state, device), batch_from_numpy(batch, device),
            tp, torch.from_numpy(a0).to(device))


@pytest.mark.parametrize("lanes", LANE_SETS)
@pytest.mark.parametrize("T", [8, 130])
def test_fused_accept_plain_matches_pallas(T, lanes):
    rng = np.random.default_rng(T * 100 + sum(lanes))
    params, state, batch, a0 = _accept_case(rng, T, *lanes, W=3, KR=150)
    jstate = jck.ResolverState(*(jnp.asarray(f) for f in state))
    jbatch = jck.ResolveBatch(*(jnp.asarray(f) for f in batch))
    want = np.asarray(pallas_scan.fused_accept(
        jstate, jbatch, params, jnp.asarray(a0), interpret=True))
    got = fused_accept_plain(*_port(params, state, batch, a0))
    np.testing.assert_array_equal(got.numpy(), want)
    _kernels.reset_launches()
    np.testing.assert_array_equal(
        fused_accept(*_port(params, state, batch, a0)).numpy(), want)
    assert _kernels.launches["fused_accept"] == 0


@pytest.mark.parametrize("bad", ["dtype", "shape", "device", "key_width"])
def test_kernel_arg_check_rejects_what_the_kernels_do_not_take(bad):
    """The wrappers validate every tensor before a pointer reaches C."""
    keys = torch.zeros((4, 3), dtype=torch.int64)
    mask = torch.zeros((4,), dtype=torch.bool)
    args = dict(device=torch.device("cpu"), key_width=3,
                int64s={"keys": (keys, (4, 3))}, bools={"mask": (mask, (4,))})
    _kernels.check_args("case", **args)
    if bad == "dtype":
        args["int64s"] = {"keys": (keys.to(torch.int32), (4, 3))}
    elif bad == "shape":
        args["bools"] = {"mask": (mask, (5,))}
    elif bad == "device":
        args["device"] = torch.device("meta")
    else:
        args["key_width"] = _kernels.MAX_KEY_WIDTH + 1
    with pytest.raises(ValueError, match="case"):
        _kernels.check_args("case", **args)


def test_sentinel_hash_collisions_match_pallas():
    """A live write whose hash is 0xFFFFFFFE matches a masked read slot,
    and a live read hashing to 0xFFFFFFFF matches a masked write slot:
    both JAX routes carry that quirk, so the port must too."""
    rng = np.random.default_rng(5)
    T = 8
    params, state, batch, _ = _accept_case(rng, T, 2, 2, 0, 0, W=2, KR=16)
    pw_hash = np.full((T, 2), 11, np.uint32)
    pr_hash = np.full((T, 2), 12, np.uint32)
    pw_hash[0, 0] = 0xFFFFFFFE  # live write vs masked reads below
    pr_hash[5, 1] = 0xFFFFFFFF  # live read vs masked writes above
    pw_mask = np.ones((T, 2), bool)
    pw_mask[2, 1] = False
    pr_mask = np.ones((T, 2), bool)
    pr_mask[3, 0] = False
    batch = batch._replace(pw_hash=pw_hash, pr_hash=pr_hash, pw_mask=pw_mask,
                           pr_mask=pr_mask, txn_mask=np.ones(T, bool))
    a0 = np.ones(T, bool)
    jstate = jck.ResolverState(*(jnp.asarray(f) for f in state))
    jbatch = jck.ResolveBatch(*(jnp.asarray(f) for f in batch))
    want = np.asarray(pallas_scan.fused_accept(
        jstate, jbatch, params, jnp.asarray(a0), interpret=True))
    got = fused_accept_plain(*_port(params, state, batch, a0)).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[3] and not got[5]  # both quirks kill
