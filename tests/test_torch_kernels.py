"""The port's two kernel modules against the JAX package's Pallas kernels.

``ring_hits_plain`` is held against ``pallas_ring.ring_hits`` and
``fused_accept_plain`` against ``pallas_scan.fused_accept``, both Pallas
kernels run in interpret mode on the CPU as the JAX suite runs them. Every
output is a bit, so the tolerance is 0. Inputs come from numpy seeds, with
limbs, hashes and versions at and above 2^31.

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_gpu.py.
"""

import os
import shutil

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
from foundationdb_tpu_torch.ops.accept import (
    fused_accept,
    fused_accept_plain,
    jacobi_accept,
)
from foundationdb_tpu_torch.ops.ring import ring_hits, ring_hits_plain
from torch_ring_cases import RING_SCENARIOS, ring_scenario

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


@pytest.mark.parametrize("point_mode", [True, False])
@pytest.mark.parametrize("name", RING_SCENARIOS)
def test_ring_walk_edges_plain_matches_pallas(name, point_mode):
    """The rings tests/test_torch_gpu.py feeds the CUDA walk: the plain
    version it is held to there agrees with the Pallas kernel here."""
    case, _ = ring_scenario(name, np.random.default_rng(11))
    want = np.asarray(pallas_ring.ring_hits(
        *(jnp.asarray(a) for a in case), point_mode=point_mode,
        interpret=True))
    got = ring_hits_plain(*_tensors(case), point_mode=point_mode)
    np.testing.assert_array_equal(got.numpy(), want)


# (PR, PW, RR, RW): every lane on, each side alone, and mixed gaps
LANE_SETS = [(2, 2, 1, 1), (2, 2, 0, 0), (0, 0, 2, 2), (2, 0, 0, 1),
             (0, 2, 1, 0), (1, 1, 1, 0)]


# which txns of a batch are live: "full" draws txn_mask (90%) and a0
# (80% of those); the others are the batches the kernels skip work on:
# a live prefix of n txns, as the packers make ("prefix<n>"), live txns
# scattered over the batch, and a0 with holes in an all-live batch (too
# old or killed by history)
LIVENESS = ["prefix0", "prefix1", "prefix33", "scattered", "holes"]


def _accept_case(rng, T, PR, PW, RR, RW, W, KR, live="full"):
    """A numpy (params, state fields, batch, a0) for fused_accept. The
    slot masks of dead txns stay drawn: nothing may read them."""
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
    if live.startswith("prefix"):
        a0 = np.arange(T) < int(live[len("prefix"):])
    elif live == "scattered":
        a0 = rng.random(T) < 0.1
    elif live == "holes":
        a0 = rng.random(T) < 0.5
    if live != "full":
        batch = batch._replace(txn_mask=a0 | (live == "holes"))
    return params, jck.ResolverState(*state), batch, a0


def _port(params, state, batch, a0, device="cpu"):
    tp = tck.ResolverParams(*params[:9])
    return (state_from_numpy(state, device), batch_from_numpy(batch, device),
            tp, torch.from_numpy(a0).to(device))


@pytest.mark.parametrize("T,lanes,live", [
    pytest.param(T, lanes, "full", id=f"{T}-lanes{i}")
    for T in (8, 130) for i, lanes in enumerate(LANE_SETS)] + [
    pytest.param(130, LANE_SETS[0], live, id=f"130-lanes0-{live}")
    for live in LIVENESS])
def test_fused_accept_plain_matches_pallas(T, lanes, live):
    rng = np.random.default_rng(T * 100 + sum(lanes))
    params, state, batch, a0 = _accept_case(rng, T, *lanes, W=3, KR=150,
                                            live=live)
    if live.startswith("prefix"):
        assert a0.sum() == int(live[len("prefix"):])
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


# ── the word-blocked sweep of csrc/accept.cu, modelled in torch ──

def _pack_words(bits):
    """bool[..., T] → int64[..., NW]: bit b of word j is bits[32j + b]."""
    T = bits.shape[-1]
    nw = (T + 31) // 32
    padded = torch.zeros((*bits.shape[:-1], nw * 32), dtype=torch.int64)
    padded[..., :T] = bits.to(torch.int64)
    weights = torch.tensor([1 << b for b in range(32)], dtype=torch.int64)
    return (padded.view(*bits.shape[:-1], nw, 32) * weights).sum(-1)


def _kernel_bitset(a0, O, rng):
    """O as the sweep finds it in obits[T][NW]: exact where the pair
    kernel writes (a live writer's word of a tile that holds a live
    reader after it, on or above the diagonal), 32 random bits where it
    writes nothing, and random bits at every dead reader in all words."""
    T = a0.shape[0]
    nw = (T + 31) // 32
    obits = _pack_words(O)
    noise = torch.from_numpy(rng.integers(0, 1 << 32, (T, nw), np.int64))
    dead = _pack_words(~a0)
    rows = torch.arange(T)
    later_live = torch.zeros((T, nw), dtype=torch.bool)
    for k in range(nw):
        r = torch.arange(32 * k, min(32 * k + 32, T))
        later_live[:, k] = ((r[None, :] > rows[:, None]) & a0[r][None, :]).any(1)
    written = a0[:, None] & later_live
    written &= torch.arange(nw)[None, :] >= (rows // 32)[:, None]
    return torch.where(written, obits | (noise & dead[None, :]), noise)


def _word_blocked_accept(base, obits):
    """The order of work of accept.cu's accept_sweep_kernel. The words go
    32 at a time (a chunk; one with no candidate is skipped). In rounds,
    every word of the chunk ORs into its kill word the rows of the txns
    the last round accepted in the chunk's earlier words, then resolves
    its diagonal block against them: each row masked to the bits after
    its own, in rounds of its own, none when no candidate kills another.
    A round that changes no word ends the chunk, whose accepted rows then
    go into the later chunks' kill words. Only candidates' rows are read,
    and only from their own word on."""
    T = base.shape[0]
    nw = (T + 31) // 32
    base_w = _pack_words(base).tolist()
    kill, accw = [0] * nw, [0] * nw

    def rows_of(acc, i, k):  # OR of word k of word i's rows in acc
        x = 0
        for b in range(32):
            if acc >> b & 1:
                x |= int(obits[32 * i + b, k])
        return x

    def in_word(cand, j):
        d = [int(obits[32 * j + b, j]) & ~((2 << b) - 1) & 0xFFFFFFFF
             if cand >> b & 1 else 0 for b in range(32)]
        acc = cand
        if any(x & cand for x in d):
            while True:
                killed = 0
                for b in range(32):
                    if acc >> b & 1:
                        killed |= d[b]
                if cand & ~killed == acc:
                    break
                acc = cand & ~killed
        return acc

    for q in range(0, nw, 32):
        words = range(q, min(q + 32, nw))
        if not any(base_w[k] for k in words):
            continue
        acc = {k: 0 for k in words}
        while True:
            new = {}
            for k in words:
                x = 0
                for i in range(q, k):
                    x |= rows_of(acc[i], i, k)
                new[k] = in_word(base_w[k] & ~(kill[k] | x), k)
            if new == acc:
                break
            acc = new
        for i in words:
            accw[i] = acc[i]
            for k in range(q + 32, nw):
                kill[k] |= rows_of(acc[i], i, k)
    return torch.tensor([accw[t // 32] >> (t % 32) & 1 for t in range(T)],
                        dtype=torch.bool)


@pytest.mark.parametrize("kind", ["random", "chain", "dense"])
@pytest.mark.parametrize("T", [1, 31, 32, 33, 130, 1025])
def test_word_blocked_sweep_model_matches_jacobi(T, kind):
    """The sweep's design against the Jacobi fixpoint on strictly upper
    relations: random ones, a chain O[t, t+1] through every word border
    (every other txn accepted), and a dense high-conflict one, with a0
    holes and the bits the kernels leave unwritten set at random."""
    rng = np.random.default_rng(T * 10 + len(kind))
    if kind == "chain":
        O = np.zeros((T, T), bool)
        O[np.arange(T - 1), np.arange(1, T)] = True
        a0 = np.ones(T, bool)
        a0[rng.integers(0, T, T // 40)] = False  # a few holes break chains
    else:
        O = np.triu(rng.random((T, T)) < (0.3 if kind == "dense" else 0.01), 1)
        a0 = rng.random(T) < 0.85
    a0, O = torch.from_numpy(a0), torch.from_numpy(O)
    want = jacobi_accept(a0, O)
    got = _word_blocked_accept(a0, _kernel_bitset(a0, O, rng))
    assert torch.equal(got, want)
    if kind == "chain" and T > 32:
        assert not (want[:-1] & want[1:]).any() and int(want.sum()) > T // 3


def test_library_path_hashes_every_header(tmp_path, monkeypatch):
    """A changed or added csrc/ header names a new library, so a stale
    build is never loaded."""
    for fn in os.listdir(_kernels.CSRC_DIR):
        shutil.copy(os.path.join(_kernels.CSRC_DIR, fn), tmp_path / fn)
    monkeypatch.setattr(_kernels, "CSRC_DIR", str(tmp_path))
    paths = [{n: _kernels._so_path(n) for n in _kernels.SOURCES}]
    with open(tmp_path / "lex.cuh", "a") as f:
        f.write("\n// changed\n")
    paths.append({n: _kernels._so_path(n) for n in _kernels.SOURCES})
    (tmp_path / "extra.cuh").write_text("#pragma once\n")
    paths.append({n: _kernels._so_path(n) for n in _kernels.SOURCES})
    for n in _kernels.SOURCES:
        assert len({p[n] for p in paths}) == 3, n
