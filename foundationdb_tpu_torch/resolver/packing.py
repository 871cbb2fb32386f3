"""Host-side packing: TxnRequests → fixed-shape ResolveBatch arrays.

The analog of ResolveTransactionBatchRequest serialization (ref:
fdbserver/ResolverInterface.h): the commit proxy packs a batch's conflict
ranges into fixed-shape numpy arrays once per batch; all key comparison
then happens on the device.

Host hashing and bucketing must match the device (ops/intervals.fnv_hash):
the hash table and coarse buckets are written with values the host
computed.
"""

import numpy as np

from foundationdb_tpu_torch.core.keys import KeyCodec
from foundationdb_tpu_torch.ops.conflict import ResolveBatch, ResolverParams
from foundationdb_tpu_torch.resolver.skiplist import TxnRequest


def fnv_hash_np(limbs):
    """numpy twin of ops.intervals.fnv_hash. limbs: uint32[..., W]."""
    with np.errstate(over="ignore"):
        h = np.full(limbs.shape[:-1], 2166136261, dtype=np.uint32)
        for i in range(limbs.shape[-1]):
            h = (h ^ limbs[..., i]) * np.uint32(16777619)
        h = h ^ (h >> 16)
        h = h * np.uint32(0x7FEB352D)
        h = h ^ (h >> 15)
    return h


def bucket_of(limbs, bucket_bits):
    """Coarse bucket = top bits of the first limb (monotone in the key)."""
    return (limbs[..., 0] >> np.uint32(32 - bucket_bits)).astype(np.int32)


def _slots(c):
    """counts[n] → (txn index, lane index) per flattened op."""
    t_idx = np.repeat(np.arange(len(c)), c)
    starts = np.cumsum(c) - c
    i_idx = np.arange(len(t_idx)) - np.repeat(starts, c)
    return t_idx, i_idx


class BatchPacker:
    """Packs transactions for one resolver, arrival order preserved, with
    whole-batch numpy encoding (one frombuffer pass per lane)."""

    def __init__(self, params: ResolverParams):
        self.params = params
        self.codec = KeyCodec(num_limbs=params.key_width - 1)
        self._empty = None  # cached zero-txn pad batch (pack_empty)

    def pack_empty(self, base_version, commit_version, new_window_start):
        """A zero-txn pad batch (resolve_many's padding): one cached
        template, only the version scalars swapped."""
        if self._empty is None:
            self._empty = self.pack([], 0, 0, 0)
        return self._empty._replace(
            cv=np.uint32(commit_version - base_version),
            new_window_start=np.uint32(
                max(0, new_window_start - base_version)
            ),
        )

    def _normalize(self, txn):
        """Fold a txn whose op lists exceed the packed lanes: overflow
        point ops spill into the range lanes (a point op is a tiny
        range), and range overflow coalesces into a single covering
        range (conservative — can only add false conflicts)."""
        p = self.params
        preads = txn.point_reads
        pwrites = txn.point_writes
        rreads = txn.range_reads
        rwrites = txn.range_writes
        if len(preads) > p.point_reads:
            rreads = list(rreads) + [
                (k, k + b"\x00") for k in preads[p.point_reads :]
            ]
            preads = preads[: p.point_reads]
        if len(pwrites) > p.point_writes:
            rwrites = list(rwrites) + [
                (k, k + b"\x00") for k in pwrites[p.point_writes :]
            ]
            pwrites = pwrites[: p.point_writes]
        if len(rreads) > p.range_reads:
            if p.range_reads == 0:
                raise ValueError(
                    "txn has range/overflow reads but params.range_reads=0"
                )
            tail = rreads[p.range_reads - 1 :]
            rreads = list(rreads[: p.range_reads - 1]) + [
                (min(b for b, _ in tail), max(e for _, e in tail))
            ]
        if len(rwrites) > p.range_writes:
            if p.range_writes == 0:
                raise ValueError(
                    "txn has range/overflow writes but params.range_writes=0"
                )
            tail = rwrites[p.range_writes - 1 :]
            rwrites = list(rwrites[: p.range_writes - 1]) + [
                (min(b for b, _ in tail), max(e for _, e in tail))
            ]
        return TxnRequest(
            read_version=txn.read_version,
            point_reads=preads,
            point_writes=pwrites,
            range_reads=rreads,
            range_writes=rwrites,
        )

    def pack(self, txns, base_version, commit_version, new_window_start):
        """txns: list[TxnRequest], len <= params.txns → numpy ResolveBatch.

        Versions are absolute; stored as uint32 offsets from
        base_version. Oversize per-txn conflict lists spill into the
        range lanes, as the reference treats every conflict range as a
        range.
        """
        p = self.params
        if len(txns) > p.txns:
            raise ValueError(f"batch of {len(txns)} exceeds capacity {p.txns}")
        T, W = p.txns, p.key_width
        u32 = np.uint32

        rv = np.zeros(T, u32)
        txn_mask = np.zeros(T, bool)
        pr_key = np.zeros((T, p.point_reads, W), u32)
        pr_mask = np.zeros((T, p.point_reads), bool)
        pw_key = np.zeros((T, p.point_writes, W), u32)
        pw_mask = np.zeros((T, p.point_writes), bool)
        rr_b = np.zeros((T, p.range_reads, W), u32)
        rr_e = np.zeros((T, p.range_reads, W), u32)
        rr_mask = np.zeros((T, p.range_reads), bool)
        rw_b = np.zeros((T, p.range_writes, W), u32)
        rw_e = np.zeros((T, p.range_writes, W), u32)
        rw_mask = np.zeros((T, p.range_writes), bool)

        n = len(txns)
        txn_mask[:n] = True
        if n:
            rv_abs = np.fromiter(
                (t.read_version for t in txns), dtype=np.int64, count=n
            )
            rv[:n] = np.clip(rv_abs - base_version, 0, 0xFFFFFFFF).astype(u32)

        # per-txn op counts drive overflow detection (only offending
        # batches pay for normalization) and the flat slot indices
        def counts():
            return (
                np.fromiter((len(x.point_reads) for x in txns), np.int64, count=n),
                np.fromiter((len(x.point_writes) for x in txns), np.int64, count=n),
                np.fromiter((len(x.range_reads) for x in txns), np.int64, count=n),
                np.fromiter((len(x.range_writes) for x in txns), np.int64, count=n),
            )

        prc, pwc, rrc, rwc = counts()
        if (
            prc.max(initial=0) > p.point_reads
            or pwc.max(initial=0) > p.point_writes
            or rrc.max(initial=0) > p.range_reads
            or rwc.max(initial=0) > p.range_writes
        ):
            txns = [self._normalize(t) for t in txns]
            prc, pwc, rrc, rwc = counts()

        pr_t, pr_i = _slots(prc)
        pw_t, pw_i = _slots(pwc)
        rr_t, rr_i = _slots(rrc)
        rw_t, rw_i = _slots(rwc)
        pr_k = [k for x in txns for k in x.point_reads]
        pw_k = [k for x in txns for k in x.point_writes]
        rr_p = [r for x in txns for r in x.range_reads]
        rw_p = [r for x in txns for r in x.range_writes]
        rr_kb, rr_ke = (list(z) for z in zip(*rr_p)) if rr_p else ([], [])
        rw_kb, rw_ke = (list(z) for z in zip(*rw_p)) if rw_p else ([], [])

        if pr_k:
            pr_key[pr_t, pr_i] = self.codec.encode_lower_batch(pr_k)
            pr_mask[pr_t, pr_i] = True
        if pw_k:
            pw_key[pw_t, pw_i] = self.codec.encode_lower_batch(pw_k)
            pw_mask[pw_t, pw_i] = True
        if rr_kb:
            lo, hi = self.codec.encode_bounds_batch(rr_kb, rr_ke)
            rr_b[rr_t, rr_i] = lo
            rr_e[rr_t, rr_i] = hi
            rr_mask[rr_t, rr_i] = True
        if rw_kb:
            lo, hi = self.codec.encode_bounds_batch(rw_kb, rw_ke)
            rw_b[rw_t, rw_i] = lo
            rw_e[rw_t, rw_i] = hi
            rw_mask[rw_t, rw_i] = True

        return ResolveBatch(
            rv=rv,
            txn_mask=txn_mask,
            pr_hash=fnv_hash_np(pr_key),
            pr_key=pr_key,
            pr_bucket=bucket_of(pr_key, p.bucket_bits),
            pr_mask=pr_mask,
            pw_hash=fnv_hash_np(pw_key),
            pw_key=pw_key,
            pw_bucket=bucket_of(pw_key, p.bucket_bits),
            pw_mask=pw_mask,
            rr_b=rr_b,
            rr_e=rr_e,
            rr_lo=bucket_of(rr_b, p.bucket_bits),
            rr_hi=bucket_of(rr_e, p.bucket_bits),
            rr_mask=rr_mask,
            rw_b=rw_b,
            rw_e=rw_e,
            rw_lo=bucket_of(rw_b, p.bucket_bits),
            rw_hi=bucket_of(rw_e, p.bucket_bits),
            rw_mask=rw_mask,
            cv=np.uint32(commit_version - base_version),
            new_window_start=np.uint32(max(0, new_window_start - base_version)),
        )
