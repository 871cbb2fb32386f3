"""Host-side packing: TxnRequests or flat columnar batches → fixed-shape
ResolveBatch arrays.

The analog of ResolveTransactionBatchRequest serialization (ref:
fdbserver/ResolverInterface.h): the commit proxy packs a batch's conflict
ranges into fixed-shape numpy arrays once per batch; all key comparison
then happens on the device. Two lanes give identical arrays: ``pack``
from TxnRequest objects, and ``pack_flat`` / ``pack_flat_group`` from the
clients' pre-encoded limb blobs (core/flatpack.py) with no per-txn
Python.

Host hashing and bucketing must match the device (ops/intervals.fnv_hash):
the hash table and coarse buckets are written with values the host
computed.
"""

import numpy as np

from foundationdb_tpu_torch.core import flatpack
from foundationdb_tpu_torch.core.keys import KeyCodec
from foundationdb_tpu_torch.ops.conflict import (
    ResolveBatch,
    ResolverParams,
    ShardBatch,
)
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


def _rows_struct(rows):
    """uint32[N, W] limb rows → structured[N] whose searchsorted order
    is exactly the limb-lexicographic key order (the host twin of
    ops/intervals.lex_lt): per-field big-endian u4 fields compare
    field-by-field numerically, i.e. limb-by-limb."""
    W = rows.shape[-1]
    dt = np.dtype([("l%d" % i, ">u4") for i in range(W)])
    be = np.ascontiguousarray(rows.astype(">u4"))
    return be.view(dt).reshape(rows.shape[:-1])


class ShardRouter:
    """Key-range router for the presharded resolve (the "range" sharding
    mode of resolver/meshresolver.py), in numpy on the host before the
    batch is copied to the device.

    Consumes the stacked numpy ResolveBatch the packer already built (no
    blob re-parse, no per-key Python) and re-scatters every
    live entry into per-lane COMPACTED slot arrays (ops/conflict
    ShardBatch): point entries go to exactly ``lane(key)``; range
    entries get one slot in every lane their span touches, carrying the
    full unclipped range. All routing is vectorized — nonzero gathers,
    one searchsorted per side against the lane bounds, and a stable
    argsort-rank (the cumsum trick) to assign slots within each
    (batch, lane) group.

    Per-lane capacity ``Q`` per conflict side is sized to
    ``headroom × T·K / n`` (the balanced-split expectation plus slack);
    a batch whose skew overflows a lane retries split into ``k``
    txn-slices (verdict-equivalent: intra-batch kills become
    history-version kills of the same direction, order preserved) —
    ``reassemble`` undoes the slicing on the status matrix. A
    single-txn slice always fits because Q ≥ K per side.

    ``bounds``: uint32[n-1, W] sorted limb-row split points; lane j owns
    [bounds[j-1], bounds[j]). Defaults to the uniform first-limb split.
    """

    def __init__(self, params: ResolverParams, n, bounds=None,
                 headroom=1.75):
        self.params = params
        self.n = int(n)
        W = params.key_width
        if bounds is None:
            first = (
                (np.arange(1, self.n, dtype=np.uint64) << np.uint64(32))
                // np.uint64(self.n)
            ).astype(np.uint32)
            bounds = np.zeros((max(self.n - 1, 0), W), np.uint32)
            bounds[:, 0] = first
        self.bounds = np.ascontiguousarray(
            np.asarray(bounds, np.uint32).reshape(self.n - 1, W)
        )
        self._bounds_s = _rows_struct(self.bounds)
        T = params.txns
        self.caps = {
            "pr": self._cap(T, params.point_reads, headroom),
            "pw": self._cap(T, params.point_writes, headroom),
            "rr": self._cap(T, params.range_reads, headroom),
            "rw": self._cap(T, params.range_writes, headroom),
        }

    def _cap(self, T, K, headroom):
        """Per-lane slot capacity for a side with K entries/txn: the
        full dense width at n=1 (no routing win possible), otherwise
        the balanced-split share with headroom, floored at K (one txn's
        entries always fit → chunking terminates) and 8-rounded."""
        if not K:
            return 0
        full = T * K
        if self.n == 1:
            return full
        q = max(K, int(np.ceil(headroom * full / self.n)))
        q = -(-q // 8) * 8
        return min(q, full)

    def lane_of_points(self, rows):
        """lane index per limb row (uint32[N, W])."""
        return np.searchsorted(
            self._bounds_s, _rows_struct(rows), side="right"
        ).astype(np.int64)

    def lane_span(self, b_rows, e_rows):
        """(first, last) lane touched by each range [b, e): the last
        lane is the one containing the greatest key < e, i.e. the count
        of bounds strictly below e."""
        lo = np.searchsorted(
            self._bounds_s, _rows_struct(b_rows), side="right"
        ).astype(np.int64)
        hi = np.searchsorted(
            self._bounds_s, _rows_struct(e_rows), side="left"
        ).astype(np.int64)
        return lo, np.maximum(hi, lo)  # degenerate ranges stay 1-lane

    def split(self, stacked: ResolveBatch):
        """stacked numpy ResolveBatch [B, T, …] → (ShardBatch with
        leading dim B·k and lane axis n·Q, chunk factor k, per-lane
        entry counts[n], the lane balance)."""
        B, T = stacked.rv.shape
        k = 1
        while True:
            out = self._try_split(stacked, B, T, k)
            if out is not None:
                sb, lane_counts = out
                return sb, k, lane_counts
            k *= 2
            if k > T:
                raise ValueError(
                    "shard split cannot place a single-txn slice: "
                    f"caps {self.caps} mis-sized for T={T}"
                )

    def reassemble(self, st, k):
        """Undo txn-slice chunking on a status stack: [B·k, T] → [B, T]
        (sub-batch c carried txns [c·Ts, (c+1)·Ts) in slots [0, Ts)). A
        numpy array or a tensor."""
        if k == 1:
            return st
        T = st.shape[-1]
        Ts = -(-T // k)
        B = st.shape[0] // k
        return st.reshape(B, k, T)[:, :, :Ts].reshape(B, k * Ts)[:, :T]

    def _try_split(self, stacked, B, T, k):
        n = self.n
        Ts = -(-T // k)
        rows = B * k
        i32, u32 = np.int32, np.uint32
        W = self.params.key_width
        lane_counts = np.zeros(n, np.int64)
        bufs = {}

        sides = (
            ("pr", False, (stacked.pr_hash, stacked.pr_key,
                           stacked.pr_bucket)),
            ("pw", False, (stacked.pw_hash, stacked.pw_key,
                           stacked.pw_bucket)),
            ("rr", True, (stacked.rr_b, stacked.rr_e,
                          stacked.rr_lo, stacked.rr_hi)),
            ("rw", True, (stacked.rw_b, stacked.rw_e,
                          stacked.rw_lo, stacked.rw_hi)),
        )
        for name, is_range, srcs in sides:
            Q = self.caps[name]
            nq = n * Q
            if is_range:
                bufs[name] = {
                    "b": np.zeros((rows, nq, W), u32),
                    "e": np.zeros((rows, nq, W), u32),
                    "lo": np.zeros((rows, nq), i32),
                    "hi": np.zeros((rows, nq), i32),
                    "txn": np.zeros((rows, nq), i32),
                    "mask": np.zeros((rows, nq), np.bool_),
                }
            else:
                zh = fnv_hash_np(np.zeros((1, W), u32))[0]
                bufs[name] = {
                    "hash": np.full((rows, nq), zh, u32),
                    "key": np.zeros((rows, nq, W), u32),
                    "bucket": np.zeros((rows, nq), i32),
                    "txn": np.zeros((rows, nq), i32),
                    "mask": np.zeros((rows, nq), np.bool_),
                }
            if not Q:
                continue
            mask = getattr(stacked, name + "_mask")
            b_idx, t_idx, l_idx = np.nonzero(mask)
            if not len(b_idx):
                continue
            if is_range:
                kb = srcs[0][b_idx, t_idx, l_idx]  # [N, W]
                ke = srcs[1][b_idx, t_idx, l_idx]
                lo, hi = self.lane_span(kb, ke)
                span = hi - lo + 1
                rep = np.repeat(np.arange(len(b_idx)), span)
                off = np.arange(span.sum()) - np.repeat(
                    np.cumsum(span) - span, span
                )
                lane = lo[rep] + off
            else:
                keys = srcs[1][b_idx, t_idx, l_idx]  # [N, W]
                lane = self.lane_of_points(keys)
                rep = np.arange(len(b_idx))
            sub = t_idx[rep] // Ts
            row = b_idx[rep] * k + sub
            g = row * n + lane
            counts = np.bincount(g, minlength=rows * n)
            if counts.max(initial=0) > Q:
                return None
            lane_counts += counts.reshape(rows, n).sum(axis=0)
            order = np.argsort(g, kind="stable")
            starts = np.cumsum(counts) - counts
            rank = np.empty(len(g), np.int64)
            rank[order] = np.arange(len(g)) - starts[g[order]]
            col = lane * Q + rank
            out = bufs[name]
            out["txn"][row, col] = (t_idx[rep] % Ts).astype(i32)
            out["mask"][row, col] = True
            if is_range:
                out["b"][row, col] = kb[rep]
                out["e"][row, col] = ke[rep]
                out["lo"][row, col] = srcs[2][b_idx, t_idx, l_idx][rep]
                out["hi"][row, col] = srcs[3][b_idx, t_idx, l_idx][rep]
            else:
                out["hash"][row, col] = srcs[0][b_idx, t_idx, l_idx][rep]
                out["key"][row, col] = keys[rep]
                out["bucket"][row, col] = srcs[2][b_idx, t_idx, l_idx][rep]

        if k == 1:
            rv_out = np.ascontiguousarray(stacked.rv, u32)
            mask_out = np.ascontiguousarray(stacked.txn_mask, np.bool_)
            cv_out = np.asarray(stacked.cv, u32).reshape(B)
            nws_out = np.asarray(
                stacked.new_window_start, u32
            ).reshape(B)
        else:
            pad = k * Ts - T
            rv_out = np.zeros((rows, T), u32)
            mask_out = np.zeros((rows, T), np.bool_)
            rv_out[:, :Ts] = np.pad(
                stacked.rv, ((0, 0), (0, pad))
            ).reshape(rows, Ts)
            mask_out[:, :Ts] = np.pad(
                stacked.txn_mask, ((0, 0), (0, pad))
            ).reshape(rows, Ts)
            cv_out = np.repeat(np.asarray(stacked.cv, u32).reshape(B), k)
            # the window advance rides ONLY the last slice of each
            # batch: earlier slices of the same batch must be judged
            # under the pre-batch window, exactly as the dense kernel
            # computes too_old before applying new_window_start
            nws_out = np.zeros(rows, u32)
            nws_out[k - 1 :: k] = np.asarray(
                stacked.new_window_start, u32
            ).reshape(B)

        sb = ShardBatch(
            rv=rv_out, txn_mask=mask_out,
            pr_hash=bufs["pr"]["hash"], pr_key=bufs["pr"]["key"],
            pr_bucket=bufs["pr"]["bucket"], pr_txn=bufs["pr"]["txn"],
            pr_mask=bufs["pr"]["mask"],
            pw_hash=bufs["pw"]["hash"], pw_key=bufs["pw"]["key"],
            pw_bucket=bufs["pw"]["bucket"], pw_txn=bufs["pw"]["txn"],
            pw_mask=bufs["pw"]["mask"],
            rr_b=bufs["rr"]["b"], rr_e=bufs["rr"]["e"],
            rr_lo=bufs["rr"]["lo"], rr_hi=bufs["rr"]["hi"],
            rr_txn=bufs["rr"]["txn"], rr_mask=bufs["rr"]["mask"],
            rw_b=bufs["rw"]["b"], rw_e=bufs["rw"]["e"],
            rw_lo=bufs["rw"]["lo"], rw_hi=bufs["rw"]["hi"],
            rw_txn=bufs["rw"]["txn"], rw_mask=bufs["rw"]["mask"],
            cv=cv_out, new_window_start=nws_out,
        )
        return sb, lane_counts


class BatchPacker:
    """Packs transactions for one resolver, arrival order preserved.

    Two paths give bit-identical arrays (tests/test_torch_native.py):
      - native (the default, ``use_native=True``): one C pass over the
        txn list (native/packer.cpp), built by g++ at first use; a
        failed build raises native.NativeBuildError;
      - numpy (``use_native=False``): whole-batch frombuffer encoding,
        and the only path that spills and coalesces overflowing lanes,
        so the native pass hands such a batch (and one whose keys are
        not bytes) to it.
    The flat columnar lane (``pack_flat``, ``pack_flat_group``) is
    numpy on both, as in the reference.
    """

    def __init__(self, params: ResolverParams, use_native=True):
        self.params = params
        self.codec = KeyCodec(num_limbs=params.key_width - 1)
        self._native = None
        if use_native and params.key_width - 1 <= 16:
            from foundationdb_tpu_torch.native import load_packer

            self._native = load_packer()
        self._empty = None  # cached zero-txn pad batch (pack_empty)
        self._staging = {}  # B → the reusable staging set of that shape
        self._zero_hash = fnv_hash_np(
            np.zeros((1, params.key_width), np.uint32))[0]
        self.flat_reuse_hits = 0
        self.flat_reuse_misses = 0
        # the owning resolver's device profile counts staging reuse
        self.profile = None

    # ── flat columnar lane (core/flatpack.py FlatTxnBatch) ──
    def flat_fits(self, flat):
        """Whether pack_flat_group can serve this batch: the resolver's
        limb width and every txn's op counts inside the packed lanes
        (the legacy lane's spill/coalesce has no flat twin)."""
        p = self.params
        return (
            flat.num_limbs == p.key_width - 1
            and len(flat) <= p.txns
            and flat.prc.max(initial=0) <= p.point_reads
            and flat.pwc.max(initial=0) <= p.point_writes
            and flat.rrc.max(initial=0) <= p.range_reads
            and flat.rwc.max(initial=0) <= p.range_writes
        )

    def _flat_staging(self, B):
        """A cleared staging set of stacked (B, T, ...) arrays, one per
        shape, refilled in place (masks and keys 0, hashes the hash of an
        all-zero key row) instead of allocated. One set is enough: the
        batch is copied out (convert.BatchStager.copy_in) before the next
        pack."""
        p = self.params
        zh = self._zero_hash
        bufs = self._staging.get(B)
        if bufs is None:
            self.flat_reuse_misses += 1
            if self.profile is not None:
                self.profile.record_staging(hit=False)
            T, W = p.txns, p.key_width
            u32, i32, b8 = np.uint32, np.int32, np.bool_
            PR, PW, RR, RW = (p.point_reads, p.point_writes, p.range_reads,
                              p.range_writes)
            bufs = {
                "rv": np.zeros((B, T), u32),
                "txn_mask": np.zeros((B, T), b8),
                "pr_key": np.zeros((B, T, PR, W), u32),
                "pr_hash": np.full((B, T, PR), zh, u32),
                "pr_bucket": np.zeros((B, T, PR), i32),
                "pr_mask": np.zeros((B, T, PR), b8),
                "pw_key": np.zeros((B, T, PW, W), u32),
                "pw_hash": np.full((B, T, PW), zh, u32),
                "pw_bucket": np.zeros((B, T, PW), i32),
                "pw_mask": np.zeros((B, T, PW), b8),
                "rr_b": np.zeros((B, T, RR, W), u32),
                "rr_e": np.zeros((B, T, RR, W), u32),
                "rr_lo": np.zeros((B, T, RR), i32),
                "rr_hi": np.zeros((B, T, RR), i32),
                "rr_mask": np.zeros((B, T, RR), b8),
                "rw_b": np.zeros((B, T, RW, W), u32),
                "rw_e": np.zeros((B, T, RW, W), u32),
                "rw_lo": np.zeros((B, T, RW), i32),
                "rw_hi": np.zeros((B, T, RW), i32),
                "rw_mask": np.zeros((B, T, RW), b8),
                "cv": np.zeros(B, u32),
                "nws": np.zeros(B, u32),
            }
            self._staging[B] = bufs
            return bufs
        self.flat_reuse_hits += 1
        if self.profile is not None:
            self.profile.record_staging(hit=True)
        for name, a in bufs.items():
            if name in ("pr_hash", "pw_hash"):
                a.fill(zh)
            elif name not in ("cv", "nws"):  # fully overwritten below
                a.fill(0)
        return bufs

    def pack_flat_group(self, flats, metas, base_version, B):
        """Pack a backlog group of FlatTxnBatches into one stacked
        ResolveBatch (leading dim ``B``, padded past ``len(flats)`` with
        empty batches at the last batch's versions, like resolve_many's
        pads), equal to packing each with :meth:`pack` and stacking:
        blob bytes become limb rows with one frombuffer per lane, slot
        indices come from cumsums, hashes and buckets are computed once
        over the stacked arrays.

        ``metas``: [(commit_version, new_window_start)] per flat batch, at
        least one. Callers have checked :meth:`flat_fits` for each batch.
        """
        p = self.params
        nb = len(flats)
        bufs = self._flat_staging(B)
        u32 = np.uint32
        n_txns = np.fromiter((len(f) for f in flats), np.int64, count=nb)
        rv_all = np.concatenate([f.rv for f in flats])
        prc, pwc, rrc, rwc = (np.concatenate([getattr(f, c) for f in flats])
                              for c in ("prc", "pwc", "rrc", "rwc"))
        pr_blob, pw_blob, rr_blob, rw_blob = (
            b"".join([getattr(f, c) for f in flats])
            for c in ("pr_blob", "pw_blob", "rr_blob", "rw_blob"))
        # b_of / t_of map a group-global txn row to its (batch, txn) slot
        b_of = np.repeat(np.arange(nb), n_txns)
        _, t_of = _slots(n_txns)
        if len(rv_all):
            bufs["rv"][b_of, t_of] = np.clip(
                rv_all - base_version, 0, 0xFFFFFFFF).astype(u32)
            bufs["txn_mask"][b_of, t_of] = True
        L = p.key_width - 1
        if len(pr_blob):
            t, i = _slots(prc)
            bufs["pr_key"][b_of[t], t_of[t], i] = flatpack.point_limbs(pr_blob, L)
            bufs["pr_mask"][b_of[t], t_of[t], i] = True
        if len(pw_blob):
            t, i = _slots(pwc)
            bufs["pw_key"][b_of[t], t_of[t], i] = flatpack.point_limbs(pw_blob, L)
            bufs["pw_mask"][b_of[t], t_of[t], i] = True
        if len(rr_blob):
            t, i = _slots(rrc)
            lo, hi = flatpack.range_limbs(rr_blob, L)
            bufs["rr_b"][b_of[t], t_of[t], i] = lo
            bufs["rr_e"][b_of[t], t_of[t], i] = hi
            bufs["rr_mask"][b_of[t], t_of[t], i] = True
        if len(rw_blob):
            t, i = _slots(rwc)
            lo, hi = flatpack.range_limbs(rw_blob, L)
            bufs["rw_b"][b_of[t], t_of[t], i] = lo
            bufs["rw_e"][b_of[t], t_of[t], i] = hi
            bufs["rw_mask"][b_of[t], t_of[t], i] = True
        for b, (cv, ws) in enumerate(metas):
            bufs["cv"][b] = u32(cv - base_version)
            bufs["nws"][b] = u32(max(0, ws - base_version))
        # pads share the last batch's version scalars
        bufs["cv"][nb:] = bufs["cv"][nb - 1]
        bufs["nws"][nb:] = bufs["nws"][nb - 1]
        # hash and bucket the live batches only: pad rows already hold
        # the all-zero key's hash and bucket 0
        bb = p.bucket_bits
        bufs["pr_hash"][:nb] = fnv_hash_np(bufs["pr_key"][:nb])
        bufs["pr_bucket"][:nb] = bucket_of(bufs["pr_key"][:nb], bb)
        bufs["pw_hash"][:nb] = fnv_hash_np(bufs["pw_key"][:nb])
        bufs["pw_bucket"][:nb] = bucket_of(bufs["pw_key"][:nb], bb)
        bufs["rr_lo"][:nb] = bucket_of(bufs["rr_b"][:nb], bb)
        bufs["rr_hi"][:nb] = bucket_of(bufs["rr_e"][:nb], bb)
        bufs["rw_lo"][:nb] = bucket_of(bufs["rw_b"][:nb], bb)
        bufs["rw_hi"][:nb] = bucket_of(bufs["rw_e"][:nb], bb)
        return ResolveBatch(
            rv=bufs["rv"], txn_mask=bufs["txn_mask"],
            pr_hash=bufs["pr_hash"], pr_key=bufs["pr_key"],
            pr_bucket=bufs["pr_bucket"], pr_mask=bufs["pr_mask"],
            pw_hash=bufs["pw_hash"], pw_key=bufs["pw_key"],
            pw_bucket=bufs["pw_bucket"], pw_mask=bufs["pw_mask"],
            rr_b=bufs["rr_b"], rr_e=bufs["rr_e"],
            rr_lo=bufs["rr_lo"], rr_hi=bufs["rr_hi"], rr_mask=bufs["rr_mask"],
            rw_b=bufs["rw_b"], rw_e=bufs["rw_e"],
            rw_lo=bufs["rw_lo"], rw_hi=bufs["rw_hi"], rw_mask=bufs["rw_mask"],
            cv=bufs["cv"], new_window_start=bufs["nws"],
        )

    def pack_flat(self, flat, base_version, commit_version, new_window_start):
        """Single-batch flat pack: one group slot with the leading dim
        dropped, shaped as :meth:`pack`'s output."""
        stacked = self.pack_flat_group(
            [flat], [(commit_version, new_window_start)], base_version, B=1)
        return ResolveBatch(*(a[0] for a in stacked))

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

    def _pack_native(self, txns, base_version, commit_version,
                     new_window_start):
        """One C pass (native/packer.cpp pack_into) into fresh arrays;
        None on lane overflow (the numpy path normalizes)."""
        p = self.params
        T, W = p.txns, p.key_width
        u32, i32 = np.uint32, np.int32
        PR, PW, RR, RW = (p.point_reads, p.point_writes, p.range_reads,
                          p.range_writes)
        a = dict(
            rv=np.zeros(T, u32), txn_mask=np.zeros(T, bool),
            pr_key=np.zeros((T, PR, W), u32),
            pr_hash=np.full((T, PR), self._zero_hash, u32),
            pr_bucket=np.zeros((T, PR), i32), pr_mask=np.zeros((T, PR), bool),
            pw_key=np.zeros((T, PW, W), u32),
            pw_hash=np.full((T, PW), self._zero_hash, u32),
            pw_bucket=np.zeros((T, PW), i32), pw_mask=np.zeros((T, PW), bool),
            rr_b=np.zeros((T, RR, W), u32), rr_e=np.zeros((T, RR, W), u32),
            rr_lo=np.zeros((T, RR), i32), rr_hi=np.zeros((T, RR), i32),
            rr_mask=np.zeros((T, RR), bool),
            rw_b=np.zeros((T, RW, W), u32), rw_e=np.zeros((T, RW, W), u32),
            rw_lo=np.zeros((T, RW), i32), rw_hi=np.zeros((T, RW), i32),
            rw_mask=np.zeros((T, RW), bool),
        )
        # pack_into's argument order (native/packer.cpp's contract)
        if self._native.pack_into(txns, base_version, (PR, PW, RR, RW),
                                  W - 1, p.bucket_bits, tuple(a.values())):
            return None
        return ResolveBatch(
            **a, cv=np.uint32(commit_version - base_version),
            new_window_start=np.uint32(
                max(0, new_window_start - base_version)))

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
        if self._native is not None and isinstance(txns, list):
            try:
                batch = self._pack_native(txns, base_version, commit_version,
                                          new_window_start)
            except TypeError:
                batch = None  # e.g. bytearray keys: the numpy path takes them
            if batch is not None:
                return batch
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
