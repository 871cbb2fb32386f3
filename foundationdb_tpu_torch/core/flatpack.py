"""Flat columnar conflict-range encoding — the commit path's packing
format.

The client encodes its conflict ranges once, into the exact bytes every
later layer consumes:

    entry(k)  = k padded to C=4*L bytes with \\x00  ||  >I(len(k))

which is the resolver's limb encoding (core/keys.py KeyCodec):
``np.frombuffer(entry, '>u4')`` IS ``encode_lower(k)``. For in-capacity
keys ``encode_upper`` agrees with ``encode_lower``, so a range packs as
``entry(begin) || entry(end)``, and a point key ``[k, k+\\x00)`` stores
only ``entry(k)`` (the point lanes hold only the lower encoding).

Per transaction the client ships four blobs (read/write × point/range)
and their counts; the proxy joins the blobs across a batch and derives
every offset from cumsums, with no per-key work. Keys longer than C
bytes do not flatten: such a transaction takes the legacy path.

The port's copy of ``foundationdb_tpu/core/flatpack.py``; its blobs are
byte-identical to the JAX package's.
"""

import struct
from typing import NamedTuple

import numpy as np

from foundationdb_tpu_torch.resolver.skiplist import TxnRequest

_U32 = struct.Struct(">I")

# per-num_limbs encode tables: (zero padding, length words 0..C)
_ENC_TABS = {}


def _tabs(num_limbs):
    t = _ENC_TABS.get(num_limbs)
    if t is None:
        cap = 4 * num_limbs
        t = (b"\x00" * cap, [_U32.pack(n) for n in range(cap + 1)])
        _ENC_TABS[num_limbs] = t
    return t


def entry_width(num_limbs):
    """Bytes per encoded key entry: C key bytes + the 4-byte length."""
    return 4 * num_limbs + 4


class FlatConflicts(NamedTuple):
    """One transaction's conflict ranges, pre-encoded by the client.

    ``*_points`` count point keys, each one ``entry_width`` bytes in its
    blob; ``*_ranges`` count true ranges, each ``2 * entry_width`` bytes
    (lower || upper)."""

    num_limbs: int
    read_points: int
    read_point_blob: bytes
    read_ranges: int
    read_range_blob: bytes
    write_points: int
    write_point_blob: bytes
    write_ranges: int
    write_range_blob: bytes


def encode_entry(key, num_limbs):
    """``entry(key)``, or None when the key exceeds limb capacity."""
    pad, lens = _tabs(num_limbs)
    n = len(key)
    if n > 4 * num_limbs:
        return None
    return key + pad[n:] + lens[n]


def _encode_side(ranges, num_limbs, pad, lens):
    """One side's (points, point_blob, ranges, range_blob), or None on
    an over-capacity key. A point is ``[k, k+\\x00)``."""
    cap = 4 * num_limbs
    pts = []
    rgs = []
    for b, e in ranges:
        nb = len(b)
        if len(e) == nb + 1 and e[-1] == 0 and e.startswith(b):
            # a point stores only its begin entry, so only the key must fit
            if nb > cap:
                return None
            pts.append(b + pad[nb:] + lens[nb])
        else:
            if nb > cap or len(e) > cap:
                return None
            rgs.append(b + pad[nb:] + lens[nb])
            ne = len(e)
            rgs.append(e + pad[ne:] + lens[ne])
    return len(pts), b"".join(pts), len(rgs) // 2, b"".join(rgs)


def encode_conflicts(read_ranges, write_ranges, num_limbs):
    """A transaction's conflict ranges → FlatConflicts, or None when any
    key exceeds the 4*num_limbs-byte limb capacity."""
    pad, lens = _tabs(num_limbs)
    r = _encode_side(read_ranges, num_limbs, pad, lens)
    if r is None:
        return None
    w = _encode_side(write_ranges, num_limbs, pad, lens)
    if w is None:
        return None
    return FlatConflicts(num_limbs, *r, *w)


def point_limbs(blob, num_limbs):
    """uint32[n_entries, W] limb rows: one frombuffer pass, which is
    KeyCodec.encode_lower_batch's output."""
    W = num_limbs + 1
    if not blob:
        return np.zeros((0, W), dtype=np.uint32)
    return np.frombuffer(blob, dtype=">u4").reshape(-1, W).astype(np.uint32)


def range_limbs(blob, num_limbs):
    """(lower uint32[n, W], upper uint32[n, W]) limb rows."""
    W = num_limbs + 1
    if not blob:
        z = np.zeros((0, W), dtype=np.uint32)
        return z, z
    a = np.frombuffer(blob, dtype=">u4").reshape(-1, 2, W).astype(np.uint32)
    return a[:, 0], a[:, 1]


def _decode_entries(blob, num_limbs):
    """entry blob → list[bytes] raw keys (exact: in-capacity only)."""
    w = entry_width(num_limbs)
    if not blob:
        return []
    lens = np.frombuffer(blob, dtype=">u4").reshape(-1, num_limbs + 1)[:, -1]
    return [blob[o: o + n]
            for o, n in zip(range(0, len(blob), w), lens.tolist())]


def decode_side(point_blob, range_blob, num_limbs):
    """``[(begin, end)]`` from one side's blobs (points as
    ``[k, k+\\x00)``)."""
    out = [(k, k + b"\x00") for k in _decode_entries(point_blob, num_limbs)]
    ks = _decode_entries(range_blob, num_limbs)
    out.extend(zip(ks[0::2], ks[1::2]))
    return out


class FlatTxnBatch:
    """One commit batch, columnar: per-txn counts + the batch's joined
    entry blobs. BatchPacker.pack_flat_group consumes it directly; the
    rare batch the flat lane cannot serve decodes to TxnRequests."""

    __slots__ = ("num_limbs", "rv", "prc", "pwc", "rrc", "rwc",
                 "pr_blob", "pw_blob", "rr_blob", "rw_blob", "_txn_memo")

    def __init__(self, num_limbs, rv, prc, pwc, rrc, rwc,
                 pr_blob, pw_blob, rr_blob, rw_blob):
        self._txn_memo = {}  # i -> decoded TxnRequest (see __getitem__)
        self.num_limbs = num_limbs
        self.rv = rv  # int64[n] absolute read versions
        self.prc = prc  # int64[n] point-read counts
        self.pwc = pwc
        self.rrc = rrc  # int64[n] range-read counts
        self.rwc = rwc
        self.pr_blob = pr_blob
        self.pw_blob = pw_blob
        self.rr_blob = rr_blob
        self.rw_blob = rw_blob

    def __len__(self):
        return len(self.rv)

    def __getitem__(self, i):
        """Txn ``i`` as a TxnRequest (decoded once, then memoized)."""
        memo = self._txn_memo.get(i)
        if memo is not None:
            return memo
        W4 = entry_width(self.num_limbs)
        po = (int(self.prc[:i].sum()), int(self.pwc[:i].sum()))
        ro = (int(self.rrc[:i].sum()), int(self.rwc[:i].sum()))
        pr = _decode_entries(
            self.pr_blob[po[0] * W4: (po[0] + int(self.prc[i])) * W4],
            self.num_limbs)
        pw = _decode_entries(
            self.pw_blob[po[1] * W4: (po[1] + int(self.pwc[i])) * W4],
            self.num_limbs)
        rr = decode_side(
            b"", self.rr_blob[ro[0] * 2 * W4: (ro[0] + int(self.rrc[i])) * 2 * W4],
            self.num_limbs)
        rw = decode_side(
            b"", self.rw_blob[ro[1] * 2 * W4: (ro[1] + int(self.rwc[i])) * 2 * W4],
            self.num_limbs)
        out = self._txn_memo[i] = TxnRequest(
            read_version=int(self.rv[i]),
            point_reads=pr, point_writes=pw,
            range_reads=rr, range_writes=rw,
        )
        return out

    def to_txn_requests(self):
        """The whole batch as legacy TxnRequests (per-key Python: for the
        batches the flat lane cannot serve)."""
        return [self[i] for i in range(len(self))]


def build_flat_batch(requests, num_limbs, idmp_key_of=None):
    """Join a request batch's FlatConflicts into one FlatTxnBatch — the
    proxy's flat twin of its legacy build. None when any request lacks a
    FlatConflicts of this width (the caller takes the legacy build).
    ``idmp_key_of(request)`` names the idempotency row an id-carrying
    request conflicts on (or None): its point entry joins both sides."""
    n = len(requests)
    if n == 0:
        z = np.zeros(0, dtype=np.int64)
        return FlatTxnBatch(num_limbs, z, z, z, z, z, b"", b"", b"", b"")
    fcs = [r.flat_conflicts for r in requests]
    if None in fcs:
        return None
    if idmp_key_of is not None and any(r.idempotency_id is not None
                                       for r in requests):
        return _build_with_ids(requests, num_limbs, idmp_key_of)
    (nls, rps, rpbs, rrs, rrbs, wps, wpbs, wrs, wrbs) = zip(*fcs)
    if any(nl != num_limbs for nl in nls):
        return None
    rv = np.fromiter((r.read_version for r in requests), dtype=np.int64,
                     count=n)
    return FlatTxnBatch(
        num_limbs, rv,
        np.fromiter(rps, np.int64, count=n),
        np.fromiter(wps, np.int64, count=n),
        np.fromiter(rrs, np.int64, count=n),
        np.fromiter(wrs, np.int64, count=n),
        b"".join(rpbs), b"".join(wpbs),
        b"".join(rrbs), b"".join(wrbs),
    )


def _build_with_ids(requests, num_limbs, idmp_key_of):
    """build_flat_batch for a batch carrying idempotency ids: each id's
    row entry appended to its request's read and write points."""
    n = len(requests)
    counts = np.empty((5, n), dtype=np.int64)  # rp, wp, rr, wr, rv
    rp, wp, rr, wr = [], [], [], []
    for i, r in enumerate(requests):
        f = r.flat_conflicts
        if f.num_limbs != num_limbs:
            return None
        ik = idmp_key_of(r)
        e = b"" if ik is None else encode_entry(ik, num_limbs)
        if e is None:
            return None  # an over-capacity id key: the legacy build
        extra = 1 if e else 0
        counts[:, i] = (f.read_points + extra, f.write_points + extra,
                        f.read_ranges, f.write_ranges, r.read_version)
        rp.append(f.read_point_blob + e)
        wp.append(f.write_point_blob + e)
        rr.append(f.read_range_blob)
        wr.append(f.write_range_blob)
    return FlatTxnBatch(num_limbs, counts[4], counts[0], counts[1],
                        counts[2], counts[3], b"".join(rp), b"".join(wp),
                        b"".join(rr), b"".join(wr))
