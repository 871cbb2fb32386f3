"""The presharded step's intra-batch conflict relation over its lanes.

``resolve_batch_presharded`` (ops/conflict.py) holds each lane's
entries in compacted slot arrays per conflict side, viewed ``[n, Q,
...]`` (parallel/mesh.py ``lane_view``), each slot naming its txn.
:func:`lane_pairs` gives O[w, r] (bool[T, T]): some lane holds a write
slot of txn w and a read slot of txn r that meet, over the four
relations (point write x point read by hash, point write in range read,
point read in range write, range write meets range read), with w < r
and both txns live. For CUDA tensors it launches csrc/lanes.cu's
``lane_pairs_kernel``, which marks only the pairs of live slots; for CPU
tensors it runs :func:`lane_pairs_plain`, the JAX package's scatter-add
of pair counts. It never falls back from the kernel to the plain
version.
"""

import torch

from foundationdb_tpu_torch.ops import _kernels
from foundationdb_tpu_torch.ops.accept import READ_SENTINEL, WRITE_SENTINEL
from foundationdb_tpu_torch.ops.intervals import point_in, ranges_overlap


def lane_pairs_plain(sb, T):
    """The plain PyTorch version: int32 pair counts by ``index_add_``
    over every lane's [Qw, Qr] slot pairs, live or padding (padding
    slots point at txn 0 with mask False and add zero), then > 0."""
    dev = sb.rv.device
    Qpr, Qpw = sb.pr_txn.shape[1], sb.pw_txn.shape[1]
    Qrr, Qrw = sb.rr_txn.shape[1], sb.rw_txn.shape[1]
    # O[t1, t2] counts (write txn, read txn) pairs over every lane; a
    # spanning write and a spanning read seen on two lanes add twice
    # before the > 0 threshold
    O_i = torch.zeros((T * T,), dtype=torch.int32, device=dev)

    def pairs(w_txn, r_txn, val):  # val: bool[n, Qw, Qr]
        idx = (w_txn.to(torch.int64)[:, :, None] * T
               + r_txn.to(torch.int64)[:, None, :])
        O_i.index_add_(0, idx.reshape(-1), val.reshape(-1).to(torch.int32))

    if Qpw and Qpr:
        wh = torch.where(sb.pw_mask, sb.pw_hash, WRITE_SENTINEL)
        rh = torch.where(sb.pr_mask, sb.pr_hash, READ_SENTINEL)
        pairs(sb.pw_txn, sb.pr_txn, wh[:, :, None] == rh[:, None, :])
    if Qpw and Qrr:
        inr = point_in(sb.pw_key[:, :, None, :], sb.rr_b[:, None],
                       sb.rr_e[:, None])  # [n, Qpw, Qrr]
        pairs(sb.pw_txn, sb.rr_txn,
              inr & sb.pw_mask[:, :, None] & sb.rr_mask[:, None, :])
    if Qrw and Qpr:
        inr = point_in(sb.pr_key[:, None], sb.rw_b[:, :, None, :],
                       sb.rw_e[:, :, None, :])  # [n, Qrw, Qpr]
        pairs(sb.rw_txn, sb.pr_txn,
              inr & sb.rw_mask[:, :, None] & sb.pr_mask[:, None, :])
    if Qrw and Qrr:
        ov = ranges_overlap(sb.rr_b[:, None], sb.rr_e[:, None],
                            sb.rw_b[:, :, None, :], sb.rw_e[:, :, None, :])
        pairs(sb.rw_txn, sb.rr_txn,
              ov & sb.rw_mask[:, :, None] & sb.rr_mask[:, None, :])

    upper = torch.ones((T, T), dtype=torch.bool, device=dev).triu(1)
    return ((O_i.view(T, T) > 0) & upper & sb.txn_mask[:, None]
            & sb.txn_mask[None, :])


def lane_pairs(sb, T):
    """bool[T, T] O[w, r] of the lanes of ``sb`` (a ShardBatch viewed
    [n, Q, ...]; see the module doc)."""
    dev = sb.rv.device
    if dev.type == "cpu":
        return lane_pairs_plain(sb, T)
    n = sb.pr_txn.shape[0]
    W = sb.pr_key.shape[2]
    Qpr, Qpw = sb.pr_txn.shape[1], sb.pw_txn.shape[1]
    Qrr, Qrw = sb.rr_txn.shape[1], sb.rw_txn.shape[1]
    _kernels.check_args(
        "lane_pairs", dev, W,
        {"pw_hash": (sb.pw_hash, (n, Qpw)), "pw_key": (sb.pw_key, (n, Qpw, W)),
         "pr_hash": (sb.pr_hash, (n, Qpr)), "pr_key": (sb.pr_key, (n, Qpr, W)),
         "rr_b": (sb.rr_b, (n, Qrr, W)), "rr_e": (sb.rr_e, (n, Qrr, W)),
         "rw_b": (sb.rw_b, (n, Qrw, W)), "rw_e": (sb.rw_e, (n, Qrw, W))},
        {"txn_mask": (sb.txn_mask, (T,)), "pw_mask": (sb.pw_mask, (n, Qpw)),
         "pr_mask": (sb.pr_mask, (n, Qpr)), "rr_mask": (sb.rr_mask, (n, Qrr)),
         "rw_mask": (sb.rw_mask, (n, Qrw))},
        {"pw_txn": (sb.pw_txn, (n, Qpw)), "pr_txn": (sb.pr_txn, (n, Qpr)),
         "rr_txn": (sb.rr_txn, (n, Qrr)), "rw_txn": (sb.rw_txn, (n, Qrw))})
    args = [t.contiguous() for t in (
        sb.txn_mask, sb.pw_hash, sb.pw_key, sb.pw_txn, sb.pw_mask,
        sb.pr_hash, sb.pr_key, sb.pr_txn, sb.pr_mask,
        sb.rr_b, sb.rr_e, sb.rr_txn, sb.rr_mask,
        sb.rw_b, sb.rw_e, sb.rw_txn, sb.rw_mask,
    )]
    O = torch.zeros((T, T), dtype=torch.bool, device=dev)
    lib = _kernels.lib("lanes")
    with torch.cuda.device(dev):
        rc = lib.fdb_lane_pairs(*[t.data_ptr() for t in args], n, T, Qpw,
                                Qpr, Qrr, Qrw, W, O.data_ptr(),
                                _kernels.stream_of(O))
    _kernels.check(rc, "lane_pairs kernel launch")
    _kernels.count("lane_pairs")
    return O
