"""The yardstick of the kernels' rooflines: the published peaks of one
NVIDIA H100 and the frozen counts of the bytes and integer operations a
kernel's call needs on its inputs.

The counts are copies of those the repository's chip smoke run used
(``io_bytes``, ``bound_ms``, ``lex_depth``, ``ring_ops``,
``accept_ops``, ``sweep_cost``), held here so that no later change to
the program moves them. A share of the roofline is the least time the
card could take (the larger of bytes over peak bandwidth and operations
over peak rate) over the kernel's measured time.
"""

import shutil
import subprocess

import numpy as np
import torch

# NVIDIA H100 SXM data sheet, at its full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
# no integer peak is published for the CUDA cores; the non-tensor
# float32 rate is the fastest rate any 32-bit scalar op could retire at,
# so dividing by it keeps the bound a lower bound
SCALAR_OPS_PER_S = 67e12
PEAK_POWER_W = 700.0


def power_limit_w():
    """The card's power limit in watts, as nvidia-smi reads it, or None."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    try:
        out = subprocess.run(
            [smi, "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.split()[0])
    except (subprocess.SubprocessError, ValueError, IndexError):
        return None


def io_bytes(*ts):
    """Bytes the function must move for these tensors, each once: a limb,
    hash or version is a uint32 quantity (4 bytes; the port holds them
    zero-extended in int64, which the bound does not charge), a mask or
    an output bit one byte."""
    return sum(t.numel() * (1 if t.dtype == torch.bool else 4) for t in ts)


def bound_ms(nb, ops):
    t_bytes = nb / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def lex_lt(a, b):
    """Elementwise lexicographic a < b over the trailing limb axis."""
    lt = eq = None
    for i in range(a.shape[-1]):
        ai, bi = a[..., i], b[..., i]
        if lt is None:
            lt, eq = ai < bi, ai == bi
        else:
            lt = lt | (eq & (ai < bi))
            eq = eq & (ai == bi)
    return lt


def lex_depth(a, b):
    """Limbs a lexicographic compare of a and b reads: up to and
    including the first that differs."""
    prefix = torch.cumprod((a == b).to(torch.int64), dim=-1).sum(-1)
    return torch.clamp(prefix + 1, max=a.shape[-1])


def ring_ops(qlo, qhi, rv, active, rb, re, ring_v, ring_m, point):
    """Integer ops the ring walk needs on these inputs: a live/newer test
    per (query, entry) pair up to the query's first hit, and for live
    newer entries the limb compares the two bounds need (the second
    only when the first passes)."""
    KR = ring_v.shape[0]
    total = 0
    idx = torch.arange(KR, device=qlo.device)
    for c in range(0, qlo.shape[0], 256):
        lo, hi = qlo[c:c + 256, None], qhi[c:c + 256, None]
        ln = ring_m[None] & (ring_v[None] > rv[c:c + 256, None])
        if point:
            first = ~lex_lt(lo, rb[None])
            d = lex_depth(lo, rb[None]) + first * lex_depth(lo, re[None])
            ov = first & lex_lt(lo, re[None])
        else:
            first = lex_lt(lo, re[None])
            d = lex_depth(lo, re[None]) + first * lex_depth(hi, rb[None])
            ov = first & lex_lt(rb[None], hi)
        hit = ov & ln
        stop = torch.where(hit.any(1), hit.to(torch.int8).argmax(1), KR - 1)
        walked = (idx[None] <= stop[:, None]) & active[c:c + 256, None]
        total += int((walked * (2 + d * ln)).sum())
    return total


def accept_ops(state, batch, a0):
    """Integer ops of the accept step on these inputs, for the admissible
    txns (a0) only, as no other txn can change an accepted bit: the ring
    walk of their live read slots, the pair tiles (every pair w < r of
    them, every hash pair, and the limb compares of every live slot pair
    of the interval lanes) and one test per txn for the sweep."""
    T = a0.shape[0]
    W = batch.pr_key.shape[-1]
    ring = (state.ring_b, state.ring_e, state.ring_v, state.ring_mask)
    PR, PW = batch.pr_key.shape[1], batch.pw_key.shape[1]
    RR, RW = batch.rr_b.shape[1], batch.rw_b.shape[1]
    rvq = batch.rv[:, None]
    ops = ring_ops(batch.pr_key.reshape(-1, W), batch.pr_key.reshape(-1, W),
                   rvq.expand(T, PR).reshape(-1),
                   (batch.pr_mask & a0[:, None]).reshape(-1), *ring,
                   point=True)
    ops += ring_ops(batch.rr_b.reshape(-1, W), batch.rr_e.reshape(-1, W),
                    rvq.expand(T, RR).reshape(-1),
                    (batch.rr_mask & a0[:, None]).reshape(-1), *ring,
                    point=False)
    upper = torch.ones((T, T), dtype=torch.bool, device=batch.rv.device).triu(1)
    upper &= a0[:, None] & a0[None, :]
    ops += int(upper.sum()) * PW * PR
    lanes = []  # (writer keys lo/hi, writer mask, reader lo/hi, reader mask)
    for s1 in range(PW):
        for s2 in range(RR):
            lanes.append((batch.pw_key[:, s1], batch.pw_key[:, s1],
                          batch.pw_mask[:, s1], batch.rr_b[:, s2],
                          batch.rr_e[:, s2], batch.rr_mask[:, s2]))
    for s1 in range(RW):
        for s2 in range(PR):
            lanes.append((batch.rw_b[:, s1], batch.rw_e[:, s1],
                          batch.rw_mask[:, s1], batch.pr_key[:, s2],
                          batch.pr_key[:, s2], batch.pr_mask[:, s2]))
        for s2 in range(RR):
            lanes.append((batch.rw_b[:, s1], batch.rw_e[:, s1],
                          batch.rw_mask[:, s1], batch.rr_b[:, s2],
                          batch.rr_e[:, s2], batch.rr_mask[:, s2]))
    for wlo, whi, wm, rlo, rhi, rm in lanes:
        live = upper & wm[:, None] & rm[None, :]
        d = lex_depth(wlo[:, None], rlo[None]) + lex_depth(whi[:, None],
                                                           rhi[None])
        ops += int((d * live).sum())
    return ops + T


def accept_bytes(state, b, a0):
    """The tensors fdb_fused_accept reads, and the accepted bits."""
    return io_bytes(a0, b.rv, b.pw_hash, b.pw_mask, b.pw_key, b.pr_hash,
                    b.pr_mask, b.pr_key, b.rr_b, b.rr_e, b.rr_mask, b.rw_b,
                    b.rw_e, b.rw_mask, state.ring_b, state.ring_e,
                    state.ring_v, state.ring_mask) + a0.shape[0]


def sweep_cost(T, accepted):
    """accept_sweep's bytes (a0 and O read once, the accepted bits
    written) and ops (one ballot word per 32 pairs, one candidate test
    per txn, and a word OR per accepted row per word), for T txns of
    which ``accepted`` were accepted."""
    nw = (T + 31) // 32
    return T + T * T + T, T * nw + T + accepted * nw


class Batch:
    """The tensors of one batch that the counts read, in the packed
    layout's shapes: txn t's k-th op of a side in slot k, keys as limb
    rows, read versions as offsets from ``base``."""

    def __init__(self, blobs, counts, rv, base, params, device):
        T, W = params["txns"], params["key_limbs"] + 1

        def slots(name, width, per_entry):
            keys = np.zeros((T, width, per_entry, W), dtype=np.int64)
            mask = np.zeros((T, width), dtype=bool)
            n = counts[name]
            if blobs[name]:
                limbs = np.frombuffer(blobs[name], dtype=">u4").astype(
                    np.int64).reshape(-1, per_entry, W)
                txn = np.repeat(np.arange(len(n)), n)
                slot = np.arange(len(txn)) - np.repeat(np.cumsum(n) - n, n)
                keys[txn, slot] = limbs
                mask[txn, slot] = True
            return (torch.from_numpy(keys).to(device),
                    torch.from_numpy(mask).to(device))

        dev = device
        self.rv = torch.from_numpy(np.asarray(rv, np.int64) - base).to(dev)
        self.txn_mask = torch.ones(T, dtype=torch.bool, device=dev)
        k, self.pr_mask = slots("pr", params["point_reads"], 1)
        self.pr_key = k[:, :, 0]
        k, self.pw_mask = slots("pw", params["point_writes"], 1)
        self.pw_key = k[:, :, 0]
        self.pr_hash = torch.zeros(self.pr_mask.shape, dtype=torch.int64,
                                   device=dev)
        self.pw_hash = torch.zeros(self.pw_mask.shape, dtype=torch.int64,
                                   device=dev)
        k, self.rr_mask = slots("rr", params["range_reads"], 2)
        self.rr_b, self.rr_e = k[:, :, 0], k[:, :, 1]
        k, self.rw_mask = slots("rw", params["range_writes"], 2)
        self.rw_b, self.rw_e = k[:, :, 0], k[:, :, 1]


def share_pct(samples, kernel_ms):
    """A kernel's share of its roofline, in %: the mean least time of the
    sampled calls over the measured time per call."""
    if not samples or not kernel_ms:
        return None
    least = float(np.mean([bound_ms(nb, ops)[0] for nb, ops in samples]))
    return 100.0 * least / kernel_ms
