"""Lexicographic compare and interval overlap on limb-encoded keys.

The dense replacement for SkipList::find's pointer-chasing key compares
(ref: fdbserver/SkipList.cpp), data-parallel over any leading batch
dimensions.

Representation: every uint32 quantity of the device step (key limbs,
hashes, version offsets) is held as an int64 tensor with zero extension.
PyTorch's CPU uint32 tensors have no ``<``, ``>>`` or max, and int64
keeps unsigned order for offsets >= 2**31 without a sign flip. Products
are masked back to 32 bits where the arithmetic wraps (``fnv_hash``).
"""

import torch

U32_MASK = 0xFFFFFFFF


def lex_lt(a, b):
    """Elementwise lexicographic a < b over the trailing limb axis.

    a, b: int64[..., W] (broadcastable). Returns bool[...]. Folded limb
    by limb with result-shaped carries, so a broadcast of a batch against
    a whole ring never materializes a [..., W]-wide intermediate.
    """
    lt = None
    eq = None
    for i in range(a.shape[-1]):
        ai, bi = a[..., i], b[..., i]
        if lt is None:
            lt = ai < bi
            eq = ai == bi
        else:
            lt = lt | (eq & (ai < bi))
            eq = eq & (ai == bi)
    return lt


def lex_le(a, b):
    return ~lex_lt(b, a)


def lex_eq(a, b):
    return torch.all(a == b, dim=-1)


def ranges_overlap(rb, re, wb, we):
    """Half-open interval overlap: [rb, re) ∩ [wb, we) != ∅.

    Empty ranges (rb >= re) never overlap anything by construction.
    """
    return lex_lt(rb, we) & lex_lt(wb, re)


def point_in(k, b, e):
    """bool: limb key k in [b, e). Broadcasting over leading dims."""
    return (~lex_lt(k, b)) & lex_lt(k, e)


def conflicts_brute(rb, re, rv, wb, we, wv, wmask):
    """Exact brute-force check of each read range against every write.

    rb, re: [Q, W] read ranges; rv: [Q] read versions; wb, we: [K, W]
    write ranges; wv: [K] commit versions; wmask: bool[K]. Returns
    bool[Q]: read q overlaps a live write newer than rv[q].
    """
    ov = ranges_overlap(rb[:, None, :], re[:, None, :], wb[None], we[None])
    newer = wv[None, :] > rv[:, None]
    return torch.any(ov & newer & wmask[None, :], dim=1)


def point_in_ranges(pk, wb, we):
    """bool[Q, K]: is point key pk[q] inside write range [wb[k], we[k))."""
    return point_in(pk[:, None, :], wb[None], we[None])


def fnv_hash(limbs):
    """FNV-1a-style 32-bit hash folded over the trailing limb axis.

    int64[..., W] holding uint32 values → int64[...] holding the uint32
    hash; bit-identical to the packer's numpy hash.
    """
    h = torch.full(limbs.shape[:-1], 2166136261, dtype=torch.int64,
                   device=limbs.device)
    for i in range(limbs.shape[-1]):
        h = ((h ^ limbs[..., i]) * 16777619) & U32_MASK
    # final avalanche (xorshift-multiply)
    h = h ^ (h >> 16)
    h = (h * 0x7FEB352D) & U32_MASK
    h = h ^ (h >> 15)
    return h


def searchsorted_limbs(sorted_keys, queries):
    """Lower-bound binary search over limb-encoded sorted keys.

    sorted_keys: [M, W] ascending; queries: [Q, W]. Returns int32[Q]:
    the first index i with sorted_keys[i] >= query.
    """
    m = sorted_keys.shape[0]
    q = queries.shape[0]
    dev = queries.device
    if m == 0:
        return torch.zeros((q,), dtype=torch.int32, device=dev)
    lo = torch.zeros((q,), dtype=torch.int64, device=dev)
    hi = torch.full((q,), m, dtype=torch.int64, device=dev)
    for _ in range(max(1, m.bit_length())):
        active = lo < hi
        mid = (lo + hi) // 2
        mid_keys = sorted_keys[mid.clamp(0, max(m - 1, 0))]
        go_right = lex_lt(mid_keys, queries) & active
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right | ~active, hi, mid)
    return lo.to(torch.int32)
