"""Inputs of ring_hits shared by the card tests (tests/test_torch_gpu.py)
and the CPU tests that hold the plain version to Pallas
(tests/test_torch_kernels.py): limbs and versions that straddle 2^31, and
rings that reach the CUDA ring walk's edges."""

import numpy as np

ALPHABET = np.array([0, 3, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint32)
V0 = 0x7FFFFFF0  # versions straddle 2^31


def keys(rng, *shape):
    return ALPHABET[rng.integers(0, len(ALPHABET), shape)]


def versions(rng, n):
    return (V0 + rng.integers(0, 30, n)).astype(np.uint32)


def ring_scenario(name, rng, Q=300, KR=785, W=5):
    """Rings that reach the ring walk's edges: (numpy inputs of
    ring_hits, the hits expected or None to take the plain version's)."""
    qlo, qhi, rv = keys(rng, Q, W), keys(rng, Q, W), versions(rng, Q)
    rb, re = keys(rng, KR, W), keys(rng, KR, W)
    ring_v, mask = versions(rng, KR), rng.random(KR) < 0.8
    want = None
    if name == "no live entry":
        mask[:] = False
        want = np.zeros(Q, bool)
    elif name == "all older than every rv":
        rv = rv + 100
        want = np.zeros(Q, bool)
    elif name == "all hit in the first tile":
        # entry 0 spans every key the queries hold
        qlo, qhi = ALPHABET[1 + rng.integers(0, 3, (2, Q, W))]
        rb[0], re[0], ring_v[0], mask[0] = 0, 0xFFFFFFFF, 0xFFFFFFFF, True
        want = np.ones(Q, bool)
    elif name == "one hit in the last entry":
        # disjoint queries [q.0.., q.1.0..); the last entry of the last,
        # partial tile is [t.0.., t.0..1) and the only one newer than rv
        qlo, qhi = np.zeros((2, Q, W), np.uint32)
        qlo[:, 0] = qhi[:, 0] = np.arange(Q)
        qhi[:, 1] = 1
        t = Q // 2
        ring_v = rng.permutation(ring_v - 100)
        rb[-1], re[-1] = 0, 0
        rb[-1, 0] = re[-1, 0] = t
        re[-1, -1] = 1
        ring_v[-1], mask[-1] = rv.max() + 1, True
        want = np.arange(Q) == t
    elif name == "non-monotone across 2^31":
        ring_v = rng.permutation(
            np.arange(0x7FFFFF00, 0x7FFFFF00 + KR, dtype=np.uint32))
        rv = (0x7FFFFF00 + rng.integers(0, KR, Q)).astype(np.uint32)
    return (qlo, qhi, rv, rb, re, ring_v, mask), want


RING_SCENARIOS = ["no live entry", "all older than every rv",
                  "all hit in the first tile", "one hit in the last entry",
                  "non-monotone across 2^31"]


# Lane rings (ring_hits_lanes): first limbs spread around 2^31, so a
# query meets a few entries of a full ring and misses the rest
FIRST0 = 0x7FFFFE00
LANE_RINGS = ["empty", "40% full", "wrapped", "read versions filter",
              "lanes differ"]


def _lane_keys(rng, n, N, W, span):
    k = keys(rng, n, N, W)
    k[..., 0] = FIRST0 + rng.integers(0, span, (n, N))
    return k


def lane_ring_case(name, rng, n, Q, KR, W):
    """Inputs of ring_hits_lanes (numpy: qlo, qhi [n, Q, W], rv [n, Q],
    ring_b, ring_e [n, KR, W], ring_v, ring_mask [n, KR]) for n lanes
    whose rings are in state ``name``:

    - "empty": a fresh ring, every entry zero and masked;
    - "40% full": the first 40% of each lane's entries written, in
      version order, the rest fresh;
    - "wrapped": every entry live, versions rising from a head that
      differs by lane, so they fall where the head wrapped;
    - "read versions filter": as "wrapped", with read versions among the
      ring's, so each query sees only the live entries newer than it;
    - "lanes differ": lane j filled to j / (n - 1) of KR (lane 0 empty,
      the last full; 40% with one lane).

    Queries are [qlo, qhi) with qhi up to 8 first-limb steps past qlo
    (empty where qhi <= qlo); a ring entry spans up to 3."""
    span = 2 * KR
    qlo = _lane_keys(rng, n, Q, W, span)
    qhi = qlo.copy()
    qhi[..., 0] += rng.integers(0, 9, (n, Q)).astype(np.uint32)
    qhi[..., 1:] = keys(rng, n, Q, W - 1)
    rb = _lane_keys(rng, n, KR, W, span)
    re = rb.copy()
    re[..., 0] += rng.integers(0, 4, (n, KR)).astype(np.uint32)
    re[..., 1:] = keys(rng, n, KR, W - 1)
    # an entry's version: one a batch of 8 writes, from the lane's head on
    age = np.arange(KR)[None, :] - rng.integers(0, KR, (n, 1))
    ring_v = (V0 + 1 + (age % KR) // 8).astype(np.uint32)
    rv = (V0 - rng.integers(0, 30, (n, Q))).astype(np.uint32)
    fill = np.full(n, KR)
    if name == "empty":
        fill[:] = 0
    elif name == "40% full":
        fill[:] = int(0.4 * KR)
        ring_v = np.broadcast_to(
            (V0 + 1 + np.arange(KR) // 8).astype(np.uint32), (n, KR)).copy()
    elif name == "read versions filter":
        rv = (V0 + rng.integers(0, KR // 8 + 1, (n, Q))).astype(np.uint32)
    elif name == "lanes differ":
        fill = (np.arange(n) * KR // max(n - 1, 1) if n > 1
                else np.array([int(0.4 * KR)]))
        ring_v = np.broadcast_to(
            (V0 + 1 + np.arange(KR) // 8).astype(np.uint32), (n, KR)).copy()
    mask = np.arange(KR)[None, :] < fill[:, None]
    for a in (rb, re):
        a[~mask] = 0
    ring_v[~mask] = 0
    return qlo, qhi, rv, rb, re, ring_v, mask
