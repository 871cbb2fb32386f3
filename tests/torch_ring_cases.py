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
