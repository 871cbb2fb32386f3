"""The port's key model and interval helpers against the JAX package.

Same numpy inputs (seeded) through ``foundationdb_tpu`` and
``foundationdb_tpu_torch``; every output is a bit, an index or a uint32,
so the tolerance is 0. Limbs span the whole uint32 range (values at and
above 2^31 included) and are drawn from a small alphabet so that ties
between limbs, which decide the lexicographic compare, are common.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationdb_tpu.core.keys import KeyCodec as JKeyCodec
from foundationdb_tpu.ops import intervals as jiv
from foundationdb_tpu.resolver.packing import fnv_hash_np as j_fnv_hash_np
from foundationdb_tpu_torch.convert import tensor_from_numpy
from foundationdb_tpu_torch.core.keys import KeyCodec
from foundationdb_tpu_torch.ops import intervals as tiv
from foundationdb_tpu_torch.resolver.packing import fnv_hash_np

# one intra-op thread per test process: the suite runs under pytest-xdist,
# where torch's default of a thread per core in every worker oversubscribes
# the CPU and slows the timed tests of the other workers
torch.set_num_threads(1)

# few distinct values per limb, half of them >= 2^31
ALPHABET = np.array([0, 1, 7, 0x7FFFFFFF, 0x80000000, 0x80000001,
                     0xFFFFFFFE, 0xFFFFFFFF], np.uint32)


def _limbs(rng, *shape):
    return ALPHABET[rng.integers(0, len(ALPHABET), shape)]


def _t(a):
    return tensor_from_numpy(a)


def _same(j, t):
    j = np.asarray(j)
    t = t.numpy()
    assert j.shape == t.shape
    np.testing.assert_array_equal(j.astype(np.int64), t.astype(np.int64))


@pytest.mark.parametrize("W", [1, 3, 9])
@pytest.mark.parametrize("seed", [0, 1])
def test_lex_compares_match_jax(W, seed):
    rng = np.random.default_rng(seed)
    a, b = _limbs(rng, 40, 1, W), _limbs(rng, 1, 30, W)
    b[0, :5] = a[:5, 0]  # some exact ties
    for jf, tf in ((jiv.lex_lt, tiv.lex_lt), (jiv.lex_le, tiv.lex_le),
                   (jiv.lex_eq, tiv.lex_eq)):
        _same(jf(jnp.asarray(a), jnp.asarray(b)), tf(_t(a), _t(b)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_overlap_point_in_and_brute_match_jax(seed):
    rng = np.random.default_rng(seed)
    W, Q, K = 4, 33, 47
    rb, re = _limbs(rng, Q, W), _limbs(rng, Q, W)
    wb, we = _limbs(rng, K, W), _limbs(rng, K, W)
    rv = rng.integers(0, 1 << 32, Q, dtype=np.uint64).astype(np.uint32)
    wv = rng.integers(0, 1 << 32, K, dtype=np.uint64).astype(np.uint32)
    wv[:5] = rv[:5]  # equal versions never conflict
    wmask = rng.random(K) < 0.7
    _same(jiv.ranges_overlap(rb[:, None], re[:, None], wb[None], we[None]),
          tiv.ranges_overlap(_t(rb)[:, None], _t(re)[:, None],
                             _t(wb)[None], _t(we)[None]))
    _same(jiv.point_in_ranges(rb, wb, we),
          tiv.point_in_ranges(_t(rb), _t(wb), _t(we)))
    _same(jiv.conflicts_brute(rb, re, rv, wb, we, wv, wmask),
          tiv.conflicts_brute(_t(rb), _t(re), _t(rv), _t(wb), _t(we), _t(wv),
                              _t(wmask)))


@pytest.mark.parametrize("W", [1, 5, 9])
def test_fnv_hash_matches_jax_and_numpy(W):
    rng = np.random.default_rng(W)
    limbs = rng.integers(0, 1 << 32, (64, 3, W), dtype=np.uint64).astype(
        np.uint32)
    limbs[0] = 0xFFFFFFFF
    limbs[1] = 0
    want = np.asarray(jiv.fnv_hash(jnp.asarray(limbs)))
    _same(want, tiv.fnv_hash(_t(limbs)))
    np.testing.assert_array_equal(fnv_hash_np(limbs), want)
    np.testing.assert_array_equal(j_fnv_hash_np(limbs), want)


@pytest.mark.parametrize("m", [1, 2, 17, 64])
def test_searchsorted_limbs_matches_jax(m):
    rng = np.random.default_rng(m)
    W = 3
    keys = np.unique(_limbs(rng, m * 2, W), axis=0)[:m]
    queries = _limbs(rng, 25, W)
    queries[:3] = keys[0]  # exact hits
    want = np.asarray(jiv.searchsorted_limbs(jnp.asarray(keys),
                                             jnp.asarray(queries)))
    got = tiv.searchsorted_limbs(_t(keys), _t(queries))
    assert got.dtype == torch.int32
    _same(want, got)


KEYS = [b"", b"a", b"ab", b"ab\x00", b"user00000001", b"\xff" * 8,
        b"\xff" * 9, b"x" * 31, b"x" * 32, b"x" * 33, b"y" * 40 + b"\x00",
        b"\x00" * 40, b"k\xff\xff\xff\xff\xff\xff\xff\xffz"]


@pytest.mark.parametrize("limbs", [1, 2, 8])
def test_key_codec_matches_jax_including_long_keys(limbs):
    jc, tc = JKeyCodec(limbs), KeyCodec(limbs)
    np.testing.assert_array_equal(tc.encode_lower_batch(KEYS),
                                  jc.encode_lower_batch(KEYS))
    ends = [k + b"\x01" for k in KEYS]
    for got, want in zip(tc.encode_bounds_batch(KEYS, ends),
                         jc.encode_bounds_batch(KEYS, ends)):
        np.testing.assert_array_equal(got, want)
    for k in KEYS:
        np.testing.assert_array_equal(tc.encode_upper(k), jc.encode_upper(k))
        np.testing.assert_array_equal(tc.encode_lower(k), jc.encode_lower(k))


def test_long_keys_round_conservatively():
    """A lower bound rounds down and an upper bound up, so a range never
    shrinks under the encoding."""
    c = KeyCodec(2)  # 8-byte exact prefix
    lo = _t(c.encode_lower_batch([b"abcdefghZZ"]))
    hi = _t(np.stack([c.encode_upper(b"abcdefghZZ")]))
    exact = _t(c.encode_lower_batch([b"abcdefgh", b"abcdefgi"]))
    assert not tiv.lex_lt(exact[0], lo[0])  # lower rounds down to prefix
    assert tiv.lex_lt(exact[0], hi[0])  # upper rounds up past the prefix
    top = _t(np.stack([c.encode_upper(b"\xff" * 9)]))
    assert tiv.lex_lt(_t(c.encode_lower_batch([b"\xff" * 8]))[0], top[0])
