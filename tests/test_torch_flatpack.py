"""The port's flat columnar commit lane against the JAX package's.

``encode_conflicts`` and ``build_flat_batch`` give the same bytes,
``pack_flat_group`` the same arrays (pads included), and a reused
staging slot leaves no trace of the batch it held before. The port's
``Resolver(device="cpu")`` resolving a FlatTxnBatch gives the statuses
and state of the JAX ``Resolver`` on the same batch and of its own
legacy lane; the batches the flat lane cannot serve (over capacity, a
read version below the device base) take the legacy lane and are
counted in ``flat_fallbacks``. Tolerance 0 throughout.
"""

import numpy as np
import pytest
import torch

from foundationdb_tpu.core import flatpack as jflat
from foundationdb_tpu.core.commit import CommitRequest as JRequest
from foundationdb_tpu.core.options import Knobs as JKnobs
from foundationdb_tpu.ops.conflict import ResolverParams as JParams
from foundationdb_tpu.resolver.packing import BatchPacker as JPacker
from foundationdb_tpu.resolver.resolver import Resolver as JResolver
from foundationdb_tpu_torch.convert import state_to_numpy
from foundationdb_tpu_torch.core import flatpack
from foundationdb_tpu_torch.core.commit import CommitRequest
from foundationdb_tpu_torch.core.options import Knobs
from foundationdb_tpu_torch.ops.conflict import ResolverParams
from foundationdb_tpu_torch.resolver.packing import BatchPacker
from foundationdb_tpu_torch.resolver.resolver import Resolver
from foundationdb_tpu_torch.server.proxy import _split_ranges

from tests.conftest import TEST_KNOBS

torch.set_num_threads(1)

L = TEST_KNOBS["key_limbs"]  # 16-byte capacity
PARAMS_KW = dict(txns=16, point_reads=2, point_writes=2, range_reads=4,
                 range_writes=4, key_width=L + 1, hash_bits=14,
                 ring_capacity=64, bucket_bits=8)


def _key(rng, long_every=0):
    k = b"k%03d" % rng.integers(60)
    if long_every and rng.integers(long_every) == 0:
        k += b"/beyond-16-bytes"
    return k


def _ranges(rng, n_points, n_ranges, long_every=0):
    out = [(k, k + b"\x00") for k in
           {_key(rng, long_every) for _ in range(n_points)}]
    for _ in range(n_ranges):
        a, b = sorted((_key(rng, long_every), _key(rng, long_every)))
        out.append((a, b + b"\xff"))
    return out


def _conflicts(rng, max_points=2, max_ranges=2, long_every=0):
    return (_ranges(rng, rng.integers(max_points + 1),
                    rng.integers(max_ranges + 1), long_every),
            _ranges(rng, rng.integers(max_points + 1),
                    rng.integers(max_ranges + 1), long_every))


def _flat_batch(rng, n, rv_base=100, **kw):
    reqs = []
    for _ in range(n):
        rcr, wcr = _conflicts(rng, **kw)
        reqs.append(CommitRequest(
            rv_base + int(rng.integers(0, 50)), [], rcr, wcr,
            flat_conflicts=flatpack.encode_conflicts(rcr, wcr, L)))
    return flatpack.build_flat_batch(reqs, L)


def _legacy(flat):
    """The same batch as the proxy's legacy build makes it."""
    out = []
    for t in flat.to_txn_requests():
        pr, rr = _split_ranges(list(t.read_ranges()))
        pw, rw = _split_ranges(list(t.write_ranges()))
        out.append(type(t)(read_version=t.read_version, point_reads=pr,
                           point_writes=pw, range_reads=rr, range_writes=rw))
    return out


def _jax_flat(flat):
    """The port's FlatTxnBatch as the JAX package's."""
    return jflat.FlatTxnBatch(flat.num_limbs, flat.rv, flat.prc, flat.pwc,
                              flat.rrc, flat.rwc, flat.pr_blob, flat.pw_blob,
                              flat.rr_blob, flat.rw_blob)


@pytest.mark.parametrize("limbs", [1, 2, 4, 8])
def test_encode_and_build_are_byte_identical(limbs):
    rng = np.random.default_rng(limbs)
    reqs, jreqs = [], []
    for _ in range(40):
        rcr, wcr = _conflicts(rng, max_points=4, long_every=9)
        f = flatpack.encode_conflicts(rcr, wcr, limbs)
        jf = jflat.encode_conflicts(rcr, wcr, limbs)
        assert (f is None) == (jf is None)
        if f is None:
            continue
        assert tuple(f) == tuple(jf)
        assert flatpack.decode_side(f.read_point_blob, f.read_range_blob,
                                    limbs) == jflat.decode_side(
            jf.read_point_blob, jf.read_range_blob, limbs)
        reqs.append(CommitRequest(int(rng.integers(1000)), [], rcr, wcr,
                                  flat_conflicts=f))
        jreqs.append(JRequest(reqs[-1].read_version, [], rcr, wcr,
                              flat_conflicts=jf))
    for n in (0, 1, len(reqs)):
        got = flatpack.build_flat_batch(reqs[:n], limbs)
        want = jflat.build_flat_batch(jreqs[:n], limbs)
        for name in ("num_limbs", "pr_blob", "pw_blob", "rr_blob", "rw_blob"):
            assert getattr(got, name) == getattr(want, name), name
        for name in ("rv", "prc", "pwc", "rrc", "rwc"):
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name), err_msg=name)
        for i in range(n):
            assert vars(got[i]) == vars(want[i])
    # a request without blobs, or of another width, refuses the flat build
    other = CommitRequest(1, [], [], [(b"a", b"a\x00")],
                          flat_conflicts=flatpack.encode_conflicts(
                              [], [(b"a", b"a\x00")], limbs + 1))
    assert flatpack.build_flat_batch(reqs[:2] + [other], limbs) is None
    bare = CommitRequest(1, [], [], [(b"a", b"a\x00")])
    assert flatpack.build_flat_batch([bare], limbs) is None
    assert bare.write_conflict_ranges == [(b"a", b"a\x00")]


def _assert_same(got, want):
    for name, g, w in zip(got._fields, got, want):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("nb,B", [(1, 1), (1, 2), (2, 2), (3, 4), (5, 8)])
def test_pack_flat_group_equals_jax_pads_included(nb, B):
    rng = np.random.default_rng(10 * nb + B)
    flats = [_flat_batch(rng, int(rng.integers(0, 17))) for _ in range(nb)]
    metas = [(1000 + 10 * b, 400 + b) for b in range(nb)]
    got = BatchPacker(ResolverParams(**PARAMS_KW)).pack_flat_group(
        flats, metas, 90, B=B)
    want = JPacker(JParams(**PARAMS_KW), use_native=False).pack_flat_group(
        [_jax_flat(f) for f in flats], metas, 90, B=B)
    _assert_same(got, want)
    # and equal to the legacy lane, batch by batch, pads as pack_empty
    packer = BatchPacker(ResolverParams(**PARAMS_KW))
    for b in range(B):
        if b < nb:
            one = packer.pack(_legacy(flats[b]), 90, *metas[b])
        else:
            one = packer.pack_empty(90, *metas[-1])
        _assert_same(type(one)(*(a[b] for a in got)), one)


def test_pack_flat_staging_reuse_is_clean():
    """The staging set reused after a longer, fuller group holds only the
    new one."""
    rng = np.random.default_rng(3)
    packer = BatchPacker(ResolverParams(**PARAMS_KW))
    fresh = BatchPacker(ResolverParams(**PARAMS_KW))
    big = [_flat_batch(rng, 16, max_points=2, max_ranges=4) for _ in range(2)]
    small = [_flat_batch(rng, 3, max_points=1, max_ranges=1)]
    packer.pack_flat_group(big, [(500, 10), (510, 11)], 5, B=2)
    got = packer.pack_flat_group(small, [(520, 12)], 5, B=2)
    assert packer.flat_reuse_hits == 1
    want = fresh.pack_flat_group(small, [(520, 12)], 5, B=2)
    _assert_same(got, want)
    one = packer.pack_flat(small[0], 5, 530, 13)
    _assert_same(one, fresh.pack(_legacy(small[0]), 5, 530, 13))


def _drive(r, batches, as_legacy=False):
    """Each (flat, cv, ws) through resolve, then all of them again as one
    resolve_many backlog at later versions."""
    out = []
    for flat, cv, ws in batches:
        out.append(r.resolve(_legacy(flat) if as_legacy else flat, cv, ws))
    last = batches[-1][1]
    backlog = [(_legacy(f) if as_legacy else f, last + cv, ws)
               for f, cv, ws in batches]
    return out + r.resolve_many(backlog)


def _stream(seed, n=8):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        cv = 200 + 40 * i
        flat = _flat_batch(rng, int(rng.integers(1, 17)), rv_base=cv - 60,
                           max_points=2, max_ranges=4)
        out.append((flat, cv, 0))
    return out


@pytest.mark.parametrize("accept_kernel", ["on", "off"])
@pytest.mark.parametrize("seed", [0, 1])
def test_resolver_flat_equals_jax_and_legacy_lane(seed, accept_kernel):
    stream = _stream(seed)
    port = Resolver(Knobs(**TEST_KNOBS, accept_kernel=accept_kernel),
                    device="cpu")
    legacy = Resolver(Knobs(**TEST_KNOBS, accept_kernel=accept_kernel),
                      device="cpu")
    jax_r = JResolver(JKnobs(**TEST_KNOBS))
    got = _drive(port, stream)
    assert got == _drive(legacy, stream, as_legacy=True)
    assert got == _drive(jax_r, [(_jax_flat(f), cv, ws)
                                 for f, cv, ws in stream])
    assert port.counters["flat_fallbacks"] == 0
    for name, a, b, c in zip(port.state._fields, state_to_numpy(port.state),
                             state_to_numpy(legacy.state), jax_r.state):
        np.testing.assert_array_equal(a, b, err_msg=name)
        np.testing.assert_array_equal(a, np.asarray(c), err_msg=name)


def test_flat_fallbacks_count_over_capacity_and_too_old():
    rng = np.random.default_rng(5)
    r = Resolver(Knobs(**TEST_KNOBS), device="cpu")
    ref = Resolver(Knobs(**TEST_KNOBS), device="cpu")
    # over capacity: more point reads than the lanes hold
    wide = _flat_batch(rng, 4, max_points=6, max_ranges=0)
    assert wide.prc.max() > PARAMS_KW["point_reads"]
    assert r._flat_refused(wide)
    assert r.resolve(wide, 1000, 0) == ref.resolve(_legacy(wide), 1000, 0)
    assert r.counters["flat_fallbacks"] == 1
    # too old: a read version below the device base
    r.base_version = ref.base_version = 50
    old = _flat_batch(rng, 3, rv_base=0)
    old.rv[0] = 10
    assert r._flat_refused(old)
    got = r.resolve(old, 1100, 0)
    assert got == ref.resolve(_legacy(old), 1100, 0) and got[0] == 2
    assert r.counters["flat_fallbacks"] == 2
    # in a backlog, one unservable batch sends the whole backlog legacy
    fine = _flat_batch(rng, 5, rv_base=1100)
    got = r.resolve_many([(fine, 1200, 0), (wide, 1300, 0)])
    assert got == ref.resolve_many([(_legacy(fine), 1200, 0),
                                    (_legacy(wide), 1300, 0)])
    assert r.counters["flat_fallbacks"] == 3
    # a backlog that mixes flat and legacy batches decodes, uncounted
    fine = _flat_batch(rng, 5, rv_base=1300)
    assert not r._flat_refused(fine)
    got = r.resolve_many([(fine, 1400, 0), (_legacy(fine), 1500, 0)])
    assert got == ref.resolve_many([(_legacy(fine), 1400, 0),
                                    (_legacy(fine), 1500, 0)])
    assert r.counters["flat_fallbacks"] == 3
    for name, a, b in zip(r.state._fields, state_to_numpy(r.state),
                          state_to_numpy(ref.state)):
        np.testing.assert_array_equal(a, b, err_msg=name)
