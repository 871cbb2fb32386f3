"""The compiled resolver step (ops/conflict.StaticStep) against the JAX
package's jitted steps.

On the CPU the port's compiled step runs eagerly, with the buffers of the
card's graphs: fixed input tensors refilled from numpy, the live state
updated in place, and a fixed output that the next run overwrites. So
these cases hold that buffer discipline to the reference at tolerance 0
(statuses and all 12 state fields): every width of both pad ladders
against ``make_resolve_scan_fn``, lazy handles read after a later
dispatch, a rebase between dispatches, a history loaded from the JAX
resolver into a resolver whose steps are already compiled, the "range"
lanes with a batch split into k > 1 txn slices, and the capture counter's
keys against the reference's compile keys. Inputs are made by numpy from
a seed at ``TEST_KNOBS`` widths.
"""

import numpy as np
import pytest
import torch

from foundationdb_tpu.core.options import Knobs as JKnobs
from foundationdb_tpu.ops import conflict as jck
from foundationdb_tpu.resolver.meshresolver import MeshResolver as JMesh
from foundationdb_tpu.resolver.packing import BatchPacker as JPacker
from foundationdb_tpu.resolver.resolver import Resolver as JResolver
from foundationdb_tpu.resolver.skiplist import TxnRequest as JTxn
from foundationdb_tpu_torch.convert import state_from_numpy, state_to_numpy
from foundationdb_tpu_torch.core.options import Knobs as TKnobs
from foundationdb_tpu_torch.core.versions import REBASE_THRESHOLD
from foundationdb_tpu_torch.ops import conflict as tck
from foundationdb_tpu_torch.resolver.meshresolver import MeshResolver
from foundationdb_tpu_torch.resolver.resolver import (
    BACKLOG_B,
    PAD_BUCKETS,
    PAD_BUCKETS_ACCEPT_KERNEL,
    Resolver,
)
from foundationdb_tpu_torch.resolver.skiplist import TxnRequest as TTxn

from tests.conftest import TEST_KNOBS

torch.set_num_threads(1)

KNOBS = {k: v for k, v in TEST_KNOBS.items() if k != "initial_backoff_s"}
T = KNOBS["batch_txn_capacity"]
# port kernel knobs ↔ JAX Pallas knobs, the pad ladder each route takes,
# and the widths a TxnRequest backlog pads to (off the accept route the
# reference pads those to one fixed bucket, BACKLOG_B)
ROUTES = {
    "plain": (dict(accept_kernel="off", ring_kernel="off"),
              dict(pallas_scan="off", pallas_ring="off"), PAD_BUCKETS,
              (BACKLOG_B,)),
    "accept_kernel": (dict(accept_kernel="on", ring_kernel="off"),
                      dict(pallas_scan="on", pallas_ring="off"),
                      PAD_BUCKETS_ACCEPT_KERNEL, PAD_BUCKETS_ACCEPT_KERNEL),
}


def _stream(seed, n_batches, v0=100, nkeys=24):
    """Batches of TxnRequest fields (seeded numpy): point and range reads
    and writes over ``nkeys`` keys, read versions lagging up to 14."""
    rng = np.random.default_rng(seed)

    def key():
        return b"k%03d" % rng.integers(nkeys)

    def span():
        a, b = sorted((key(), key()))
        return (a, b + b"\xff")

    out, v = [], v0
    for _ in range(n_batches):
        txns = [dict(read_version=int(v - rng.integers(15)),
                     point_reads=[key() for _ in range(rng.integers(3))],
                     point_writes=[key() for _ in range(rng.integers(3))],
                     range_reads=[span() for _ in range(rng.integers(3))],
                     range_writes=[span() for _ in range(rng.integers(2))])
                for _ in range(int(rng.integers(1, T + 1)))]
        v += int(rng.integers(1, 5))
        out.append((txns, v, max(0, v - 60)))
    return out


def _as(cls, stream):
    return [([cls(**t) for t in txns], cv, ws) for txns, cv, ws in stream]


def _same_state(jstate, tstate):
    for name, j, t in zip(tck.ResolverState._fields, jstate,
                          state_to_numpy(tstate)):
        j = np.asarray(j)
        assert j.dtype == t.dtype, name
        np.testing.assert_array_equal(t, j, err_msg=name)


def _pair(route, **extra):
    tk, jk, _, _ = ROUTES[route]
    jr = JResolver(JKnobs(resolver_backend="tpu", **KNOBS, **jk, **extra))
    tr = Resolver(TKnobs(**KNOBS, **tk, **extra), device="cpu")
    assert tr.params.use_accept_kernel == jr.params.use_pallas_scan
    return jr, tr


@pytest.mark.parametrize("route", list(ROUTES))
def test_every_pad_width_matches_the_jax_scan(route):
    """One history through a scan of every width of the route's pad
    ladder in turn: the port's compiled scan of each width against the
    reference's ``make_resolve_scan_fn`` of the same width."""
    tk, jk, ladder, _ = ROUTES[route]
    jp = jck.ResolverParams(
        txns=T, point_reads=KNOBS["point_reads_per_txn"],
        point_writes=KNOBS["point_writes_per_txn"],
        range_reads=KNOBS["range_reads_per_txn"],
        range_writes=KNOBS["range_writes_per_txn"],
        key_width=KNOBS["key_limbs"] + 1, hash_bits=KNOBS["hash_table_bits"],
        ring_capacity=KNOBS["range_ring_capacity"],
        bucket_bits=KNOBS["coarse_buckets_bits"],
        use_pallas_scan=jk["pallas_scan"] == "on")
    tp = tck.ResolverParams(**{f: getattr(jp, f) for f in tck.ResolverParams._fields
                               if hasattr(jp, f)},
                            use_accept_kernel=tk["accept_kernel"] == "on")
    packer = JPacker(jp, use_native=False)
    js = jck.init_state(jp)
    ts = tck.init_state(tp)
    stream = _stream(7, sum(ladder))
    i = 0
    for B in ladder:
        packed = [packer.pack([JTxn(**t) for t in txns], 0, cv, ws)
                  for txns, cv, ws in stream[i:i + B]]
        i += B
        stacked = jck.ResolveBatch(*(np.stack([np.asarray(f) for f in fs])
                                     for fs in zip(*packed)))
        js, jst = jck.make_resolve_scan_fn(jp, donate=False)(js, stacked)
        tst = tck.make_resolve_scan_fn(tp, ts).run(stacked)
        np.testing.assert_array_equal(tst.numpy(), np.asarray(jst),
                                      err_msg=f"B={B}")
        _same_state(js, ts)
    assert int(np.asarray(jst == 0).sum()) > 0  # some txn committed


@pytest.mark.parametrize("route", list(ROUTES))
def test_lazy_handles_read_after_a_later_dispatch(route):
    """Two backlogs of one pad width dispatched lazily before either is
    read, then read newest first: each must keep its own statuses, though
    the second dispatch ran the same compiled scan over the same output."""
    jr, tr = _pair(route)
    stream = _stream(11, 12)
    want = [jr.resolve_many(_as(JTxn, stream[i:i + 3]))
            for i in range(0, 9, 3)]
    handles = [tr.resolve_many(_as(TTxn, stream[i:i + 3]), lazy=True)
               for i in range(0, 9, 3)]
    got = [h.wait() for h in reversed(handles)][::-1]
    assert got == want
    # then the single step, and one more backlog, after the lazy reads
    for txns, cv, ws in stream[9:11]:
        assert tr.resolve([TTxn(**t) for t in txns], cv, ws) == \
            jr.resolve([JTxn(**t) for t in txns], cv, ws)
    assert tr.resolve_many(_as(TTxn, stream[11:])) == \
        jr.resolve_many(_as(JTxn, stream[11:]))
    _same_state(jr.state, tr.state)
    B = 4 if route == "accept_kernel" else BACKLOG_B  # a backlog of 3
    assert tr.status()["graphs"]["captures"][str((False, B))] == 1


def test_rebase_between_dispatches_matches_jax():
    """A lazy backlog, then batches whose versions cross the rebase
    threshold (the state shifts in place under the compiled steps), then
    the first handle read."""
    jr, tr = _pair("plain")
    first = _stream(4, 3)
    jump = _stream(5, 4, v0=first[-1][1] + REBASE_THRESHOLD + 10)
    h = tr.resolve_many(_as(TTxn, first), lazy=True)
    want = [jr.resolve_many(_as(JTxn, first))]
    for txns, cv, ws in jump[:2]:
        want.append(jr.resolve([JTxn(**t) for t in txns], cv, ws))
    want.append(jr.resolve_many(_as(JTxn, jump[2:])))
    got_rest = [tr.resolve([TTxn(**t) for t in txns], cv, ws)
                for txns, cv, ws in jump[:2]]
    got_rest.append(tr.resolve_many(_as(TTxn, jump[2:])))
    assert [h.wait()] + got_rest == want
    assert tr.base_version == jr.base_version > 0  # it did rebase
    _same_state(jr.state, tr.state)


def test_load_state_from_jax_into_compiled_steps():
    """The port compiles its steps on a history of its own, then loads
    the JAX resolver's history in place: every later step must see the
    loaded one. A state of other shapes is refused."""
    jr, tr = _pair("plain")
    stream = _stream(9, 14)
    warm = _stream(10, 3, v0=20)
    for txns, cv, ws in warm[:1]:
        tr.resolve([TTxn(**t) for t in txns], cv, ws)
    tr.resolve_many(_as(TTxn, warm[1:]))  # compiles (False, 1), (False, 8)
    for txns, cv, ws in stream[:4]:
        jr.resolve([JTxn(**t) for t in txns], cv, ws)
    tr.load_state(state_from_numpy([np.asarray(f) for f in jr.state]))
    tr.base_version = jr.base_version
    tr._range_history = jr._range_history
    for txns, cv, ws in stream[4:8]:
        assert tr.resolve([TTxn(**t) for t in txns], cv, ws) == \
            jr.resolve([JTxn(**t) for t in txns], cv, ws)
    assert tr.resolve_many(_as(TTxn, stream[8:10])) == \
        jr.resolve_many(_as(JTxn, stream[8:10]))
    assert tr.resolve_many(_as(TTxn, stream[10:])) == \
        jr.resolve_many(_as(JTxn, stream[10:]))
    _same_state(jr.state, tr.state)
    assert tr.status()["graphs"]["captures"][str((False, BACKLOG_B))] == 1
    bad = tck.init_state(tr.params._replace(ring_capacity=32))
    with pytest.raises(ValueError, match="ring_b"):
        tr.load_state(bad)


def _one_key_stream(n_batches, v0=100):
    """Every txn reads two keys and a span of one prefix, some write them:
    all entries land in one lane, past its slots (2 * T point reads
    against a lane's 1.75 * 2T / n at n >= 4), so the router splits each
    batch into k > 1 txn slices."""
    out, v = [], v0
    for i in range(n_batches):
        txns = [dict(read_version=v - (j % 5), point_reads=[b"same", b"samf"],
                     point_writes=[b"same"] if j % 3 == 0 else [],
                     range_reads=[(b"same", b"same2")],
                     range_writes=[(b"same", b"same2")] if j % 4 == 1 else [])
                for j in range(T)]
        v += 3
        out.append((txns, v, max(0, v - 40)))
    return out


@pytest.mark.parametrize("n", [4, 8])
def test_range_lanes_split_into_slices_match_jax(n):
    """MeshResolver ("range") on batches that split into k > 1 txn
    slices, through resolve and a resolve_many backlog: each (k, B) is
    its own compiled scan; statuses and state equal to the JAX mesh."""
    jr = JMesh(JKnobs(resolver_backend="tpu", resolver_sharding="range",
                      **KNOBS), n_lanes=n)
    tr = MeshResolver(TKnobs(resolver_sharding="range", **KNOBS), n_lanes=n,
                      device="cpu")
    stream = _one_key_stream(6) + _stream(12, 4, v0=200)
    for txns, cv, ws in stream[:3]:
        assert tr.resolve([TTxn(**t) for t in txns], cv, ws) == \
            jr.resolve([JTxn(**t) for t in txns], cv, ws)
    assert tr.resolve_many(_as(TTxn, stream[3:6])) == \
        jr.resolve_many(_as(JTxn, stream[3:6]))
    assert tr.resolve_many(_as(TTxn, stream[6:])) == \
        jr.resolve_many(_as(JTxn, stream[6:]))
    _same_state(jr.state, tr.state)
    ks = {k for k in tr.split_chunks if k > 1}
    assert ks, tr.split_chunks
    keys = {eval(k) for k in tr.status()["graphs"]["captures"]}
    assert {(False, k, 1) for k in ks} <= keys
    assert any(k[1] > 1 and k[2] == BACKLOG_B for k in keys), keys


@pytest.mark.parametrize("route", list(ROUTES))
def test_capture_keys_match_the_reference_compile_keys(route):
    """Backlogs of depths that reach every pad width of the ladder: the
    port's scan captures, keyed (variant, B), are the reference's scan
    compiles, one each; the single steps are the port's (variant, 1) on
    top."""
    jr, tr = _pair(route)
    ladder, padded = ROUTES[route][2:]
    stream = _stream(13, 2 + sum(ladder))
    for txns, cv, ws in stream[:2]:
        assert tr.resolve([TTxn(**t) for t in txns], cv, ws) == \
            jr.resolve([JTxn(**t) for t in txns], cv, ws)
    i = 2
    for B in ladder:
        depth = B // 2 + 1  # pads up to B
        assert tr.resolve_many(_as(TTxn, stream[i:i + depth])) == \
            jr.resolve_many(_as(JTxn, stream[i:i + depth]))
        i += depth
    _same_state(jr.state, tr.state)
    caps = tr.status()["graphs"]["captures"]
    scans = {k: v for k, v in caps.items() if eval(k)[1] > 1}
    assert scans == jr.profile.compile_keys
    assert scans == {str((False, B)): 1 for B in padded}
    assert caps[str((False, 1))] == 1


@pytest.mark.parametrize("route", list(ROUTES))
def test_precompile_compiles_each_key_once(route):
    """precompile() sets up every key a dispatch can take before the
    first batch; the stream then compiles nothing new and leaves the
    statuses and state of the reference."""
    jr, tr = _pair(route)
    keys = tr.precompile()
    ladder = ROUTES[route][2]
    assert set(keys) == {(v, B) for v in (False, True) for B in (1, *ladder)}
    before = dict(tr.status()["graphs"]["captures"])
    assert before == {str(k): 1 for k in keys}
    stream = _stream(17, 8)
    for txns, cv, ws in stream[:3]:
        assert tr.resolve([TTxn(**t) for t in txns], cv, ws) == \
            jr.resolve([JTxn(**t) for t in txns], cv, ws)
    assert tr.resolve_many(_as(TTxn, stream[3:])) == \
        jr.resolve_many(_as(JTxn, stream[3:]))
    _same_state(jr.state, tr.state)
    assert tr.status()["graphs"]["captures"] == before
