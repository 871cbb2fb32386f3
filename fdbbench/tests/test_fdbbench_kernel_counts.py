"""The frozen kernel counts equal the chip smoke run's on the same
inputs, and the roofline readers find nothing where nothing launched."""

import types

import numpy as np
import pytest
import torch

import chip_smoke
from fdbbench import harness, roofline, spec

T, W, KR = 48, 9, 64


def limbs(n, *shape):
    g = torch.Generator().manual_seed(n)
    # few distinct limbs, so compares go deep and intervals overlap
    return torch.randint(0, 3, shape + (W,), generator=g, dtype=torch.int64)


@pytest.fixture(scope="module")
def inputs():
    g = torch.Generator().manual_seed(7)
    lo, hi = limbs(1, KR), limbs(2, KR)
    ring = types.SimpleNamespace(
        ring_b=torch.minimum(lo, hi), ring_e=torch.maximum(lo, hi),
        ring_v=torch.randint(0, 100, (KR,), generator=g),
        ring_mask=torch.rand(KR, generator=g) < 0.7)
    rb, re = limbs(3, T, 2), limbs(4, T, 2)
    wb, we = limbs(5, T, 2), limbs(6, T, 2)
    batch = types.SimpleNamespace(
        rv=torch.randint(0, 100, (T,), generator=g),
        pr_key=limbs(8, T, 4), pr_mask=torch.rand(T, 4, generator=g) < 0.5,
        pr_hash=torch.zeros(T, 4, dtype=torch.int64),
        pw_key=limbs(9, T, 4), pw_mask=torch.rand(T, 4, generator=g) < 0.5,
        pw_hash=torch.zeros(T, 4, dtype=torch.int64),
        rr_b=torch.minimum(rb, re), rr_e=torch.maximum(rb, re),
        rr_mask=torch.rand(T, 2, generator=g) < 0.5,
        rw_b=torch.minimum(wb, we), rw_e=torch.maximum(wb, we),
        rw_mask=torch.rand(T, 2, generator=g) < 0.5)
    a0 = torch.rand(T, generator=g) < 0.8
    return ring, batch, a0


def test_accept_ops_and_bytes_equal_chip_smoke(inputs):
    ring, batch, a0 = inputs
    assert roofline.accept_ops(ring, batch, a0) == \
        chip_smoke.accept_ops(ring, batch, a0)
    r = (ring.ring_b, ring.ring_e, ring.ring_v, ring.ring_mask)
    for point, lo, hi in ((True, batch.pr_key, batch.pr_key),
                          (False, batch.rr_b, batch.rr_e)):
        args = (lo.reshape(-1, W), hi.reshape(-1, W),
                batch.rv[:, None].expand(T, lo.shape[1]).reshape(-1),
                torch.ones(lo.shape[0] * lo.shape[1], dtype=torch.bool))
        assert roofline.ring_ops(*args, *r, point=point) == \
            chip_smoke.ring_ops(*args, *r, point=point)
    ts = (a0, batch.rv, batch.pr_key, ring.ring_mask)
    assert roofline.io_bytes(*ts) == chip_smoke.io_bytes(*ts)
    for nb, ops in ((10 ** 6, 10), (10, 10 ** 9)):
        assert roofline.bound_ms(nb, ops) == chip_smoke.bound_ms(nb, ops)


def test_sweep_cost_equals_chip_smoke(inputs):
    from foundationdb_tpu_torch.ops.accept import jacobi_accept

    _, _, a0 = inputs
    O = torch.rand(T, T, generator=torch.Generator().manual_seed(3)) < 0.05
    O = O & torch.ones(T, T, dtype=torch.bool).triu(1)
    accepted = int(jacobi_accept(a0, O).sum())
    assert roofline.sweep_cost(T, accepted) == chip_smoke.sweep_cost(a0, O)


def test_batch_tensors_take_the_packed_shapes():
    entry = lambda k: k + b"\x00" * (32 - len(k)) + len(k).to_bytes(4, "big")
    blobs = {"pr": entry(b"user1") + entry(b"user22"), "pw": entry(b"user1"),
             "rr": entry(b"a") + entry(b"b"), "rw": b""}
    counts = {"pr": np.array([2, 0]), "pw": np.array([0, 1]),
              "rr": np.array([1, 0]), "rw": np.array([0, 0])}
    params = dict(txns=2, point_reads=4, point_writes=4, range_reads=2,
                  range_writes=2, key_limbs=8)
    b = roofline.Batch(blobs, counts, [105, 107], 100, params, "cpu")
    assert b.rv.tolist() == [5, 7]
    assert b.pr_key.shape == (2, 4, 9) and b.rr_b.shape == (2, 2, 9)
    assert b.pr_mask.tolist() == [[True, True, False, False], [False] * 4]
    assert b.pw_mask.tolist() == [[False] * 4, [True, False, False, False]]
    assert b.pr_key[0, 1, -1].item() == 6  # the length limb
    assert b.rr_e[0, 0, 0].item() == int.from_bytes(b"b\0\0\0", "big")


def fake_trace(kernels):
    return types.SimpleNamespace(
        kernel=lambda names: harness.devtrace.DeviceTrace.kernel(
            types.SimpleNamespace(kernels=kernels), names))


def test_roofline_reads_nothing_where_the_kernel_did_not_launch():
    ctx = harness.Context(trace=fake_trace({}), samples=[], accepted=0,
                          params={"txns": 1024})
    assert spec.metric_reader("accept_sweep_roofline").read(ctx) is None
    assert ctx.roofline("fused_accept") is None
    # both kernels' parts in one trace: the shared sweep is not split
    both = {"accept_ring_kernel(x)": [4, 1e-4], "accept_pack_kernel": [4, 1e-5],
            "accept_sweep_kernel": [8, 1e-4]}
    ctx.trace = fake_trace(both)
    assert spec.metric_reader("accept_sweep_roofline").read(ctx) is None


def test_accept_sweep_share_is_its_bytes_over_its_time():
    T = 1024
    ctx = harness.Context(
        trace=fake_trace({"void accept_pack_kernel(a)": [10, 40e-6],
                          "accept_sweep_kernel(b)": [10, 60e-6]}),
        samples=[], accepted=5000, params={"txns": T})
    share = spec.metric_reader("accept_sweep_roofline").read(ctx)
    least_ms = (2 * T + T * T) / roofline.HBM_BYTES_PER_S * 1e3
    assert share == pytest.approx(100 * least_ms / 0.01)
