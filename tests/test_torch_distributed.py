"""``parallel/distributed.py`` of the port: the process group and the
hybrid ('hosts', 'rs') lane layout, held to the JAX package's
``tests/test_sharded_resolver.py`` cases (a 2×4 hybrid mesh equal to the
flat 8 shards, ``fleet_mesh`` in one process) and run as a two-process
gloo group on loopback."""

import os
import random
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from foundationdb_tpu.ops import conflict as jck
from foundationdb_tpu.parallel import mesh as jpm
from foundationdb_tpu.resolver.packing import BatchPacker as JPacker
from foundationdb_tpu.resolver.packing import ShardRouter as JRouter
from foundationdb_tpu.resolver.skiplist import TxnRequest as JTxn
from foundationdb_tpu_torch.convert import (
    shard_batch_from_numpy,
    state_to_numpy,
)
from foundationdb_tpu_torch.core.status import CONFLICT
from foundationdb_tpu_torch.ops import conflict as tck
from foundationdb_tpu_torch.parallel import distributed as dist
from foundationdb_tpu_torch.parallel import mesh as tpm
from foundationdb_tpu_torch.resolver.packing import BatchPacker, ShardRouter
from foundationdb_tpu_torch.resolver.skiplist import TxnRequest as TTxn
from tests.test_resolver import SMALL

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TPARAMS = tck.ResolverParams(**{
    k: v for k, v in SMALL._asdict().items()
    if k in tck.ResolverParams._fields})
HYBRID = dist.FleetMesh((2, 4), (dist.HOST_AXIS, dist.AXIS))
FLAT = dist.FleetMesh((8,), (dist.AXIS,))


@pytest.fixture
def no_group_env(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)


def test_initialize_without_an_address_is_a_no_op(no_group_env):
    """No address: nothing is formed, the process is (0, 1), and the
    fleet layout is the flat one over the lanes asked for."""
    assert dist.initialize() == (0, 1)
    assert not torch.distributed.is_initialized()
    m = dist.fleet_mesh(8)
    assert m == FLAT and m.size == 8
    assert dist.fleet_mesh() == dist.FleetMesh((1,), (dist.AXIS,))
    assert dist.shard_axes(m) == (dist.AXIS,)
    assert dist.shard_axes(HYBRID) == (dist.HOST_AXIS, dist.AXIS)


def test_initialize_with_an_address_needs_world_and_rank(no_group_env):
    with pytest.raises(ValueError, match="num_processes"):
        dist.initialize("127.0.0.1:1", device="cpu")
    assert not torch.distributed.is_initialized()


def _spread_batches(seed, n_batches=12):
    """Batches of point and range txns over keys whose first byte varies,
    so every lane of the uniform first-limb split gets traffic."""
    rng = random.Random(seed)

    def key():
        return bytes([rng.randrange(256)]) + b"k%d" % rng.randrange(4)

    def span():
        a, b = sorted((key(), key()))
        return a, b + b"\xff"

    out, v = [], 100
    for _ in range(n_batches):
        txns = [JTxn(read_version=v - rng.randrange(0, 25),
                     point_reads=[key() for _ in range(rng.randrange(3))],
                     point_writes=[key() for _ in range(rng.randrange(3))],
                     range_reads=[span() for _ in range(rng.randrange(2))],
                     range_writes=[span() for _ in range(rng.randrange(2))])
                for _ in range(rng.randrange(1, SMALL.txns + 1))]
        v += rng.randrange(1, 8)
        out.append((txns, v, max(0, v - 60)))
    return out


def _stacked(packer, txns, cv, ws):
    b = packer.pack(txns, 0, cv, ws)
    return jck.ResolveBatch(*(np.asarray(f)[None] for f in b))


def _port_run(batches, mesh):
    """The presharded lanes on the port: ``mesh.size`` lanes behind the
    key-range router, flattened row-major from the layout."""
    kern = tpm.PreshardedResolverKernel(TPARAMS, mesh.size)
    router = ShardRouter(TPARAMS, mesh.size)
    packer = BatchPacker(TPARAMS, use_native=False)
    state, out = kern.state, []
    for txns, cv, ws in batches:
        sb, k, _ = router.split(_stacked(
            packer, [TTxn(**vars(t)) for t in txns], cv, ws))
        state, status = kern._scan_step(state, shard_batch_from_numpy(sb))
        out.append(router.reassemble(status, k)[0][: len(txns)].tolist())
    return out, state


def _reference_run(batches, mesh):
    """The JAX package's presharded fleet on ``mesh``."""
    kern = jpm.PreshardedResolverKernel(SMALL, mesh=mesh, donate=False)
    router = JRouter(SMALL, mesh.devices.size)
    packer = JPacker(SMALL, use_native=False)
    out = []
    for txns, cv, ws in batches:
        sb, k, _ = router.split(_stacked(packer, txns, cv, ws))
        status = np.asarray(kern.resolve_many(sb))
        out.append(router.reassemble(status, k)[0][: len(txns)].tolist())
    return out, kern.state


def test_hybrid_lane_layout_matches_flat_and_the_reference():
    """The 2×4 hybrid layout is a reshape of the 8-lane axis: the same
    verdicts and state as the flat 8 lanes, and the reference's
    presharded verdicts and state on its hybrid ('hosts', 'rs') mesh of
    8 virtual CPU devices."""
    assert len(jax.devices()) >= 8
    batches = _spread_batches(seed=5)
    hybrid, hstate = _port_run(batches, HYBRID)
    flat, fstate = _port_run(batches, FLAT)
    want, wstate = _reference_run(batches, Mesh(
        np.array(jax.devices()[:8]).reshape(2, 4), ("hosts", "rs")))
    assert hybrid == flat == want
    assert any(s == CONFLICT for statuses in want for s in statuses)
    for name, h, f, w in zip(tck.ResolverState._fields, hstate, fstate,
                             wstate):
        assert torch.equal(h, f), name
    for name, h, w in zip(tck.ResolverState._fields, state_to_numpy(hstate),
                          wstate):
        w = np.asarray(w)
        assert h.dtype == w.dtype and h.shape == w.shape, name
        np.testing.assert_array_equal(h, w, err_msg=name)
    assert int((hstate.ring_head != 0).sum()) > 1  # several lanes' rings


_CHILD = r"""
import sys
import torch
from foundationdb_tpu_torch.parallel import distributed as dist
rank = int(sys.argv[2])
idx, count = dist.initialize(sys.argv[1], 2, rank, device="cpu")
m = dist.fleet_mesh(8)
t = torch.tensor([rank + 1])
torch.distributed.all_reduce(t)
print(idx, count, m.shape, m.axis_names, dist.shard_axes(m), int(t))
torch.distributed.destroy_process_group()
"""


def test_two_process_gloo_group_on_loopback(no_group_env):
    """Two processes join one gloo group at ``tcp://127.0.0.1:<port>``,
    naming world size and rank: ranks 0 and 1 of 2, the hybrid layout of
    2 hosts × 4 lanes, and an all-reduce across them."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    addr = f"tcp://127.0.0.1:{port}"
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD, addr, str(r)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, errs = p.communicate(timeout=120)
            assert p.returncode == 0, errs
            outs.append(out.strip())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert outs == [
        f"{r} 2 (2, 4) ('hosts', 'rs') ('hosts', 'rs') 3" for r in (0, 1)]
