"""``parallel/distributed.py`` of the port: the process group and the
hybrid ('hosts', 'rs') lane layout, held to the JAX package's
``tests/test_sharded_resolver.py`` cases (a 2×4 hybrid mesh equal to the
flat 8 shards, ``fleet_mesh`` in one process) and run as a two-process
gloo group on loopback."""

import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from foundationdb_tpu_torch.convert import batch_from_numpy
from foundationdb_tpu_torch.ops import conflict as tck
from foundationdb_tpu_torch.parallel import distributed as dist
from foundationdb_tpu_torch.parallel import mesh as tpm
from foundationdb_tpu_torch.resolver.packing import BatchPacker
from foundationdb_tpu_torch.resolver.skiplist import TxnRequest as TTxn
from tests.test_resolver import SMALL
from tests.test_sharded_resolver import make_point_batches, run_sharded

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


def _port_run(batches, mesh):
    """The reference's run_sharded on the port: the "hash" lanes of
    ``mesh.size`` lanes, flattened row-major from the layout."""
    kern = tpm.ShardedResolverKernel(TPARAMS, mesh.size)
    packer = BatchPacker(TPARAMS, use_native=False)
    state, out = kern.state, []
    for txns, cv, ws in batches:
        b = packer.pack([TTxn(**vars(t)) for t in txns], 0, cv, ws)
        status, _, state = kern._step(state, batch_from_numpy(b))
        out.append(status[: len(txns)].tolist())
    return out, state.ring_head.view(*mesh.shape).reshape(-1)


def test_hybrid_lane_layout_matches_flat_and_the_reference():
    """The 2×4 hybrid layout is a reshape of the 8-lane axis: the same
    verdicts and state as the flat 8 lanes, and the reference's verdicts
    on its hybrid ('hosts', 'rs') mesh of 8 virtual CPU devices."""
    assert len(jax.devices()) >= 8
    batches = make_point_batches(seed=5)
    hybrid, hstate = _port_run(batches, HYBRID)
    flat, fstate = _port_run(batches, FLAT)
    want = run_sharded(batches, Mesh(
        np.array(jax.devices()[:8]).reshape(2, 4), ("hosts", "rs")))
    assert hybrid == flat == want
    assert torch.equal(hstate, fstate)


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
