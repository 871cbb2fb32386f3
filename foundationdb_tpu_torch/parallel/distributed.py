"""Multi-process deployment: the process group and the hybrid lane layout.

Ref parity: the role FlowTransport and the cluster connection string
play in the reference — how N machines become one transaction system.
The JAX package forms its process group with ``jax.distributed`` and
lays resolver shards out on a hybrid ``('hosts', 'rs')`` device mesh,
so its verdict collectives ride the chips' links within a host and only
the small reductions cross between hosts.

The port keeps a resolver fleet as a lane axis of one state on one card
(parallel/mesh.py), so a fleet layout is a shape of that axis: the flat
``('rs',)`` layout of n lanes, or, across processes, the hybrid
``('hosts', 'rs')`` layout whose flattened coordinate ``host * per_host
+ r`` is the lane id: a view of the lane axis in that shape, so the lane
order, and every verdict, is the flat layout's.

The process group is ``torch.distributed``'s. ``initialize`` decides
from its arguments and the environment alone and touches no device
first: with no address it is a no-op that leaves the process alone
(``(0, 1)``), so the same code runs in one process on one card.
"""

import math
import os
from collections import namedtuple

AXIS = "rs"
HOST_AXIS = "hosts"

# torch.distributed's own environment convention
_ENV_ADDR, _ENV_PORT = "MASTER_ADDR", "MASTER_PORT"
_ENV_WORLD, _ENV_RANK = "WORLD_SIZE", "RANK"


def _address_from_env():
    addr = os.environ.get(_ENV_ADDR)
    if not addr:
        return None
    port = os.environ.get(_ENV_PORT)
    return f"{addr}:{port}" if port else addr


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, device=None, **kw):
    """Join (or form) the multi-process group; returns
    ``(process_index, process_count)``.

    Safe to call unconditionally: with no address (the argument, or
    ``MASTER_ADDR``/``MASTER_PORT``) it starts nothing and returns the
    group it already belongs to, else ``(0, 1)``. With an address it
    calls ``torch.distributed.init_process_group`` naming the address
    (``tcp://host:port``), the world size and the rank explicitly
    (arguments, else ``WORLD_SIZE``/``RANK``). The backend is ``nccl``
    for a card and ``gloo`` when ``device="cpu"``. A process already in
    a group keeps it. ``kw`` passes on (``timeout=``)."""
    import torch.distributed as dist

    addr = coordinator_address or _address_from_env()
    if addr and not dist.is_initialized():
        if num_processes is None:
            num_processes = os.environ.get(_ENV_WORLD)
        if process_id is None:
            process_id = os.environ.get(_ENV_RANK)
        if num_processes is None or process_id is None:
            raise ValueError(
                "initialize: an address needs num_processes and process_id "
                f"(or {_ENV_WORLD} and {_ENV_RANK})")
        backend = "gloo" if str(device) == "cpu" else "nccl"
        init = addr if "://" in addr else f"tcp://{addr}"
        dist.init_process_group(backend, init_method=init,
                                world_size=int(num_processes),
                                rank=int(process_id), **kw)
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _process_count():
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


class FleetMesh(namedtuple("FleetMesh", ["shape", "axis_names"])):
    """A resolver fleet's lane layout: ``shape`` over ``axis_names``,
    flattened row-major into lane ids."""

    __slots__ = ()

    @property
    def size(self):
        """The fleet's lane count."""
        return math.prod(self.shape)


def fleet_mesh(n_lanes=None):
    """The resolver fleet's layout across every process.

    One process: the flat ``('rs',)`` layout of ``n_lanes`` lanes (1 by
    default). Several: the hybrid ``('hosts', 'rs')`` layout, one row a
    process and consecutive 'rs' lanes on one process; ``n_lanes`` is
    then the whole fleet and must split evenly over the processes."""
    procs = _process_count()
    if procs <= 1:
        return FleetMesh((1 if n_lanes is None else int(n_lanes),), (AXIS,))
    total = procs if n_lanes is None else int(n_lanes)
    if total % procs:
        raise ValueError(
            f"n_lanes={total} cannot split over {procs} processes: every "
            "process holds the same number of lanes")
    return FleetMesh((procs, total // procs), (HOST_AXIS, AXIS))


def shard_axes(mesh):
    """The axes the conflict state shards over: both axes of a hybrid
    layout (every lane of the fleet owns a slice), 'rs' of a flat one."""
    return (HOST_AXIS, AXIS) if HOST_AXIS in mesh.axis_names else (AXIS,)

