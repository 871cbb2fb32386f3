"""The two packages' names for the cluster-level parity tests of
replication, the ratekeeper and the system keys
(tests/test_torch_datadistribution.py, test_torch_ratekeeper.py,
test_torch_systemkeys.py), of regions, change feeds and the layers
(test_torch_regions.py, test_torch_changefeed.py,
test_torch_layers.py): each test writes its script once against a
``Side`` and runs it on the JAX package and on the port (its cluster on
``device="cpu"``), then compares what the two returned, at tolerance 0.
"""

import functools
import importlib

import numpy as np

from foundationdb_tpu.core import deterministic as jdeterministic
from foundationdb_tpu.core import systemdata as jsystemdata
from foundationdb_tpu.core.commit import CommitRequest as JRequest
from foundationdb_tpu.core.errors import FDBError as JError
from foundationdb_tpu.core.keys import KeySelector as JSelector
from foundationdb_tpu.core.mutations import Mutation as JMutation
from foundationdb_tpu.core.mutations import Op as JOp
from foundationdb_tpu.layers import subspace as jsubspace
from foundationdb_tpu.layers import tenant as jtenant
from foundationdb_tpu.layers import tuple as jtuple
from foundationdb_tpu.server import coordination as jcoordination
from foundationdb_tpu.server import region as jregion
from foundationdb_tpu.server import grv as jgrv
from foundationdb_tpu.server import tlog as jtlog
from foundationdb_tpu.server.cluster import Cluster as JCluster
from foundationdb_tpu.server.datadistribution import (
    DataDistributor as JDataDistributor,
)
from foundationdb_tpu.server.datadistribution import ShardMap as JShardMap
from foundationdb_tpu.server.ratekeeper import Ratekeeper as JRatekeeper
from foundationdb_tpu.server.sequencer import Sequencer as JSequencer
from foundationdb_tpu.server.storage import StorageServer as JStorage
from foundationdb_tpu_torch.convert import state_to_numpy
from foundationdb_tpu_torch.core import deterministic as tdeterministic
from foundationdb_tpu_torch.core import systemdata as tsystemdata
from foundationdb_tpu_torch.core.commit import CommitRequest as TRequest
from foundationdb_tpu_torch.core.errors import FDBError as TError
from foundationdb_tpu_torch.core.keys import KeySelector as TSelector
from foundationdb_tpu_torch.core.mutations import Mutation as TMutation
from foundationdb_tpu_torch.core.mutations import Op as TOp
from foundationdb_tpu_torch.layers import subspace as tsubspace
from foundationdb_tpu_torch.layers import tenant as ttenant
from foundationdb_tpu_torch.layers import tuple as ttuple
from foundationdb_tpu_torch.server import coordination as tcoordination
from foundationdb_tpu_torch.server import region as tregion
from foundationdb_tpu_torch.server import grv as tgrv
from foundationdb_tpu_torch.server import tlog as ttlog
from foundationdb_tpu_torch.server.cluster import Cluster as TCluster
from foundationdb_tpu_torch.server.datadistribution import (
    DataDistributor as TDataDistributor,
)
from foundationdb_tpu_torch.server.datadistribution import ShardMap as TShardMap
from foundationdb_tpu_torch.server.ratekeeper import Ratekeeper as TRatekeeper
from foundationdb_tpu_torch.server.sequencer import Sequencer as TSequencer
from foundationdb_tpu_torch.server.storage import StorageServer as TStorage


# the layers packages export a ``directory`` object under the submodule's
# name: take the modules themselves
jdirectory = importlib.import_module("foundationdb_tpu.layers.directory")
tdirectory = importlib.import_module("foundationdb_tpu_torch.layers.directory")


class Side:
    def __init__(self, name, **names):
        self.name = name
        self.__dict__.update(names)


JAX = Side("jax", cluster=JCluster, request=JRequest, error=JError,
           selector=JSelector, mutation=JMutation, op=JOp, grv=jgrv,
           tlog=jtlog, ratekeeper=JRatekeeper, sequencer=JSequencer,
           storage=JStorage, shard_map=JShardMap, dd=JDataDistributor,
           systemdata=jsystemdata, deterministic=jdeterministic,
           region=jregion, coordination=jcoordination, tuple=jtuple,
           subspace=jsubspace, directory=jdirectory, tenant=jtenant,
           state=lambda c: [np.asarray(f) for f in c.resolvers[0].state])
PORT = Side("port", cluster=functools.partial(TCluster, device="cpu"),
            request=TRequest, error=TError, selector=TSelector,
            mutation=TMutation, op=TOp, grv=tgrv, tlog=ttlog,
            ratekeeper=TRatekeeper, sequencer=TSequencer, storage=TStorage,
            shard_map=TShardMap, dd=TDataDistributor, systemdata=tsystemdata,
            deterministic=tdeterministic, region=tregion,
            coordination=tcoordination, tuple=ttuple, subspace=tsubspace,
            directory=tdirectory, tenant=ttenant,
            state=lambda c: list(state_to_numpy(c.resolvers[0].state)))
SIDES = (JAX, PORT)


def outcome(side, fn):
    """("ok", value) or ("err", code) of ``fn()``."""
    try:
        return ("ok", fn())
    except side.error as e:
        return ("err", e.code)


def results(rs):
    """A commit_batch's results: versions, or ("err", code)."""
    return [("err", r.code) if isinstance(r, Exception) else r for r in rs]


def muts(ms):
    """Mutations as comparable tuples."""
    return [(m.op.value, m.key, m.param) for m in ms]


def rows(storage):
    """Every row a storage holds at its version, system keys included."""
    return storage.get_range(b"", b"\xff\xff", storage.version)


def shard_map(c):
    m = c.dd.map
    return list(m.boundaries), [list(t) for t in m.teams], list(m.sizes)


def request(side, rv, sets=(), reads=(), clears=(), **kw):
    """A CommitRequest of point writes ``sets`` (key, value), point reads
    and clear ranges, each with its conflict range."""
    ms = [side.mutation(side.op.SET, k, v) for k, v in sets]
    ms += [side.mutation(side.op.CLEAR_RANGE, b, e) for b, e in clears]
    wcr = [(k, k + b"\x00") for k, _ in sets] + list(clears)
    rcr = [(k, k + b"\x00") for k in reads]
    return side.request(read_version=rv, mutations=ms,
                        read_conflict_ranges=rcr, write_conflict_ranges=wcr,
                        **kw)
