"""The two packages' names for the cluster-level parity tests of
replication, the ratekeeper and the system keys
(tests/test_torch_datadistribution.py, test_torch_ratekeeper.py,
test_torch_systemkeys.py), of regions, change feeds and the layers
(test_torch_regions.py, test_torch_changefeed.py,
test_torch_layers.py) and of observability (test_torch_observability.py,
test_torch_health.py, test_torch_status.py): each test writes its script
once against a ``Side`` and runs it on the JAX package and on the port
(its cluster on ``device="cpu"``), then compares what the two returned,
at tolerance 0.
"""

import contextlib
import functools
import importlib
import time

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
from foundationdb_tpu.server import consistencyscan as jconsistencyscan
from foundationdb_tpu.server import health as jhealth
from foundationdb_tpu.utils import deviceprofile as jdeviceprofile
from foundationdb_tpu.utils import heatmap as jheatmap
from foundationdb_tpu.utils import lockdep as jlockdep
from foundationdb_tpu.utils import metrics as jmetrics
from foundationdb_tpu.utils import span as jspan
from foundationdb_tpu.utils import timeseries as jtimeseries
from foundationdb_tpu.utils import trace as jtrace
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
from foundationdb_tpu_torch.server import consistencyscan as tconsistencyscan
from foundationdb_tpu_torch.server import health as thealth
from foundationdb_tpu_torch.utils import deviceprofile as tdeviceprofile
from foundationdb_tpu_torch.utils import heatmap as theatmap
from foundationdb_tpu_torch.utils import lockdep as tlockdep
from foundationdb_tpu_torch.utils import metrics as tmetrics
from foundationdb_tpu_torch.utils import span as tspan
from foundationdb_tpu_torch.utils import timeseries as ttimeseries
from foundationdb_tpu_torch.utils import trace as ttrace


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
           metrics=jmetrics, span=jspan, heatmap=jheatmap,
           deviceprofile=jdeviceprofile, timeseries=jtimeseries,
           health=jhealth, consistencyscan=jconsistencyscan, trace=jtrace,
           lockdep=jlockdep,
           state=lambda c: [np.asarray(f) for f in c.resolvers[0].state])
PORT = Side("port", cluster=functools.partial(TCluster, device="cpu"),
            request=TRequest, error=TError, selector=TSelector,
            mutation=TMutation, op=TOp, grv=tgrv, tlog=ttlog,
            ratekeeper=TRatekeeper, sequencer=TSequencer, storage=TStorage,
            shard_map=TShardMap, dd=TDataDistributor, systemdata=tsystemdata,
            deterministic=tdeterministic, region=tregion,
            coordination=tcoordination, tuple=ttuple, subspace=tsubspace,
            directory=tdirectory, tenant=ttenant,
            metrics=tmetrics, span=tspan, heatmap=theatmap,
            deviceprofile=tdeviceprofile, timeseries=ttimeseries,
            health=thealth, consistencyscan=tconsistencyscan, trace=ttrace,
            lockdep=tlockdep,
            state=lambda c: list(state_to_numpy(c.resolvers[0].state)))
SIDES = (JAX, PORT)

# the thread-mode daemons (prober, history, scan) commit and read on
# their own schedule: a parity script that is not about them turns them
# off on both sides
QUIET = dict(health_probe_enabled=False, history_enabled=False,
             consistency_scan_enabled=False)


class StepClock:
    """A clock that stands still until ``tick`` moves it: every wall a
    script measures is 0.0, and the cadences (probe, history, scan) fire
    where the script ticks past them."""

    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def tick(self, dt=1.0):
        self.t += dt


@contextlib.contextmanager
def seeded(side, seed=7, clock=None):
    """``side``'s named streams seeded and its clock a StepClock for the
    block (its trace ring emptied first); the clock is yielded."""
    clock = clock or StepClock()
    side.deterministic.seed(seed)
    side.deterministic.set_clock(clock)
    side.trace.global_trace_log().clear()
    try:
        yield clock
    finally:
        side.deterministic.unseed()
        side.deterministic.set_clock(time.time)


def doc_diff(want, got, path=""):
    """Where two JSON-like documents differ: [(path, want, got)], keys
    missing on one side included."""
    out = []
    if isinstance(want, dict) and isinstance(got, dict):
        for k in sorted(set(want) | set(got), key=str):
            p = f"{path}/{k}"
            if k not in want or k not in got:
                out.append((p, want.get(k, "<absent>"), got.get(k, "<absent>")))
            else:
                out.extend(doc_diff(want[k], got[k], p))
    elif (isinstance(want, list) and isinstance(got, list)
          and len(want) == len(got)):
        for i, (w, g) in enumerate(zip(want, got)):
            out.extend(doc_diff(w, g, f"{path}[{i}]"))
    elif want != got:
        out.append((path, want, got))
    return out


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
