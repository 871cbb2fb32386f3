"""foundationdb_tpu_torch — FoundationDB's in-process database on PyTorch
and CUDA.

The PyTorch port of ``foundationdb_tpu``: the conflict-detection step of
the Resolver runs on an NVIDIA card with the two Pallas TPU kernels
rewritten by hand in CUDA C++ for Hopper (``csrc/``), the same verdicts
bit for bit; around it, the sequencer, GRV and commit proxies, the log,
storage and client transactions of the in-process cluster, with the
batching commit pipeline that forms shared-version batches from
concurrent clients (``commit_pipeline="thread"``), a fleet of resolver
lanes on one card (``n_resolvers=k``), client-side transaction repair
(``txn_repair``, on by default), the native host code (the g++-built
batch packer and the C++ conflict set of ``resolver_backend="native"``),
durability and recovery (write-ahead logs replicated with ``n_tlogs``,
disk storage engines, the coordinators' generation and the
transaction-system recovery of ``Cluster.detect_and_recruit``), and the
cluster's controls: several storage servers with ``replication``
copies of each shard, data distribution and the storage router, the
ratekeeper's admission with tag quotas, the database lock and
idempotency ids; multi-region replication (``regions=``: a sync or
async satellite log in a remote region and its failover on the card),
live ``Cluster.configure`` resizes of the proxies and resolvers, change
feeds, and the tuple, subspace, directory and tenant layers
(``foundationdb_tpu_torch.layers``). The package imports ``torch`` and numpy only and keeps
its own copy of every module it needs.

Entry points: :func:`open` returns a Database whose resolver runs on
``cuda:0`` (``device="cpu"`` runs it on the CPU);
:class:`foundationdb_tpu_torch.server.cluster.Cluster` is the cluster
behind it; :class:`foundationdb_tpu_torch.resolver.resolver.Resolver`
the resolver alone. Without a card and without ``device="cpu"`` they
raise.
"""

import functools

from foundationdb_tpu_torch.core.errors import FDBError
from foundationdb_tpu_torch.core.keys import KeyRange, KeySelector, key_successor, strinc

__version__ = "0.2.0"
__all__ = ["FDBError", "KeyRange", "KeySelector", "key_successor", "open",
           "strinc", "transactional"]


def open(cluster_file=None, **kw):
    """Open a database and return a Database handle (ref parity:
    fdb.open() in bindings/python/fdb/__init__.py). The cluster runs
    in-process: every keyword goes to
    :class:`~foundationdb_tpu_torch.server.cluster.Cluster` (``device``,
    ``commit_pipeline``, ``n_resolvers``, the placement arguments
    ``n_storage`` and ``replication``, the ratekeeper's ``target_tps``
    and ``rk_clock``, the durability arguments ``wal_path``,
    ``n_tlogs``, ``storage_engines``, ``fsync`` and
    ``coordination_dir``, and ``regions``, a region config such as
    ``{"primary": "east", "remote": "west", "satellites": 1,
    "satellite_mode": "sync"}``) or, if it is none of those, to the
    Knobs."""
    if cluster_file is not None:
        raise NotImplementedError(
            "cluster_file: the RPC client is not ported; open() runs the "
            "cluster in-process")
    from foundationdb_tpu_torch.server.cluster import Cluster

    return Cluster(**kw).database()


def transactional(func):
    """Decorator: run ``func(tr, ...)`` in a retry loop, or directly when
    given a Transaction (ref parity: @fdb.transactional)."""

    @functools.wraps(func)
    def wrapper(db_or_tr, *args, **kwargs):
        from foundationdb_tpu_torch.txn.transaction import Transaction

        if isinstance(db_or_tr, Transaction):
            return func(db_or_tr, *args, **kwargs)
        return db_or_tr.run(lambda tr: func(tr, *args, **kwargs))

    return wrapper
