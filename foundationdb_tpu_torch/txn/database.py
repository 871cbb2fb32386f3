"""Database handle + retry loop.

Ref parity: fdbclient Database/DatabaseContext plus the Python binding's
``@fdb.transactional`` retry protocol (bindings/python/fdb/impl.py):
run the function, commit, catch retryable errors via on_error, loop.
On a cluster with a batching commit pipeline, concurrent ``run`` calls
from many threads commit in shared-version batches.
"""

from foundationdb_tpu_torch.core.errors import FDBError
from foundationdb_tpu_torch.txn.transaction import Transaction


def retry_loop(tr, fn):
    """Run ``fn(tr)`` and commit until it succeeds; ``on_error``
    re-raises what is not retryable. After a repair that replayed the op
    log verbatim (``tr.repair_ready``, txn/repair.py) the body does NOT
    run again: the restored mutations resubmit as they are, and the
    previous attempt's result is the result."""
    result = None
    while True:
        try:
            # a wrapper (a TenantTransaction) need not carry the flag
            if not getattr(tr, "repair_ready", False):
                result = fn(tr)
            tr.commit()
            return result
        except FDBError as e:
            tr.on_error(e)


class Database:
    def __init__(self, cluster):
        self._cluster = cluster

    @property
    def _knobs(self):
        return self._cluster.knobs

    def create_transaction(self):
        return Transaction(self)

    def run(self, fn):
        """Execute ``fn(tr)`` transactionally with automatic retries."""
        return retry_loop(self.create_transaction(), fn)

    transact = run

    # one-shot conveniences (binding parity: db[key] etc.)
    def get(self, key):
        return self.run(lambda tr: tr.get(key))

    def set(self, key, value):
        self.run(lambda tr: tr.set(key, value))

    def clear(self, key):
        self.run(lambda tr: tr.clear(key))

    def clear_range(self, begin, end):
        self.run(lambda tr: tr.clear_range(begin, end))

    def get_range(self, begin, end, **kw):
        return self.run(lambda tr: tr.get_range(begin, end, **kw))

    def get_range_startswith(self, prefix, **kw):
        return self.run(lambda tr: tr.get_range_startswith(prefix, **kw))

    def get_key(self, selector):
        return self.run(lambda tr: tr.get_key(selector))

    def watch(self, key):
        out = {}

        def _w(tr):
            out["w"] = tr.watch(key)

        self.run(_w)
        return out["w"]

    def add(self, key, param):
        self.run(lambda tr: tr.add(key, param))

    def __getitem__(self, key):
        if isinstance(key, slice):
            return self.get_range(key.start, key.stop)
        return self.get(key)

    def __setitem__(self, key, value):
        self.set(key, value)

    def __delitem__(self, key):
        if isinstance(key, slice):
            self.clear_range(key.start, key.stop)
        else:
            self.clear(key)

    def open_tenant(self, name):
        from foundationdb_tpu_torch.layers.tenant import Tenant

        return Tenant(self, name)

    # ── change feeds (ref: getChangeFeedStream / the change feed API) ──
    def register_change_feed(self, feed_id, begin, end):
        """Subscribe ``feed_id`` to every committed mutation touching
        [begin, end), streamed in commit-version order."""
        self._cluster.change_feeds.register(
            bytes(feed_id), bytes(begin), bytes(end))

    def read_change_feed(self, feed_id, begin_version, end_version=None,
                         limit=0):
        """[(version, [Mutation])] with begin_version < v <= end_version;
        transaction_too_old (1007) below the popped or trimmed frontier."""
        return self._cluster.change_feeds.read(
            bytes(feed_id), begin_version, end_version, limit)

    def pop_change_feed(self, feed_id, version):
        self._cluster.change_feeds.pop(bytes(feed_id), version)

    def deregister_change_feed(self, feed_id):
        self._cluster.change_feeds.deregister(bytes(feed_id))

    def status(self):
        return self._cluster.status()
