"""CommitRequest — what a client sends at commit.

Ref parity: CommitTransactionRequest (fdbclient/CommitTransaction.h).

``flat_conflicts`` (core/flatpack.py) is the columnar form of the
conflict ranges: the client pre-encodes them into limb-entry blobs, and
the proxy and packer consume the blobs directly. A request may carry
only that form; the byte-pair range lists are then rebuilt lazily
(``_from_flat``), exactly, since the flat form exists only for
in-capacity keys.
"""

from foundationdb_tpu_torch.core import flatpack


class CommitRequest:
    __slots__ = ("read_version", "mutations", "_read_conflict_ranges",
                 "_write_conflict_ranges", "report_conflicting_keys",
                 "lock_aware", "idempotency_id", "flat_conflicts", "tags")

    def __init__(self, read_version, mutations, read_conflict_ranges,
                 write_conflict_ranges, report_conflicting_keys=False,
                 lock_aware=False, idempotency_id=None,
                 flat_conflicts=None, tags=()):
        # None: a read-free txn; the proxy assigns its read version
        self.read_version = read_version
        self.mutations = mutations
        self._read_conflict_ranges = read_conflict_ranges  # [(begin, end)]
        self._write_conflict_ranges = write_conflict_ranges
        self.report_conflicting_keys = report_conflicting_keys
        # ref: the LOCK_AWARE option: commits while the database is locked
        self.lock_aware = lock_aware
        # ref: IdempotencyId: a client token the proxy records with the
        # commit and dedupes on, so a retry after 1021 cannot apply twice
        self.idempotency_id = idempotency_id
        self.flat_conflicts = flat_conflicts
        # the client's set_tag() labels (ref: TransactionTagRef)
        self.tags = tuple(tags) if tags else ()

    @property
    def read_conflict_ranges(self):
        r = self._read_conflict_ranges
        if r is None:
            r = self._read_conflict_ranges = self._from_flat("read")
        return r

    @read_conflict_ranges.setter
    def read_conflict_ranges(self, v):
        self._read_conflict_ranges = v

    @property
    def write_conflict_ranges(self):
        w = self._write_conflict_ranges
        if w is None:
            w = self._write_conflict_ranges = self._from_flat("write")
        return w

    @write_conflict_ranges.setter
    def write_conflict_ranges(self, v):
        self._write_conflict_ranges = v

    def _from_flat(self, side):
        """Rebuild a byte-pair range list from the columnar form (points
        first; the resolver is order-independent within a txn)."""
        f = self.flat_conflicts
        if f is None:
            return []
        if side == "read":
            return flatpack.decode_side(
                f.read_point_blob, f.read_range_blob, f.num_limbs)
        return flatpack.decode_side(
            f.write_point_blob, f.write_range_blob, f.num_limbs)
