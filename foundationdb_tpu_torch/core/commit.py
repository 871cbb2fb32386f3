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
                 "flat_conflicts")

    def __init__(self, read_version, mutations, read_conflict_ranges,
                 write_conflict_ranges, report_conflicting_keys=False,
                 flat_conflicts=None):
        # None: a read-free txn; the proxy assigns its read version
        self.read_version = read_version
        self.mutations = mutations
        self._read_conflict_ranges = read_conflict_ranges  # [(begin, end)]
        self._write_conflict_ranges = write_conflict_ranges
        self.report_conflicting_keys = report_conflicting_keys
        self.flat_conflicts = flat_conflicts

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
