"""Versions: offsets on the device, and versionstamps.

FDB versions are signed 64-bit integers advancing at ~1e6 per wall second
(ref: SERVER_KNOBS->VERSIONS_PER_SECOND). The resolver keeps them on the
device as uint32 *offsets* from a rolling host-held ``base_version``: the
5-second MVCC window spans only 5e6 versions, so 32 bits give ~70 minutes
of headroom between rebases.

A :class:`Versionstamp` is the 10-byte commit stamp (8-byte version and
2-byte order within its batch) with an optional 2-byte user suffix
(ref: fdbclient/Versionstamp.h).
"""

import struct

VERSIONS_PER_SECOND = 1_000_000
MAX_READ_TRANSACTION_LIFE_VERSIONS = 5 * VERSIONS_PER_SECOND
# Rebase the device window well before uint32 offsets can wrap.
REBASE_THRESHOLD = 1 << 30


class Versionstamp:
    """10-byte versionstamp: 8-byte commit version + 2-byte batch order,
    and a 2-byte user version after it in the tuple encoding."""

    __slots__ = ("tr_version", "user_version")

    def __init__(self, tr_version=None, user_version=0):
        if tr_version is not None and len(tr_version) != 10:
            raise ValueError("transaction versionstamp must be 10 bytes")
        self.tr_version = tr_version  # None: incomplete, filled at commit
        self.user_version = int(user_version)

    @classmethod
    def from_version(cls, version, batch_order=0, user_version=0):
        return cls(struct.pack(">qH", version, batch_order), user_version)

    @property
    def complete(self):
        return self.tr_version is not None

    def to_bytes(self):
        tr = self.tr_version if self.complete else b"\xff" * 10
        return tr + struct.pack(">H", self.user_version)

    @classmethod
    def from_bytes(cls, data):
        if len(data) != 12:
            raise ValueError("versionstamp must be 12 bytes")
        tr, user = data[:10], struct.unpack(">H", data[10:])[0]
        return cls(tr if tr != b"\xff" * 10 else None, user)

    def version(self):
        return struct.unpack(">q", self.tr_version[:8])[0] if self.complete else None

    def __eq__(self, other):
        return isinstance(other, Versionstamp) and self.to_bytes() == other.to_bytes()

    def __lt__(self, other):
        return self.to_bytes() < other.to_bytes()

    def __hash__(self):
        return hash(self.to_bytes())

    def __repr__(self):
        return f"Versionstamp({self.tr_version!r}, {self.user_version})"
