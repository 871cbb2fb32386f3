"""Subspace layer: a fixed key prefix + tuple-encoded suffixes.

Ref parity: bindings/python/fdb/subspace_impl.py behavior — a Subspace
scopes tuple keys under a raw prefix; sub[x] nests, range() spans the
contents, contains/unpack invert.
"""

from foundationdb_tpu_torch.layers import tuple as fdbtuple


class Subspace:
    def __init__(self, prefix_tuple=(), raw_prefix=b""):
        self.raw_prefix = bytes(raw_prefix) + fdbtuple.pack(tuple(prefix_tuple))

    def key(self):
        return self.raw_prefix

    def pack(self, t=()):
        return fdbtuple.pack(tuple(t), prefix=self.raw_prefix)

    def pack_with_versionstamp(self, t):
        return fdbtuple.pack_with_versionstamp(tuple(t), prefix=self.raw_prefix)

    def unpack(self, key):
        key = bytes(key)
        if not self.contains(key):
            raise ValueError("key is not in subspace")
        return fdbtuple.unpack(key, prefix_len=len(self.raw_prefix))

    def range(self, t=()):
        return fdbtuple.range(tuple(t), prefix=self.raw_prefix)

    def contains(self, key):
        return bytes(key).startswith(self.raw_prefix)

    def as_foundationdb_key(self):
        return self.raw_prefix

    def subspace(self, t):
        return Subspace(tuple(t), self.raw_prefix)

    def __getitem__(self, item):
        return Subspace((item,), self.raw_prefix)

    def __eq__(self, other):
        return isinstance(other, Subspace) and self.raw_prefix == other.raw_prefix

    def __hash__(self):
        return hash(self.raw_prefix)

    def __repr__(self):
        return f"Subspace(raw_prefix={self.raw_prefix!r})"
