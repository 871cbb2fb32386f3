"""Directory layer: a filesystem-like hierarchy of short key prefixes.

Ref parity: bindings/python/fdb/directory_impl.py behavior, rebuilt from
the design doc (design/directory.md): a tree of named directories stored
in the node subspace (default ``\\xfe``), each assigned a short content
prefix by a windowed high-contention allocator (HCA); create/open/move/
remove/list with layer tags.

Metadata schema (all under node_subspace):
  node(prefix)[b'layer']        = layer tag bytes
  node(prefix)[SUBDIRS][name]   = child's content prefix
  root[b'version']              = struct <III (major, minor, micro)
  root[b'hca'][counters][w]     = allocation count in window starting w
  root[b'hca'][recent][c]       = candidate c claimed
"""

import struct

from foundationdb_tpu_torch.core import deterministic
from foundationdb_tpu_torch.core.keys import strinc
from foundationdb_tpu_torch.layers import tuple as fdbtuple
from foundationdb_tpu_torch.layers.subspace import Subspace

SUBDIRS = 0
VERSION = (1, 0, 0)


class HighContentionAllocator:
    """Windowed prefix allocator (ref: HCA in directory_impl.py).

    Counters track how many allocations each window start has seen; when a
    window is half-full the start advances. Candidates are drawn uniformly
    from the current window and claimed with a conflict-checked write, so
    concurrent allocators collide with probability ~count/window and
    retry cheaply — the OCC conflict detector is the mutex.
    """

    def __init__(self, subspace: Subspace):
        self.counters = subspace[0]
        self.recent = subspace[1]
        # candidate draws come from the injected stream: a seeded run
        # allocates identical prefixes run after run (the HCA's window
        # draws are cluster-visible state), production stays OS-random
        self._rng = deterministic.rng("directory-hca")

    def allocate(self, tr):
        while True:
            start = 0
            kvs = tr.snapshot.get_range(*self.counters.range(), limit=1, reverse=True)
            if kvs:
                start = self.counters.unpack(kvs[0][0])[0]
            window_advanced = False
            while True:
                if window_advanced:
                    tr.clear_range(self.counters.key(), self.counters.pack((start,)))
                    tr.options.set_next_write_no_write_conflict_range()
                    tr.clear_range(self.recent.key(), self.recent.pack((start,)))
                tr.add(self.counters.pack((start,)), struct.pack("<q", 1))
                raw = tr.snapshot.get(self.counters.pack((start,)))
                count = struct.unpack("<q", raw)[0] if raw else 0
                window = self._window_size(start)
                if count * 2 < window:
                    break
                start += window
                window_advanced = True
            while True:
                candidate = start + self._rng.randrange(self._window_size(start))
                key = self.recent.pack((candidate,))
                # restart if another allocator advanced the window under us
                kvs = tr.snapshot.get_range(*self.counters.range(), limit=1, reverse=True)
                latest = self.counters.unpack(kvs[0][0])[0] if kvs else 0
                if latest > start:
                    break
                # conflicting read: two allocators claiming the same
                # candidate must OCC-conflict (one's write hits the
                # other's read) — a snapshot read here would let both
                # commit the same prefix
                if tr.get(key) is None:
                    tr.set(key, b"")
                    return fdbtuple.pack((candidate,))

    @staticmethod
    def _window_size(start):
        if start < 255:
            return 64
        if start < 65535:
            return 1024
        return 8192


class Directory:
    """A node in the directory hierarchy (shared impl of layer + subspace)."""

    def __init__(self, directory_layer, path=(), layer=b""):
        self._directory_layer = directory_layer
        self._path = tuple(path)
        self._layer = layer

    def get_path(self):
        return self._path

    def get_layer(self):
        return self._layer

    def _partition_and_rel(self, path):
        return self._directory_layer, self._path + _to_path(path)

    def create_or_open(self, tr, path, layer=None):
        dl, p = self._partition_and_rel(path)
        return dl.create_or_open(tr, p, layer)

    def open(self, tr, path, layer=None):
        dl, p = self._partition_and_rel(path)
        return dl.open(tr, p, layer)

    def create(self, tr, path, layer=None, prefix=None):
        dl, p = self._partition_and_rel(path)
        return dl.create(tr, p, layer, prefix)

    def list(self, tr, path=()):
        dl, p = self._partition_and_rel(path)
        return dl.list(tr, p)

    def move(self, tr, old_path, new_path):
        dl, _ = self._partition_and_rel(())
        return dl.move(tr, self._path + _to_path(old_path), self._path + _to_path(new_path))

    def move_to(self, tr, new_absolute_path):
        return self._directory_layer.move(tr, self._path, _to_path(new_absolute_path))

    def remove(self, tr, path=()):
        dl, p = self._partition_and_rel(path)
        return dl.remove(tr, p)

    def remove_if_exists(self, tr, path=()):
        dl, p = self._partition_and_rel(path)
        return dl.remove_if_exists(tr, p)

    def exists(self, tr, path=()):
        dl, p = self._partition_and_rel(path)
        return dl.exists(tr, p)


class DirectorySubspace(Directory, Subspace):
    """An opened directory: a Subspace over its content prefix plus the
    Directory navigation methods."""

    def __init__(self, path, prefix, directory_layer, layer=b""):
        Directory.__init__(self, directory_layer, path, layer)
        Subspace.__init__(self, (), prefix)

    def __repr__(self):
        return f"DirectorySubspace(path={self._path}, prefix={self.raw_prefix!r})"


PARTITION_LAYER = b"partition"


class DirectoryPartition(Directory):
    """A directory whose contents are an ISOLATED directory hierarchy.

    Ref parity: DirectoryPartition in bindings/python/fdb/directory_impl.py
    — created with ``layer=b"partition"``, it owns a child DirectoryLayer
    whose node subspace lives inside the partition's prefix
    (``prefix + \\xfe``), so the whole subtree (metadata AND contents) can
    be moved or removed as one unit from the parent hierarchy. Paths
    opened through the partition are RELATIVE to it and allocate from its
    own HCA; operations on the partition itself (exists/remove/move_to)
    route to the parent hierarchy. A partition is deliberately NOT a
    subspace — keys must live in directories created inside it.
    """

    def __init__(self, path, prefix, parent_layer):
        prefix = bytes(prefix)
        child = DirectoryLayer(
            node_subspace=Subspace(raw_prefix=prefix + b"\xfe"),
            content_subspace=Subspace(raw_prefix=prefix),
        )
        Directory.__init__(self, child, path, PARTITION_LAYER)
        self._parent_layer = parent_layer
        self.raw_prefix = prefix  # introspection only; packing is blocked

    def __repr__(self):
        return f"DirectoryPartition(path={self._path}, prefix={self.raw_prefix!r})"

    def _partition_and_rel(self, path):
        # contents operations (create/open/list) are relative to the
        # partition's own hierarchy — its root is the child layer's root
        return self._directory_layer, _to_path(path)

    def _self_or_rel(self, path):
        """exists/remove on an empty path target the partition ITSELF —
        a node of the PARENT hierarchy; deeper paths are child-relative."""
        p = _to_path(path)
        if not p:
            return self._parent_layer, self._path
        return self._directory_layer, p

    def exists(self, tr, path=()):
        dl, p = self._self_or_rel(path)
        return dl.exists(tr, p)

    def remove(self, tr, path=()):
        dl, p = self._self_or_rel(path)
        return dl.remove(tr, p)

    def remove_if_exists(self, tr, path=()):
        dl, p = self._self_or_rel(path)
        return dl.remove_if_exists(tr, p)

    def move(self, tr, old_path, new_path):
        # moves are within the partition's own hierarchy, relative paths
        return self._directory_layer.move(
            tr, _to_path(old_path), _to_path(new_path)
        )

    def move_to(self, tr, new_path_in_parent):
        """Relocate the partition itself within its PARENT hierarchy —
        the path is relative to the hierarchy the partition lives in
        (for a top-level partition that is the root layer; for a nested
        one, the enclosing partition). A partition can never move into a
        different hierarchy: its content prefix is a byte range of the
        parent's allocator."""
        return self._parent_layer.move(
            tr, self._path, _to_path(new_path_in_parent)
        )

    # ── a partition is not a content subspace (ref: the bindings raise) ──
    def _no_subspace(self, *_a, **_k):
        raise ValueError(
            "cannot open a key subspace in the root of a directory "
            "partition — create a directory inside it"
        )

    key = pack = unpack = range = contains = subspace = _no_subspace
    __getitem__ = _no_subspace


def _to_path(path):
    if isinstance(path, str):
        return (path,)
    return tuple(path)


class DirectoryLayer(Directory):
    def __init__(self, node_subspace=None, content_subspace=None, allow_manual_prefixes=False):
        Directory.__init__(self, self)
        self._node_subspace = node_subspace or Subspace(raw_prefix=b"\xfe")
        self._content_subspace = content_subspace or Subspace()
        self._allow_manual_prefixes = allow_manual_prefixes
        self._root_node = self._node_subspace[self._node_subspace.key()]
        self._allocator = HighContentionAllocator(self._root_node[b"hca"])

    # ────────────────────────── node helpers ───────────────────────────
    def _node_with_prefix(self, prefix):
        return self._node_subspace[bytes(prefix)]

    def _node_containing_key(self, tr, key):
        """Deepest existing directory whose content prefix contains key."""
        if key.startswith(self._node_subspace.key()):
            return self._root_node
        begin, _ = self._node_subspace.range(())
        kvs = tr.get_range(
            begin, self._node_subspace.pack((key,)) + b"\x00", limit=1, reverse=True
        )
        if kvs:
            prev_prefix = self._node_subspace.unpack(kvs[0][0])[0]
            if key.startswith(prev_prefix):
                return self._node_with_prefix(prev_prefix)
        return None

    def _find(self, tr, path):
        node = self._root_node
        for name in path:
            prefix = tr.get(node[SUBDIRS].pack((name,)))
            if prefix is None:
                return None
            node = self._node_with_prefix(prefix)
        return node

    def _route(self, tr, path):
        """Longest-prefix partition routing (ref: the bindings routing
        every operation through the deepest partition on its path): a
        path that TRAVERSES a partition delegates the remainder to the
        partition's own directory layer, whose metadata lives inside the
        partition prefix and is invisible to this layer's _find. Returns
        (directory_layer, relative_path); (self, path) when no partition
        is crossed. The final path element itself being a partition does
        NOT reroute — operations on the partition node (open/exists/
        remove/move of the partition) belong to THIS hierarchy."""
        node = self._root_node
        for i, name in enumerate(path[:-1]):
            prefix = tr.get(node[SUBDIRS].pack((name,)))
            if prefix is None:
                return self, path  # let the caller raise not-exists
            node = self._node_with_prefix(prefix)
            if (tr.get(node.pack((b"layer",))) or b"") == PARTITION_LAYER:
                part = self._contents_of_node(
                    node, path[: i + 1], PARTITION_LAYER
                )
                return part._directory_layer._route(tr, path[i + 1:])
        return self, path

    def _contents_of_node(self, node, path, layer=b""):
        prefix = self._node_subspace.unpack(node.key())[0]
        if layer == PARTITION_LAYER:
            return DirectoryPartition(path, prefix, self)
        return DirectorySubspace(path, prefix, self, layer)

    def _check_version(self, tr, write):
        raw = tr.get(self._root_node.pack((b"version",)))
        if raw is None:
            if write:
                tr.set(self._root_node.pack((b"version",)), struct.pack("<III", *VERSION))
            return
        major, _, _ = struct.unpack("<III", raw)
        if major > VERSION[0]:
            raise ValueError("directory layer written in a newer format version")

    # ─────────────────────────── operations ────────────────────────────
    def create_or_open(self, tr, path, layer=None):
        return self._create_or_open(tr, _to_path(path), layer, allow_open=True, allow_create=True)

    def open(self, tr, path, layer=None):
        return self._create_or_open(tr, _to_path(path), layer, allow_open=True, allow_create=False)

    def create(self, tr, path, layer=None, prefix=None):
        return self._create_or_open(
            tr, _to_path(path), layer, prefix=prefix, allow_open=False, allow_create=True
        )

    def _create_or_open(self, tr, path, layer, prefix=None, allow_open=True, allow_create=True):
        dl, rel = self._route(tr, path)
        if dl is not self:
            return dl._create_or_open(
                tr, rel, layer, prefix=prefix,
                allow_open=allow_open, allow_create=allow_create,
            )
        self._check_version(tr, write=False)
        if prefix is not None and not self._allow_manual_prefixes:
            raise ValueError("manual prefixes are not enabled on this DirectoryLayer")
        if not path:
            raise ValueError("the root directory cannot be opened")
        layer = layer or b""

        existing = self._find(tr, path)
        if existing is not None:
            if not allow_open:
                raise ValueError("the directory already exists")
            stored = tr.get(existing.pack((b"layer",))) or b""
            if layer and stored != layer:
                raise ValueError(
                    f"directory was created with incompatible layer {stored!r}"
                )
            return self._contents_of_node(existing, path, stored)

        if not allow_create:
            raise ValueError("the directory does not exist")
        self._check_version(tr, write=True)

        if prefix is None:
            prefix = self._content_subspace.key() + self._allocator.allocate(tr)
            if tr.get_range_startswith(prefix, limit=1):
                raise ValueError("the allocated prefix is not empty")
        if not self._is_prefix_free(tr, prefix):
            raise ValueError("the given prefix is already in use")

        if len(path) > 1:
            parent = self._create_or_open(tr, path[:-1], None)
            parent_node = self._node_with_prefix(parent.key())
        else:
            parent_node = self._root_node
        node = self._node_with_prefix(prefix)
        tr.set(parent_node[SUBDIRS].pack((path[-1],)), prefix)
        tr.set(node.pack((b"layer",)), layer)
        return self._contents_of_node(node, path, layer)

    def _is_prefix_free(self, tr, prefix):
        if not prefix:
            return False
        if self._node_containing_key(tr, prefix) is not None:
            return False
        begin = self._node_subspace.pack((prefix,))
        end = self._node_subspace.pack((strinc(prefix),))
        return not tr.get_range(begin, end, limit=1)

    def list(self, tr, path=()):
        self._check_version(tr, write=False)
        path = _to_path(path)
        dl, rel = self._route(tr, path)
        if dl is not self:
            return dl.list(tr, rel)
        node = self._find(tr, path)
        if node is None:
            raise ValueError("the directory does not exist")
        if path and (tr.get(node.pack((b"layer",))) or b"") == PARTITION_LAYER:
            # listing a partition's path lists its CONTENTS (child root)
            return self._contents_of_node(
                node, path, PARTITION_LAYER
            )._directory_layer.list(tr, ())
        sub = node[SUBDIRS]
        return [sub.unpack(k)[0] for k, _ in tr.get_range(*sub.range())]

    def exists(self, tr, path=()):
        self._check_version(tr, write=False)
        path = _to_path(path)
        dl, rel = self._route(tr, path)
        if dl is not self:
            return dl.exists(tr, rel)
        return self._find(tr, path) is not None

    def move(self, tr, old_path, new_path):
        self._check_version(tr, write=True)
        old_path, new_path = _to_path(old_path), _to_path(new_path)
        old_dl, old_rel = self._route(tr, old_path)
        new_dl, new_rel = self._route(tr, new_path)
        # routing builds fresh layer objects, so hierarchies compare by
        # their node-subspace prefix, not identity
        if old_dl._node_subspace.raw_prefix != new_dl._node_subspace.raw_prefix:
            # ref: the bindings refuse moves between partitions (the
            # content prefix cannot leave the partition's byte range)
            raise ValueError("cannot move between directory partitions")
        if old_dl is not self:
            return old_dl.move(tr, old_rel, new_rel)
        if new_path[: len(old_path)] == old_path:
            raise ValueError("cannot move a directory under itself")
        old_node = self._find(tr, old_path)
        if old_node is None:
            raise ValueError("the directory does not exist")
        if self._find(tr, new_path) is not None:
            raise ValueError("the directory already exists")
        parent_node = self._find(tr, new_path[:-1]) if len(new_path) > 1 else self._root_node
        if parent_node is None:
            raise ValueError("the directory does not exist")
        prefix = self._node_subspace.unpack(old_node.key())[0]
        tr.set(parent_node[SUBDIRS].pack((new_path[-1],)), prefix)
        self._remove_from_parent(tr, old_path)
        layer = tr.get(old_node.pack((b"layer",))) or b""
        return self._contents_of_node(old_node, new_path, layer)

    def remove(self, tr, path=()):
        if not self.remove_if_exists(tr, path):
            raise ValueError("the directory does not exist")
        return True

    def remove_if_exists(self, tr, path=()):
        self._check_version(tr, write=True)
        path = _to_path(path)
        if not path:
            raise ValueError("the root directory cannot be removed")
        dl, rel = self._route(tr, path)
        if dl is not self:
            return dl.remove_if_exists(tr, rel)
        node = self._find(tr, path)
        if node is None:
            return False
        self._remove_recursive(tr, node)
        self._remove_from_parent(tr, path)
        return True

    def _remove_recursive(self, tr, node):
        sub = node[SUBDIRS]
        for _, child_prefix in tr.get_range(*sub.range()):
            self._remove_recursive(tr, self._node_with_prefix(child_prefix))
        prefix = self._node_subspace.unpack(node.key())[0]
        tr.clear_range(prefix, strinc(prefix))  # contents
        b, e = self._node_subspace.range((prefix,))
        tr.clear_range(b, e)  # metadata
        tr.clear(self._node_subspace.pack((prefix,)))

    def _remove_from_parent(self, tr, path):
        parent = self._find(tr, path[:-1]) if len(path) > 1 else self._root_node
        tr.clear(parent[SUBDIRS].pack((path[-1],)))


directory = DirectoryLayer()
