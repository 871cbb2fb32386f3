"""Write map: a transaction's uncommitted writes, for read-your-writes.

Ref parity: the WriteMap inside fdbclient/ReadYourWrites.actor.cpp /
RYWIterator — tracks sets, clears (point + range), and pending atomic op
chains in sequence order, and answers "what would this key/range look
like if my writes were applied over the snapshot".
"""

from foundationdb_tpu_torch.core.mutations import Op, apply_atomic


class _Entry:
    __slots__ = ("seq", "ops", "base_cleared")

    def __init__(self, seq, ops, base_cleared):
        self.seq = seq
        self.ops = ops  # list[(Op, param)], applied in order over base
        self.base_cleared = base_cleared

    @property
    def independent(self):
        """True if the chain's result doesn't depend on the snapshot value."""
        return self.base_cleared or (self.ops and self.ops[0][0] is Op.SET)


class WriteMap:
    def __init__(self):
        # plain dict: transactions write a handful of keys, and the only
        # ordered consumers (clear_range shadowing, overlay_range merges)
        # sort on demand — measurably cheaper per-transaction than a
        # SortedDict, which costs ~30us just to construct (the commit
        # pipeline creates one WriteMap per txn at >100k txns/sec)
        self._writes = {}  # key -> _Entry
        self._clears = []  # [(seq, begin, end)]
        self._seq = 0

    def _keys_in(self, begin, end):
        return sorted(k for k in self._writes if begin <= k < end)

    def _next_seq(self):
        self._seq += 1
        return self._seq

    def _covered_by_clear(self, key):
        return any(b <= key < e for _, b, e in self._clears)

    # ───────────────────────── mutations ──────────────────────────────
    def set(self, key, value):
        seq = self._next_seq()
        self._writes[key] = _Entry(seq, [(Op.SET, value)], base_cleared=False)
        return seq

    def clear(self, key):
        seq = self._next_seq()
        self._writes[key] = _Entry(seq, [(Op.CLEAR, None)], base_cleared=True)
        return seq

    def clear_range(self, begin, end):
        seq = self._next_seq()
        self._clears.append((seq, begin, end))
        for k in self._keys_in(begin, end):
            self._writes[k] = _Entry(seq, [(Op.CLEAR, None)], base_cleared=True)
        return seq

    def atomic(self, op, key, param):
        seq = self._next_seq()
        entry = self._writes.get(key)
        if entry is None:
            entry = _Entry(seq, [], base_cleared=self._covered_by_clear(key))
            self._writes[key] = entry
        entry.seq = seq
        entry.ops.append((op, param))
        return seq

    # ─────────────────────────── reads ────────────────────────────────
    def lookup(self, key):
        """→ (known, needs_base, entry_or_None).

        known=True: this map fully determines the value (maybe via a base
        read — needs_base says whether the caller must supply the
        snapshot value to fold the atomic chain)."""
        e = self._writes.get(key)
        if e is not None:
            return True, not e.independent, e
        if self._covered_by_clear(key):
            return True, False, None
        return False, False, None

    def fold(self, entry, base):
        if entry is None:
            return None
        val = None if entry.base_cleared else base
        for op, param in entry.ops:
            val = apply_atomic(op, val, param)
        return val

    def overlay_range(self, begin, end):
        """Iterate written keys in [begin, end) → (key, entry)."""
        for k in self._keys_in(begin, end):
            yield k, self._writes[k]

    def cleared_in(self, begin, end):
        """Clear ranges intersecting [begin, end)."""
        return [(b, e) for _, b, e in self._clears if b < end and begin < e]

    def is_cleared(self, key, after_seq=0):
        return any(b <= key < e and s > after_seq for s, b, e in self._clears)

    @property
    def empty(self):
        return not self._writes and not self._clears
