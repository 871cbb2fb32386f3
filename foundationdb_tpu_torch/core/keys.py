"""Byte keys to fixed-width uint32 limb vectors.

FoundationDB keys are byte strings ordered lexicographically. The device
resolver cannot chase pointers over variable-length strings, so keys
crossing into the conflict step are encoded as fixed-width vectors of
uint32 *limbs* plus a length limb:

    E(k) = (limb_0, ..., limb_{L-1}, len(k))        for len(k) <= 4*L

Each limb packs 4 key bytes big-endian, zero-padded, so comparing encoded
vectors lexicographically (limbs first, length last) matches byte-string
order exactly for in-capacity keys.

Keys longer than the capacity are *rounded conservatively*: lower bounds
round down to their 4L-byte prefix and upper bounds round up to the
prefix's successor. Widening a conflict range can only add false
conflicts (a spurious retry), never miss one.

Also here: the client's key model — :class:`KeyRange`,
:class:`KeySelector`, :func:`strinc`, :func:`key_successor` and the
key and value size limits (ref: fdbclient/FDBTypes.h, fdbclient/Knobs.h).
"""

import numpy as np

MAX_KEY_SIZE = 10_000  # bytes; ref: CLIENT_KNOBS->KEY_SIZE_LIMIT
MAX_VALUE_SIZE = 100_000  # ref: CLIENT_KNOBS->VALUE_SIZE_LIMIT
DEFAULT_LIMBS = 8  # 32-byte exact prefix


class KeyCodec:
    """Encodes byte keys into fixed-width uint32 limb vectors.

    ``width`` = num_limbs + 1 (trailing length limb). All encoded arrays
    have dtype uint32 and compare lexicographically elementwise.
    """

    def __init__(self, num_limbs=DEFAULT_LIMBS):
        if num_limbs < 1:
            raise ValueError(f"num_limbs must be >= 1, got {num_limbs}")
        self.num_limbs = int(num_limbs)
        self.capacity = 4 * self.num_limbs
        self.width = self.num_limbs + 1

    def _pack(self, key):
        limbs = np.zeros(self.width, dtype=np.uint32)
        data = key[: self.capacity]
        padded = data + b"\x00" * (self.capacity - len(data))
        limbs[: self.num_limbs] = np.frombuffer(padded, dtype=">u4").astype(np.uint32)
        return limbs

    def encode_lower(self, key):
        """Encode a lower (inclusive-begin) bound; rounds down if too long."""
        limbs = self._pack(key)
        limbs[-1] = min(len(key), self.capacity)
        return limbs

    def encode_upper(self, key):
        """Encode an upper (exclusive-end) bound; rounds up if too long."""
        limbs = self._pack(key)
        if len(key) <= self.capacity:
            limbs[-1] = len(key)
            return limbs
        # Successor of the 4L-byte prefix, as a 32L-bit increment.
        for i in range(self.num_limbs - 1, -1, -1):
            if limbs[i] != 0xFFFFFFFF:
                limbs[i] += np.uint32(1)
                limbs[i + 1 : self.num_limbs] = 0
                limbs[-1] = 0
                return limbs
            limbs[i] = 0
        # All-0xFF prefix: saturate above every encodable key.
        limbs[: self.num_limbs] = np.uint32(0xFFFFFFFF)
        limbs[-1] = np.uint32(self.capacity + 1)
        return limbs

    def _pack_batch(self, keys):
        """keys: list[bytes] → (uint32[n, W] with zeroed length limb,
        int64[n] true lengths), one frombuffer over the joined bytes."""
        n = len(keys)
        C, L = self.capacity, self.num_limbs
        buf = b"".join(
            [k.ljust(C, b"\x00") if len(k) <= C else k[:C] for k in keys]
        )
        out = np.zeros((n, self.width), dtype=np.uint32)
        if n:
            out[:, :L] = (
                np.frombuffer(buf, dtype=">u4").reshape(n, L).astype(np.uint32)
            )
        lens = np.fromiter(map(len, keys), dtype=np.int64, count=n)
        return out, lens

    def encode_lower_batch(self, keys):
        """Vectorized encode_lower: list[bytes] → uint32[n, W]."""
        out, lens = self._pack_batch(keys)
        out[:, -1] = np.minimum(lens, self.capacity).astype(np.uint32)
        return out

    def encode_bounds_batch(self, begins, ends):
        """Both bounds of n ranges in one packing pass → (lower[n, W],
        upper[n, W]). Only over-capacity upper bounds take the scalar
        prefix-successor fixup."""
        nb = len(begins)
        out, lens = self._pack_batch(list(begins) + list(ends))
        out[:, -1] = np.minimum(lens, self.capacity).astype(np.uint32)
        long = np.nonzero(lens[nb:] > self.capacity)[0]
        for i in long:
            out[nb + i] = self.encode_upper(ends[i])
        return out[:nb], out[nb:]


def key_successor(key):
    """Smallest key strictly greater than ``key``: key + b'\\x00'.

    Ref: keyAfter() in fdbclient/FDBTypes.h.
    """
    return bytes(key) + b"\x00"


def strinc(key):
    """Smallest key not prefixed by ``key`` (ref: strinc() in flow):
    increments the last non-0xFF byte and truncates after it."""
    key = bytes(key)
    stripped = key.rstrip(b"\xff")
    if not stripped:
        raise ValueError("strinc of all-0xFF key has no successor")
    return stripped[:-1] + bytes([stripped[-1] + 1])


class KeyRange:
    """Half-open byte-key range [begin, end). Ref: KeyRangeRef."""

    __slots__ = ("begin", "end")

    def __init__(self, begin, end):
        begin, end = bytes(begin), bytes(end)
        if begin > end:
            from foundationdb_tpu_torch.core.errors import err

            raise err("inverted_range")
        self.begin = begin
        self.end = end

    @classmethod
    def single_key(cls, key):
        return cls(key, key_successor(key))

    @classmethod
    def prefix(cls, p):
        return cls(p, strinc(p))

    def __contains__(self, key):
        return self.begin <= bytes(key) < self.end

    def intersects(self, other):
        return self.begin < other.end and other.begin < self.end

    def empty(self):
        return self.begin == self.end

    def __eq__(self, other):
        return (isinstance(other, KeyRange) and self.begin == other.begin
                and self.end == other.end)

    def __hash__(self):
        return hash((self.begin, self.end))

    def __repr__(self):
        return f"KeyRange({self.begin!r}, {self.end!r})"


class KeySelector:
    """FDB key selector, resolved against the database's key order: start
    from the last key <= (or <) ``key``, then move ``offset`` keys
    forward. Ref: KeySelectorRef and the storage server's findKey."""

    __slots__ = ("key", "or_equal", "offset")

    def __init__(self, key, or_equal, offset):
        self.key = bytes(key)
        self.or_equal = bool(or_equal)
        self.offset = int(offset)

    @classmethod
    def last_less_than(cls, key):
        return cls(key, False, 0)

    @classmethod
    def last_less_or_equal(cls, key):
        return cls(key, True, 0)

    @classmethod
    def first_greater_than(cls, key):
        return cls(key, True, 1)

    @classmethod
    def first_greater_or_equal(cls, key):
        return cls(key, False, 1)

    def __add__(self, n):
        return KeySelector(self.key, self.or_equal, self.offset + n)

    def __sub__(self, n):
        return KeySelector(self.key, self.or_equal, self.offset - n)

    def __repr__(self):
        return (f"KeySelector({self.key!r}, or_equal={self.or_equal}, "
                f"offset={self.offset})")
