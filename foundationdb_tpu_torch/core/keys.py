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
"""

import numpy as np

MAX_KEY_SIZE = 10_000  # bytes; ref: CLIENT_KNOBS->KEY_SIZE_LIMIT
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
