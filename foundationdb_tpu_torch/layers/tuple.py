"""Tuple layer: order-preserving encoding of typed tuples to keys.

Ref parity: the FDB tuple-encoding spec implemented by every binding
(design/tuple.md in the reference tree; bindings/python/fdb/tuple.py is
the behavioral model, re-implemented here from the wire spec). Encoded
bytes compare (as unsigned byte strings) exactly like the tuples compare
element-wise, which is what makes tuples usable as range-queryable keys.

Wire format (type code byte, then payload):
  0x00        null       (escaped as 00 FF inside nested tuples)
  0x01        bytes      payload with 00 -> 00 FF escaping, 00 terminator
  0x02        str        utf-8, same escaping/terminator
  0x05        nested     elements encoded recursively, 00 terminator
  0x0b        -bigint    length-complement byte, then complemented bytes
  0x0c..0x13  int < 0    8..1 payload bytes, value + 2^(8n) - 1 big-endian
  0x14        int == 0
  0x15..0x1c  int > 0    1..8 payload bytes, big-endian
  0x1d        +bigint    length byte, then bytes
  0x20        float32    big-endian IEEE with order-transform
  0x21        float64    big-endian IEEE with order-transform
  0x26/0x27   False/True
  0x30        UUID       16 raw bytes
  0x33        Versionstamp  12 bytes (10 txn + 2 user)
"""

import struct
import uuid as _uuid

from foundationdb_tpu_torch.core.keys import strinc
from foundationdb_tpu_torch.core.versions import Versionstamp

NULL_CODE = 0x00
BYTES_CODE = 0x01
STRING_CODE = 0x02
NESTED_CODE = 0x05
NEG_INT_START = 0x0B
INT_ZERO_CODE = 0x14
POS_INT_END = 0x1D
FLOAT_CODE = 0x20
DOUBLE_CODE = 0x21
FALSE_CODE = 0x26
TRUE_CODE = 0x27
UUID_CODE = 0x30
VERSIONSTAMP_CODE = 0x33

_size_limits = tuple((1 << (i * 8)) - 1 for i in range(9))


class SingleFloat:
    """Wrapper marking a value as 32-bit float (Python floats are doubles)."""

    __slots__ = ("value",)

    def __init__(self, value):
        self.value = struct.unpack(">f", struct.pack(">f", value))[0]

    def __eq__(self, other):
        return isinstance(other, SingleFloat) and self.value == other.value

    def __lt__(self, other):
        return self.value < other.value

    def __hash__(self):
        return hash(("SingleFloat", self.value))

    def __repr__(self):
        return f"SingleFloat({self.value})"


def _float_transform(raw, decode=False):
    """IEEE bits -> order-preserving bytes: negative numbers get all bits
    flipped, non-negative get the sign bit flipped (spec: total order incl.
    -0 < +0, and NaNs sort to the edges deterministically)."""
    if decode:
        if raw[0] & 0x80:
            return bytes(b ^ 0x80 if i == 0 else b for i, b in enumerate(raw))
        return bytes(b ^ 0xFF for b in raw)
    if raw[0] & 0x80:
        return bytes(b ^ 0xFF for b in raw)
    return bytes((raw[0] ^ 0x80,)) + raw[1:]


def _encode(value, nested=False):
    if value is None:
        return b"\x00\xff" if nested else b"\x00"
    if value is True:
        return bytes((TRUE_CODE,))
    if value is False:
        return bytes((FALSE_CODE,))
    if isinstance(value, (bytes, bytearray)):
        return bytes((BYTES_CODE,)) + bytes(value).replace(b"\x00", b"\x00\xff") + b"\x00"
    if isinstance(value, str):
        return bytes((STRING_CODE,)) + value.encode("utf-8").replace(b"\x00", b"\x00\xff") + b"\x00"
    if isinstance(value, int):
        return _encode_int(value)
    if isinstance(value, SingleFloat):
        return bytes((FLOAT_CODE,)) + _float_transform(struct.pack(">f", value.value))
    if isinstance(value, float):
        return bytes((DOUBLE_CODE,)) + _float_transform(struct.pack(">d", value))
    if isinstance(value, _uuid.UUID):
        return bytes((UUID_CODE,)) + value.bytes
    if isinstance(value, Versionstamp):
        return bytes((VERSIONSTAMP_CODE,)) + value.to_bytes()
    if isinstance(value, (tuple, list)):
        return (
            bytes((NESTED_CODE,))
            + b"".join(_encode(v, nested=True) for v in value)
            + b"\x00"
        )
    raise ValueError(f"unencodable tuple element of type {type(value).__name__}")


def _encode_int(v):
    if v == 0:
        return bytes((INT_ZERO_CODE,))
    if v > 0:
        if v > _size_limits[8]:  # bigint
            payload = v.to_bytes((v.bit_length() + 7) // 8, "big")
            if len(payload) > 255:
                raise ValueError("integer magnitude too large for tuple encoding")
            return bytes((POS_INT_END, len(payload))) + payload
        n = (v.bit_length() + 7) // 8
        return bytes((INT_ZERO_CODE + n,)) + v.to_bytes(n, "big")
    mag = -v
    if mag > _size_limits[8]:
        payload = mag.to_bytes((mag.bit_length() + 7) // 8, "big")
        if len(payload) > 255:
            raise ValueError("integer magnitude too large for tuple encoding")
        complemented = bytes(b ^ 0xFF for b in payload)
        return bytes((NEG_INT_START, len(payload) ^ 0xFF)) + complemented
    n = (mag.bit_length() + 7) // 8
    return bytes((INT_ZERO_CODE - n,)) + (v + _size_limits[n]).to_bytes(n, "big")


def _find_terminator(data, pos):
    """Index of the unescaped 0x00 terminator from ``pos``."""
    while True:
        idx = data.index(b"\x00", pos)
        if idx + 1 < len(data) and data[idx + 1] == 0xFF:
            pos = idx + 2
            continue
        return idx


def _decode(data, pos, nested=False):
    code = data[pos]
    if code == NULL_CODE:
        if nested:  # inside a nested tuple, null is 00 FF
            return None, pos + 2
        return None, pos + 1
    if code == BYTES_CODE or code == STRING_CODE:
        end = _find_terminator(data, pos + 1)
        raw = data[pos + 1 : end].replace(b"\x00\xff", b"\x00")
        return (raw if code == BYTES_CODE else raw.decode("utf-8")), end + 1
    if code == NESTED_CODE:
        out = []
        p = pos + 1
        while True:
            if data[p] == 0x00:
                if p + 1 < len(data) and data[p + 1] == 0xFF:
                    out.append(None)
                    p += 2
                    continue
                return tuple(out), p + 1
            v, p = _decode(data, p, nested=True)
            out.append(v)
    if code == NEG_INT_START:  # negative bigint
        n = data[pos + 1] ^ 0xFF
        payload = bytes(b ^ 0xFF for b in data[pos + 2 : pos + 2 + n])
        return -int.from_bytes(payload, "big"), pos + 2 + n
    if code == POS_INT_END:  # positive bigint
        n = data[pos + 1]
        return int.from_bytes(data[pos + 2 : pos + 2 + n], "big"), pos + 2 + n
    if NEG_INT_START < code < POS_INT_END:
        n = code - INT_ZERO_CODE
        if n == 0:
            return 0, pos + 1
        if n > 0:
            return int.from_bytes(data[pos + 1 : pos + 1 + n], "big"), pos + 1 + n
        n = -n
        raw = int.from_bytes(data[pos + 1 : pos + 1 + n], "big")
        return raw - _size_limits[n], pos + 1 + n
    if code == FLOAT_CODE:
        raw = _float_transform(data[pos + 1 : pos + 5], decode=True)
        return SingleFloat(struct.unpack(">f", raw)[0]), pos + 5
    if code == DOUBLE_CODE:
        raw = _float_transform(data[pos + 1 : pos + 9], decode=True)
        return struct.unpack(">d", raw)[0], pos + 9
    if code == FALSE_CODE:
        return False, pos + 1
    if code == TRUE_CODE:
        return True, pos + 1
    if code == UUID_CODE:
        return _uuid.UUID(bytes=bytes(data[pos + 1 : pos + 17])), pos + 17
    if code == VERSIONSTAMP_CODE:
        return Versionstamp.from_bytes(bytes(data[pos + 1 : pos + 13])), pos + 13
    raise ValueError(f"unknown tuple type code 0x{code:02x} at offset {pos}")


def pack(t, prefix=b""):
    """Encode tuple ``t`` to an order-preserving byte string."""
    return bytes(prefix) + b"".join(_encode(v) for v in t)


def unpack(key, prefix_len=0):
    """Decode a packed tuple (inverse of :func:`pack`)."""
    data = bytes(key)
    out = []
    pos = prefix_len
    while pos < len(data):
        v, pos = _decode(data, pos)
        out.append(v)
    return tuple(out)


def pack_with_versionstamp(t, prefix=b""):
    """Pack a tuple containing exactly one incomplete Versionstamp, with a
    4-byte little-endian offset trailer for SET_VERSIONSTAMPED_KEY.

    Ref: bindings' pack_with_versionstamp + MutationRef::SetVersionstampedKey
    (the last 4 bytes locate where the commit version is spliced in)."""
    packed = bytes(prefix)
    offset = None
    for v in t:
        if isinstance(v, Versionstamp) and not v.complete:
            if offset is not None:
                raise ValueError("tuple has multiple incomplete versionstamps")
            offset = len(packed) + 1  # skip the type code byte
        elif _contains_incomplete(v):
            raise ValueError("incomplete versionstamp in nested tuple unsupported")
        packed += _encode(v)
    if offset is None:
        raise ValueError("tuple has no incomplete versionstamp")
    return packed + struct.pack("<I", offset)


def _contains_incomplete(v):
    if isinstance(v, Versionstamp) and not v.complete:
        return True
    if isinstance(v, (tuple, list)):
        return any(_contains_incomplete(x) for x in v)
    return False


def has_incomplete_versionstamp(t):
    return _contains_incomplete(tuple(t))


def range(t, prefix=b""):  # noqa: A001 — binding-parity name
    """(begin, end) spanning all keys that are extensions of tuple ``t``."""
    p = pack(t, prefix)
    return p + b"\x00", p + b"\xff"


def range_startswith(prefix):
    prefix = bytes(prefix)
    return prefix, strinc(prefix)


def compare(a, b):
    """Tuple comparison via the encoding (total order incl. mixed types)."""
    ka, kb = pack(a), pack(b)
    return (ka > kb) - (ka < kb)
