"""Mutation model + atomic operations.

Ref parity: MutationRef in fdbclient/CommitTransaction.h and the atomic-op
implementations of fdbclient (doLittleEndianAdd, doMin, doMax, doAnd,
doOr, doXor, doByteMin, doByteMax, doAppendIfFits, doCompareAndClear).
Atomics evaluate at apply time on the storage server; the client's
read-your-writes layer uses the same functions.
"""

import enum
import struct

from foundationdb_tpu_torch.core.keys import MAX_VALUE_SIZE
from foundationdb_tpu_torch.core.versions import Versionstamp


class Op(enum.Enum):
    SET = "set"
    CLEAR = "clear"  # single key
    CLEAR_RANGE = "clear_range"
    ADD = "add"
    BIT_AND = "bit_and"
    BIT_OR = "bit_or"
    BIT_XOR = "bit_xor"
    MIN = "min"
    MAX = "max"
    BYTE_MIN = "byte_min"
    BYTE_MAX = "byte_max"
    APPEND_IF_FITS = "append_if_fits"
    COMPARE_AND_CLEAR = "compare_and_clear"
    SET_VERSIONSTAMPED_KEY = "set_versionstamped_key"
    SET_VERSIONSTAMPED_VALUE = "set_versionstamped_value"


class Mutation:
    """One mutation: (op, key[, param]) or (CLEAR_RANGE, begin, end)."""

    __slots__ = ("op", "key", "param")

    def __init__(self, op, key, param=None):
        self.op = op
        self.key = key if type(key) is bytes else bytes(key)
        self.param = (param if param is None or type(param) is bytes
                      else bytes(param))

    def __repr__(self):
        return f"Mutation({self.op.value}, {self.key!r}, {self.param!r})"


def _le_int(data, width):
    """Little-endian unsigned int of ``width`` bytes (zero-padded)."""
    padded = (data or b"")[:width].ljust(width, b"\x00")
    return int.from_bytes(padded, "little")


def apply_atomic(op, old, param):
    """New value for a key given its existing value ``old`` (None =
    absent) and ``param``; None means "clear the key". The operand's
    length is the arithmetic width, as in FDB."""
    if op is Op.SET:
        return param
    if op is Op.CLEAR:
        return None
    width = len(param) if param is not None else 0
    if op is Op.ADD:
        if width == 0:
            return b""
        total = (_le_int(old, width) + _le_int(param, width)) % (1 << (8 * width))
        return total.to_bytes(width, "little")
    if op is Op.BIT_AND:
        if old is None:
            return param  # AND on an absent key stores param (doAndV2)
        return (_le_int(old, width) & _le_int(param, width)).to_bytes(width, "little")
    if op is Op.BIT_OR:
        return (_le_int(old, width) | _le_int(param, width)).to_bytes(width, "little")
    if op is Op.BIT_XOR:
        return (_le_int(old, width) ^ _le_int(param, width)).to_bytes(width, "little")
    if op is Op.MIN:
        if old is None:
            return param
        return min(_le_int(old, width), _le_int(param, width)).to_bytes(width, "little")
    if op is Op.MAX:
        if old is None:
            return param
        return max(_le_int(old, width), _le_int(param, width)).to_bytes(width, "little")
    if op is Op.BYTE_MIN:
        return param if old is None else min(old, param)
    if op is Op.BYTE_MAX:
        return param if old is None else max(old, param)
    if op is Op.APPEND_IF_FITS:
        combined = (old or b"") + (param or b"")
        return combined if len(combined) <= MAX_VALUE_SIZE else (old or b"")
    if op is Op.COMPARE_AND_CLEAR:
        return None if old == param else old
    raise ValueError(f"not an atomic value op: {op}")


def substitute_versionstamp(mutation, version, batch_order, txn_order):
    """Resolve SET_VERSIONSTAMPED_KEY/VALUE into a plain SET at commit.

    The final 4 bytes of the key (VERSIONSTAMPED_KEY) or value
    (VERSIONSTAMPED_VALUE) are the little-endian offset of the 10-byte
    placeholder (ref: transformVersionstampMutation).
    """
    stamp = Versionstamp.from_version(version, batch_order + txn_order).tr_version
    if mutation.op is Op.SET_VERSIONSTAMPED_KEY:
        data = mutation.key
        (off,) = struct.unpack("<I", data[-4:])
        if off + 10 > len(data) - 4:
            raise ValueError("versionstamp offset out of range")
        return Mutation(Op.SET, data[:off] + stamp + data[off + 10 : -4],
                        mutation.param)
    if mutation.op is Op.SET_VERSIONSTAMPED_VALUE:
        data = mutation.param
        (off,) = struct.unpack("<I", data[-4:])
        if off + 10 > len(data) - 4:
            raise ValueError("versionstamp offset out of range")
        return Mutation(Op.SET, mutation.key,
                        data[:off] + stamp + data[off + 10 : -4])
    return mutation


ATOMIC_OPS = {
    Op.ADD,
    Op.BIT_AND,
    Op.BIT_OR,
    Op.BIT_XOR,
    Op.MIN,
    Op.MAX,
    Op.BYTE_MIN,
    Op.BYTE_MAX,
    Op.APPEND_IF_FITS,
    Op.COMPARE_AND_CLEAR,
}
