"""The benchmark's traffic: YCSB's data model and request distributions,
and a pool of commit batches drawn from ``--seed``.

One general generator reads every mix file (``mixes/<mix>.json``). A
mix lists the conflict ranges of one committing transaction as ops,
each a read or a write, a point or a range of ``span`` consecutive keys
(in key order), over a key drawn by the mix's request distribution;
ops that name the same draw share its key. Read-only transactions
never reach a resolver, so every transaction of a mix writes.

Keys follow YCSB's ``CoreWorkload`` under its default
``insertorder=hashed``: record ``n`` is named ``user`` followed by the
decimal FNV-1a-64 hash of ``n``. Request distributions follow YCSB's
generator: ``zipfian``, the one a mix may name, is
``ScrambledZipfianGenerator`` (a Zipfian over 10^10 items at YCSB's
constant theta 0.99, hashed onto the records, so hot records lie apart
in key order).

Every conflict range is a run of key ranks ``[lo, hi)``: a point is
``[r, r + 1)``, and a range of ``span`` keys from rank ``r`` is the
byte range ``[key[r], key[r + span])``. The pool carries both the flat
blobs the program reads (``core/flatpack.py``'s entries: the key padded
to ``4 * key_limbs`` bytes and its big-endian length) and the rank runs
the reference reads. Plain numpy; nothing of the program is imported.
"""

import numpy as np

FNV_OFFSET_BASIS_64 = np.uint64(0xCBF29CE484222325)
FNV_PRIME_64 = np.uint64(1099511628211)
# ScrambledZipfianGenerator: a Zipfian over ITEM_COUNT items at the
# default constant, whose zeta YCSB precomputes as ZETAN
SCRAMBLED_ITEM_COUNT = 10_000_000_000
SCRAMBLED_THETA = 0.99
SCRAMBLED_ZETAN = 26.46902820178302
SIDES = ("read", "write")
SHAPES = ("point", "range")
# the flat batch's four blobs, by (side, shape)
BLOBS = {("read", "point"): "pr", ("write", "point"): "pw",
         ("read", "range"): "rr", ("write", "range"): "rw"}


def fnvhash64(values):
    """YCSB's ``Utils.fnvhash64`` over int64[n] non-negative values:
    FNV-1a over the eight low-first bytes, then ``Math.abs``."""
    v = np.asarray(values, dtype=np.int64).astype(np.uint64)
    h = np.full(v.shape, FNV_OFFSET_BASIS_64, dtype=np.uint64)
    for _ in range(8):
        h ^= v & np.uint64(0xFF)
        v >>= np.uint64(8)
        h *= FNV_PRIME_64
    return np.abs(h.view(np.int64))


def key_names(record_count):
    """The YCSB key of each record number, as bytes."""
    return [b"user%d" % h for h in fnvhash64(np.arange(record_count)).tolist()]


class KeySpace:
    """The records' keys in key order: ``rank_of[n]`` is record n's rank,
    and ``entries[r]`` the flat entry of the key of rank r."""

    def __init__(self, record_count, key_limbs):
        names = np.array(key_names(record_count))
        width = 4 * key_limbs
        if names.dtype.itemsize > width:
            raise ValueError(f"a key of {names.dtype.itemsize} bytes exceeds "
                             f"the {width}-byte flat entry")
        order = np.argsort(names, kind="stable")
        self.record_count = record_count
        self.rank_of = np.empty(record_count, dtype=np.int64)
        self.rank_of[order] = np.arange(record_count)
        self.sorted_names = names[order]
        lens = np.char.str_len(self.sorted_names).astype(">u4")
        ent = np.zeros((record_count, width + 4), dtype=np.uint8)
        ent[:, :width] = np.frombuffer(
            self.sorted_names.astype(f"S{width}").tobytes(),
            dtype=np.uint8).reshape(record_count, width)
        ent[:, width:] = lens.view(np.uint8).reshape(record_count, 4)
        self.entries = ent

    def key(self, rank):
        return bytes(self.sorted_names[rank])


def scrambled_zipfian(rng, n, item_count):
    """``n`` draws of YCSB's ScrambledZipfianGenerator over
    ``[0, item_count)``."""
    theta = SCRAMBLED_THETA
    items = SCRAMBLED_ITEM_COUNT
    zetan = SCRAMBLED_ZETAN
    zeta2 = 1.0 + 0.5 ** theta
    alpha = 1.0 / (1.0 - theta)
    eta = (1.0 - (2.0 / items) ** (1.0 - theta)) / (1.0 - zeta2 / zetan)
    u = rng.random(n)
    uz = u * zetan
    tail = np.floor(items * (eta * u - eta + 1.0) ** alpha).astype(np.int64)
    ret = np.where(uz < 1.0, 0, np.where(uz < 1.0 + 0.5 ** theta, 1, tail))
    return fnvhash64(ret) % item_count


def draw_records(rng, n, record_count, dist):
    """``n`` record numbers under the mix's ``request_distribution``.

    CoreWorkload builds its Zipfian chooser over ``record_count + 1``
    items and draws again past the last record: so does this."""
    if dist != "zipfian":
        raise ValueError(f"unknown request distribution {dist!r}")
    out = scrambled_zipfian(rng, n, record_count + 1)
    while True:
        bad = np.flatnonzero(out >= record_count)
        if not len(bad):
            return out
        out[bad] = scrambled_zipfian(rng, len(bad), record_count + 1)


def validate_mix(mix):
    """Raise unless every transaction of the mix writes and its ops are
    well formed."""
    ops = mix["ops"]
    if not any(op["side"] == "write" for op in ops):
        raise ValueError("a mix must write: read-only transactions never "
                         "reach a resolver")
    for op in ops:
        if op["side"] not in SIDES or op["shape"] not in SHAPES:
            raise ValueError(f"bad op {op}")
        if op["shape"] == "range" and int(op["span"]) < 1:
            raise ValueError(f"bad span in {op}")
        if not 0 <= int(op["draw"]) < int(mix["draws"]):
            raise ValueError(f"op {op} names a draw the mix lacks")


class Pool:
    """``n_batches`` commit batches of ``txns`` transactions each, drawn
    from ``seed``: per batch the flat blobs and counts, each
    transaction's read-version lag, and the rank runs of its reads and
    writes (``read_lo``/``read_hi``, ``write_lo``/``write_hi``:
    int32[n_batches, txns, ops of that side])."""

    def __init__(self, keys, mix, n_batches, txns, lag_range, seed):
        validate_mix(mix)
        rng = np.random.default_rng(seed)
        N = keys.record_count
        ops = mix["ops"]
        n = n_batches * txns
        records = draw_records(rng, n * int(mix["draws"]), N,
                               mix["request_distribution"])
        ranks = keys.rank_of[records].reshape(n, int(mix["draws"]))
        lo = np.empty((n, len(ops)), dtype=np.int64)
        hi = np.empty((n, len(ops)), dtype=np.int64)
        for j, op in enumerate(ops):
            r = ranks[:, int(op["draw"])]
            if op["shape"] == "point":
                lo[:, j], hi[:, j] = r, r + 1
            else:
                span = int(op["span"])
                # a range needs the key after its last: starts stop short
                lo[:, j] = r % (N - span)
                hi[:, j] = lo[:, j] + span
        self.txns = txns
        self.n_batches = n_batches
        self.lags = rng.integers(lag_range[0], lag_range[1] + 1,
                                 (n_batches, txns)).astype(np.int64)
        shape3 = (n_batches, txns, -1)
        rd = [j for j, op in enumerate(ops) if op["side"] == "read"]
        wr = [j for j, op in enumerate(ops) if op["side"] == "write"]
        self.read_lo = lo[:, rd].astype(np.int32).reshape(shape3)
        self.read_hi = hi[:, rd].astype(np.int32).reshape(shape3)
        self.write_lo = lo[:, wr].astype(np.int32).reshape(shape3)
        self.write_hi = hi[:, wr].astype(np.int32).reshape(shape3)
        self.max_span = int(max(int(op.get("span", 1)) for op in ops))
        # the flat blobs: per (side, shape) the entries of every txn's
        # ops in txn order, a range as entry(begin) || entry(end)
        ent = keys.entries
        self.counts = {}
        blobs = {}
        for (side, shape), name in BLOBS.items():
            cols = [j for j, op in enumerate(ops)
                    if op["side"] == side and op["shape"] == shape]
            self.counts[name] = np.full(txns, len(cols), dtype=np.int64)
            if not cols:
                blobs[name] = None
                continue
            if shape == "point":
                rows = ent[lo[:, cols]]  # [n, k, E]
            else:
                rows = ent[np.stack([lo[:, cols], hi[:, cols]], axis=2)]
            blobs[name] = rows.reshape(n_batches, -1)
        self._blobs = blobs

    def blobs(self, i):
        """Batch ``i``'s four blobs, by name (pr, pw, rr, rw)."""
        return {name: (b"" if arr is None else arr[i].tobytes())
                for name, arr in self._blobs.items()}


class Versions:
    """The commit version clock: batch ``i`` of the run commits at
    ``first + (i + 1) * per_batch``; its window starts ``window``
    versions earlier, and a transaction reads at its batch's version
    less one, less its lag."""

    def __init__(self, first, per_batch, window):
        self.first = int(first)
        self.per_batch = int(per_batch)
        self.window = int(window)

    def commit(self, i):
        return self.first + (i + 1) * self.per_batch

    def window_start(self, i):
        return max(0, self.commit(i) - self.window)

    def read_versions(self, i, lags):
        return self.commit(i) - 1 - lags
