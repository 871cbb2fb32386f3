"""Native host code: the C++ ConflictSet behind ``resolver_backend="native"``
and the CPython batch packer behind ``BatchPacker(use_native=True)``.

Both are built by ``g++ -O2 -std=c++17 -shared -fPIC`` at first use into
``foundationdb_tpu_torch/build/`` (never at import), each library named
by a hash of its flags, its source, the interpreter's ``EXT_SUFFIX`` and
include path, so that a change to any of them builds anew instead of
loading a stale library. A build goes to a temporary file that is then
renamed into place: several processes may build at once. A failed build
raises :class:`NativeBuildError`; nothing falls back to numpy behind the
caller's back (``use_native=False`` asks for the numpy packer).

The conflict set is bound with ``ctypes.CDLL``, which releases the
interpreter lock during a call, so the proxy's sub-resolve pool runs
native resolvers in parallel. The batch ABI moves whole commit batches
across in packed numpy arrays, as the device path packs batches into
device tensors (resolver/packing.py).

Ref parity: fdbserver/SkipList.cpp ConflictSet (role), bindings/c (the
C-ABI shape of the reference's native surface).
"""

import ctypes
import hashlib
import os
import subprocess
import sysconfig
import threading

import numpy as np

from foundationdb_tpu_torch.core.status import COMMITTED, CONFLICT, TOO_OLD
from foundationdb_tpu_torch.utils import lockdep

HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(HERE), "build")
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
EXT_SUFFIX = sysconfig.get_config_var("EXT_SUFFIX") or ".so"

_lock = lockdep.lock("native._lock")
_lib = None
_packer_mod = None


class NativeBuildError(RuntimeError):
    """g++ is missing, or the build or the load of a native library
    failed."""


def _so_path(name, extra_flags=()):
    """The library of ``native/<name>.cpp``: named by a hash of the
    flags, the source and the interpreter's ABI, with the ABI's suffix."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + tuple(extra_flags)).encode())
    h.update(EXT_SUFFIX.encode())
    with open(os.path.join(HERE, name + ".cpp"), "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}{EXT_SUFFIX}")


def _compile(name, extra_flags=()):
    """Build ``native/<name>.cpp`` unless its library exists; returns the
    library's path."""
    so = _so_path(name, extra_flags)
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = ["g++", *CXX_FLAGS, *extra_flags, "-o", tmp,
           os.path.join(HERE, name + ".cpp")]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise NativeBuildError("g++ not available") from e
    except subprocess.CalledProcessError as e:
        raise NativeBuildError(
            f"native build of {name}.cpp failed:\n{e.stderr}") from e
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    return so


def load_library():
    """Build (if needed) and load the conflict-set library; cached per
    process."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        try:
            lib = ctypes.CDLL(_compile("conflict_set"))
        except OSError as e:
            raise NativeBuildError(f"loading conflict_set failed: {e}") from e
        lib.ccs_new.argtypes = []
        lib.ccs_new.restype = ctypes.c_void_p
        lib.ccs_free.argtypes = [ctypes.c_void_p]
        lib.ccs_free.restype = None
        lib.ccs_window_start.argtypes = [ctypes.c_void_p]
        lib.ccs_window_start.restype = ctypes.c_uint64
        lib.ccs_segment_count.argtypes = [ctypes.c_void_p]
        lib.ccs_segment_count.restype = ctypes.c_uint64
        lib.ccs_prune.argtypes = [ctypes.c_void_p]
        lib.ccs_prune.restype = None
        lib.ccs_resolve_batch.restype = None
        lib.ccs_resolve_batch.argtypes = [
            ctypes.c_void_p,  # set
            ctypes.c_char_p,  # blob
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,  # reads
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,  # writes
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64,  # read versions
            ctypes.c_uint64, ctypes.c_uint64,  # commit v, window
            ctypes.POINTER(ctypes.c_uint8),  # statuses out
        ]
        _lib = lib
        return lib


def load_packer():
    """Build (if needed) and import the CPython packer extension, built
    against the running interpreter; cached per process. Raises
    NativeBuildError when it cannot be built or imported."""
    from importlib.machinery import ExtensionFileLoader
    from importlib.util import module_from_spec, spec_from_loader

    global _packer_mod
    with _lock:
        if _packer_mod is not None:
            return _packer_mod
        so = _compile("packer", (f"-I{sysconfig.get_paths()['include']}",))
        loader = ExtensionFileLoader("fdbtorch_packer", so)
        try:
            mod = module_from_spec(spec_from_loader("fdbtorch_packer", loader))
            loader.exec_module(mod)
        except ImportError as e:
            raise NativeBuildError(f"importing the packer failed: {e}") from e
        _packer_mod = mod
        return mod


_STATUS_MAP = {0: COMMITTED, 1: CONFLICT, 2: TOO_OLD}


class NativeConflictSet:
    """The C++ twin of resolver.skiplist.CpuConflictSet: the same
    statuses for every batch."""

    def __init__(self):
        self._lib = load_library()
        self._ptr = ctypes.c_void_p(self._lib.ccs_new())

    def __del__(self):
        ptr, self._ptr = getattr(self, "_ptr", None), None
        if ptr:
            self._lib.ccs_free(ptr)

    @property
    def window_start(self):
        return self._lib.ccs_window_start(self._ptr)

    @property
    def segment_count(self):
        return self._lib.ccs_segment_count(self._ptr)

    def prune(self):
        """Immediate GC of out-of-window segments (normally amortized)."""
        self._lib.ccs_prune(self._ptr)

    def resolve(self, txns, commit_version, new_window_start=None):
        """Resolve a batch of TxnRequests in arrival order → statuses.

        A point key k packs once as ``k\\x00`` and its end span
        [k, k+\\x00) aliases the same blob bytes (begin = (off, len),
        end = (off, len+1)): no per-range bytes concatenation."""
        blob = bytearray()
        blob_extend, blob_append = blob.extend, blob.append
        reads, writes = [], []

        def pack(txn_reads, txn_writes, t):
            for out, points, ranges in (
                (reads, txn_reads[0], txn_reads[1]),
                (writes, txn_writes[0], txn_writes[1]),
            ):
                for b in points:
                    bo = len(blob)
                    blob_extend(b)
                    blob_append(0)
                    n = len(b)
                    out.append((t, bo, n, bo, n + 1))
                for b, e in ranges:
                    bo = len(blob)
                    blob_extend(b)
                    eo = len(blob)
                    blob_extend(e)
                    out.append((t, bo, len(b), eo, len(e)))

        rvs = np.empty(len(txns), np.uint64)
        for t, txn in enumerate(txns):
            rvs[t] = txn.read_version
            pack((txn.point_reads, txn.range_reads),
                 (txn.point_writes, txn.range_writes), t)

        r_arr = np.asarray(reads, np.int64).reshape(-1, 5)
        w_arr = np.asarray(writes, np.int64).reshape(-1, 5)
        return self._call_resolve(bytes(blob), r_arr, w_arr, rvs,
                                  commit_version, new_window_start)

    def _call_resolve(self, blob, r_arr, w_arr, rvs, commit_version,
                      new_window_start):
        i64p = ctypes.POINTER(ctypes.c_int64)
        statuses = np.empty(len(rvs), np.uint8)
        self._lib.ccs_resolve_batch(
            self._ptr,
            blob,
            r_arr.ctypes.data_as(i64p), len(r_arr),
            w_arr.ctypes.data_as(i64p), len(w_arr),
            rvs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), len(rvs),
            commit_version,
            new_window_start if new_window_start is not None else 0,
            statuses.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        return [_STATUS_MAP[s] for s in statuses.tolist()]

    def resolve_flat(self, flat, commit_version, new_window_start=None):
        """Resolve a columnar FlatTxnBatch (core/flatpack.py) with no
        per-key Python: the concatenated entry blobs are the ABI's key
        blob. An entry is ``key ‖ \\x00-padding ‖ >I(len)``, so the raw
        key is ``blob[off : off+len]`` and a point's end span ``k+\\x00``
        is ``blob[off : off+len+1]``, the \\x00 being the entry's own
        padding (or the first length byte when len == capacity, since
        capacity < 2^24). Entries sort by txn with one stable argsort
        (the C walk consumes rows strictly in txn order)."""
        n = len(flat)
        W = flat.num_limbs + 1
        W4 = 4 * W
        blob = flat.pr_blob + flat.pw_blob + flat.rr_blob + flat.rw_blob
        base_pw = len(flat.pr_blob)
        base_rr = base_pw + len(flat.pw_blob)
        base_rw = base_rr + len(flat.rr_blob)

        def lens_of(b):
            if not b:
                return np.zeros(0, np.int64)
            return np.frombuffer(b, dtype=">u4").reshape(-1, W)[:, -1] \
                .astype(np.int64)

        def point_rows(b, base, counts):
            t = np.repeat(np.arange(n), counts)
            off = base + np.arange(len(t), dtype=np.int64) * W4
            ln = lens_of(b)
            return np.stack([t, off, ln, off, ln + 1], axis=1)

        def range_rows(b, base, counts):
            t = np.repeat(np.arange(n), counts)
            ln = lens_of(b)  # interleaved lower/upper lengths
            off = base + np.arange(2 * len(t), dtype=np.int64) * W4
            return np.stack(
                [t, off[0::2], ln[0::2], off[1::2], ln[1::2]], axis=1
            )

        def side(prows, rrows):
            rows = np.concatenate([prows, rrows])
            # stable: a txn's points stay ahead of its ranges
            return np.ascontiguousarray(
                rows[np.argsort(rows[:, 0], kind="stable")]
            )

        r_arr = side(point_rows(flat.pr_blob, 0, flat.prc),
                     range_rows(flat.rr_blob, base_rr, flat.rrc))
        w_arr = side(point_rows(flat.pw_blob, base_pw, flat.pwc),
                     range_rows(flat.rw_blob, base_rw, flat.rwc))
        rvs = np.ascontiguousarray(flat.rv.astype(np.uint64))
        return self._call_resolve(blob, r_arr, w_arr, rvs, commit_version,
                                  new_window_start)
