"""Build, load and count the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface under
``foundationdb_tpu_torch/build/``, and loaded with ``ctypes``. Every
pointer and the stream go over as ``c_void_p``, every size as
``c_int``. Each C entry returns ``cudaGetLastError()`` after its
launches; :func:`check` raises on anything but 0. Nothing here runs at
import time: this module imports on machines without ``nvcc`` or a card.

``launches`` counts, per wrapper, the calls that launched its kernels on
a CUDA device (the CPU path of a wrapper never counts). A wrapper called
while a CUDA graph is being captured on its thread launches nothing: its
count goes to that capture's tally (:func:`capturing`), which the graph
adds to ``launches`` on every replay (:func:`add_launches`).
"""

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")
SOURCES = ("ring", "accept")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points per source: name → argtypes (restype is c_int)
_SIGNATURES = {
    "ring": {"fdb_ring_hits": [_P] * 7 + [_I] * 4 + [_P, _P]},
    "accept": {"fdb_fused_accept": [_P] * 18 + [_I] * 8 + [_P] * 4,
               "fdb_accept_sweep": [_P, _P, _I, _P, _P, _P]},
}

launches = {"ring_hits": 0, "fused_accept": 0, "accept_sweep": 0}
# nvcc's -Xptxas -v report (registers, shared memory, spills) per source
build_logs = {}

_libs = {}
_lock = threading.Lock()
_tally = threading.local()


def reset_launches():
    for k in launches:
        launches[k] = 0


def count(name):
    """One call of wrapper ``name`` that launched its kernels, or, inside
    :func:`capturing` on this thread, recorded them into a graph."""
    held = getattr(_tally, "held", None)
    if held is None:
        launches[name] += 1
    else:
        held[name] = held.get(name, 0) + 1


@contextlib.contextmanager
def capturing():
    """While a graph is captured on this thread: yields the dict of the
    wrapper calls it records, by name (the launches one replay makes)."""
    held = {}
    _tally.held = held
    try:
        yield held
    finally:
        _tally.held = None


def add_launches(held):
    """A replay of a graph holding ``held`` launches."""
    for name, n in held.items():
        launches[name] += n


def nvcc_path():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build from csrc/ at first use "
            "and need the CUDA toolkit (PATH or /usr/local/cuda/bin)"
        )
    return path


def _so_path(name):
    """The library of ``csrc/<name>.cu``, named by a hash of the flags,
    the source and every header in ``csrc/``, so that a change to any of
    them builds anew instead of loading a stale library."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fn in (name + ".cu", *headers):
        h.update(fn.encode())
        with open(os.path.join(CSRC_DIR, fn), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build(names=SOURCES):
    """Compile every source in ``names`` that has no current library,
    one ``nvcc`` per source, all started together. Returns the seconds
    spent. Raises with nvcc's output if any build fails."""
    t0 = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        so = _so_path(name)
        if os.path.exists(so):
            continue
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, name + ".cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, so)
    failed = []
    for name, (p, tmp, so) in procs.items():
        out, _ = p.communicate()
        build_logs[name] = out
        if p.returncode != 0:
            failed.append(f"nvcc {name}.cu failed ({p.returncode}):\n{out}")
        else:
            os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("\n".join(failed))
    return time.perf_counter() - t0


def lib(name):
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        cdll = _libs.get(name)
        if cdll is None:
            build([name])
            cdll = ctypes.CDLL(_so_path(name))
            for fn, argtypes in _SIGNATURES[name].items():
                f = getattr(cdll, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _libs[name] = cdll
        return cdll


def check(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


# Widest key the kernels take (csrc/lex.cuh FDB_MAX_W): 16 limbs + length
MAX_KEY_WIDTH = 17


def check_args(what, device, key_width, int64s, bools):
    """Raise ValueError unless the key width (None: no keys) is one the
    kernels take and every tensor lies on ``device`` with its expected
    shape: int64 for ``int64s``, bool for ``bools`` (both {name: (tensor,
    shape)})."""
    if key_width is not None and not 1 <= key_width <= MAX_KEY_WIDTH:
        raise ValueError(f"{what}: key width {key_width} outside the "
                         f"kernels' 1..{MAX_KEY_WIDTH}")
    for group, dtype in ((int64s, torch.int64), (bools, torch.bool)):
        for name, (t, shape) in group.items():
            if (t.device != device or t.dtype != dtype
                    or tuple(t.shape) != tuple(shape)):
                raise ValueError(
                    f"{what}: {name} must be {dtype} {tuple(shape)} on "
                    f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def stream_of(t):
    """The handle of PyTorch's current stream on tensor ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
