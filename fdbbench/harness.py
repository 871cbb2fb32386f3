"""One run of one cell: set-up, warm-up, the measured window, the device
trace, and the output check.

The traffic is a closed loop that stands for one commit proxy: it
dispatches ``resolve_many(group, lazy=True)`` on groups of flat batches,
as the proxy's batcher pipeline does, keeps ``in_flight`` groups
outstanding and waits on the oldest. Each dispatch stamps the batch's
versions from the run's version clock; the batches come from a pool
drawn from the seed in set-up. Every batch the run dispatches, warm-up
included, is judged against the reference once the window has closed
and the program's state is freed.
"""

import collections
import contextlib
import gc
import os
import sys
import time
import types

import numpy as np
import torch

from fdbbench import devtrace, reference, roofline, spec

WARMUP_BATCHES = 64  # set-up dispatches: every shape, the history filled
TRACE_SECONDS = 3.0  # the traced slice at the start of a --trace 1 window
ROOFLINE_SAMPLES = 4  # single-batch dispatches counted for the rooflines
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "foundationdb_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN_MODULES))


class ResolverSystem:
    """The system under test: one ``Resolver``, or a ``MeshResolver`` of
    ``resolvers`` lanes, on ``device``, with every step compiled."""

    def __init__(self, config, device):
        from foundationdb_tpu_torch.core.options import Knobs

        knobs = Knobs(**config["knobs"])
        n = int(config["resolvers"])
        if n == 1:
            from foundationdb_tpu_torch.resolver.resolver import Resolver
            self.resolver = Resolver(knobs, device=device)
        else:
            from foundationdb_tpu_torch.resolver.meshresolver import (
                MeshResolver)
            self.resolver = MeshResolver(knobs, n_lanes=n, device=device)
        self.resolver.precompile()
        self.key_limbs = knobs.key_limbs
        self.params = {"txns": knobs.batch_txn_capacity,
                       "point_reads": knobs.point_reads_per_txn,
                       "point_writes": knobs.point_writes_per_txn,
                       "range_reads": knobs.range_reads_per_txn,
                       "range_writes": knobs.range_writes_per_txn,
                       "key_limbs": knobs.key_limbs}

    def flat(self, blobs, counts, rv):
        from foundationdb_tpu_torch.core.flatpack import FlatTxnBatch

        return FlatTxnBatch(self.key_limbs, rv, counts["pr"], counts["pw"],
                            counts["rr"], counts["rw"], blobs["pr"],
                            blobs["pw"], blobs["rr"], blobs["rw"])

    def dispatch(self, group):
        return self.resolver.resolve_many(group, lazy=True)

    def captures(self):
        return sum(self.resolver.status()["graphs"]["captures"].values())

    def profile(self):
        return self.resolver.profile.snapshot()

    def ring(self):
        """A copy of the history's ring of range writes."""
        st = self.resolver.state
        return types.SimpleNamespace(
            ring_b=st.ring_b.clone(), ring_e=st.ring_e.clone(),
            ring_v=st.ring_v.clone(), ring_mask=st.ring_mask.clone())

    def release(self):
        self.resolver.release()
        self.resolver = None


class Driver:
    """The closed loop over the pool: batch ``i`` of the run is pool row
    ``i % n_batches`` at the clock's versions for ``i``."""

    def __init__(self, system, pool, versions, group_batches, in_flight,
                 span):
        self.system = system
        self.pool = pool
        self.versions = versions
        self.group_batches = int(group_batches)
        self.in_flight = int(in_flight)
        self.span = span  # devtrace.span in a traced run
        self.next = 0
        self.pending = collections.deque()
        self.statuses = {}  # run index -> int8[T]
        self.done = []  # (run index, seconds from dispatch, completed at)

    def batch(self, i):
        row = i % self.pool.n_batches
        rv = self.versions.read_versions(i, self.pool.lags[row])
        return (self.system.flat(self.pool.blobs(row), self.pool.counts, rv),
                self.versions.commit(i), self.versions.window_start(i))

    def dispatch(self, n=None):
        n = n or self.group_batches
        idx = list(range(self.next, self.next + n))
        self.next += n
        with self.span("pack_dispatch"):
            t0 = time.perf_counter()
            handle = self.system.dispatch([self.batch(i) for i in idx])
        self.pending.append((idx, t0, handle))

    def complete(self):
        idx, t0, handle = self.pending.popleft()
        with self.span("wait_unpack"):
            out = [np.asarray(s, dtype=np.int8) for s in handle.wait()]
            t1 = time.perf_counter()
        for i, s in zip(idx, out):
            self.statuses[i] = s
            self.done.append((i, t1 - t0, t1))

    def step(self):
        self.dispatch()
        if len(self.pending) >= self.in_flight:
            self.complete()

    def drain(self):
        while self.pending:
            self.complete()


def _delta(after, before):
    """Numeric fields of a device profile snapshot, after less before."""
    out = {}
    for k, v in after.items():
        b = before.get(k)
        if isinstance(v, (int, float)) and isinstance(b, (int, float)):
            out[k] = v - b
        elif isinstance(v, list) and isinstance(b, list):
            b = b + [0] * (len(v) - len(b))
            out[k] = [x - y for x, y in zip(v, b)]
        elif isinstance(v, dict) and isinstance(b, dict):
            out[k] = {kk: vv - b.get(kk, 0) for kk, vv in v.items()
                      if isinstance(vv, (int, float))}
    return out


class Context:
    """What a per-layer metric's reader reads (``metrics/<name>.py``)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def roofline(self, name):
        """Kernel ``name``'s share of its roofline in %: the frozen count
        of its calls (``kernels/<name>.py``) over its device time per call
        in the traced slice; None where it did not launch, or where a
        kernel it shares a part with launched too."""
        mod = spec.kernel_count(name)
        launches, secs = self.trace.kernel(mod.PARTS)
        if not launches or self.trace.kernel(mod.OTHERS)[0]:
            return None
        return roofline.share_pct(mod.costs(self), secs * 1e3 / launches)


def run(cell, seed, seconds, trace, device="cuda", t_start=None, log=None):
    """One run of ``cell`` (a spec.Cell) on ``device``: the result, its
    output check's numbers last (``checks``). Raises SystemExit where a
    step compiled in the window. The caller looks for JAX in
    ``sys.modules`` (:func:`forbidden_modules`) once this has returned,
    after the metric readers, the kernel counts and the judge."""
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    cfg, mix = cell.config, cell.mix
    marks = [("start", time.perf_counter() - t_start)]
    keys, pool, versions = cell.traffic(seed)
    marks.append(("keys and pool", time.perf_counter() - t_start))
    system = ResolverSystem(cfg, device)
    marks.append(("system and precompile", time.perf_counter() - t_start))
    drv = Driver(system, pool, versions, mix["group_batches"],
                 mix["in_flight"],
                 devtrace.span if trace else lambda _: contextlib.nullcontext())
    while drv.next < WARMUP_BATCHES:
        drv.step()
    drv.drain()
    sync()
    captures0 = system.captures()
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    marks.append(("warm-up", setup_s))
    log("set-up: " + ", ".join(
        f"{name} {b - a} s" for (_, a), (name, b) in zip(
            [("", 0.0)] + marks[:-1], marks)))
    first_window = drv.next
    tracer = devtrace.DeviceTrace(os.environ.get("TMPDIR", "/tmp")) \
        if trace else None

    traced = None
    if tracer:
        prof0 = system.profile()
        tracer.start()
    # the measured window
    t0 = time.perf_counter()
    t_end = t0 + seconds
    while True:
        now = time.perf_counter()
        if now >= t_end:
            break
        if tracer and traced is None and now >= t0 + TRACE_SECONDS:
            tracer.stop()
            traced = (system.profile(), drv.next)
        drv.step()
    if tracer and traced is None:
        tracer.stop()
        traced = (system.profile(), drv.next)
    drv.drain()
    sync()
    captures1 = system.captures()
    samples = []
    if tracer:
        for _ in range(ROOFLINE_SAMPLES):
            sync()
            ring = system.ring()
            i = drv.next
            drv.dispatch(1)
            drv.complete()
            row = i % pool.n_batches
            samples.append(dict(
                blobs=pool.blobs(row), counts=pool.counts,
                rv=versions.read_versions(i, pool.lags[row]),
                base=system.resolver.base_version, ring=ring,
                accepted=drv.statuses[i] == reference.COMMITTED))
    if captures1 != captures0:
        raise SystemExit(f"{captures1 - captures0} step(s) compiled inside "
                         "the measured window")
    memory_peak = (torch.cuda.max_memory_allocated(device) if on_card else 0)
    in_window = [(i, lat) for i, lat, t in drv.done
                 if i >= first_window and t <= t_end]
    window_txns = len(in_window) * pool.txns
    window_committed = sum(int((drv.statuses[i] == reference.COMMITTED).sum())
                           for i, _ in in_window)
    lat_ms = np.array([lat for _, lat in in_window]) * 1e3
    n_dispatched = drv.next

    metrics = {}
    breakdown = None
    busy = None
    if not trace:
        e2e = {
            "resolved_txns_per_s": window_txns / seconds,
            "committed_txns_per_s": window_committed / seconds,
            "resolve_batch_p95_ms": (float(np.percentile(lat_ms, 95))
                                     if len(lat_ms) else None),
            "setup_s": setup_s,
        }
        for m in cell.end_to_end:
            if e2e.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
        if len(lat_ms):
            print(f"batches {len(lat_ms)} in the window: p50 "
                  f"{np.percentile(lat_ms, 50)} ms, p95 "
                  f"{np.percentile(lat_ms, 95)} ms, p99 "
                  f"{np.percentile(lat_ms, 99)} ms from dispatch to statuses "
                  "(BASELINE north star: < 2 ms added p99 commit latency)",
                  flush=True)
    else:
        tracer.read()
        prof1, next1 = traced
        slice_idx = range(first_window, next1)
        accepted = sum(int((drv.statuses[i] == reference.COMMITTED).sum())
                       for i in slice_idx)
        ctx = Context(profile=_delta(prof1, prof0), trace=tracer,
                      batches=len(slice_idx), accepted=accepted,
                      samples=samples, params=system.params)
        for m in cell.per_layer:
            v = spec.metric_reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        breakdown = tracer.breakdown()
        busy = (tracer.busy_s, tracer.window_s)
    system.release()
    del system
    if on_card:
        torch.cuda.empty_cache()

    # the output check, after the window and with the program's state freed
    tj = time.perf_counter()
    judge = reference.Judge(pool, versions, keys.record_count)
    for i in range(n_dispatched):
        judge.batch(i, drv.statuses.get(i))
    nums = judge.numbers()
    log(f"judged {n_dispatched} batches ({nums['txns']} txns, "
        f"{nums['committed']} committed) in {time.perf_counter() - tj} s")
    checks = {name: {"value": nums[name], "limit": limit}
              for name, limit in cell.limits.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    result = {
        "correct": correct,
        "attempted": nums["txns"],
        "failed": nums["unsound_commits"] + nums["bad_statuses"],
        "metrics": metrics,
        "device": {
            "platform": "gpu" if on_card else "cpu",
            "kind": (torch.cuda.get_device_name(device) if on_card
                     else "cpu"),
            "count": 1,
            "memory_peak_bytes": int(memory_peak),
            "power_limit_w": roofline.power_limit_w() if on_card else None,
        },
    }
    if busy:
        result["device"]["busy_s"], result["device"]["window_s"] = busy
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result
