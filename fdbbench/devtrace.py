"""The device trace of a ``--trace 1`` run: torch.profiler over a slice
of the window, read back from its Chrome trace.

Busy time is the union of the intervals in which a kernel, copy or
memset ran on the card. Host spans are the benchmark's own
``record_function`` ranges (``fdbbench.*``), and each idle gap between
device intervals is charged to the span the host was in at its middle.
"""

import bisect
import json
import os
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "fdbbench."
TOP = 10


def span(name):
    """A host span of the benchmark's own, seen by the trace."""
    return torch.profiler.record_function(SPAN_PREFIX + name)


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _label(spans, starts, t):
    """The host span (they do not nest) that covers time ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and spans[i][1] >= t:
        return spans[i][2]
    return "host.other"


def summarize(events):
    """Busy seconds, device seconds and launches by kernel name, and idle
    seconds by host span, from Chrome trace events."""
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS]
    kernels = {}
    for e in dev:
        k = kernels.setdefault(e["name"], [0, 0.0])
        k[0] += 1
        k[1] += float(e["dur"]) / 1e6
    merged = _merge((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                    for e in dev)
    busy_s = sum(b - a for a, b in merged) / 1e6
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"][len(SPAN_PREFIX):])
                   for e in events if e.get("ph") == "X"
                   and e.get("cat") == "user_annotation"
                   and e.get("name", "").startswith(SPAN_PREFIX))
    starts = [a for a, _, _ in spans]
    gaps = {}
    for (_, b), (a2, _) in zip(merged, merged[1:]):
        name = _label(spans, starts, (b + a2) / 2)
        gaps[name] = gaps.get(name, 0.0) + (a2 - b) / 1e6
    return busy_s, kernels, gaps


class DeviceTrace:
    """torch.profiler (host and device activity) from :meth:`start` to
    :meth:`stop`, which synchronises first so the slice ends with no
    work in flight."""

    def __init__(self, tmpdir):
        self.path = os.path.join(tmpdir, f"fdbbench-trace-{os.getpid()}.json")
        self.prof = None
        self.window_s = 0.0
        self.busy_s = 0.0
        self.kernels = {}
        self.gaps = {}

    def start(self):
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self):
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self.prof.__exit__(None, None, None)

    def read(self):
        """Export, read and delete the trace."""
        try:
            self.prof.export_chrome_trace(self.path)
            with open(self.path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            if os.path.exists(self.path):
                os.remove(self.path)
        self.busy_s, self.kernels, self.gaps = summarize(events)

    def kernel(self, names):
        """(launches of the first name, device seconds of all) over the
        kernels whose names start with one of ``names``."""
        launches, secs = 0, 0.0
        for name, (n, s) in self.kernels.items():
            bare = name.removeprefix("void ")
            for i, prefix in enumerate(names):
                if bare.startswith(prefix):
                    secs += s
                    if i == 0:
                        launches += n
                    break
        return launches, secs

    def breakdown(self):
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][1])[:TOP]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n[:96], s] for n, (_, s) in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}
