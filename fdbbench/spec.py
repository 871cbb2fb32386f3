"""What a cell is made of, found by name: its entry in ``BENCHMARK.json``,
its configuration (``configs/<config>.json``), its traffic mix
(``mixes/<traffic>.json``), the limits of its output check
(``limits/<cell>.json``), the reader of each per-layer metric
(``metrics/<metric>.py``) and the work count of each kernel
(``kernels/<kernel>.py``). Adding a cell, a mix, a metric or a kernel
count adds files and entries; no file here names one."""

import importlib.util
import json
import os

from fdbbench import traffic

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path):
    with open(path) as f:
        return json.load(f)


def benchmark():
    return _json(os.path.join(ROOT, "BENCHMARK.json"))


def _module(kind, name):
    path = os.path.join(HERE, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"fdbbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name):
    """``metrics/<name>.py``: ``read(ctx)`` gives the metric's value, or
    None where the run has nothing to read it from."""
    return _module("metrics", name)


def kernel_count(name):
    """``kernels/<name>.py``: the kernel's profiler names and its frozen
    count of bytes and operations per call."""
    return _module("kernels", name)


class Cell:
    """One ``workloads`` entry with its configuration, mix, limits and
    metric entries."""

    def __init__(self, name, bench=None):
        bench = bench or benchmark()
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = cells[name]
        self.chips = int(self.entry["chips"])
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = _json(os.path.join(ROOT, configs[self.entry["config"]]
                                         ["file"]))
        self.mix = _json(os.path.join(HERE, "mixes",
                                      self.entry["traffic"] + ".json"))
        self.limits = _json(os.path.join(HERE, "limits", name + ".json"))
        self.end_to_end = [m for m in bench["end_to_end"] if self._has(m)]
        self.per_layer = [m for m in bench["per_layer"] if self._has(m)]

    def _has(self, metric):
        return "workloads" not in metric or self.name in metric["workloads"]

    def traffic(self, seed):
        """The cell's key space, its pool of batches drawn from ``seed``,
        and its version clock."""
        cfg, mix = self.config, self.mix
        keys = traffic.KeySpace(int(cfg["record_count"]),
                                int(cfg["knobs"]["key_limbs"]))
        pool = traffic.Pool(keys, mix, int(mix["pool_batches"]),
                            int(cfg["knobs"]["batch_txn_capacity"]),
                            cfg["read_version_lag"], seed & (2 ** 63 - 1))
        versions = traffic.Versions(cfg["first_version"],
                                    cfg["versions_per_batch"],
                                    cfg["mvcc_window_versions"])
        return keys, pool, versions
