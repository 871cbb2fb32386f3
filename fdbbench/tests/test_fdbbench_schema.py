"""BENCHMARK.json against the benchmark's contract, and every file a
cell is found by."""

import json
import os
import re

import pytest

from fdbbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return spec.benchmark()


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level(bench):
    assert set(bench) == TOP_KEYS
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) <= 65536
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(spec.ROOT, p))
    cmd = bench["command"]
    assert 1 <= len(cmd) <= 32 and all(line(w) for w in cmd)
    for w in cmd:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in bench["paths"])
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    n = len(bench["workloads"])
    budget = (2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 180 + 1200
    assert budget <= 43200 and 1 <= n <= 24


def test_configs(bench):
    names = [c["name"] for c in bench["configs"]]
    assert len(names) == len(set(names)) and 1 <= len(names) <= 24
    used = {w["config"] for w in bench["workloads"]}
    files = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert line(c["source"]) and line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in bench["paths"])
        assert c["file"] not in files
        files.add(c["file"])
        with open(os.path.join(spec.ROOT, c["file"])) as f:
            body = json.load(f)
        assert body["name"] == c["name"]
        assert body["reduced"] == c["reduced"] and len(c["reduced"]) <= 16


def test_workloads(bench):
    cells = bench["workloads"]
    names = [w["name"] for w in cells]
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in cells]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in cells)
    assert four <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and line(w["why"])
        for kind, name in (("mixes", w["traffic"] + ".json"),
                           ("limits", w["name"] + ".json")):
            assert os.path.isfile(os.path.join(spec.HERE, kind, name))


def test_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    assert 1 <= len(bench["per_layer"]) <= 128
    names = list(e2e) + [m["name"] for m in bench["per_layer"]]
    assert len(names) == len(set(names))
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                         "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                         "layer", "moves"}
        assert m["source"] in SOURCES and line(m["layer"])
        assert m["moves"] in e2e
        assert os.path.isfile(os.path.join(spec.HERE, "metrics",
                                           m["name"] + ".py"))
        if m["name"].endswith("_roofline"):
            kernel = m["name"][:-len("_roofline")]
            assert m["unit"] == "%"
            assert os.path.isfile(os.path.join(spec.HERE, "kernels",
                                               kernel + ".py"))
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")


def test_every_cell_reports_what_its_metrics_move(bench):
    cells = {w["name"] for w in bench["workloads"]}
    for w in cells:
        c = spec.Cell(w, bench)
        e2e = {m["name"] for m in c.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert c.per_layer
        for m in c.per_layer:
            assert m["moves"] in e2e
    for m in bench["per_layer"] + bench["end_to_end"]:
        assert set(m.get("workloads", cells)) <= cells
