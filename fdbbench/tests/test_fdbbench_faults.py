"""A run with its timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a
run on the CPU (the port's step runs there too) at the cell's widths,
with a small pool and a short window. The faults a one-card resolver
cell can have: a step that leaves its history unchanged, half of each
batch left out (its statuses taken from the other half), and an answer
altered where it is produced. No cell spans cards, so none has an
exchange between cards to leave out."""

import json
import subprocess
import sys

import numpy as np
import pytest

from fdbbench import harness, spec


def small_cell(name):
    cell = spec.Cell(name)
    cell.mix["pool_batches"] = 24
    return cell


def run(monkeypatch, cell, seed=2 ** 32 + 7):
    monkeypatch.setattr(harness, "WARMUP_BATCHES", 4)
    return harness.run(cell, seed, 1.0, False, device="cpu",
                       log=lambda *a: None)


@pytest.fixture
def resolver_cls():
    from foundationdb_tpu_torch.resolver.resolver import Resolver
    return Resolver


def test_sound_run_is_correct(monkeypatch):
    out = run(monkeypatch, small_cell("resolver1.ycsb_a"))
    assert out["correct"], out["checks"]
    assert out["checks"]["unsound_commits"]["value"] == 0
    assert out["attempted"] > 0 and out["failed"] == 0


def test_history_left_unchanged_is_caught(monkeypatch, resolver_cls):
    from foundationdb_tpu_torch.resolver.resolver import ResolveHandle

    orig = resolver_cls.resolve_many

    def frozen(self, batches, lazy=False):
        saved = [t.clone() for t in self.state]
        res = orig(self, batches, lazy=False)
        for t, s in zip(self.state, saved):
            t.copy_(s)
        return ResolveHandle(result=res) if lazy else res

    monkeypatch.setattr(resolver_cls, "resolve_many", frozen)
    out = run(monkeypatch, small_cell("resolver1.ycsb_a"))
    assert not out["correct"]
    assert out["checks"]["unsound_commits"]["value"] > 0


def test_half_of_each_batch_left_out_is_caught(monkeypatch, resolver_cls):
    from foundationdb_tpu_torch.core.flatpack import FlatTxnBatch, entry_width
    from foundationdb_tpu_torch.resolver.resolver import ResolveHandle

    orig = resolver_cls.resolve_many

    def half(f):
        h = len(f) // 2
        E = entry_width(f.num_limbs)

        def cut(blob, counts, per):
            return blob[:int(counts[:h].sum()) * per * E]

        return FlatTxnBatch(f.num_limbs, f.rv[:h], f.prc[:h], f.pwc[:h],
                            f.rrc[:h], f.rwc[:h], cut(f.pr_blob, f.prc, 1),
                            cut(f.pw_blob, f.pwc, 1), cut(f.rr_blob, f.rrc, 2),
                            cut(f.rw_blob, f.rwc, 2))

    def halved(self, batches, lazy=False):
        res = orig(self, [(half(f), cv, ws) for f, cv, ws in batches])
        res = [list(s) + list(s)[:len(f) - len(s)]
               for s, (f, _, _) in zip(res, batches)]
        return ResolveHandle(result=res) if lazy else res

    monkeypatch.setattr(resolver_cls, "resolve_many", halved)
    out = run(monkeypatch, small_cell("resolver1.ycsb_a"))
    assert not out["correct"]


def test_altered_answer_is_caught(monkeypatch, resolver_cls):
    from foundationdb_tpu_torch.resolver.resolver import ResolveHandle

    orig = resolver_cls.resolve_many

    def altered(self, batches, lazy=False):
        res = [list(s) for s in orig(self, batches)]
        for s in res:
            i = s.index(1) if 1 in s else 0
            s[i] = 0  # one CONFLICT answered COMMITTED
        return ResolveHandle(result=res) if lazy else res

    monkeypatch.setattr(resolver_cls, "resolve_many", altered)
    out = run(monkeypatch, small_cell("resolver1.ycsb_a"))
    assert not out["correct"]
    assert out["checks"]["unsound_commits"]["value"] > 0


def test_run_refuses_without_a_card():
    p = subprocess.run(
        [sys.executable, "fdbbench/run.py", "--workload", "resolver1.ycsb_a",
         "--seed", "5", "--seconds", "1", "--trace", "0"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""


def test_harness_loads_no_jax_and_the_reference_nothing_of_the_program():
    code = (
        "import sys, json\n"
        "from fdbbench import reference, traffic, roofline, devtrace\n"
        "ref = sorted({m.split('.')[0] for m in sys.modules})\n"
        "from fdbbench import harness, spec\n"
        "cell = spec.Cell('resolver1.ycsb_a')\n"
        "cell.mix['pool_batches'] = 8\n"
        "harness.WARMUP_BATCHES = 2\n"
        "out = harness.run(cell, 3, 0.2, False, device='cpu',"
        " log=lambda *a: None)\n"
        "top = sorted({m.split('.')[0] for m in sys.modules})\n"
        "print(json.dumps([ref, top, out['correct']]))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    ref, top, correct = json.loads(p.stdout.strip().splitlines()[-1])
    assert correct
    assert "foundationdb_tpu_torch" in top  # the program did run
    for banned in ("jax", "jaxlib", "flax", "foundationdb_tpu"):
        assert banned not in top  # whole top-level names
        assert banned not in ref
    assert "foundationdb_tpu_torch" not in ref
    assert harness.forbidden_modules() == sorted(
        {"jax", "jaxlib", "flax", "foundationdb_tpu"}
        & {m.split(".")[0] for m in sys.modules})


RUN_ON_THE_CPU = """
import sys
sys.path[:0] = [{stubs!r}, {root!r}]
import importlib.util, runpy
import torch
torch.cuda.is_available = lambda: True
torch.cuda.device_count = lambda: 1
torch.cuda.synchronize = lambda *a: None
from fdbbench import harness, spec
real_run = harness.run
def on_the_cpu(cell, seed, seconds, trace, device, t_start):
    cell.mix["pool_batches"] = 8
    harness.WARMUP_BATCHES = 2
    return real_run(cell, seed, seconds, trace, device="cpu", t_start=t_start)
harness.run = on_the_cpu
real_reader = spec.metric_reader
def planted(name):
    if name != "device.idle_pct":
        return real_reader(name)
    s = importlib.util.spec_from_file_location("planted", {reader!r})
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod
spec.metric_reader = planted
sys.argv = ["run.py", "--workload", "resolver1.ycsb_a", "--seed", "9",
            "--seconds", "0.3", "--trace", "1"]
runpy.run_path({run!r}, run_name="__main__")
"""


@pytest.mark.parametrize("reader_imports_jax", [True, False])
def test_jax_loaded_by_a_metric_reader_withholds_the_result(
        tmp_path, reader_imports_jax):
    """A module named ``jax`` that a metric reader loads after the window
    has closed stops the run before it prints a result; the same run
    with a reader that loads nothing prints one."""
    (tmp_path / "stubs" / "jax").mkdir(parents=True)
    (tmp_path / "stubs" / "jax" / "__init__.py").write_text("")
    reader = tmp_path / "reader.py"
    reader.write_text("def read(ctx):\n"
                      + ("    import jax  # noqa: F401\n"
                         if reader_imports_jax else "")
                      + "    return 1.0\n")
    code = RUN_ON_THE_CPU.format(
        stubs=str(tmp_path / "stubs"), root=spec.ROOT, reader=str(reader),
        run=str(spec.HERE + "/run.py"))
    p = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                       capture_output=True, text=True, timeout=300)
    lines = p.stdout.strip().splitlines()
    if reader_imports_jax:
        assert p.returncode != 0
        assert "loaded during the run: jax" in p.stderr
        assert not any(line.startswith("{") for line in lines)
    else:
        assert p.returncode == 0, p.stderr[-2000:]
        result = json.loads(lines[-1])
        assert result["metrics"]["device.idle_pct"]["value"] == 1.0
