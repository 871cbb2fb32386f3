"""flowlint's per-file rules on the port (FL001–FL005, the engine's
suppressions, baseline and CLI): every synthetic-source case of the
JAX package's tests/test_flowlint.py runs through both packages' rules,
which must find the same rule, line and message; plus the port's own
FL004 roots, the functions a StaticStep captures into a CUDA graph."""

import os
import sys
import textwrap

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))

from foundationdb_tpu_torch.analysis import flowlint  # noqa: E402
from foundationdb_tpu_torch.analysis.rules import fl004_jit  # noqa: E402
from tests import test_flowlint as ref  # noqa: E402
from tests.torch_flowlint_twin import assert_twin, run_twin, twin_cases  # noqa: E402


@pytest.mark.parametrize("case", twin_cases(ref))
def test_rule_case_matches_jax(case, request):
    assert_twin(run_twin(ref, case, request))


def lint(path, src):
    return flowlint.lint_source(path, textwrap.dedent(src))


def test_fl004_flags_print_in_a_captured_lambdas_callee():
    """The port's root: a function handed to StaticStep through a
    lambda is captured into a CUDA graph, and so is what it calls; a
    print there fires at capture only, never on replay."""
    findings = lint("ops/foo.py", """
        from foundationdb_tpu_torch.ops import conflict as ck

        def helper(x):
            print("captured")
            return x

        def step(state, batch):
            return helper(state)

        def eager(x):
            print("not captured")

        def make(state):
            return ck.StaticStep(lambda s, b: step(s, b)[0], state, None)
    """)
    assert [(f.rule, f.line) for f in findings] == [("FL004", 5)]
    assert "capture-reachable function 'helper'" in findings[0].message
    assert "never on replay" in findings[0].message


def test_fl004_roots_through_bindings_and_scan_of():
    """A lambda bound to a name, a ``self.<attr> = scan_of(...)``
    binding and the graph's own ``with torch.cuda.graph(...)`` body all
    root what they call (parallel/mesh.py's and ops/conflict.py's
    shapes)."""
    findings = lint("parallel/foo.py", """
        import numpy as np
        import torch

        class Kernel:
            def __init__(self):
                self._scan_step = scan_of(self._step)

            def _step(self, state, batch):
                self.hits = np.sum(batch)
                return state

            def _other(self, state):
                open("/dev/null")

            def static_step(self, state):
                return ck.StaticStep(
                    lambda s, b: self._scan_step(s, b)[1], state, None)

            def capture(self, graph, state):
                with torch.cuda.graph(graph):
                    out = self._other(state)
                return out
    """)
    msgs = sorted(f.message for f in findings)
    assert [f.rule for f in findings] == ["FL004"] * 3
    assert "mutates self.hits" in msgs[0] and "'_step'" in msgs[0]
    assert "np.sum" in msgs[1] and "'_step'" in msgs[1]
    assert "open()" in msgs[2] and "'_other'" in msgs[2]


def test_fl004_clean_captured_step_and_scope():
    """A pure captured step passes; the same source outside ops/,
    resolver/ and parallel/ is not in the rule's scope."""
    src = """
        import torch

        def step(state, batch):
            return torch.maximum(state, batch)

        def make(state):
            return StaticStep(lambda s, b: step(s, b), state, None)

        def bad(state):
            print(state)

        def make_bad(state):
            return StaticStep(lambda s, b: bad(s), state, None)
    """
    assert [f.rule for f in lint("resolver/foo.py", src)] == ["FL004"]
    assert lint("server/foo.py", src) == []
    assert lint("ops/foo.py", src.split("def bad")[0]) == []


def test_fl004_reaches_the_ports_captured_steps():
    """On the port's own tree the roots are live: ops/conflict.py's
    StaticStep lambdas reach resolve_batch, and parallel/mesh.py's reach
    the lane kernels' _step; neither module has a finding."""
    import ast

    pkg = flowlint.package_dir()
    captured = {}
    for rp in ("ops/conflict.py", "parallel/mesh.py"):
        with open(os.path.join(pkg, rp), encoding="utf-8") as f:
            tree = ast.parse(f.read())
        assert list(fl004_jit.check(tree, rp)) == []
        _, traced, captured[rp] = fl004_jit.reachable_functions(tree)
        assert traced == set()
    assert "resolve_batch" in captured["ops/conflict.py"]
    assert "_step" in captured["parallel/mesh.py"]


def test_fl004_jax_shaped_source_reads_as_the_reference_rule():
    """The JAX package's roots are kept, with its wording, so a source
    of its shape gets the same finding from both rules."""
    findings = lint("ops/foo.py", ref.FL004_SRC)
    assert [f.rule for f in findings] == ["FL004", "FL004"]
    assert all("jit-reachable" in f.message for f in findings)


def test_backoff_jitter_rides_the_seeded_stream_as_the_reference():
    """FL001 exempts ``utils/backoff.py`` as the backoff seam: its
    jitter draws from the named "backoff-jitter" stream, so one seed
    gives the reference's delays, and each sleep is counted."""
    from foundationdb_tpu.core import deterministic as jdet
    from foundationdb_tpu.utils import backoff as jbackoff
    from foundationdb_tpu_torch.core import deterministic as tdet
    from foundationdb_tpu_torch.utils import backoff as tbackoff

    delays = []
    for det, mod in ((jdet, jbackoff), (tdet, tbackoff)):
        det.seed(17)
        try:
            b = mod.Backoff(initial_s=0.0001, max_s=0.0004)
            before = mod.retry_count()
            delays.append([b.delay() for _ in range(5)] + [b.sleep()])
            assert mod.retry_count() == before + 1
        finally:
            det.unseed()
    assert delays[0] == delays[1]
    assert len(set(delays[1][:3])) == 3
