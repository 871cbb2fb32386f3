"""One short run of the cheapest cell on the card: the result line as
the contract asks for it. Skips without a card; on a card run
``python -m pytest -m gpu fdbbench/tests``."""

import json
import subprocess
import sys

import pytest

from fdbbench import spec


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
def test_short_run_on_the_card(card):
    p = subprocess.run(
        [sys.executable, "fdbbench/run.py", "--workload", "resolver1.ycsb_a",
         "--seed", str(2 ** 31 + 11), "--seconds", "2", "--trace", "0"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["failed"] == 0
    assert set(out["metrics"]) == {"resolved_txns_per_s",
                                   "committed_txns_per_s",
                                   "resolve_batch_p95_ms", "setup_s"}
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
    assert list(out)[-1] == "checks"
    assert p.stderr.strip().splitlines()[-1].startswith("check ")
