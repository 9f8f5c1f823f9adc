"""A short run of each cell on the card through the benchmark's command
(skips without a card)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from bench.core import registry

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.parametrize("workload", [w["name"] for w in registry.benchmark()["workloads"]])
def test_a_short_run_is_correct_on_the_card(card, workload):
    res = subprocess.run([sys.executable, "bench/run.py", "--workload", workload, "--seed",
                          "2147483659", "--seconds", "5", "--trace", "0"],
                         capture_output=True, text=True, timeout=1200, cwd=str(ROOT))
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
