"""One short run of a cell on the card (marked ``cuda``; skips without one):
``python3 -m pytest gpbench/tests/test_gpbench_card.py -m cuda``."""

import json
import subprocess
import sys

import pytest
import torch

from gpbench import harness


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark measures only on the card")


@pytest.mark.cuda
def test_a_short_run_on_the_card(card):
    out = subprocess.run([sys.executable, "-m", "gpbench.run", "--workload", "gp50k-train",
                          "--seed", "3000000999", "--seconds", "3", "--trace", "1"],
                         capture_output=True, text=True, cwd=harness.ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["busy_s"] > 0
