"""One short run of a cell on the card, and of the tests' tiny multi-rank
cell over every card where there are several (marked ``cuda``; skip without
them): ``python3 -m pytest gpbench/tests/test_gpbench_card.py -m cuda``."""

import json
import os
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


@pytest.mark.cuda
def test_a_multi_rank_cell_on_the_cards(tmp_path):
    """NCCL over every card of the machine, from a scratch copy of the tree
    with the cell added as new files."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs or more")
    from .world_card import make_tree

    size = torch.cuda.device_count()
    make_tree(tmp_path / "checkout", size)
    out = subprocess.run([sys.executable, "-m", "gpbench.run", "--workload", "tiny-world",
                          "--seed", "3000000998", "--seconds", "3", "--trace", "1"],
                         capture_output=True, text=True, cwd=tmp_path / "checkout", timeout=900,
                         env=dict(os.environ, PYTHONPATH=str(harness.ROOT)))
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["count"] == size and len(result["device"]["cards"]) == size
