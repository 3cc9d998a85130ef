"""Each mix's loop rehearsed at a tiny size on the CPU, through the
harness's test-only hooks; and the command's refusals."""

import json
import subprocess
import sys

import pytest

from gpbench import harness

from .tiny import run_tiny

CELLS = [w["name"] for w in harness.load_manifest()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_tiny_cell_runs_and_is_correct(cell, traced):
    result = run_tiny(cell, traced=traced)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    manifest = harness.load_manifest()
    if traced:
        # the CPU trace has no device operations: readers of the device
        # stay silent, the others report
        assert "breakdown" in result and result["device"]["busy_s"] == 0.0
        names = {m["name"] for m in manifest["per_layer"] if harness.metric_applies(m, cell)}
        assert set(result["metrics"]) <= names
    else:
        names = {m["name"] for m in manifest["end_to_end"] if harness.metric_applies(m, cell)}
        assert set(result["metrics"]) == names
    assert list(result["checks"])[-1] == "failed"
    json.dumps(result)


def test_the_command_refuses_a_machine_without_a_card():
    out = subprocess.run([sys.executable, "-m", "gpbench.run", "--workload", "gp50k-train",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=harness.ROOT, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_the_command_refuses_an_unknown_cell():
    out = subprocess.run([sys.executable, "-m", "gpbench.run", "--workload", "nope",
                          "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, cwd=harness.ROOT, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_a_large_seed_is_a_seed():
    from gpbench import data

    a = data.substream(2**40 + 3, "train")
    assert a == data.substream(2**40 + 3, "train") != data.substream(2**40 + 4, "train")
    assert 0 <= a < 2**63 and data.substream(-5, "train") != data.substream(5, "train")


def test_device_reports_the_fullest_card():
    import torch

    one = harness.device_info(torch.device("cpu"), [7])
    assert one == {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 7}
    four = harness.device_info(torch.device("cpu"), [3, 9, 5, 7])
    assert four["count"] == 4 and four["memory_peak_bytes"] == 9
    assert [c["memory_peak_bytes"] for c in four["cards"]] == [3, 9, 5, 7]


@pytest.mark.parametrize("body,match", [(None, "unknown loop"), ("X = 1\n", "no LOOP"),
                                        ("LOOP = dict\n", "no LOOP")])
def test_a_loop_is_built_in_or_a_flow_file(tmp_path, body, match):
    from gpbench.loops import flow_module

    (tmp_path / "gpbench" / "flows").mkdir(parents=True)
    if body is not None:
        (tmp_path / "gpbench" / "flows" / "mine.py").write_text(body)
    with pytest.raises(ValueError, match=match):
        flow_module("mine", tmp_path)
    with pytest.raises(ValueError, match="unknown loop"):
        flow_module("../mine", tmp_path)
