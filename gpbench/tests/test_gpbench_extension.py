"""A later change adds a configuration, a mix, a cell and a per-layer metric
as new files and new entries of BENCHMARK.json, and the harness finds them
by name with no other file edited."""

import hashlib
import json
import shutil

import pytest

from gpbench import harness

from .tiny import run_tiny


def digest(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "gpbench").rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture
def extended(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.PACKAGE, tmp_path / "gpbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = digest(tmp_path)
    pkg = tmp_path / "gpbench"
    config = json.loads((pkg / "configs" / "gp50k-f32-dense.json").read_text())
    config.update(name="gp60k-f32-dense", n=60_000, capacity=60_512)
    (pkg / "configs" / "gp60k-f32-dense.json").write_text(json.dumps(config))
    (pkg / "traffic" / "bo-wide.json").write_text(json.dumps(
        {"loop": "bo", "candidates": 8192, "batch": 32, "xi": 0.01, "warmup_steps": 1,
         "check_steps": 3}))
    (pkg / "metrics" / "bo.steps.bo-wide.py").write_text(
        "def read(run):\n    return float(len(run.steps)) or None\n")
    (pkg / "limits" / "gp60k-bo-wide.json").write_text(
        (pkg / "limits" / "gp50k-bo.json").read_text())
    manifest = json.loads((tmp_path / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "gp60k-f32-dense", "source": "https://example.org/gp",
                                "file": "gpbench/configs/gp60k-f32-dense.json", "reduced": [],
                                "why": "test"})
    manifest["workloads"].append({"name": "gp60k-bo-wide", "config": "gp60k-f32-dense",
                                  "traffic": "bo-wide", "chips": 1, "why": "test"})
    for m in manifest["end_to_end"]:
        if m["name"] == "bo_step_s":
            m["workloads"].append("gp60k-bo-wide")
    manifest["per_layer"].append({"name": "bo.steps.bo-wide", "unit": "steps", "better": "higher",
                                  "source": "host_clock", "layer": "whole flow or step",
                                  "moves": "bo_step_s", "workloads": ["gp60k-bo-wide"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    return tmp_path, before


def test_new_files_are_found_by_name(extended):
    root, before = extended
    cell = harness.Cell("gp60k-bo-wide", root)
    assert cell.config["n"] == 60_000 and cell.traffic["candidates"] == 8192
    assert [m["name"] for m in cell.per_layer][-1] == "bo.steps.bo-wide"
    assert cell.limits
    after = digest(root)
    assert {k: v for k, v in after.items() if k in before} == before
    result = run_tiny("gp60k-bo-wide", traced=True, root=root)
    assert result["correct"] and result["metrics"]["bo.steps.bo-wide"]["value"] >= 1


@pytest.mark.parametrize("limits", [None, "{}"], ids=["missing", "empty"])
def test_a_cell_without_limits_does_not_run(extended, limits):
    root, _ = extended
    path = root / "gpbench" / "limits" / "gp60k-bo-wide.json"
    if limits is None:
        path.unlink()
    else:
        path.write_text(limits)
    with pytest.raises(harness.CellError, match="limits|compare"):
        harness.Cell("gp60k-bo-wide", root)
