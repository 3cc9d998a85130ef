"""BENCHMARK.json against the benchmark's contract, and every part it names
present under ``gpbench/``."""

import json
import math
import re

import pytest

from gpbench import harness
from gpbench.loops import LOOPS

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def manifest():
    return harness.load_manifest()


def test_keys_and_sizes(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert len(json.dumps(manifest)) <= 64 * 1024
    assert 1 <= manifest["run_seconds"] <= 51 and isinstance(manifest["run_seconds"], int)
    assert all(not p.startswith("/") and ".." not in p for p in manifest["paths"])
    assert manifest["command"][:3] == ["python3", "-m", "gpbench.run"]
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("gpbench/configs/")
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in manifest["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in manifest["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES


def test_names_units_and_text(manifest):
    entries = manifest["configs"] + manifest["workloads"] + manifest["end_to_end"] + manifest["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in manifest[group]]
        assert len(names) == len(set(names)), group
    for w in manifest["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    texts = [e["why"] for e in manifest["configs"] + manifest["workloads"]]
    texts += [c["source"] for c in manifest["configs"]] + [m["layer"] for m in manifest["per_layer"]]
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t


def test_every_cell_reports_what_it_must(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e
    cells = [w["name"] for w in manifest["workloads"]]
    for cell in cells:
        reported = {n for n, m in e2e.items() if harness.metric_applies(m, cell)}
        assert "setup_s" in reported and len(reported) >= 2, cell
        assert any(harness.metric_applies(m, cell) for m in manifest["per_layer"]), cell
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert harness.metric_applies(e2e[m["moves"]], cell), (m["name"], cell)


def test_four_chip_share(manifest):
    cells = manifest["workloads"]
    four = sum(1 for w in cells if w["chips"] == 4)
    assert four <= max(1, math.floor(len(cells) * 0.25))


def test_layer_names_agree(manifest):
    """Metrics of one layer give it letter for letter the same name."""
    by_module = {}
    for m in manifest["per_layer"]:
        key = m["layer"].split(" (")[0]
        by_module.setdefault(key, set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_module.values()), by_module


def test_every_part_is_a_file(manifest):
    for w in manifest["workloads"]:
        cell = harness.Cell(w["name"])
        kind = cell.traffic["loop"]
        assert kind in LOOPS or (harness.PACKAGE / "flows" / f"{kind}.py").exists(), kind
        assert cell.limits, f"{w['name']} has no limits file"
        for m in cell.per_layer:
            assert callable(harness.load_metric_module(m["name"]).read)
    for c in manifest["configs"]:
        cfg = harness.load_json(harness.ROOT / c["file"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
