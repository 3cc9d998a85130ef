"""A cell on several cards, added to a scratch copy of the tree as new files
only (a configuration, mixes, a loop of ``gpbench/flows/``, limits, an
end-to-end metric and a reader), run as a world of CPU ranks over gloo
through the command's own path: ``gpbench.run``, ``gpbench.control`` and
``gpbench.sweep`` with the look for a card skipped. Rank 0 starts the other
ranks (``gpbench/world.py``) and prints the one result."""

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import time

import pytest

from gpbench import harness

from .world_card import MIX, add_cells

#: Every test's limit on one command, seconds.
LIMIT_S = 180
HOOK = ("import sys; from gpbench import {tool}, world; {setup}"
        "sys.exit({tool}.main(sys.argv[1:], device='cpu'))")


def digest(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "gpbench").rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture
def tree(tmp_path):
    """A scratch copy of the tree; ``tree(chips, **mixes)`` adds the cells,
    checks that no file of the copy changed, and returns its root."""
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(harness.ROOT / "BENCHMARK.json", root)
    shutil.copytree(harness.PACKAGE, root / "gpbench", ignore=shutil.ignore_patterns("__pycache__"))
    before = digest(root)

    def extend(chips: int, **mixes) -> object:
        add_cells(root, chips, mixes)
        after = digest(root)
        assert {k: v for k, v in after.items() if k in before} == before
        return root

    return extend


def command(root, tool: str, *args, setup: str = ""):
    """A tool of the benchmark from ``root``, rank 0 in its own process; the
    program from this checkout."""
    env = dict(os.environ, PYTHONPATH=str(harness.ROOT), OMP_NUM_THREADS="1")
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, "-c", HOOK.format(tool=tool, setup=setup), *args],
                         capture_output=True, text=True, cwd=root, env=env, timeout=LIMIT_S)
    out.seconds = time.monotonic() - t0
    return out


def pids(stderr: str) -> list:
    found = re.search(r"gpbench: ranks 1-\d+: pids ([\d ]+)", stderr)
    assert found, stderr[-3000:]
    return [int(p) for p in found.group(1).split()]


def assert_gone(pid_list, wait_s: float = 10.0) -> None:
    deadline = time.monotonic() + wait_s
    alive = list(pid_list)
    while alive and time.monotonic() < deadline:
        alive = [p for p in alive if os.path.exists(f"/proc/{p}")
                 and open(f"/proc/{p}/stat").read().split()[2] != "Z"]
        time.sleep(0.1)
    assert not alive, f"ranks left running: {alive}"


def result_line(out) -> dict:
    lines = out.stdout.strip().splitlines()
    assert out.returncode == 0, out.stderr[-4000:]
    assert len(lines) == 1, out.stdout[-2000:]
    return json.loads(lines[0])


@pytest.mark.parametrize("chips,traced", [(2, 1), (4, 0)])
def test_a_world_runs_and_is_correct(tree, chips, traced):
    root = tree(chips, **{"tiny-world": dict(MIX, peak_bytes=[3, 9, 5, 7][:chips])})
    out = command(root, "run", "--workload", "tiny-world", "--seed", str(2**40 + 17),
                  "--seconds", "0.5", "--trace", str(traced))
    result = result_line(out)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    device = result["device"]
    assert device["count"] == chips and device["platform"] == "cpu"
    assert [c["memory_peak_bytes"] for c in device["cards"]] == [3, 9, 5, 7][:chips]
    assert device["memory_peak_bytes"] == 9
    if traced:
        assert set(result["metrics"]) == {"tiny.collectives"}
        assert result["metrics"]["tiny.collectives"]["value"] > 0
        assert "busy_s" in device and all("busy_s" in c for c in device["cards"])
        assert "breakdown" in result
    else:
        assert set(result["metrics"]) == {"predict_s", "setup_s", "peak_mem_gb"}
        assert result["metrics"]["peak_mem_gb"]["value"] == 9 / 1e9
    assert_gone(pids(out.stderr))
    assert re.search(r"rank 1: tiny_world: \d+ predictions on rank 1 of", out.stderr)


@pytest.mark.parametrize("fault", ["", "answers_altered"])
def test_the_control_and_a_fault_on_every_rank(tree, fault):
    root = tree(2, **{"tiny-world": MIX})
    out = command(root, "control", "--workload", "tiny-world", "--seeds", "31,32",
                  "--control-seeds", "32", "--seconds", "0.3", "--fault", fault)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = [json.loads(line) for line in out.stdout.strip().splitlines()]
    assert [line["seed"] for line in lines] == [31, 32]
    for line in lines:
        assert line["correct"] == (not fault), line
    if fault:
        assert lines[0]["readings"]["mean_gap"] == pytest.approx(0.05, abs=1e-3)
    else:
        assert lines[0]["control"] is None
        assert lines[1]["control"]["var_gap"] > 10 * lines[1]["readings"]["var_gap"]
    assert_gone(pids(out.stderr))


def test_a_sweep_runs_over_the_world(tree):
    root = tree(2, **{"tiny-world": MIX})
    out = command(root, "sweep", "--workload", "tiny-world", "--seed", "7", "--seconds", "0.3",
                  "--rates", "1,2")
    assert out.returncode == 0, out.stderr[-4000:]
    lines = [json.loads(line) for line in out.stdout.strip().splitlines()]
    assert [line["rate_per_s"] for line in lines] == [1.0, 2.0]
    assert_gone(pids(out.stderr))


def test_a_rank_that_raises_in_set_up_fails_the_run(tree):
    root = tree(2, **{"tiny-raise": dict(MIX, fail="setup", fail_rank=1)})
    out = command(root, "run", "--workload", "tiny-raise", "--seed", "1", "--seconds", "0.5")
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "rank 1 fails in set-up, as the mix asks" in out.stderr
    assert out.seconds < 60
    assert_gone(pids(out.stderr))


def test_a_rank_that_hangs_in_the_window_fails_the_run(tree):
    """The collectives' timeout, cut to seconds here, ends the wait; the
    hung rank's stack is on standard error."""
    root = tree(4, **{"tiny-hang": dict(MIX, fail="window", fail_rank=2)})
    out = command(root, "run", "--workload", "tiny-hang", "--seed", "1", "--seconds", "0.5",
                  setup="world.SLACK_S = 8.0; ")
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "tiny_world.py" in out.stderr and "in fail" in out.stderr, out.stderr[-4000:]
    assert out.seconds < 90
    assert_gone(pids(out.stderr))


def test_the_ranks_end_when_rank_0_is_killed(tree):
    """As NCCL's watchdog does to a rank 0 that waits on a hung rank: the
    other ranks end themselves, each printing its stacks."""
    root = tree(2, **{"tiny-hang": dict(MIX, fail="window", fail_rank=1)})
    env = dict(os.environ, PYTHONPATH=str(harness.ROOT), OMP_NUM_THREADS="1")
    hook = HOOK.format(tool="run", setup="world.SLACK_S = 60.0; ")
    proc = subprocess.Popen([sys.executable, "-c", hook,
                             "--workload", "tiny-hang", "--seed", "1", "--seconds", "0.5"],
                            stderr=subprocess.PIPE, stdout=subprocess.DEVNULL, text=True,
                            cwd=root, env=env)
    try:
        lines = []
        for line in proc.stderr:
            lines.append(line)
            if "hangs in the window" in line:
                break
        ranks = pids("".join(lines))
        time.sleep(1.0)  # rank 0 waits on rank 1 in a collective
        proc.kill()
        proc.wait(timeout=LIMIT_S)
        rest = proc.stderr.read()  # to its end: every rank has closed it
    finally:
        proc.kill()
    assert "rank 1: rank 0 is gone; this rank's stacks:" in rest
    assert "in fail" in rest, rest[-3000:]
    assert_gone(ranks)
