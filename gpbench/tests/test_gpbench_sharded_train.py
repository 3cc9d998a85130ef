"""The ``sharded_train`` loop and the readers of ``gp200k-train``: a tiny cell
of that loop (a scratch copy of the tree, the cell added as new files, n cut
to 2,048, so no sub-fit runs: the builder's Hutchinson fit at full n, whose
8 probes lose the signal on some data sets at 1,024) run as worlds of 2 and 4 gloo ranks through
``gpbench.run`` and ``gpbench.control``, as ``test_gpbench_world.py`` runs
its tiny cell; and the readers of the device trace against traces made up
here, which a CPU run does not give."""

import json
import shutil

import pytest

from gpbench import harness, trace as tracing
from gpbench.trace import DeviceOp, HostRange, Launch, Trace

from .test_gpbench_world import assert_gone, command, pids, result_line

CELL = "gp200k-train"
TINY = "tiny-sharded"
#: The readers of the cell.
METRICS = [m["name"] for m in harness.load_manifest()["per_layer"]
           if harness.metric_applies(m, CELL)]


def add_tiny_cell(root, chips: int) -> None:
    """``gp200k-train`` at n = 2,048 on ``chips`` CPU ranks, as new files of
    a scratch copy of the tree: its configuration, cell and limits, and the
    cell added to the lists of its metrics."""
    pkg = root / "gpbench"
    config = dict(harness.load_json(pkg / "configs" / "gp200k-f32-4chip.json"),
                  name="tiny-f32-sharded", n=2048, capacity=2048)
    (pkg / "configs" / "tiny-f32-sharded.json").write_text(json.dumps(config))
    shutil.copy(pkg / "limits" / f"{CELL}.json", pkg / "limits" / f"{TINY}.json")
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "tiny-f32-sharded", "source": "https://example.org/gp",
                                "file": "gpbench/configs/tiny-f32-sharded.json", "reduced": [],
                                "why": "test"})
    manifest["workloads"].append({"name": TINY, "config": "tiny-f32-sharded",
                                  "traffic": "sharded_train", "chips": chips, "why": "test"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append(TINY)
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))


@pytest.fixture
def tree(tmp_path):
    def make(chips: int):
        root = tmp_path / "checkout"
        root.mkdir()
        shutil.copy(harness.ROOT / "BENCHMARK.json", root)
        shutil.copytree(harness.PACKAGE, root / "gpbench",
                        ignore=shutil.ignore_patterns("__pycache__"))
        add_tiny_cell(root, chips)
        return root

    return make


@pytest.mark.parametrize("chips,traced", [(2, 1), (4, 0)])
def test_the_loop_runs_over_a_world_and_is_correct(tree, chips, traced):
    out = command(tree(chips), "run", "--workload", TINY, "--seed", str(2**40 + 18),
                  "--seconds", "0.5", "--trace", str(traced))
    result = result_line(out)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert result["device"]["count"] == chips
    if traced:
        # a CPU trace has no device operations: the readers of the device
        # trace stay silent, those of the program's clocks and counters read
        assert set(result["metrics"]) == {"factor.build_s.train",
                                          "comm.bcast_gb.sharded_train", "mfu.sharded_train"}
        assert all(m["value"] > 0 for m in result["metrics"].values())
    else:
        assert set(result["metrics"]) == {"train_s", "peak_mem_gb", "setup_s"}
    assert_gone(pids(out.stderr))
    assert f"sharded_train: rank 1 of {chips}:" in out.stderr


@pytest.mark.parametrize("fault", ["answers_altered", "half_the_data"])
def test_a_planted_fault_is_not_correct(tree, fault):
    out = command(tree(2), "control", "--workload", TINY, "--seeds", "41", "--seconds", "0.3",
                  "--fault", fault)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert not line["correct"], line
    if fault == "answers_altered":
        assert line["readings"]["mean_gap"] == pytest.approx(0.05, abs=1e-3)
    assert_gone(pids(out.stderr))


# -- the readers of the device trace, on traces made up here ---------------------


class Run:
    """What the readers read of a run on four cards."""

    def __init__(self, traces, reports, timings=(), window_s=1.0, n=200_000):
        self.traces, self.rank_reports = traces, reports
        self.trace = traces[0]
        self.timings = list(timings)
        self.window_s = window_s
        self.world = len(traces)
        self.config = {"n": n}
        import torch

        self.dtype = torch.float32


def card(ops):
    """A card's trace: one ``large_scale/factor`` scope on the host over
    [100, 900) with a ``mesh/broadcast`` scope inside it over [500, 600),
    and ``ops`` as ``(name, start, end, launched)``, each launched at the
    host time ``launched``."""
    return Trace([DeviceOp(name, s, e, i) for i, (name, s, e, _) in enumerate(ops)],
                 [HostRange(tracing.WINDOW_RANGE, 0, 10_000, 0),
                  HostRange("large_scale/factor", 100, 900, 0),
                  HostRange("mesh/broadcast", 500, 600, 0)],
                 [Launch(at, 0, i) for i, (*_, at) in enumerate(ops)], (0, 10_000))


def report(trace, shapes):
    return {"trace": trace, "counters_before": {"b2_by_shape": {}},
            "counters_after": {"b2_by_shape": shapes}}


def reader(name):
    return harness.load_metric_module(name)


def four_cards():
    """Rank r's factorization launches (r + 1) * 1,000 ns of B2 and 200 ns
    of a kernel that runs after the scope has closed on the host, and a
    broadcast of 300 ns; what is launched outside the factorization (the
    benchmark's own broadcast, a GEMM) is not counted, whenever it runs."""
    return [card([("panel_strip_tf32x3_ws_kernel", 1_000, 1_000 + (r + 1) * 1_000, 200),
                  ("trsm_kernel", 9_000, 9_200, 300),
                  ("ncclDevKernel_Broadcast_RING_LL", 5_500, 5_800, 550),
                  ("ncclDevKernel_Broadcast_RING_LL", 9_500, 9_800, 950),
                  ("void gemm_outside", 1_000, 5_000, 50)])
            for r in range(4)]


def test_the_card_balance_and_the_busiest_cards_nccl():
    run = Run(four_cards(), [])
    balance = reader("device.card_balance.sharded_train").read(run)
    assert balance == pytest.approx(100.0 * 2_700 / 4_200)
    assert reader("comm.nccl_s.sharded_train").read(run) == pytest.approx(300e-9)


def test_the_b2_roofline_sums_over_the_cards():
    from gpbench import roofline

    import torch

    traces = four_cards()
    shape = (50_000, 2_000, 100_000, 8, "float32", 2)
    run = Run(traces, [report(t, {shape: 1}) for t in traces])
    flops, nbytes = roofline.panel_strip_work(50_000, 2_000, 100_000, 8, torch.float32)
    bound = 4 * roofline.bound_s(flops, nbytes + 4 * 2_000 * 100_000, torch.float32)
    busy = sum((r + 1) * 1_000 for r in range(4)) / 1e9
    assert reader("b2_roofline.sharded_train").read(run) == pytest.approx(100 * bound / busy)


def test_the_mfu_counts_the_subfit_once_over_the_cards_peak():
    from gpbench import roofline

    import torch

    timings = [{"subfit": 1.0, "subfit_points": 40_000, "subfit_iterations": 11, "build": 1.0}]
    run = Run(four_cards(), [], timings, window_s=30.0)
    flops = roofline.train_flops(200_000, 40_000, 11)
    want = 100 * flops / 30.0 / (4 * roofline.PEAK_FLOPS[torch.float32])
    assert reader("mfu.sharded_train").read(run) == pytest.approx(want)


def test_the_readers_are_silent_on_one_card():
    one = [card([("panel_strip", 1_000, 2_000, 200)])]
    run = Run(one, [report(one[0], {})])
    for name in ("device.card_balance.sharded_train", "comm.nccl_s.sharded_train",
                 "b2_roofline.sharded_train"):
        assert reader(name).read(run) is None, name
    assert set(METRICS) >= {"device.card_balance.sharded_train", "comm.nccl_s.sharded_train",
                            "b2_roofline.sharded_train", "comm.bcast_gb.sharded_train",
                            "mfu.sharded_train", "fit.subfit_s.train", "factor.build_s.train",
                            "b1_roofline.train", "fit.iter_ms.train", "fit.iter_idle.train",
                            "device.idle.train"}
