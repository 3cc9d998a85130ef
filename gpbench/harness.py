"""One run of one cell: the cell's parts found by name, set-up, the measured
window, the per-layer readers, the comparison with the reference, and the
result line.

Everything that belongs to one configuration, traffic mix, per-layer metric
or cell is a file of its own, found by the name ``BENCHMARK.json`` gives it:

- ``gpbench/configs/<config>.json``: the sizes and the builder's settings;
- ``gpbench/traffic/<mix>.json``: the mix's parameters, read by the loop
  its ``"loop"`` names: one built into ``gpbench/loops.py``, or the
  ``LOOP`` of ``gpbench/flows/<loop>.py``;
- ``gpbench/metrics/<metric>.py``: a reader, ``read(run)`` returning a number
  or None, with an optional ``prepare(run)`` called before the window;
- ``gpbench/limits/<cell>.json``: the limits of the numbers compared; a cell
  without them does not run.

A cell on W > 1 cards runs as W ranks, one process on each card
(``gpbench/world.py``), each calling :func:`execute`: every rank sets up,
runs the window and releases the program's state alike; the ranks' reports
are gathered to rank 0, which reads the metrics and returns the result. A
cell on one card runs in the one process, with no process group.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import re
import sys
import time
from pathlib import Path

import torch

from . import check, trace as tracing

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "friedrich_tpu")
#: A name of the manifest, and of a file found by it.
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


class CellError(RuntimeError):
    """The cell cannot run: a missing part, or no card."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_manifest(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.exists():
        raise CellError(f"no {path}")
    return load_json(path)


def metric_applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_module(path: Path, kind: str):
    """The module of the file ``path``, loaded under a name of its own."""
    name = f"gpbench_{kind}_{path.stem.replace('.', '_').replace('-', '_')}"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_metric_module(name: str, root: Path = ROOT):
    path = root / "gpbench" / "metrics" / f"{name}.py"
    if not path.exists():
        raise CellError(f"per-layer metric {name!r} has no reader {path}")
    return load_module(path, "metric")


class Cell:
    """A cell of the manifest with its configuration, mix, metrics and
    limits, all read from their files."""

    def __init__(self, name: str, root: Path = ROOT):
        manifest = load_manifest(root)
        self.root = root
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise CellError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = cells[name]
        configs = {c["name"]: c for c in manifest["configs"]}
        self.config = load_json(root / configs[self.entry["config"]]["file"])
        self.traffic = load_json(root / "gpbench" / "traffic" / f"{self.entry['traffic']}.json")
        self.chips = int(self.entry["chips"])
        self.end_to_end = [m for m in manifest["end_to_end"] if metric_applies(m, name)]
        self.per_layer = [m for m in manifest["per_layer"] if metric_applies(m, name)]
        limits = root / "gpbench" / "limits" / f"{name}.json"
        if not limits.exists():
            raise CellError(f"workload {name!r} has no limits file {limits}")
        self.limits = load_json(limits)
        if not self.limits:
            raise CellError(f"{limits} names no number to compare")


class Run:
    """State of one run, shared by the loop and the per-layer readers. In a
    cell on W cards each rank has its own: ``rank`` of ``world``, on its
    ``device``."""

    def __init__(self, cell: Cell, seed: int, traced: bool, device: str, rank: int = 0,
                 world: int = 1):
        self.root = cell.root
        self.config = cell.config
        self.traffic = cell.traffic
        self.seed = int(seed)
        self.traced = traced
        self.device = torch.device(device)
        self.rank = int(rank)
        self.world = int(world)
        self.dtype = {"float32": torch.float32, "float64": torch.float64}[cell.config["dtype"]]
        #: Seconds of the benchmark's own clocks around calls into a layer.
        self.spans: dict = {}
        #: ``builder.timings`` of each model trained in the window.
        self.timings: list = []
        #: Program counters read before and after the window.
        self.counters_before: dict = {}
        self.counters_after: dict = {}
        #: What the per-layer readers recorded themselves (``prepare``).
        self.records: dict = {}
        #: This rank's trace; on rank 0 after the window, every rank's
        #: (``traces``) and every rank's report (``rank_reports``: its peak,
        #: counters, records, spans and trace), in rank order.
        self.trace: tracing.Trace | None = None
        self.traces: list = []
        self.rank_reports: list = []
        self.window_s = 0.0
        self.steps: list = []  # (live n, seconds) of each step of the window

    def span(self, name: str, seconds: float) -> None:
        self.spans.setdefault(name, []).append(seconds)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def barrier(self) -> None:
        """Every rank waits for the others; nothing on one card."""
        if self.world > 1:
            torch.distributed.barrier()

    def agree(self, flag: bool) -> bool:
        """Rank 0's ``flag`` on every rank: in a multi-rank loop, rank 0
        decides (whether the window goes on) and the others follow."""
        if self.world == 1:
            return bool(flag)
        box = torch.tensor([int(bool(flag))], device=self.device)
        torch.distributed.broadcast(box, src=0)
        return bool(box.item())


def gather(obj, rank: int, world: int) -> list | None:
    """Every rank's ``obj`` on rank 0, in rank order (None on the others);
    ``[obj]`` on one card, with no process group."""
    if world == 1:
        return [obj]
    out = [None] * world if rank == 0 else None
    torch.distributed.gather_object(obj, out, dst=0)
    return out


def program_counters(loop) -> dict:
    """The program's own counters, copied."""
    from friedrich_tpu_torch.ops.cuda import covariance_cuda, panel_strip_cuda

    out = {"b1_by_shape": dict(covariance_cuda.LAUNCHES_BY_SHAPE),
           "b2_by_variant": dict(panel_strip_cuda.LAUNCHES_BY_VARIANT)}
    out.update(loop.counters())
    return out


def peak_bytes(device: torch.device) -> int:
    """The card's peak of allocated memory since its reset (none on the CPU)."""
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def forbidden_modules() -> list:
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def device_info(device: torch.device, peaks: list) -> dict:
    """The result's ``device``: ``count`` cards, the fullest card's peak,
    and on more than one card each card's under ``cards``."""
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    info = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind,
            "count": len(peaks), "memory_peak_bytes": int(max(peaks))}
    if len(peaks) > 1:
        info["cards"] = [{"rank": r, "memory_peak_bytes": int(p)} for r, p in enumerate(peaks)]
    return info


def make_profiler(activities):
    """A profiler of every thread: the server's dispatcher runs the
    program's sweeps on a thread of its own."""
    from torch._C._profiler import _ExperimentalConfig

    config = _ExperimentalConfig(profile_all_threads=True)
    return torch.profiler.profile(activities=activities, experimental_config=config)


def execute(cell: Cell, seed: int, seconds: float, traced: bool, device: str,
            started: float, log=print, readings: bool = False, control: bool = False,
            rank: int = 0, world: int = 1) -> dict | None:
    """One run of ``cell``: returns the result object (without printing).
    ``started`` is the host clock when the process began its set-up.
    ``readings`` adds every reading of the program's answers; ``control``
    adds those and the control's (``check.control_readings``).

    On W > 1 ranks every rank calls this, in a process group that exists,
    with its ``rank`` and its card's ``device``; rank 0 returns the result,
    the others None. Each rank traces its own card; the peak is the fullest
    card's, ``busy_s`` and ``window_s`` the cards' means, the breakdown
    taken over every card."""
    from .loops import make_loop

    run = Run(cell, seed, traced, device, rank, world)
    loop = make_loop(run)
    loop.setup()
    run.sync()
    readers = ({m["name"]: load_metric_module(m["name"], cell.root) for m in cell.per_layer}
               if traced else {})
    for module in readers.values():
        if hasattr(module, "prepare"):
            module.prepare(run)
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(run.device)
    run.counters_before = program_counters(loop)
    run.barrier()
    setup_s = time.perf_counter() - started
    profiler = None
    if traced:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if run.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = make_profiler(activities)
        profiler.__enter__()
    with torch.profiler.record_function(tracing.WINDOW_RANGE):
        outcome = loop.window(seconds)
        run.sync()
    if profiler is not None:
        profiler.__exit__(None, None, None)
        run.trace = tracing.from_profiler(profiler)
        del profiler
    run.barrier()
    run.counters_after = program_counters(loop)
    peak = peak_bytes(run.device)
    for module in readers.values():
        if hasattr(module, "finish"):
            module.finish(run)
    report = {"rank": run.rank, "peak_bytes": peak, "trace": run.trace,
              "counters_before": run.counters_before, "counters_after": run.counters_after,
              "records": run.records, "spans": run.spans, "timings": run.timings,
              "steps": run.steps, "window_s": run.window_s}
    reports = gather(report, run.rank, run.world)

    metrics = {}
    if run.rank == 0:
        run.rank_reports = reports
        run.traces = [r["trace"] for r in reports]
        peaks = [r["peak_bytes"] for r in reports]
        values = {"setup_s": setup_s, "peak_mem_gb": max(peaks) / 1e9, **outcome.metrics}
        if traced:
            for m in cell.per_layer:
                value = readers[m["name"]].read(run)
                if value is not None:
                    metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        else:
            for m in cell.end_to_end:
                if m["name"] not in values:
                    raise CellError(f"the {cell.traffic['loop']} loop gives no {m['name']}")
                metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}

    for line in outcome.notes:
        log(line)
    outputs = loop.outputs()
    loop.release()
    del loop
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    read = check.readings(outputs)
    control_read = check.control_readings(outputs) if control else None
    if run.rank != 0:
        return None
    correct, checks = check.compare(read, cell.limits, failed=outcome.failed)
    result = {"correct": bool(correct), "attempted": int(outcome.attempted),
              "failed": int(outcome.failed), "metrics": metrics,
              "device": device_info(run.device, peaks)}
    if traced and run.trace is not None:
        cards = [(tracing.busy_ns(t) / 1e9, t.window_s) for t in run.traces]
        result["device"].update(busy_s=sum(b for b, _ in cards) / len(cards),
                                window_s=sum(w for _, w in cards) / len(cards))
        if len(cards) > 1:
            for card, (busy, window) in zip(result["device"]["cards"], cards):
                card.update(busy_s=busy, window_s=window)
        result["breakdown"] = tracing.breakdown(*run.traces)
    if readings or control:
        result["readings"] = read
    if control:
        result["control"] = control_read
    result["checks"] = checks
    return result
