"""One run of one cell: the cell's parts found by name, set-up, the measured
window, the per-layer readers, the comparison with the reference, and the
result line.

Everything that belongs to one configuration, traffic mix, per-layer metric
or cell is a file of its own, found by the name ``BENCHMARK.json`` gives it:

- ``gpbench/configs/<config>.json``: the sizes and the builder's settings;
- ``gpbench/traffic/<mix>.json``: the mix's parameters, read by the loop
  its ``"loop"`` names (``gpbench/loops.py``);
- ``gpbench/metrics/<metric>.py``: a reader, ``read(run)`` returning a number
  or None, with an optional ``prepare(run)`` called before the window;
- ``gpbench/limits/<cell>.json``: the limits of the numbers compared; a cell
  without them does not run.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

from . import check, trace as tracing

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "friedrich_tpu")


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


def load_metric_module(name: str, root: Path = ROOT):
    path = root / "gpbench" / "metrics" / f"{name}.py"
    if not path.exists():
        raise CellError(f"per-layer metric {name!r} has no reader {path}")
    spec = importlib.util.spec_from_file_location(f"gpbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


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
    """State of one run, shared by the loop and the per-layer readers."""

    def __init__(self, cell: Cell, seed: int, traced: bool, device: str):
        self.config = cell.config
        self.traffic = cell.traffic
        self.seed = int(seed)
        self.traced = traced
        self.device = torch.device(device)
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
        self.trace: tracing.Trace | None = None
        self.window_s = 0.0
        self.steps: list = []  # (live n, seconds) of each step of the window

    def span(self, name: str, seconds: float) -> None:
        self.spans.setdefault(name, []).append(seconds)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def program_counters(loop) -> dict:
    """The program's own counters, copied."""
    from friedrich_tpu_torch.ops.cuda import covariance_cuda, panel_strip_cuda

    out = {"b1_by_shape": dict(covariance_cuda.LAUNCHES_BY_SHAPE),
           "b2_by_variant": dict(panel_strip_cuda.LAUNCHES_BY_VARIANT)}
    out.update(loop.counters())
    return out


def forbidden_modules() -> list:
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def device_info(device: torch.device, peak_bytes: int) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
                "memory_peak_bytes": int(peak_bytes)}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": int(peak_bytes)}


def make_profiler(activities):
    """A profiler of every thread: the server's dispatcher runs the
    program's sweeps on a thread of its own."""
    from torch._C._profiler import _ExperimentalConfig

    config = _ExperimentalConfig(profile_all_threads=True)
    return torch.profiler.profile(activities=activities, experimental_config=config)


def execute(cell: Cell, seed: int, seconds: float, traced: bool, device: str,
            started: float, log=print, readings: bool = False, control: bool = False) -> dict:
    """One run of ``cell``: returns the result object (without printing).
    ``started`` is the host clock when the process began its set-up.
    ``readings`` adds every reading of the program's answers; ``control``
    adds those and the control's (``check.control_readings``)."""
    from .loops import make_loop

    run = Run(cell, seed, traced, device)
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
    run.counters_after = program_counters(loop)
    peak = torch.cuda.max_memory_allocated(run.device) if run.device.type == "cuda" else 0
    for module in readers.values():
        if hasattr(module, "finish"):
            module.finish(run)

    values = {"setup_s": setup_s, "peak_mem_gb": peak / 1e9, **outcome.metrics}
    metrics = {}
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
    correct, checks = check.compare(read, cell.limits, failed=outcome.failed)
    result = {"correct": bool(correct), "attempted": int(outcome.attempted),
              "failed": int(outcome.failed), "metrics": metrics,
              "device": device_info(run.device, peak)}
    if traced and run.trace is not None:
        busy = tracing.busy_ns(run.trace) / 1e9
        result["device"].update(busy_s=busy, window_s=run.trace.window_s)
        result["breakdown"] = tracing.breakdown(run.trace)
    if readings or control:
        result["readings"] = read
    if control:
        result["control"] = check.control_readings(outputs)
    result["checks"] = checks
    return result
