"""Tracing and profiling scopes.

Counterpart of ``friedrich_tpu/utils/profiling.py``. The reference has no
tracing (only commented-out ``println!`` lines,
``optimizer.rs:140,145-148,274,279-283``). Here: named ranges around the hot
phases (covariance build, factorization, solves, fit iterations, NUTS
transitions) that show in ``torch.profiler`` traces, where the device time of
the kernels launched inside a range is summed under its name, and, on a CUDA
device, as NVTX ranges for Nsight; plus a wall-clock timer for host-side logs.

Where the JAX package separates a host annotation (``annotate``) from a
device-side named scope for traced code (``scope``), eager PyTorch launches
every kernel from the host, so the two are the same range here.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named range: a ``torch.profiler.record_function`` (the profiler sums
    the device time of the kernels launched inside it under ``name``), and
    an NVTX range when CUDA is available. Costs about a microsecond when no
    profiler runs.

        with annotate("covariance-build"):
            k = train_covariance_padded(...)
    """
    with torch.profiler.record_function(name):
        if not torch.cuda.is_available():
            yield
            return
        torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            torch.cuda.nvtx.range_pop()


def scope(name: str):
    """The named scope of the library's hot paths, under the JAX package's
    names (``gp/build_factor[<backend>]``, ``gp/predict_mean``,
    ``fit/rebuild``, ``nuts/transition``, ...): :func:`annotate`."""
    return annotate(name)


@contextlib.contextmanager
def timed(name: str, log: Optional[list] = None) -> Iterator[None]:
    """Host-side wall-clock scope; appends (name, seconds) to ``log``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if log is not None:
            log.append((name, dt))


_TRACE: Optional[tuple[torch.profiler.profile, Path]] = None


def start_trace(logdir: str) -> None:
    """Begin a ``torch.profiler`` trace of the host and, when CUDA is
    available, the device; :func:`stop_trace` writes it to ``logdir``."""
    global _TRACE
    if _TRACE is not None:
        raise RuntimeError("a trace is already running; stop_trace() it first")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.__enter__()
    _TRACE = (prof, Path(logdir))


def stop_trace() -> torch.profiler.profile:
    """End the trace begun by :func:`start_trace` and write it to
    ``<logdir>/trace.json`` (Chrome trace format: Perfetto,
    ``chrome://tracing``). Returns the profiler, whose ``key_averages()``
    give the time by range and by kernel."""
    global _TRACE
    if _TRACE is None:
        raise RuntimeError("no trace is running; start_trace() first")
    prof, logdir = _TRACE
    _TRACE = None
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    logdir.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(logdir / "trace.json"))
    return prof
