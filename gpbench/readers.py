"""What the per-layer readers of ``gpbench/metrics/`` share. Each reader
returns None where its run has nothing to read, and the harness then leaves
the metric out of the line."""

from __future__ import annotations

import statistics

from . import roofline, trace as tracing

B1_KERNEL = "cov_kernel"
B2_KERNEL = "panel_strip"
B2_HELPERS = ("bf16_rows",)


def mean(values) -> float | None:
    values = list(values)
    return statistics.fmean(values) if values else None


def device_seconds(run, *parts: str, without: tuple = ()) -> float:
    if run.trace is None:
        return 0.0
    ops = run.trace.ops_named(*parts, without=without)
    return sum(op.end - op.start for op in ops) / 1e9


def counter_delta(run, key: str) -> dict:
    before = run.counters_before.get(key, {})
    after = run.counters_after.get(key, {})
    return {k: v - before.get(k, 0) for k, v in after.items() if v - before.get(k, 0)}


def b1_roofline(run) -> float | None:
    """B1's share of its roofline over the window: the bound of every
    launch, by the program's count of launches by shape, over the device
    time of B1's kernels in the trace."""
    d = run.config["d"]
    bound = 0.0
    for (rows, cols, _train), count in counter_delta(run, "b1_by_shape").items():
        flops, nbytes = roofline.covariance_work(rows, cols, d, run.dtype)
        bound += count * roofline.bound_s(flops, nbytes, run.dtype)
    return roofline.share(bound, device_seconds(run, B1_KERNEL))


def idle_share(run) -> float | None:
    if run.trace is None or not run.trace.ops:
        return None
    return 100.0 * (1.0 - tracing.busy_ns(run.trace) / (run.trace.window[1] - run.trace.window[0]))


def mfu(run, flops: float) -> float | None:
    if run.window_s <= 0 or flops <= 0:
        return None
    return 100.0 * flops / run.window_s / roofline.PEAK_FLOPS[run.dtype]
