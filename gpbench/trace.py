"""Reduction of a ``torch.profiler`` trace of the measured window.

The device is busy while any kernel, copy or memset runs on any of its
streams: busy time is the length of the union of those intervals, so that
work overlapping on two streams is counted once (a sum of kernel times
counts it twice, and can read more busy time than the window holds). The
idle time is what the union leaves of the window. Each idle gap is named by
the innermost named range open on the host at its midpoint: the program's
scopes (``gp/...``, ``fit_large/...``, ``serving/batch``) before the
benchmark's own (``gpbench/...``).
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict

WINDOW_RANGE = "gpbench/window"
HARNESS_PREFIX = "gpbench/"


@dataclasses.dataclass
class DeviceOp:
    name: str
    start: int  # ns
    end: int
    correlation: int


@dataclasses.dataclass
class HostRange:
    name: str
    start: int
    end: int
    thread: int


@dataclasses.dataclass
class Launch:
    start: int
    thread: int
    correlation: int


@dataclasses.dataclass
class Trace:
    """What the readers use of a trace: the device's operations, the named
    host ranges and the launch calls, with the window's bounds."""

    ops: list
    ranges: list
    launches: list
    window: tuple  # (start ns, end ns)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def ops_named(self, *parts: str, without: tuple = ()) -> list:
        return [op for op in self.ops
                if all(p in op.name for p in parts) and not any(w in op.name for w in without)]

    def ranges_named(self, name: str) -> list:
        return [r for r in self.ranges if r.name == name]


def union_length(intervals) -> int:
    """Total length covered by ``(start, end)`` intervals, overlaps once."""
    total, cur_start, cur_end = 0, None, None
    for start, end in sorted(intervals):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        total += cur_end - cur_start
    return total


def idle_gaps(intervals, window: tuple) -> list:
    """The ``(start, end)`` stretches of ``window`` that no interval covers."""
    gaps, cursor = [], window[0]
    for start, end in sorted(intervals):
        start, end = max(start, window[0]), min(end, window[1])
        if end <= start:
            continue
        if start > cursor:
            gaps.append((cursor, start))
        cursor = max(cursor, end)
    if cursor < window[1]:
        gaps.append((cursor, window[1]))
    return gaps


def busy_ns(trace: Trace) -> int:
    lo, hi = trace.window
    return union_length((max(op.start, lo), min(op.end, hi)) for op in trace.ops
                        if op.end > lo and op.start < hi)


def labels_at(ranges, times) -> list:
    """For each of the sorted ``times``, the innermost named host range
    open then: a program scope before a range of the benchmark's own;
    ``host`` where none is open."""
    ordered = sorted((r for r in ranges if r.name != WINDOW_RANGE), key=lambda r: r.start)
    labels, active, i = [], [], 0
    for t in times:
        while i < len(ordered) and ordered[i].start <= t:
            active.append(ordered[i])
            i += 1
        active = [r for r in active if r.end > t]
        best = max(active, key=lambda r: (not r.name.startswith(HARNESS_PREFIX), r.start),
                   default=None)
        labels.append(best.name if best else "host")
    return labels


def breakdown(*traces: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time by
    what the host was doing, ``top`` of each, in seconds: over every card's
    trace, operations summed by name and idle gaps by label."""
    by_op = defaultdict(int)
    by_label = defaultdict(int)
    for trace in traces:
        for op in trace.ops:
            by_op[op.name[:120]] += op.end - op.start
        gaps = idle_gaps(((op.start, op.end) for op in trace.ops), trace.window)
        labels = labels_at(trace.ranges, [(s + e) // 2 for s, e in gaps])
        for (start, end), label in zip(gaps, labels):
            by_label[label] += end - start
    def ranked(d):
        return [[k, v / 1e9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": ranked(by_op), "idle_gaps": ranked(by_label)}


def from_profiler(prof) -> Trace:
    """The trace of a finished ``torch.profiler.profile``; its window is
    the benchmark's ``gpbench/window`` range. A device operation is any
    event on the card but the copies of the host's named ranges there; a
    launch is a call of the CUDA runtime or driver (``cu...``) on the host."""
    from torch.autograd import DeviceType

    ops, ranges, launches = [], [], []
    for e in prof.profiler.kineto_results.events():
        annotation = e.is_user_annotation()
        if e.device_type() == DeviceType.CUDA:
            if not annotation:
                ops.append(DeviceOp(e.name(), e.start_ns(), e.end_ns(), e.correlation_id()))
        elif annotation:
            ranges.append(HostRange(e.name(), e.start_ns(), e.end_ns(), e.start_thread_id()))
        elif e.name().startswith("cu"):
            launches.append(Launch(e.start_ns(), e.start_thread_id(), e.correlation_id()))
    marks = [r for r in ranges if r.name == WINDOW_RANGE]
    if not marks:
        raise RuntimeError(f"the trace holds no {WINDOW_RANGE} range")
    return Trace(ops, ranges, launches, (marks[0].start, marks[0].end))
