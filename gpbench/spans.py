"""The program's own spans and append counters in the traced run: what
``friedrich_tpu_torch/utils/profiling.py`` records in memory while recording
is on, read against the device operations of the same run's trace (both on
the ``time.time_ns()`` clock).

Recording is on in the traced run only: a reader's ``prepare`` calls
:func:`start`, its ``finish`` calls :func:`collect`; both may be called by
several readers. Against a program without the recorder or the counters
they record nothing, and the readers return None.
"""

from __future__ import annotations

import bisect

from . import trace as tracing


def _recorder():
    from friedrich_tpu_torch.utils import profiling

    return profiling if hasattr(profiling, "drain") else None


def _append_counters() -> dict | None:
    from friedrich_tpu_torch.models import api

    if not hasattr(api, "APPENDS") or not hasattr(api, "APPEND_COPY_BYTES"):
        return None
    return {"appends": sum(api.APPENDS.values()), "copy_bytes": api.APPEND_COPY_BYTES}


def start(run) -> None:
    """Empty the program's span buffer, note its append counters and turn
    recording on, once per run."""
    if "spans_started" in run.records:
        return
    run.records["spans_started"] = True
    run.records["appends_before"] = _append_counters()
    recorder = _recorder()
    if recorder is not None:
        recorder.drain()
        recorder.enable()


def collect(run) -> None:
    """Turn recording off and keep in ``run.records["spans"]`` the spans
    that overlap the trace's window, and the append counters after it,
    once per run."""
    if "spans" in run.records or "spans_started" not in run.records:
        return
    run.records["appends_after"] = _append_counters()
    recorder = _recorder()
    if recorder is None or run.trace is None:
        run.records["spans"] = None
        return
    recorder.disable()
    run.records["spans_dropped"] = recorder.dropped()
    lo, hi = run.trace.window
    run.records["spans"] = [s for s in recorder.drain() if s.end_ns > lo and s.start_ns < hi]


def named(run, name: str) -> list | None:
    """The window's spans called ``name``, or None where nothing was
    recorded."""
    spans = run.records.get("spans")
    if spans is None:
        return None
    return [s for s in spans if s.name == name]


def append_delta(run) -> tuple[int, int] | None:
    """(appends, bytes of factor copied) over the window."""
    before, after = run.records.get("appends_before"), run.records.get("appends_after")
    if before is None or after is None:
        return None
    return after["appends"] - before["appends"], after["copy_bytes"] - before["copy_bytes"]


class Idle:
    """The window's idle gaps (``gpbench/trace.idle_gaps``: what the union
    of every kernel, copy and memset leaves of it), to measure how much of
    a host span the device spent idle."""

    def __init__(self, trace: tracing.Trace):
        self.gaps = tracing.idle_gaps(((op.start, op.end) for op in trace.ops), trace.window)
        self.starts = [start for start, _ in self.gaps]
        self.window = trace.window

    def within(self, start: int, end: int) -> int:
        """Nanoseconds of ``[start, end)`` in which the device was idle."""
        idle = 0
        i = max(bisect.bisect_right(self.starts, start) - 1, 0)
        while i < len(self.gaps) and self.gaps[i][0] < end:
            lo, hi = self.gaps[i]
            idle += max(0, min(hi, end) - max(lo, start))
            i += 1
        return idle

    def length(self, start: int, end: int) -> int:
        """Nanoseconds of ``[start, end)`` inside the window."""
        return max(0, min(end, self.window[1]) - max(start, self.window[0]))
