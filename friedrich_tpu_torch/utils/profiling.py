"""Tracing and profiling scopes, and the in-memory span recorder.

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

A profiler range exists only while ``torch.profiler`` runs, carries no
request's identity and cannot cross threads. So, while recording is on
(:func:`record_spans`, or :func:`enable` and :func:`disable`), every
:func:`scope` and :func:`timed` also appends a :class:`Span` to one
process-wide buffer, and :func:`record_span` records a span that one thread
opens and another closes (a request's wait in a server's queue).
:func:`drain` takes them. Spans are timed by ``time.time_ns()``, the clock on
which ``torch.profiler`` reports its events, so they read against the
device operations of a trace taken at the same time. A span around
asynchronous work ends when the host has queued it; none synchronises the
device. With recording off a scope costs one flag test more than its
profiler range.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
from pathlib import Path
from typing import Iterator, Optional

import torch

#: Spans the buffer holds; what is recorded beyond them is counted as
#: dropped (:func:`dropped`) until the next :func:`drain`.
CAPACITY = 1 << 20

_RECORDING = False
_SPANS: list = []
_DROPPED = 0
_LOCK = threading.Lock()
_IDS = itertools.count(1)
_LOCAL = threading.local()  # .stack: the ids of the thread's open spans; .thread


@dataclasses.dataclass(slots=True, eq=False)
class Span:
    """A named interval on the host, in ``time.time_ns()`` nanoseconds:
    ``parent`` is the id of the span open around it on its thread (or
    given to :func:`record_span`), ``thread`` the thread's native id,
    ``attrs`` small ints and strings."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    thread: int
    attrs: dict

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


def recording() -> bool:
    """Whether spans are being recorded."""
    return _RECORDING


def enable() -> None:
    """Start recording spans (again harmless)."""
    global _RECORDING
    _RECORDING = True


def disable() -> None:
    """Stop recording spans; what is buffered stays for :func:`drain`."""
    global _RECORDING
    _RECORDING = False


@contextlib.contextmanager
def record_spans() -> Iterator[None]:
    """Record spans inside the block, and leave recording as it was after
    it; :func:`drain` takes what was recorded.

        with profiling.record_spans():
            ...
        spans = profiling.drain()
    """
    was = _RECORDING
    enable()
    try:
        yield
    finally:
        if not was:
            disable()


def drain() -> list:
    """The buffered spans, in the order they ended; empties the buffer and
    the count of dropped spans."""
    global _SPANS, _DROPPED
    with _LOCK:
        spans, _SPANS, _DROPPED = _SPANS, [], 0
    return spans


def dropped() -> int:
    """Spans not recorded since the last :func:`drain`: the buffer held
    :data:`CAPACITY`."""
    return _DROPPED


def _stack() -> list:
    """The calling thread's stack of open span ids; its native id, read
    once (a system call), is ``_LOCAL.thread``."""
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
        _LOCAL.thread = threading.get_native_id()
    return stack


def _append(span: Span) -> None:
    global _DROPPED
    with _LOCK:
        if len(_SPANS) < CAPACITY:
            _SPANS.append(span)
        else:
            _DROPPED += 1


def record_span(name: str, start_ns: int, end_ns: int, parent: Optional[int] = None,
                **attrs) -> Optional[int]:
    """Record a span whose ends were read on the ``time.time_ns()`` clock,
    possibly by two threads; returns its id, or None with recording off."""
    if not _RECORDING:
        return None
    _stack()
    span = Span(name, start_ns, end_ns, next(_IDS), parent, _LOCAL.thread, attrs)
    _append(span)
    return span.id


def annotate(name: str) -> _Range:
    """Named range: a ``torch.profiler.record_function`` (the profiler sums
    the device time of the kernels launched inside it under ``name``), and
    an NVTX range when CUDA is available. Costs some microseconds of host
    time when no profiler runs (PERF.md).

        with annotate("covariance-build"):
            k = train_covariance_padded(...)
    """
    return _Range(name, None, None)


class _Range:
    """The ranges of :func:`annotate`; for a :func:`scope` made while
    recording is on, also a :class:`Span` with ``attrs``, and for a
    :func:`timed` ``log`` its seconds. The clock is read just before each
    of the profiler's own reads, inside the NVTX range's ends: the calls
    that open and close a profiler range give up the interpreter's lock,
    so a read after one may first wait for other threads. Entering
    returns the open span (its ``attrs`` may still be set), or None."""

    __slots__ = ("name", "attrs", "log", "_rf", "_span", "_start", "_nvtx")

    def __init__(self, name: str, attrs: Optional[dict], log: Optional[list]):
        self.name, self.attrs, self.log = name, attrs, log

    def __enter__(self) -> Optional[Span]:
        recording = _RECORDING and self.attrs is not None
        self._rf = torch.profiler.record_function(self.name)
        self._start = time.time_ns() if recording or self.log is not None else None
        self._rf.__enter__()
        self._span = None
        if recording:
            stack = _stack()
            self._span = Span(self.name, self._start, 0, next(_IDS), stack[-1] if stack else None,
                              _LOCAL.thread, self.attrs)
            stack.append(self._span.id)
        self._nvtx = torch.cuda.is_available()
        if self._nvtx:
            torch.cuda.nvtx.range_push(self.name)
        return self._span

    def __exit__(self, *exc) -> bool:
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        end = time.time_ns() if self._start is not None else None
        self._rf.__exit__(*exc)
        if end is not None:
            if self._span is not None:
                self._span.end_ns = end
                _LOCAL.stack.pop()
                _append(self._span)
            if self.log is not None:
                self.log.append((self.name, (end - self._start) / 1e9))
        return False


def scope(name: str, **attrs):
    """The named scope of the library's hot paths, under the JAX package's
    names (``gp/build_factor[<backend>]``, ``gp/predict_mean``,
    ``fit/rebuild``, ``nuts/transition``, ...): an :func:`annotate` range,
    and while recording is on a :class:`Span` with ``attrs``, which
    ``with scope(...) as span`` returns (None with recording off). Whether
    to record is decided when the scope is made, so open it inside a
    function rather than decorate one."""
    if not _RECORDING:
        return annotate(name)
    return _Range(name, attrs, None)


def timed(name: str, log: Optional[list] = None) -> _Range:
    """Host-side wall-clock scope on the spans' clock: appends (name,
    seconds) to ``log``, and is a :func:`scope` besides."""
    return _Range(name, {}, log)


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
