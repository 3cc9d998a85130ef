"""What the readers of a cell on several cards share: every card's device
time in the program's factorizations, split into the collectives' kernels
and the rest, and the counters of every rank. A kernel belongs to the scope
its launch was made in on the host (by the trace's correlation of launch
and kernel), not to the time it ran: a collective is queued on the host
long before its kernel runs. Each function returns None where its run has
nothing to read (a one-card run, a trace without factorizations)."""

from __future__ import annotations

import bisect
import types
from collections import defaultdict

from . import readers, trace as tracing

#: ``parallel/large_scale.py``'s scope around a distributed factorization.
FACTOR_RANGE = "large_scale/factor"
#: ``parallel/mesh.py``'s scopes around each collective.
COLLECTIVE_RANGES = ("mesh/broadcast", "mesh/all_reduce")


def launched_in(trace: tracing.Trace, names: tuple) -> set:
    """The correlations of the launches made inside the host ranges called
    one of ``names``, on the range's own thread."""
    by_thread = defaultdict(list)
    for launch in trace.launches:
        by_thread[launch.thread].append((launch.start, launch.correlation))
    for launches in by_thread.values():
        launches.sort()
    found = set()
    for r in trace.ranges:
        if r.name in names:
            launches = by_thread.get(r.thread, [])
            lo = bisect.bisect_left(launches, (r.start, -1))
            hi = bisect.bisect_left(launches, (r.end, -1))
            found.update(c for _, c in launches[lo:hi])
    return found


def factor_time(trace: tracing.Trace) -> tuple[float, float, int] | None:
    """``(collective seconds, other busy seconds, factorizations)`` of one
    card: of the kernels, copies and memsets launched inside its
    ``large_scale/factor`` scopes, those launched inside a collective's
    scope summed (a collective's kernel that waits for its peers counts its
    wait), the rest as the union of their intervals."""
    if trace is None:
        return None
    factorizations = len(trace.ranges_named(FACTOR_RANGE))
    if not factorizations:
        return None
    inside = launched_in(trace, (FACTOR_RANGE,))
    collective = launched_in(trace, COLLECTIVE_RANGES)
    ops = [op for op in trace.ops if op.correlation in inside]
    comm = sum(op.end - op.start for op in ops if op.correlation in collective)
    other = tracing.union_length((op.start, op.end) for op in ops
                                 if op.correlation not in collective)
    return comm / 1e9, other / 1e9, factorizations


def factors_by_card(run) -> list | None:
    """:func:`factor_time` of every card, rank order, or None where a card
    has nothing to read."""
    cards = [factor_time(t) for t in run.traces]
    if len(cards) < 2 or any(c is None for c in cards):
        return None
    return cards


def rank_counter_delta(report: dict, key: str) -> dict:
    """``readers.counter_delta`` of one rank's report (``run.rank_reports``)."""
    counters = types.SimpleNamespace(counters_before=report["counters_before"],
                                     counters_after=report["counters_after"])
    return readers.counter_delta(counters, key)
