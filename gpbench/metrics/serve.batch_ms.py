"""Milliseconds of one merged sweep: from the start of the program's
``serving/batch`` range to the end of the last device operation launched
inside it (the range itself ends when the host has queued the work)."""

import bisect
from collections import defaultdict

from gpbench.readers import mean


def read(run):
    if run.trace is None:
        return None
    ends = defaultdict(int)
    for op in run.trace.ops:
        ends[op.correlation] = max(ends[op.correlation], op.end)
    by_thread = defaultdict(list)
    for launch in run.trace.launches:
        by_thread[launch.thread].append((launch.start, launch.correlation))
    for launches in by_thread.values():
        launches.sort()
    batches = []
    for r in run.trace.ranges_named("serving/batch"):
        launches = by_thread.get(r.thread, [])
        lo = bisect.bisect_left(launches, (r.start, -1))
        hi = bisect.bisect_left(launches, (r.end, -1))
        last = max((ends.get(c, 0) for _, c in launches[lo:hi]), default=0)
        batches.append((max(last, r.end) - r.start) / 1e6)
    return mean(batches)
