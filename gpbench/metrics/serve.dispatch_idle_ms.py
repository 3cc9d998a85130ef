"""Milliseconds of a sweep in which the device is idle: inside each of the
program's ``serving/dispatch`` spans (from taking a chunk to its last waiter
woken), the time the union of the device's operations leaves uncovered,
averaged over the window's sweeps. The host's merge, copies and wake-ups."""

from gpbench import spans
from gpbench.readers import mean


def prepare(run):
    spans.start(run)


def finish(run):
    spans.collect(run)


def read(run):
    dispatches = spans.named(run, "serving/dispatch")
    if not dispatches or run.trace is None:
        return None
    idle = spans.Idle(run.trace)
    return mean(idle.within(s.start_ns, s.end_ns) / 1e6 for s in dispatches)
