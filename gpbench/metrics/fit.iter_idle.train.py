"""Share of the sub-fit's iterations in which the device is idle: inside
the program's ``fit_large/iteration`` spans in the window, the time the
union of the device's operations leaves uncovered, over their total
length. The host's part of the fit's loop."""

from gpbench import spans


def prepare(run):
    spans.start(run)


def finish(run):
    spans.collect(run)


def read(run):
    iterations = spans.named(run, "fit_large/iteration")
    if not iterations or run.trace is None:
        return None
    idle = spans.Idle(run.trace)
    total = sum(idle.length(s.start_ns, s.end_ns) for s in iterations)
    if total <= 0:
        return None
    return 100.0 * sum(idle.within(s.start_ns, s.end_ns) for s in iterations) / total
