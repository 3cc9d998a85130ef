"""Share of the solved columns that are real rows: over the window's
``serving/dispatch`` spans, the rows merged over the ``block``-wide solves
they pay (``block`` times the rows over ``block``, rounded up); the rest is
the zero padding of each sweep's last block."""

from gpbench import spans


def prepare(run):
    spans.start(run)


def finish(run):
    spans.collect(run)


def read(run):
    dispatches = spans.named(run, "serving/dispatch")
    if not dispatches:
        return None
    rows = sum(s.attrs["rows"] for s in dispatches)
    solved = sum(s.attrs["block"] * -(-s.attrs["rows"] // s.attrs["block"]) for s in dispatches)
    return 100.0 * rows / solved
