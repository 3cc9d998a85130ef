"""Share of the window in which nothing ran on the device: one less the
union of every kernel, copy and memset on all streams over the traced
window (``gpbench/trace.py``)."""

from gpbench.readers import idle_share


def read(run):
    return idle_share(run)
