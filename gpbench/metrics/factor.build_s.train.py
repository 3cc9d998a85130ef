"""Seconds of the full-n build and factorization per trained model: the
builder's own clock (``builder.timings["build"]``, which waits for the
device)."""

from gpbench.readers import mean


def read(run):
    return mean(t["build"] for t in run.timings if "build" in t)
