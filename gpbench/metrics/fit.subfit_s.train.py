"""Seconds of the sub-fit per trained model: the builder's own clock
(``builder.timings["subfit"]``, which waits for the device)."""

from gpbench.readers import mean


def read(run):
    return mean(t["subfit"] for t in run.timings if "subfit" in t)
