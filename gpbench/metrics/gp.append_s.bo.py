"""Seconds of one ``add_samples`` of a step's batch: the benchmark's clock
around the call, the device synchronised on both sides."""

from gpbench.readers import mean


def read(run):
    return mean(run.spans.get("append", []))
