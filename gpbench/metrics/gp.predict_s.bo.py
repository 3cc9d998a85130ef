"""Seconds of one ``predict_mean_variance`` of a step's candidates: the
benchmark's clock around the call, the device synchronised on both sides."""

from gpbench.readers import mean


def read(run):
    return mean(run.spans.get("predict", []))
