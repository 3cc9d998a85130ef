"""Milliseconds a request waits in the server's queue, 95th percentile:
the program's ``serving/queue`` spans in the window, each from the request's
enqueue to the start of the sweep that answers it."""

import numpy as np

from gpbench import spans


def prepare(run):
    spans.start(run)


def finish(run):
    spans.collect(run)


def read(run):
    waits = [s.seconds * 1e3 for s in spans.named(run, "serving/queue") or ()]
    return float(np.percentile(waits, 95)) if waits else None
