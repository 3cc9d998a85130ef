"""Gigabytes (1e9 bytes) of factor copied per ``add_samples``: the program's
counters ``APPEND_COPY_BYTES`` over ``APPENDS`` (``models/api.py``), their
change over the window. An append into a copy of the factor copies all of
it; one in place copies nothing."""

from gpbench import spans


def prepare(run):
    spans.start(run)


def finish(run):
    spans.collect(run)


def read(run):
    delta = spans.append_delta(run)
    if delta is None or delta[0] <= 0:
        return None
    appends, copied = delta
    return copied / appends / 1e9
