"""Requests merged into one sweep of the server: the mean of the program's
count ``AcceleratedGPServer.requests_per_dispatch`` over the window."""

from gpbench.readers import counter_delta


def read(run):
    merged = counter_delta(run, "requests_per_dispatch")
    sweeps = sum(merged.values())
    return sum(k * c for k, c in merged.items()) / sweeps if sweeps else None
