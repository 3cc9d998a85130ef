"""Milliseconds of one applied iteration of the Hutchinson sub-fit: the mean
of the program's ``fit_large/iteration`` spans in the window whose update
was applied (a gradient step and a rebuild, ending when the host has read
the rebuild's flag; the converging step, which stops before its rebuild,
is left out)."""

from gpbench import spans
from gpbench.readers import mean


def prepare(run):
    spans.start(run)


def finish(run):
    spans.collect(run)


def read(run):
    return mean(s.seconds * 1e3 for s in spans.named(run, "fit_large/iteration") or ()
                if s.attrs.get("applied"))
