"""Kernel B2's share of its roofline over every card in the window: the
bound of each launch (``gpbench/roofline.py``; a two-operand launch also
reads the panel's rows it was sent) over the device time of B2's kernels,
both summed over the cards. Each launch's shape is the program's own count
of B2's launches by shape, read on every rank (``run.rank_reports``)."""

import torch

from gpbench import roofline
from gpbench.cards import rank_counter_delta
from gpbench.readers import B2_HELPERS, B2_KERNEL


def read(run):
    bound = seconds = 0.0
    for report in run.rank_reports:
        if report["trace"] is None:
            return None
        shapes = rank_counter_delta(report, "b2_by_shape")
        for (rows, block, depth, d, dtype, operands), count in shapes.items():
            dtype = getattr(torch, dtype)
            flops, nbytes = roofline.panel_strip_work(rows, block, depth, d, dtype)
            if operands == 2:
                nbytes += roofline.itemsize(dtype) * block * depth
            bound += count * roofline.bound_s(flops, nbytes, dtype)
        ops = report["trace"].ops_named(B2_KERNEL, without=B2_HELPERS)
        seconds += sum(op.end - op.start for op in ops) / 1e9
    return roofline.share(bound, seconds)
