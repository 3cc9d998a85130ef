"""Kernel B1's share of its roofline in the window: the bound of each launch
(``gpbench/roofline.py``, shapes from the program's count of launches by
shape) over the device time of B1's kernels in the trace."""

from gpbench.readers import b1_roofline


def read(run):
    return b1_roofline(run)
