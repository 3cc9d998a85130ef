"""The Bayesian-optimization steps' share of the card's peak: each step's
variance solve, mean and append counted from its live n
(``gpbench/roofline.bo_step_flops``) over the window's wall time, at the TF32
peak for float32."""

from gpbench import roofline
from gpbench.readers import mfu


def read(run):
    mix = run.traffic
    flops = sum(roofline.bo_step_flops(n, int(mix["candidates"]), int(mix["batch"]))
                for n, _ in run.steps)
    return mfu(run, flops)
