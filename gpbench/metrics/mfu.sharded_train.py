"""The trained models' share of the cards' peak: each factorization counted
once as m^3 / 3 at its live size (the sub-fit's build and one rebuild per
iteration at the sub-fit's size, which every card repeats, and the full
build, which the cards share), over the window's wall time, at the cards'
number times the TF32 peak for float32."""

from gpbench import roofline
from gpbench.readers import mfu


def read(run):
    if not run.timings or any("subfit" in t and t["subfit_points"] is None
                               for t in run.timings):
        return None  # a sub-fit of unknown size
    flops = sum(roofline.train_flops(run.config["n"], t.get("subfit_points"),
                                     t.get("subfit_iterations", 0))
                for t in run.timings)
    share = mfu(run, flops)
    return None if share is None else share / run.world
