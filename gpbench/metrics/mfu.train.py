"""The trained models' share of the card's peak: each factorization the flow
performs counted as m^3 / 3 at its live size (the sub-fit's build and one
rebuild per iteration, at the size and count the builder reports,
``subfit_points`` and ``subfit_iterations``, and the full build), over the window's wall time, at the TF32 peak for float32."""

from gpbench import roofline
from gpbench.readers import mfu


def read(run):
    if any("subfit" in t and t["subfit_points"] is None for t in run.timings):
        return None  # a sub-fit of unknown size
    flops = sum(roofline.train_flops(run.config["n"], t.get("subfit_points"),
                                     t.get("subfit_iterations", 0))
                for t in run.timings)
    return mfu(run, flops)
