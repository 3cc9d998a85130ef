"""The serving knee: one model, one server, the serve mix at several offered
rates in turn, for finding the highest rate the system sustains.

    python -m gpbench.sweep --workload gp100k-serve --seed 5 --seconds 20 \
        --rates 10,15,20,25,30

Prints one JSON line per rate: latency p50 and p95, the generator's
lateness, and ``growth``, the median latency of the last third of the
window's requests over that of the first third: about 1 while the backlog
does not grow, rising with the backlog past the knee. The rate of a cell is
a number in its traffic file, set once from such a sweep.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m gpbench.sweep")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", required=True)
    args = p.parse_args(argv)
    from gpbench import harness
    from gpbench.loops import make_loop

    cell = harness.Cell(args.workload)
    run = harness.Run(cell, args.seed, False, "cuda")
    loop = make_loop(run)
    loop.setup()
    try:
        for rate in (float(r) for r in args.rates.split(",")):
            t0 = time.perf_counter()
            outcome = loop.window(args.seconds, rate)
            lat = loop.latency[np.argsort(loop.due)]
            third = max(1, len(lat) // 3)
            print(json.dumps({
                "rate_per_s": rate, "requests": outcome.attempted, "failed": outcome.failed,
                "p50_s": float(np.percentile(lat, 50)), "p95_s": float(np.percentile(lat, 95)),
                "growth": float(np.median(lat[-third:]) / np.median(lat[:third])),
                "wall_s": time.perf_counter() - t0, "note": outcome.notes[0]}), flush=True)
    finally:
        loop.release()
    return 0


if __name__ == "__main__":
    sys.exit(main())
