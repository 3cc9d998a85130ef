"""The serving knee: one model, one server, the serve mix at several offered
rates in turn, for finding the highest rate the system sustains.

    python -m gpbench.sweep --workload gp100k-serve --seed 5 --seconds 20 \
        --rates 10,15,20,25,30

Prints one JSON line per rate: latency p50 and p95, the generator's
lateness, and ``growth``, the median latency of the last third of the
window's requests over that of the first third: about 1 while the backlog
does not grow, rising with the backlog past the knee. The rate of a cell is
a number in its traffic file, set once from such a sweep.

A cell on W > 1 cards runs as a world of W ranks (``gpbench/world.py``):
every rank sets up the one model and runs each rate's window, rank 0
measuring and printing, the others following.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np


def main(argv=None, device: str = "cuda") -> int:
    """The tool; ``device`` other than ``"cuda"`` only from tests."""
    p = argparse.ArgumentParser(prog="python -m gpbench.sweep")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", required=True)
    args = p.parse_args(argv)
    from gpbench import harness, world

    cell = harness.Cell(args.workload)
    job = {"entry": "gpbench.sweep:rates", "root": str(cell.root), "workload": cell.name,
           "seed": args.seed, "seconds": args.seconds, "device": device,
           "rates": [float(r) for r in args.rates.split(",")],
           "timeout_s": world.timeout_s(cell, args.seconds)}

    def log(line):
        print(line, file=sys.stderr, flush=True)

    lines = (rates(job, 0, 1, device, log) if cell.chips == 1
             else world.launch(job, cell.chips, log))
    for line in lines:
        print(json.dumps(line), flush=True)
    return 0


def rates(job: dict, rank: int, size: int, device: str, log):
    """One model, one server, a window at each of the job's rates; yields
    each rate's line on rank 0."""
    from gpbench import harness
    from gpbench.loops import make_loop

    cell = harness.Cell(job["workload"], Path(job["root"]))
    run = harness.Run(cell, job["seed"], False, device, rank, size)
    loop = make_loop(run)
    loop.setup()
    run.barrier()
    try:
        for rate in job["rates"]:
            t0 = time.perf_counter()
            outcome = loop.window(job["seconds"], rate)
            if rank != 0:
                continue
            lat = loop.latency[np.argsort(loop.due)]
            third = max(1, len(lat) // 3)
            yield {
                "rate_per_s": rate, "requests": outcome.attempted, "failed": outcome.failed,
                "p50_s": float(np.percentile(lat, 50)), "p95_s": float(np.percentile(lat, 95)),
                "growth": float(np.median(lat[-third:]) / np.median(lat[:third])),
                "wall_s": time.perf_counter() - t0, "note": outcome.notes[0]}
    finally:
        loop.release()


if __name__ == "__main__":
    sys.exit(main())
