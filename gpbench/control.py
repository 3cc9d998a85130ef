"""Readings of the numbers compared, for setting their limits: the program's
on many seeds and the control's on some, in one process.

    python -m gpbench.control --workload gp50k-train --seeds 11,12,13 \
        --control-seeds 11 --seconds 5
    python -m gpbench.control --workload gp50k-bo --seeds 21,22,23 \
        --fault wrong_y_appended --seconds 5

Each seed runs the cell as ``gpbench.run`` does (set-up, a window of
``--seconds``, the comparison with the reference) and prints one JSON line:
its readings and, for the seeds of ``--control-seeds``, the control's: the
reference computed in TF32 put in the program's place. ``--fault`` plants
one of ``gpbench/faults.py``'s faults (or of the ``FAULTS`` of the cell's
flow file) in the program for every seed. The benchmark's own runs never
run the control or a fault.

A cell on W > 1 cards runs as one world of W ranks for all the seeds
(``gpbench/world.py``), the fault planted on every rank; rank 0 prints.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time


def main(argv=None, device: str = "cuda") -> int:
    """The tool; ``device`` other than ``"cuda"`` only from tests."""
    p = argparse.ArgumentParser(prog="python -m gpbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--fault", default="", help="a fault of gpbench/faults.py to plant")
    args = p.parse_args(argv)
    import torch

    from gpbench import harness

    if device == "cuda" and not torch.cuda.is_available():
        print("gpbench.control: no CUDA card", file=sys.stderr)
        return 3
    cell = harness.Cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    controls = {int(s) for s in args.control_seeds.split(",") if s}

    def log(line):
        print(line, file=sys.stderr, flush=True)

    if cell.chips > 1:
        from gpbench import world

        job = world.run_job(cell, seeds, args.seconds, False, device, readings=True,
                            control_seeds=sorted(controls), fault=args.fault)
        results = ((seed, result) for seed, result, _ in world.launch(job, cell.chips, log))
    else:
        if args.fault:
            from gpbench import faults

            faults.plant(args.fault, cell, faults.Patch)
        results = ((seed, one_seed(cell, seed, args.seconds, device, log, seed in controls))
                   for seed in seeds)
    for seed, result in results:
        line = {"workload": cell.name, "seed": seed, "fault": args.fault or None,
                "correct": result["correct"],
                "attempted": result["attempted"], "failed": result["failed"],
                "readings": result["readings"],
                "control": result.get("control"), "metrics": result["metrics"]}
        print(json.dumps(line), flush=True)
    return 0


def one_seed(cell, seed: int, seconds: float, device: str, log, control: bool) -> dict:
    import torch

    from gpbench import harness

    result = harness.execute(harness.Cell(cell.name, cell.root), seed, seconds, False, device,
                             time.perf_counter(), log=log, readings=True, control=control)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return result


if __name__ == "__main__":
    sys.exit(main())
