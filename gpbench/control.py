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
one of ``gpbench/faults.py``'s faults in the program for every seed. The
benchmark's own runs never run the control or a fault.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m gpbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--fault", default="", help="a fault of gpbench/faults.py to plant")
    args = p.parse_args(argv)
    import torch

    from gpbench import harness

    if not torch.cuda.is_available():
        print("gpbench.control: no CUDA card", file=sys.stderr)
        return 3
    if args.fault:
        from gpbench import faults

        getattr(faults, args.fault)(faults.Patch)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = harness.Cell(args.workload)
        result = harness.execute(cell, seed, args.seconds, False, "cuda", time.perf_counter(),
                                 log=lambda line: print(line, file=sys.stderr, flush=True),
                                 readings=True, control=seed in controls)
        line = {"workload": cell.name, "seed": seed, "fault": args.fault or None,
                "correct": result["correct"],
                "attempted": result["attempted"], "failed": result["failed"],
                "readings": result["readings"],
                "control": result.get("control"), "metrics": result["metrics"]}
        print(json.dumps(line), flush=True)
        del result
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
