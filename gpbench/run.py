"""Run one cell of the benchmark once and print its result line.

    python -m gpbench.run --workload gp100k-train --seed 7 --seconds 40 --trace 0

from the root of a checkout, on a machine with the card the cell asks for.
Makes the cell's data from ``--seed``, sets up and warms up, measures for
``--seconds`` seconds, then checks what the window produced against the
plain reference (``gpbench/check.py``). The last line of standard output is
one JSON object; with ``--trace 1`` it carries the per-layer metrics, read
from a ``torch.profiler`` trace of the window, instead of the end-to-end
ones. The numbers compared, each beside its limit, are the last lines of
standard error and the ``checks`` key of the result.

A cell on W > 1 cards runs as W processes, this one rank 0 on ``cuda:0``
and rank r on ``cuda:r`` (``gpbench/world.py``); only rank 0 prints.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(prog="python -m gpbench.run", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, device: str = "cuda") -> int:
    """The command; ``device`` other than ``"cuda"`` only from tests, which
    skip the look for a card."""
    args = parse(argv)
    import torch

    from gpbench import check, harness

    cell = harness.Cell(args.workload)
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < cell.chips):
        print(f"gpbench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3

    def log(line):
        print(line, file=sys.stderr, flush=True)

    if cell.chips == 1:
        result = harness.execute(cell, args.seed, args.seconds, bool(args.trace), device, STARTED,
                                 log=log)
        found = [harness.forbidden_modules()]
    else:
        from gpbench import world

        job = world.run_job(cell, [args.seed], args.seconds, bool(args.trace), device, STARTED)
        (_, result, found), = world.launch(job, cell.chips, log)
    for rank, names in enumerate(found):
        if names:
            print(f"gpbench: rank {rank} loaded {', '.join(names)}", file=sys.stderr)
    if any(found):
        return 4
    for line in check.check_lines(result["checks"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
