"""Test-only hooks: a cell of the manifest cut to a size the CPU runs in
seconds, driven through the harness with the device set to the CPU (the
command itself refuses a machine without a card)."""

import time

import torch

from gpbench import harness

TINY_N = 1500
TINY_SERVE = {"clients": 4, "rows_max": 64, "check_requests": 8, "warmup_s": 0.5}


def tiny_cell(name: str, n: int = TINY_N, root=harness.ROOT) -> harness.Cell:
    cell = harness.Cell(name, root)
    cell.config = dict(cell.config, n=n, capacity=n + 512)
    if cell.traffic["loop"] == "serve":
        cell.traffic = dict(cell.traffic, **TINY_SERVE)
    return cell


def run_tiny(name: str, seconds: float = 1.0, traced: bool = False, control: bool = False,
             seed: int = 2**33 + 5, **kw) -> dict:
    torch.set_num_threads(4)
    cell = tiny_cell(name, **kw)
    return harness.execute(cell, seed, seconds, traced, "cpu", time.perf_counter(),
                           log=lambda line: None, control=control)
