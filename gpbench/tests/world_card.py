"""The tests' tiny multi-rank cell (``add_cells``: its configuration, mixes,
loop ``world_flow.py``, limits, metric and reader, added to a scratch copy
of the tree as new files), and checks of the multi-card path on a machine
with several cards, by hand:

    python3 -m gpbench.tests.world_card tree <dir> --chips 4
        a scratch copy of the tree at <dir> with the tests' tiny multi-rank
        cells (``tiny-world``, ``tiny-raise``, ``tiny-hang``) added as new
        files only; run one from there with the program on ``PYTHONPATH``:
        ``cd <dir> && PYTHONPATH=<repo> python3 -m gpbench.run --workload
        tiny-world --seed 5 --seconds 5 --trace 0``
    python3 -m gpbench.tests.world_card reference --n 100000 --rows 512
        the sharded reference over every card (NCCL) against the one-card
        reference on card 0, on the benchmark's data at n and ``--rows``
        query rows: prints one JSON line with the widest gaps of means and
        latent variances, the TF32 control's gaps, and the seconds of each.

The hyperparameters are those the gp100k cells' fit stops at (PERF.md §2:
ls 1.42, ampl 2.7–3.1, noise 0.84–0.85), the worse conditioned of the two
kinds of fit.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from gpbench import data, harness
from gpbench.reference import gp as ref, sharded
from gpbench.world import free_port

LS, AMPL, NOISE = 1.42, 2.9, 0.845
D = 8
#: The tiny multi-rank cell's mix (its loop is ``world_flow.py``).
MIX = {"loop": "tiny_world", "rows": 256}


def add_cells(root, chips: int, mixes: dict) -> None:
    """The new files and entries of a multi-card cell per mix."""
    pkg = root / "gpbench"
    config = {"name": "tiny-f32-world", "n": 1024, "d": 8, "dtype": "float32", "noise": 0.5,
              "reduced": []}
    (pkg / "configs" / "tiny-f32-world.json").write_text(json.dumps(config))
    shutil.copy(harness.PACKAGE / "tests" / "world_flow.py", pkg / "flows" / "tiny_world.py")
    (pkg / "metrics" / "tiny.collectives.py").write_text(
        "def read(run):\n"
        "    total = sum(r['counters_after']['collectives'] - r['counters_before']['collectives']\n"
        "                for r in run.rank_reports)\n"
        "    return float(total) or None\n")
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "tiny-f32-world", "source": "https://example.org/gp",
                                "file": "gpbench/configs/tiny-f32-world.json", "reduced": [],
                                "why": "test"})
    for name, mix in mixes.items():
        (pkg / "traffic" / f"{name}.json").write_text(json.dumps(mix))
        (pkg / "limits" / f"{name}.json").write_text(
            json.dumps({"mean_gap": {"max": 1e-3}, "var_gap": {"max": 1e-3}}))
        manifest["workloads"].append({"name": name, "config": "tiny-f32-world", "traffic": name,
                                      "chips": chips, "why": "test"})
    manifest["end_to_end"].append({"name": "predict_s", "unit": "s", "better": "lower",
                                   "bound": 0.1, "source": "host_clock", "workloads": list(mixes)})
    manifest["per_layer"].append({"name": "tiny.collectives", "unit": "collectives",
                                  "better": "lower", "source": "program_counter",
                                  "layer": "test", "moves": "predict_s", "workloads": list(mixes)})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))


def make_tree(root: Path, chips: int) -> None:
    root.mkdir(parents=True)
    shutil.copy(harness.ROOT / "BENCHMARK.json", root)
    shutil.copytree(harness.PACKAGE, root / "gpbench", ignore=shutil.ignore_patterns("__pycache__"))
    add_cells(root, chips, {"tiny-world": MIX,
                            "tiny-raise": dict(MIX, fail="setup", fail_rank=1),
                            "tiny-hang": dict(MIX, fail="window", fail_rank=chips - 1)})


def inputs(n: int, rows: int, seed: int, device):
    x, y = data.training_data(seed, n, D, torch.float32, device)
    gen = data.device_generator(seed, "queries", device)
    q = torch.randn((rows, D), generator=gen, dtype=torch.float32, device=device)
    return x, y, q


def rank_main(rank: int, size: int, port: int, n: int, rows: int, seed: int, out: str,
              cpu: bool) -> None:
    device = torch.device("cpu") if cpu else torch.device("cuda", rank)
    if not cpu:
        torch.cuda.set_device(device)
    dist.init_process_group("gloo" if cpu else "nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=size, rank=rank, device_id=None if cpu else device)
    try:
        x, y, q = inputs(n, rows, seed, device)
        prior = float(torch.mean(y.double()))
        found = {}
        for tf32 in (False, True):
            dist.barrier()
            sync(device)
            t0 = time.perf_counter()
            factor = sharded.cholesky(x, LS, AMPL, NOISE, tf32)
            mean, var = sharded.predict(factor, x, y - prior, prior, LS, AMPL, q, tf32)
            dist.barrier()
            sync(device)
            found[tf32] = {"mean": mean, "var": var, "seconds": time.perf_counter() - t0,
                           "peak_bytes": harness.peak_bytes(device)}
            del factor
            if not cpu:
                torch.cuda.empty_cache()
        if rank == 0:
            torch.save(found, f"{out}/sharded.pt")
    finally:
        dist.destroy_process_group()


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reference(n: int, rows: int, seed: int, cpu_ranks: int = 0) -> dict:
    """``cpu_ranks`` > 0: a rehearsal on that many CPU ranks (gloo)."""
    size = cpu_ranks or torch.cuda.device_count()
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(rank_main, args=(size, free_port(), n, rows, seed, tmp, bool(cpu_ranks)),
                 nprocs=size)
        found = torch.load(f"{tmp}/sharded.pt")
    device = torch.device("cpu") if cpu_ranks else torch.device("cuda", 0)
    x, y, q = inputs(n, rows, seed, device)
    prior = float(torch.mean(y.double()))
    sync(device)
    t0 = time.perf_counter()
    factor = ref.cholesky(x, LS, AMPL, NOISE)
    mean, var = ref.predict(factor, x, y - prior, prior, LS, AMPL, q)
    sync(device)
    one_card_s = time.perf_counter() - t0

    def gap(a, b):
        return float(torch.max(torch.abs(a - b)))

    kind = "cpu" if cpu_ranks else torch.cuda.get_device_name(device)
    return {"n": n, "rows": rows, "seed": seed, "cards": size, "kind": kind,
            "ls": LS, "ampl": AMPL, "noise": NOISE,
            "mean_gap": gap(found[False]["mean"], mean), "var_gap": gap(found[False]["var"], var),
            "control_mean_gap": gap(found[True]["mean"], mean),
            "control_var_gap": gap(found[True]["var"], var),
            "sharded_s": found[False]["seconds"], "sharded_control_s": found[True]["seconds"],
            "sharded_peak_bytes_rank0": found[False]["peak_bytes"], "one_card_s": one_card_s}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m gpbench.tests.world_card")
    sub = p.add_subparsers(dest="what", required=True)
    t = sub.add_parser("tree")
    t.add_argument("dir")
    t.add_argument("--chips", type=int, required=True)
    r = sub.add_parser("reference")
    r.add_argument("--n", type=int, required=True)
    r.add_argument("--rows", type=int, default=512)
    r.add_argument("--seed", type=int, default=3000001700)
    r.add_argument("--cpu-ranks", type=int, default=0, help="rehearse on CPU ranks")
    args = p.parse_args(argv)
    if args.what == "tree":
        make_tree(Path(args.dir), args.chips)
        print(os.path.abspath(args.dir))
    else:
        print(json.dumps(reference(args.n, args.rows, args.seed, args.cpu_ranks)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
