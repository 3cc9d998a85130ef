"""Times the predictions of the PyTorch/CUDA port (``friedrich_tpu_torch``)
at capacity 100,512 on one GPU, by the number of rows a call asks for.

    python3 scripts/torch_predict_times.py [--repo DIR] [--reps 5]

``--repo`` is the root of the checkout whose ``friedrich_tpu_torch`` is
timed (default: this repository), so that two versions can be compared on
one card in turns, e.g. a parent commit unpacked with ``git archive`` into
a git-ignored directory:

    python3 scripts/torch_predict_times.py --repo tmp_cache/parent
    python3 scripts/torch_predict_times.py
    python3 scripts/torch_predict_times.py
    python3 scripts/torch_predict_times.py --repo tmp_cache/parent

The model is a streamed float32 model of ``bench.py``'s data (d = 8, seed 0)
at n = 100,000 and capacity 100,512 with fixed hyperparameters (SquaredExp
ls 1.3, ampl 2.0, noise 1.0, constant prior 0; no fit). For 1, 16, 256,
1,024 and 4,096 query rows it times ``predict_mean_variance`` in one solve
of all the rows, and, where the checkout's model takes ``block``, in
fixed-width sweeps of 256 and 1,024 columns; then, where the checkout has
``serving.AcceleratedGPServer``, one request of each size at a time through
the server and a ``GPClient`` (float64 on the wire) at both widths. Each
time is the wall-clock of one call from a synchronized card to a
synchronized card, the median of ``--reps`` calls after a warm-up. Prints
the card's ``nvidia-smi`` name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import inspect
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROWS = (1, 16, 256, 1024, 4096)
SERVED_ROWS = (1, 16, 256, 1024)
WIDTHS = (256, 1024)


def median_s(fn, reps: int) -> float:
    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--repo", default=str(Path(__file__).resolve().parents[1]),
                        help="root of the checkout to time (default: this repository)")
    parser.add_argument("--reps", type=int, default=5)
    args = parser.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_predict_times: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.repo).resolve()))
    import friedrich_tpu_torch as ft

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    n, cap = 100_000, 100_512
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    y = (np.sin(2.5 * x[:, 0]) + 0.5 * np.cos(2.0 * x[:, 1]) + rng.normal(size=n)).astype(np.float32)
    xq_np = rng.normal(size=(max(ROWS), 8))
    t0 = time.perf_counter()
    gp = (ft.GaussianProcessBuilder(x, y, device="cuda").set_dtype("float32").set_capacity(cap)
          .set_kernel(ft.kernels.SquaredExp(ls=1.3, ampl=2.0)).set_prior(ft.priors.ConstantPrior(0.0))
          .set_noise(1.0).set_backend("streamed").train())
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    xq = torch.as_tensor(xq_np, dtype=torch.float32, device="cuda")
    takes_block = "block" in inspect.signature(gp.predict_mean_variance).parameters
    times: dict = {"one_solve": {}}
    for m in ROWS:
        times["one_solve"][m] = median_s(lambda: gp.predict_mean_variance(xq[:m]), args.reps)
    if takes_block:
        for w in WIDTHS:
            times[f"block_{w}"] = {m: median_s(lambda: gp.predict_mean_variance(xq[:m], block=w), args.reps)
                                   for m in ROWS}
    try:
        from friedrich_tpu_torch import serving
    except ImportError:
        serving = None
    if serving is not None and hasattr(serving, "AcceleratedGPServer"):
        for w in WIDTHS:
            with serving.AcceleratedGPServer(gp, block=w) as srv:
                with serving.GPClient(port=srv.port, timeout=600.0) as client:
                    served = {}
                    for m in SERVED_ROWS:
                        q = xq_np[:m]
                        client.predict_mean_variance(q)
                        lat = []
                        for _ in range(args.reps):
                            t0 = time.perf_counter()
                            client.predict_mean_variance(q)
                            lat.append(time.perf_counter() - t0)
                        served[m] = statistics.median(lat)
            times[f"served_block_{w}"] = served
    print(json.dumps({"repo": args.repo, "device": torch.cuda.get_device_name(0), "smi": smi,
                      "capacity": cap, "build_s": build_s, "reps": args.reps, "seconds": times}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
