"""Times kernel B1, the covariance tile of the PyTorch/CUDA port
(``friedrich_tpu_torch``), at the main path's shapes on one GPU.

    python3 scripts/torch_covariance_times.py [--repo DIR] [--reps 10]

``--repo`` is the root of the checkout whose ``friedrich_tpu_torch`` is
timed (default: this repository), so that two versions can be compared on
one card in turns, e.g. a parent commit unpacked with ``git archive`` into
a git-ignored directory:

    python3 scripts/torch_covariance_times.py --repo tmp_cache/parent
    python3 scripts/torch_covariance_times.py
    python3 scripts/torch_covariance_times.py
    python3 scripts/torch_covariance_times.py --repo tmp_cache/parent

The inputs are ``bench.py``'s shapes (d = 8, float32, seed 0): the
SquaredExp kernel (the main path's, a single leaf) in train mode at 8,192²
(the sub-fit) and 50,512², in cross mode at 50,512 × 4,096 and 100,512 ×
4,096 (the predicts), and the Composite tree Matern2·RationalQuadratic +
Linear·SquaredExp in train mode at 50,512²; beside them, for the card's
practical write rate, torch's ``fill_`` of a 50,512² float32 matrix, which
writes the same bytes and reads none. Each time is the device time
of one launch: CUDA events around ``--reps`` launches issued back to back
after a warm-up, divided by ``--reps``, the median of three such runs. The
kernels' parameters stay on the host, so that a launch does not wait for
a device-to-host copy of them. Prints the card's ``nvidia-smi`` name and
power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path


def launch_ms(fn, reps: int) -> float:
    """Device time of one call of ``fn``: the median of three runs of
    ``reps`` calls back to back, each timed by CUDA events, over ``reps``."""
    import torch

    fn()
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--repo", default=str(Path(__file__).resolve().parents[1]),
                        help="root of the checkout to time (default: this repository)")
    parser.add_argument("--reps", type=int, default=10)
    args = parser.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_covariance_times: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.repo).resolve()))
    from friedrich_tpu_torch import kernels as K
    from friedrich_tpu_torch.ops.cuda import covariance_cuda

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(100_512, 8)).astype(np.float32), device="cuda")
    xq = torch.as_tensor(rng.normal(size=(4096, 8)).astype(np.float32), device="cuda")
    se = K.SquaredExp(ls=0.9, ampl=1.3).to(torch.float32, "cpu")
    composite = (K.Matern2(ls=1.1, ampl=0.7) * K.RationalQuadratic(alpha=1.5, ls=1.2)
                 + K.Linear(c=0.4) * K.SquaredExp(ls=0.9, ampl=1.3)).to(torch.float32, "cpu")
    x50, x8 = x[:50_512], x[:8192]
    cases = {
        "train 8192^2": (se, x8, x8, 8192, True),
        "train 50512^2": (se, x50, x50, 50_000, True),
        "cross 50512 x 4096": (se, x50, xq, 50_000, False),
        "cross 100512 x 4096": (se, x, xq, 100_000, False),
        "Composite train 50512^2": (composite, x50, x50, 50_000, True),
    }
    times = {}
    for label, (kern, x1, x2, n, train) in cases.items():
        times[label] = launch_ms(lambda: covariance_cuda.covariance(kern, x1, x2, n, 1.0 if train else 0.0,
                                                                    train=train), args.reps)
        torch.cuda.empty_cache()
    # the card's practical write rate: torch's fill_ of the same 50,512^2 float32 matrix
    out = torch.empty((50_512, 50_512), dtype=torch.float32, device="cuda")
    fill_ms = launch_ms(lambda: out.fill_(1.0), args.reps)
    print(json.dumps({"repo": args.repo, "device": torch.cuda.get_device_name(0), "smi": smi,
                      "reps": args.reps, "ms": times, "fill_50512^2_ms": fill_ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
