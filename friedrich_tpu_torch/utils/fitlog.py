"""Structured fit and MCMC observability.

Counterpart of ``friedrich_tpu/utils/fitlog.py``. The reference's only
observability is commented-out prints (``optimizer.rs:145-148,279-283``).
Here: a per-iteration record the fits emit (parameters, noise, scale, step
size, exact likelihood) and a summary formatter for MCMC diagnostics.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, List, Optional

import numpy as np
import torch

from ..mcmc.diagnostics import ess, rhat


@dataclasses.dataclass
class FitRecord:
    iteration: int
    params: list
    noise: float
    scale: Optional[float] = None
    max_delta: Optional[float] = None
    likelihood: Optional[float] = None

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))


class FitLog:
    """Accumulates per-iteration fit records; printable / serializable."""

    def __init__(self, verbose: bool = False):
        self.records: List[FitRecord] = []
        self.verbose = verbose

    def log(self, **kwargs: Any) -> None:
        rec = FitRecord(**kwargs)
        self.records.append(rec)
        if self.verbose:
            print(rec.to_json())

    def __len__(self) -> int:
        return len(self.records)


def mcmc_summary_table(samples, accept_prob=None, divergent=None) -> str:
    """Human-readable posterior summary with R-hat / ESS diagnostics."""
    samples = torch.as_tensor(samples)
    x = samples.detach().cpu().numpy()
    mean, std = x.mean(axis=(0, 1)), x.std(axis=(0, 1))
    r = rhat(samples).cpu().numpy()
    e = ess(samples).cpu().numpy()
    lines = ["dim      mean       std      rhat       ess"]
    for i in range(mean.shape[0]):
        lines.append(f"{i:>3} {mean[i]:>9.4f} {std[i]:>9.4f} {r[i]:>9.4f} {e[i]:>9.1f}")
    if accept_prob is not None:
        lines.append(f"mean accept: {float(np.mean(_numpy(accept_prob))):.3f}")
    if divergent is not None:
        lines.append(f"divergence rate: {float(np.mean(_numpy(divergent))):.4f}")
    return "\n".join(lines)


def _numpy(values) -> np.ndarray:
    return values.detach().cpu().numpy() if isinstance(values, torch.Tensor) else np.asarray(values)
