"""Heuristic hyperparameter initialization.

Reference: ``parameters/kernel.rs:94-119``; counterpart of
``friedrich_tpu/kernels/heuristics.py``. The mean pairwise distance is one
vectorized distance matrix and a reduction; above
:data:`_STREAM_THRESHOLD` rows it is summed in (n, B) strips so that memory
stays O(n*B) (a whole matrix at n=50,000 would take 10 GB in float32).
"""

from __future__ import annotations

import torch

from ..ops.distance import DIST, pairwise_features
from ..ops.partition import pick_block

#: Above this n the full n x n distance matrix is streamed in strips.
_STREAM_THRESHOLD = 16384


def fit_bandwidth_mean(x: torch.Tensor, method: str = "gram") -> torch.Tensor:
    """Mean distance between distinct sample pairs (``kernel.rs:94-113``).

    Sums distances over unordered pairs i<j and divides by n(n-1)/2. The
    full symmetric distance matrix has zero diagonal, so the strict-triangle
    sum is simply half the total sum.
    """
    n = x.shape[0]
    nb_pairs = (n * n - n) / 2.0
    if n > _STREAM_THRESHOLD:
        return _bandwidth_mean_streamed(x, method) / nb_pairs
    dist = pairwise_features(x, x, frozenset({DIST}), method=method)[DIST]
    total = torch.sum(dist) / 2.0
    return total / nb_pairs


def _bandwidth_mean_streamed(x: torch.Tensor, method: str, block: int = 4096) -> torch.Tensor:
    n = x.shape[0]
    b = pick_block(n, block)
    total = torch.zeros((), dtype=x.dtype, device=x.device)
    for j0 in range(0, n, b):
        dist = pairwise_features(x, x[j0:j0 + b], frozenset({DIST}), method=method)[DIST]
        total = total + torch.sum(dist)
    return total / 2.0


def fit_amplitude_var(y: torch.Tensor) -> torch.Tensor:
    """Population variance of the outputs (``kernel.rs:116-119``): divides
    by n, not n-1."""
    return torch.var(y, correction=0)
