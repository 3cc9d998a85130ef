"""Published peaks of one NVIDIA H100 and the work of the program's kernels.

Peaks: NVIDIA's data sheet for the H100 SXM part, dense rates at the full
700 W power limit. Float32 work is counted at the TF32 tensor-core rate, the
fastest any float32 product runs on the card (B2's 3xTF32 product already
runs past the 67 TFLOP/s of the CUDA cores); float64 at the FP64 tensor
cores' rate.

Work is what the mathematics needs, counted once, whatever implements it:
operations from the shapes, each input read once and each output written
once. A kernel's bound is the larger of its operations over the peak rate
and its bytes over the memory bandwidth.
"""

from __future__ import annotations

import torch

PEAK_FLOPS = {torch.float32: 495e12, torch.float64: 67e12}
HBM_BYTES_PER_S = 3.35e12


def itemsize(dtype: torch.dtype) -> int:
    return torch.finfo(dtype).bits // 8


def bound_s(flops: float, nbytes: float, dtype: torch.dtype) -> float:
    """Least time for ``flops`` operations and ``nbytes`` of traffic."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)


def covariance_work(rows: int, cols: int, d: int, dtype: torch.dtype) -> tuple[float, float]:
    """Kernel B1, one (rows, cols) tile of K over d features: the distances'
    2 rows cols d operations; both inputs read, the tile written."""
    size = itemsize(dtype)
    return 2.0 * rows * cols * d, size * ((rows + cols) * d + rows * cols)


def panel_strip_work(rows: int, block: int, j0: int, d: int,
                     dtype: torch.dtype) -> tuple[float, float]:
    """Kernel B2, one strip ``K(X[j0:], X[j0:j0+B]) - L[j0:, :j0] L[j0:j0+B, :j0]^T``
    of ``rows`` rows: the downdate's 2 rows B j0 operations and the map's
    2 rows B d; the prefix rows (the panel's own among them), both inputs
    read once, the strip written."""
    size = itemsize(dtype)
    flops = 2.0 * rows * block * j0 + 2.0 * rows * block * d
    return flops, size * (rows * j0 + (rows + block) * d + rows * block)


def share(bound: float, seconds: float) -> float | None:
    """A roofline share in %, or None where nothing ran."""
    return 100.0 * bound / seconds if seconds > 0 and bound > 0 else None


def factorization_flops(m: int) -> float:
    """A Cholesky factorization of an m x m matrix: m^3 / 3."""
    return m ** 3 / 3.0


def train_flops(n: int, subfit: int | None, subfit_iterations: int) -> float:
    """One trained model: the sub-fit's factorizations (its first build and
    one rebuild per iteration, at the subset's size) and the full build."""
    sub = factorization_flops(subfit) * (subfit_iterations + 1) if subfit else 0.0
    return sub + factorization_flops(n)


def bo_step_flops(n: int, candidates: int, batch: int) -> float:
    """One Bayesian-optimization step at n points: the variance's solve
    against the factor (n^2 per candidate), the mean (2 n per candidate)
    and the append's update (n^2 per new point)."""
    return float(n) * n * candidates + 2.0 * n * candidates + float(n) * n * batch
