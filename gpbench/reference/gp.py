"""Plain reference of the Gaussian process the benchmark runs.

Written from the mathematics alone, in plain PyTorch: it imports nothing of
the program under test and takes nothing it made, only the inputs, the
outputs and the hyperparameters a fit returned. The model is exact GP
regression with the squared-exponential kernel
``k(a, b) = |ampl| exp(-||a - b||^2 / (2 ls^2))``, observation noise
``noise^2`` on the diagonal and a constant prior mean, the mean of the
training outputs. Every matmul runs in float32 with TF32 off; ``tf32=True``
runs them in TF32 instead (the control of ``gpbench/check.py``): TF32 on
the card, and on the CPU, which has none, with each operand rounded to TF32's
10 mantissa bits first. Scalar reductions (the log marginal likelihood)
accumulate in float64.

The factor is computed left-looking, one panel of columns at a time, in
place in one (n, n) buffer, so that at n = 100,000 it needs the factor's
40 GB and one panel strip.
"""

from __future__ import annotations

import contextlib
import math

import torch

LOG_2PI = math.log(2.0 * math.pi)
PANEL = 2048
QUERY_BLOCK = 1024


@contextlib.contextmanager
def precision(tf32: bool):
    """Float32 matmuls in full float32 (``tf32=False``) or in TF32 on the
    card; the previous settings are restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.set_float32_matmul_precision(old[1])


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to the nearest TF32 value (10 mantissa
    bits), ties away from zero, as the tensor cores take their operands."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    """``a @ b`` under the precision of :func:`precision` on the card; on
    the CPU, TF32 is emulated by rounding the operands."""
    if tf32 and not a.is_cuda:
        a, b = round_tf32(a), round_tf32(b)
    return a @ b


def sq_distances(x1: torch.Tensor, x2: torch.Tensor, tf32: bool) -> torch.Tensor:
    """Squared distances between the rows of ``x1`` and ``x2``, by the
    identity ``|a|^2 + |b|^2 - 2 a.b``."""
    sq = mm(x1, x2.mT, tf32).mul_(-2.0)
    sq.add_(torch.sum(x1 * x1, dim=1, keepdim=True)).add_(torch.sum(x2 * x2, dim=1))
    return sq.clamp_(min=0.0)


def kernel_block(x1: torch.Tensor, x2: torch.Tensor, ls: float, ampl: float,
                 tf32: bool) -> torch.Tensor:
    return sq_distances(x1, x2, tf32).mul_(-0.5 / (ls * ls)).exp_().mul_(abs(ampl))


def cholesky(x: torch.Tensor, ls: float, ampl: float, noise: float, tf32: bool = False,
             panel: int = PANEL) -> torch.Tensor:
    """Lower Cholesky factor of ``K(x, x) + noise^2 I`` (zeros above the
    diagonal). Raises ``ValueError`` where a diagonal block is not positive
    definite."""
    n = x.shape[0]
    factor = torch.zeros((n, n), dtype=x.dtype, device=x.device)
    with precision(tf32):
        for j in range(0, n, panel):
            b = min(panel, n - j)
            strip = kernel_block(x[j:], x[j:j + b], ls, ampl, tf32)
            # the diagonal at zero distance exactly
            strip[:b].diagonal().fill_(abs(ampl) + noise * noise)
            if j:
                strip.sub_(mm(factor[j:, :j], factor[j:j + b, :j].mT, tf32))
            diag, info = torch.linalg.cholesky_ex(strip[:b])
            if int(info) != 0:
                raise ValueError(f"reference factor: panel at column {j} is not positive definite")
            factor[j:j + b, j:j + b] = diag
            if j + b < n:
                factor[j + b:, j:j + b] = torch.linalg.solve_triangular(
                    diag.mT, strip[b:], upper=True, left=False)
            del strip, diag
    return factor


def solve_lower(factor: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_triangular(factor, rhs, upper=False)


def log_marginal_likelihood(factor: torch.Tensor, resid: torch.Tensor) -> float:
    """``-1/2 (r^T K^-1 r + ln|K| + n ln 2 pi)`` from the factor of K."""
    n = factor.shape[0]
    beta = solve_lower(factor, resid[:, None])[:, 0]
    data_fit = float(torch.sum(beta.double() ** 2))
    logdet = 2.0 * float(torch.sum(torch.log(torch.diagonal(factor).double())))
    return -0.5 * (data_fit + logdet + n * LOG_2PI)


def predict(factor: torch.Tensor, x: torch.Tensor, resid: torch.Tensor, prior: float,
            ls: float, ampl: float, xq: torch.Tensor,
            tf32: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Posterior mean and latent variance (noise not added) at the rows of
    ``xq``, as float64 tensors on the host, for the model whose factor is
    ``factor`` (over the rows ``x``, residuals ``resid`` against the
    constant ``prior``)."""
    means, variances = [], []
    with precision(tf32):
        beta = solve_lower(factor, resid[:, None])
        for lo in range(0, xq.shape[0], QUERY_BLOCK):
            q = xq[lo:lo + QUERY_BLOCK]
            v = solve_lower(factor, kernel_block(x, q, ls, ampl, tf32))
            means.append((prior + mm(v.mT, beta, tf32)[:, 0]).double().cpu())
            variances.append((abs(ampl) - torch.sum(v * v, dim=0)).double().cpu())
            del v
    return torch.cat(means), torch.cat(variances)


def mean_distance(x: torch.Tensor, block: int = 4096) -> float:
    """Mean distance between distinct pairs of rows: the heuristic start
    of the lengthscale."""
    n = x.shape[0]
    total = 0.0
    with precision(False):
        for j in range(0, n, block):
            dist = sq_distances(x, x[j:j + block], False).sqrt_()
            dist[j:j + block].diagonal().zero_()
            total += float(torch.sum(dist, dtype=torch.float64))
    return total / (n * n - n)


def heuristic_start(x: torch.Tensor, y: torch.Tensor) -> tuple[float, float]:
    """The fit's starting kernel: ls the mean pairwise distance, ampl the
    population variance of the outputs."""
    return mean_distance(x), float(torch.var(y.double(), correction=0))
