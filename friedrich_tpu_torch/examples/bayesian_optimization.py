"""Bayesian optimization on the port: the twin of
``examples/bayesian_optimization.py``.

The reference positions itself as "a building block for algorithms like
Bayesian optimization" (reference readme.md:7). This is that algorithm:
expected-improvement BO over a 1-D test function, each acquisition an
O(n^2 k) Cholesky append into capacity reserved up front (never a
retrain), with a hyperparameter refit every 5 acquisitions. On the card
the covariance kernel builds each train and cross covariance.

Run: ``python -m friedrich_tpu_torch.examples.bayesian_optimization``
(the card), or ``main(device="cpu")``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import GaussianProcess, kernels, priors


def objective(x):
    """Multi-modal 1-D test function (global max ~0.976 at x~0.867)."""
    return np.sin(13.0 * x) * np.sin(27.0 * x) / 2.0 + 0.5


def expected_improvement(mean: torch.Tensor, var: torch.Tensor, best: float,
                         xi: float = 0.01) -> torch.Tensor:
    std = torch.sqrt(torch.clamp(var, min=1e-12))
    z = (mean - best - xi) / std
    pdf = torch.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)
    return (mean - best - xi) * torch.special.ndtr(z) + std * pdf


def main(num_iters: int = 20, seed: int = 0, device=None) -> float:
    rng = np.random.default_rng(seed)
    # initial design
    x_obs = rng.uniform(0.0, 1.0, size=(4, 1))
    y_obs = objective(x_obs[:, 0])

    gp = (
        GaussianProcess.builder(x_obs, y_obs, device=device)
        .set_kernel(kernels.Matern2())
        .set_prior(priors.ConstantPrior.default(1))
        .fit_kernel()
        .fit_prior()
        .set_fit_parameters(30, 0.05)
        .set_capacity(64)  # reserve room: appends stay in place
        .train()
    )

    grid = np.linspace(0.0, 1.0, 501)[:, None]
    grid_t = torch.as_tensor(grid, dtype=gp.state.x.dtype, device=gp.state.x.device)
    for i in range(num_iters):
        mean, var = gp.predict_mean_variance(grid_t)
        ei = expected_improvement(mean, var, float(np.max(y_obs)))
        x_next = grid[int(torch.argmax(ei))]
        y_next = objective(x_next[0])
        gp.add_samples(x_next[None, :], np.asarray([y_next]))  # O(n^2) append
        x_obs = np.vstack([x_obs, x_next[None, :]])
        y_obs = np.append(y_obs, y_next)
        if (i + 1) % 5 == 0:
            gp.fit_parameters(True, True, max_iter=20)
        print(
            f"iter {i + 1:2d}: x={x_next[0]:.3f} y={y_next:+.4f} "
            f"best={np.max(y_obs):+.4f} n={gp.num_samples}"
        )

    best_x = x_obs[np.argmax(y_obs), 0]
    print(f"\nbest found: f({best_x:.4f}) = {np.max(y_obs):.4f}")
    return float(np.max(y_obs))


if __name__ == "__main__":
    main()
