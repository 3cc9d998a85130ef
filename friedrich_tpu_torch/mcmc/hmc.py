"""Hamiltonian Monte Carlo with warmup adaptation.

Counterpart of ``friedrich_tpu/mcmc/hmc.py``:

- **Chains in lockstep.** Every chain takes its step before any chain takes
  the next, so the pooled warmup statistics (``mcmc/_adapt.py``: dual
  averaging on the mean acceptance, Welford diagonal mass from the second
  warmup half) are those of all chains at the same step. The JAX package
  vmaps the chains inside one ``lax.scan``; here each chain's step is a
  Python call in turn.
- The leapfrog carries the gradient between steps: ``num_leapfrog`` steps
  cost exactly ``num_leapfrog`` density gradients (for the exact-LML target
  each is a covariance build and a Cholesky).
- Per step and per chain the step size is jittered,
  ``eps (1 + jitter (2u - 1))``, which decorrelates trajectory lengths; a
  non-finite ``log_accept`` rejects.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from ._adapt import (
    DA_GAMMA,
    DA_KAPPA,
    DA_T0,
    TARGET_ACCEPT,
    GeneratorDraws,
    as_generator,
    chain_starts,
    dual_averaging_warmup,
    evaluate_chains,
    log_uniform,
    value_and_grad,
)

__all__ = [
    "HMCResult",
    "sample_hmc",
    "TARGET_ACCEPT",
    "DA_GAMMA",
    "DA_KAPPA",
    "DA_T0",
]


class HMCResult(NamedTuple):
    samples: torch.Tensor  # (num_samples, chains, dim)
    accept_prob: torch.Tensor  # (num_samples, chains)
    step_size: torch.Tensor  # () adapted step size
    inv_mass: torch.Tensor  # (dim,) adapted diagonal inverse mass
    final_logp: torch.Tensor  # (chains,)


def _leapfrog(val_grad, theta, p, logp_v, g, eps: float, inv_mass, num_steps: int):
    """Gradient-carrying leapfrog: N steps = N gradient evaluations."""
    for _ in range(num_steps):
        p = p + 0.5 * eps * g
        theta = theta + eps * inv_mass * p
        logp_v, g = val_grad(theta)
        p = p + 0.5 * eps * g
    return theta, p, logp_v, g


def _hamiltonian(logp_val, p, inv_mass) -> torch.Tensor:
    return -logp_val + 0.5 * torch.sum(p * p * inv_mass)


def hmc_step(val_grad, theta, logp_v, g, eps: float, inv_mass, num_leapfrog: int, jitter: float,
             draws):
    """One HMC step of one chain (``friedrich_tpu/mcmc/hmc.py:167-184``).
    Returns ``(theta, logp, g, accept_prob)``: the new state as tensors and
    ``exp(log_accept)`` as a host float."""
    # per-chain step-size jitter decorrelates trajectory lengths
    eps_c = eps * (1.0 + jitter * (2.0 * draws.jitter_uniform() - 1.0))
    p = draws.momentum(theta.shape[0]).to(dtype=theta.dtype, device=theta.device) / torch.sqrt(inv_mass)
    h0 = float(_hamiltonian(logp_v, p, inv_mass))
    theta_new, p_new, logp_new, g_new = _leapfrog(val_grad, theta, p, logp_v, g, eps_c, inv_mass,
                                                  num_leapfrog)
    h1 = float(_hamiltonian(logp_new, p_new, inv_mass))
    log_accept = -math.inf if math.isnan(h0 - h1) else min(0.0, h0 - h1)
    if log_uniform(draws.accept_uniform()) < log_accept:
        theta, logp_v, g = theta_new, logp_new, g_new
    return theta, logp_v, g, math.exp(log_accept)


def sample_hmc(
    logp: Callable[[torch.Tensor], torch.Tensor],
    init_theta: torch.Tensor,
    generator,
    num_warmup: int = 300,
    num_samples: int = 500,
    num_chains: int = 4,
    num_leapfrog: int = 16,
    init_step_size: float = 0.1,
    jitter: float = 0.2,
    pool_mean=None,
    pool_sum=None,
    step_size=None,
    inv_mass=None,
) -> HMCResult:
    """Run ``num_chains`` HMC chains; returns the post-warmup draws.

    ``init_theta``: (dim,) start (chains jittered around it) or (chains,
    dim) per-chain starts. ``generator``: a ``torch.Generator`` (on the
    CPU) or an int seed, which draws the starts and every step's numbers.
    ``pool_mean`` / ``pool_sum`` pool
    the warmup statistics across devices (identity by default). Pass
    ``step_size`` and ``inv_mass`` (e.g. a previous result's) to skip warmup:
    chain resumption, with ``init_theta=prev.samples[-1]``.
    """
    generator = as_generator(generator)
    draws = GeneratorDraws(generator)
    val_grad = value_and_grad(logp)
    theta0 = chain_starts(init_theta, num_chains, generator)
    dtype, device = theta0.dtype, theta0.device

    def step_fn(carry, eps, im):
        out = [hmc_step(val_grad, *chain, eps, im, num_leapfrog, jitter, draws)
               for chain in zip(*carry)]
        theta, logp_v, g, acc = zip(*out)
        carry = (torch.stack(theta), torch.stack(logp_v), torch.stack(g))
        return carry, torch.tensor(acc, dtype=dtype, device=device)

    carry = (theta0, *evaluate_chains(val_grad, theta0))
    if step_size is None or inv_mass is None:
        warm = dual_averaging_warmup(step_fn, carry, lambda c: c[0], num_warmup, init_step_size,
                                     pool_mean, pool_sum)
        carry, eps, inv_mass = warm.carry, warm.step_size, warm.inv_mass
    else:
        eps = float(step_size)
        inv_mass = torch.as_tensor(inv_mass, dtype=dtype, device=device)

    samples = theta0.new_empty((num_samples, *theta0.shape))
    accepts = theta0.new_empty((num_samples, theta0.shape[0]))
    for s in range(num_samples):
        carry, accepts[s] = step_fn(carry, eps, inv_mass)
        samples[s] = carry[0]
    return HMCResult(
        samples=samples,
        accept_prob=accepts,
        step_size=torch.tensor(eps, dtype=dtype, device=device),
        inv_mass=inv_mass,
        final_logp=carry[1],
    )
