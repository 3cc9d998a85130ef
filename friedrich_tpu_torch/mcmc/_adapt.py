"""What HMC and NUTS share: the warmup adaptation, the random draws and the
density's value and gradient.

Counterpart of ``friedrich_tpu/mcmc/_adapt.py``. One function owns the
dual-averaging step-size schedule (Hoffman & Gelman 2014 constants:
gamma=0.05, t0=10, kappa=0.75, target accept 0.8) and the pooled Welford
diagonal-mass estimate. The sampler supplies only its transition; the
``pool_mean`` / ``pool_sum`` hooks (identity by default) are where the
cross-chain reductions become all-reduces when chains are spread over
devices. The schedule's scalars live on the host; the Welford sums are
tensors on the chains' device. One Python loop over the warmup steps takes
the place of the JAX package's ``lax.scan``.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

TARGET_ACCEPT = 0.8
DA_GAMMA = 0.05
DA_T0 = 10.0
DA_KAPPA = 0.75


class GeneratorDraws:
    """The samplers' random numbers, drawn in turn from one CPU
    ``torch.Generator`` as a transition asks for them. The draws decide
    host-side branches, so drawing them on the host costs no device round
    trip, and a seed gives the same draws on the CPU and on the card.

    A transition asks for its numbers by purpose: ``momentum(dim)``
    (standard normals), ``direction()`` (True: forward), and the uniforms
    ``leaf_uniform``, ``merge_uniform``, ``jitter_uniform`` and
    ``accept_uniform``. An object with the same methods can replay another
    generator's numbers (the tests replay the JAX package's keys)."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def momentum(self, dim: int) -> torch.Tensor:
        return torch.randn((dim,), generator=self.generator, dtype=torch.float64)

    def uniform(self) -> float:
        return float(torch.rand((), generator=self.generator, dtype=torch.float64))

    def direction(self) -> bool:
        return self.uniform() < 0.5

    leaf_uniform = merge_uniform = jitter_uniform = accept_uniform = uniform


def as_generator(generator) -> torch.Generator:
    """A CPU ``torch.Generator``: ``generator`` itself, or one seeded with
    it when it is an int."""
    if isinstance(generator, torch.Generator):
        return generator
    return torch.Generator().manual_seed(int(generator))


def value_and_grad(logp: Callable[[torch.Tensor], torch.Tensor]):
    """``theta -> (logp(theta), d logp / d theta)``, both detached: each call
    differentiates on a fresh leaf, so no graph is kept between calls."""

    def val_grad(theta: torch.Tensor):
        th = theta.detach().requires_grad_(True)
        with torch.enable_grad():
            val = logp(th)
            (grad,) = torch.autograd.grad(val, th)
        return val.detach(), grad

    return val_grad


def log_uniform(u: float) -> float:
    """``log(u)`` of a uniform draw in [0, 1), -inf at 0."""
    return math.log(u) if u > 0.0 else -math.inf


def chain_starts(init_theta: torch.Tensor, num_chains: int, generator) -> torch.Tensor:
    """(chains, dim) starts: ``init_theta`` itself when it is (chains, dim),
    else jittered around it by 0.1 standard normals from ``generator``."""
    if init_theta.ndim == 2:
        return init_theta
    noise = torch.randn((num_chains, init_theta.shape[0]), generator=generator, dtype=torch.float64)
    return init_theta[None, :] + 0.1 * noise.to(dtype=init_theta.dtype, device=init_theta.device)


def evaluate_chains(val_grad, theta: torch.Tensor):
    """The densities (chains,) and gradients (chains, dim) at the rows of
    ``theta``, one evaluation per chain."""
    vals, grads = zip(*(val_grad(t) for t in theta))
    return torch.stack(vals), torch.stack(grads)


class WarmupResult(NamedTuple):
    carry: tuple  # sampler-specific chain state after warmup
    step_size: float
    inv_mass: torch.Tensor


def _identity(v):
    return v


def _da_phase(step_fn, carry, get_positions, num_steps, inv_mass, init_step_size,
              pool_mean, pool_sum, welford_from):
    """One dual-averaging phase under a FIXED ``inv_mass``; Welford
    statistics pooled over the chains from step ``welford_from`` on.
    Returns ``(carry, step_size, variance, count)``."""
    mu = math.log(10.0 * init_step_size)
    log_eps = log_eps_bar = math.log(init_step_size)
    h_bar = 0.0
    positions = get_positions(carry)
    dim = positions.shape[-1]
    w_mean = torch.zeros((dim,), dtype=positions.dtype, device=positions.device)
    w_m2 = torch.zeros_like(w_mean)
    w_cnt = torch.zeros((), dtype=positions.dtype, device=positions.device)
    for i in range(num_steps):
        carry, alpha = step_fn(carry, math.exp(log_eps), inv_mass)
        acc_mean = float(pool_mean(torch.mean(alpha)))
        t = i + 1.0
        h_bar = (1.0 - 1.0 / (t + DA_T0)) * h_bar + (TARGET_ACCEPT - acc_mean) / (t + DA_T0)
        log_eps = mu - math.sqrt(t) / DA_GAMMA * h_bar
        w = t ** (-DA_KAPPA)
        log_eps_bar = w * log_eps + (1.0 - w) * log_eps_bar
        if i >= welford_from:
            theta = get_positions(carry)
            w_cnt = w_cnt + pool_sum(torch.tensor(float(theta.shape[0]), dtype=w_cnt.dtype,
                                                  device=w_cnt.device))
            delta = theta - w_mean[None, :]
            w_mean = w_mean + pool_sum(torch.sum(delta, dim=0)) / torch.clamp(w_cnt, min=1.0)
            w_m2 = w_m2 + pool_sum(torch.sum(delta * (theta - w_mean[None, :]), dim=0))
    var = w_m2 / torch.clamp(w_cnt - 1.0, min=1.0)
    return carry, math.exp(log_eps_bar), var, w_cnt


def dual_averaging_warmup(
    step_fn: Callable,
    carry0: tuple,
    get_positions: Callable[[tuple], torch.Tensor],
    num_warmup: int,
    init_step_size: float = 0.1,
    pool_mean=None,
    pool_sum=None,
) -> WarmupResult:
    """Two-phase warmup. ``step_fn(carry, eps, inv_mass) -> (carry,
    alpha)`` advances every chain once at step size ``eps`` (a float) and
    returns the per-chain acceptance statistics as a tensor;
    ``get_positions(carry)`` gives the (chains, dim) states for the mass.

    Phase 1 (~3/4): dual-average eps under identity mass, collecting the
    pooled Welford variance over its second half. Phase 2 (~1/4): re-tune
    eps under the adapted diagonal mass, anchored at phase 1's eps (a mass
    far from identity changes the effective step size)."""
    pool_mean = pool_mean or _identity
    pool_sum = pool_sum or _identity
    n1 = max(1, (3 * num_warmup) // 4)
    n2 = max(1, num_warmup - n1)
    positions = get_positions(carry0)
    ones = torch.ones((positions.shape[-1],), dtype=positions.dtype, device=positions.device)
    carry, eps1, var, w_cnt = _da_phase(step_fn, carry0, get_positions, n1, ones, init_step_size,
                                        pool_mean, pool_sum, welford_from=n1 // 2)
    inv_mass = torch.where(w_cnt > 2, torch.clamp(var, min=1e-6), 1.0)
    carry, eps2, _, _ = _da_phase(step_fn, carry, get_positions, n2, inv_mass, eps1,
                                  pool_mean, pool_sum, welford_from=n2 + 1)
    return WarmupResult(carry=carry, step_size=eps2, inv_mass=inv_mass)
