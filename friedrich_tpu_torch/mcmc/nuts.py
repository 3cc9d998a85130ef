"""No-U-Turn Sampler (iterative, multinomial).

Counterpart of ``friedrich_tpu/mcmc/nuts.py``, with the same algorithm, so
that its draws and their distribution can be held against the JAX
package's:

- **Iterative tree building** with checkpoints instead of recursion. Within
  a doubling of 2^k leaves, leaf ``a`` (even) is checkpointed at slot
  ctz(a) (slot ``max_depth`` for a = 0); at an odd leaf ``i`` every aligned
  power-of-two block ending at ``i`` is U-turn-checked against its start
  checkpoint — the set of subtree checks the recursive algorithm performs.
- **Multinomial sampling** over the trajectory (Betancourt 2017): within a
  subtree, a reservoir takes each leaf with probability
  ``exp(logw_leaf - logsumexp)``; across the doubling merge, biased
  progressive (``min(1, w_new / w_old)``) as Stan does.
- Generalized U-turn criterion with a diagonal mass: turning iff
  ``dz . (inv_mass r_minus) < 0`` or ``dz . (inv_mass r_plus) < 0``, for
  every checked block and for the whole trajectory after each merge.
- Divergence when the energy error exceeds 1000 (Stan's default) or is not
  finite; a divergent leaf has weight zero, so a non-finite point never
  becomes the proposal.
- The proposal's gradient is carried with it: no gradient is recomputed.

The JAX package writes one chain's transition as nested ``lax.while_loop``s
over state dicts and vmaps the chains. Here a transition is a Python loop
over host scalars: the position, momentum, gradient and density of each
leaf stay tensors on the chain's device, and each leaf reads its energy
(and, at odd leaves, its U-turn checks) on the host. The chains advance in
lockstep, each chain's transition in turn. A transition takes its random
numbers from a draws object (``sample_nuts`` passes an
``_adapt.GeneratorDraws``) and consumes them in the JAX package's order:
momentum; then per doubling the direction, one uniform per leaf and the
merge uniform (drawn even when the subtree turned or diverged).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from ..utils.profiling import scope
from ._adapt import (
    GeneratorDraws,
    as_generator,
    chain_starts,
    dual_averaging_warmup,
    evaluate_chains,
    log_uniform,
    value_and_grad,
)

MAX_DELTA_ENERGY = 1000.0


class NUTSResult(NamedTuple):
    samples: torch.Tensor  # (num_samples, chains, dim)
    accept_prob: torch.Tensor  # (num_samples, chains) trajectory-averaged alpha
    step_size: torch.Tensor  # ()
    inv_mass: torch.Tensor  # (dim,)
    tree_depth: torch.Tensor  # (num_samples, chains)
    divergent: torch.Tensor  # (num_samples, chains) bool


def _ctz(i: int) -> int:
    """Count of trailing zero bits of a positive int."""
    return (i & -i).bit_length() - 1


def _logaddexp(a: float, b: float) -> float:
    if a == -math.inf:
        return b
    if b == -math.inf:
        return a
    hi = max(a, b)
    return hi + math.log1p(math.exp(-abs(a - b)))


def _leapfrog(val_grad, z, r, g, eps: float, inv_mass):
    r = r + 0.5 * eps * g
    z = z + eps * inv_mass * r
    logp, g = val_grad(z)
    r = r + 0.5 * eps * g
    return z, r, logp, g


def _energy(logp, r, inv_mass) -> torch.Tensor:
    return -logp + 0.5 * torch.sum(r * r * inv_mass)


def _turning(z_minus, r_minus, z_plus, r_plus, inv_mass) -> torch.Tensor:
    """The generalized U-turn test, as a 0-d bool tensor (no host read)."""
    dz = z_plus - z_minus
    return (torch.dot(dz, inv_mass * r_minus) < 0) | (torch.dot(dz, inv_mass * r_plus) < 0)


class _Subtree(NamedTuple):
    z: torch.Tensor  # the new edge
    r: torch.Tensor
    g: torch.Tensor
    z_prop: torch.Tensor
    logp_prop: torch.Tensor
    g_prop: torch.Tensor
    log_weight: float
    sum_alpha: float
    leaves: int
    turning: bool
    divergent: bool


def _build_subtree(val_grad, edge, h0: float, eps: float, forward: bool, depth: int,
                   inv_mass, max_depth: int, draws) -> _Subtree:
    """Simulate up to 2^depth leaves from ``edge = (z, r, g)`` in one
    direction, stopping at the first U-turn or divergence
    (``friedrich_tpu/mcmc/nuts.py:184-282``)."""
    z, r, g = edge
    eps_d = eps if forward else -eps
    ckpt: list = [None] * (max_depth + 1)
    z_prop, g_prop = z, g
    logp_prop = torch.full((), -math.inf, dtype=z.dtype, device=z.device)
    log_weight, sum_alpha = -math.inf, 0.0
    turning = divergent = False
    i = 0
    while i < 2**depth and not turning and not divergent:
        z, r, logp, g = _leapfrog(val_grad, z, r, g, eps_d, inv_mass)
        h = float(_energy(logp, r, inv_mass))
        delta = h - h0
        divergent = not math.isfinite(h) or delta > MAX_DELTA_ENERGY
        logw = -delta if math.isfinite(h) else -math.inf
        alpha = 0.0 if math.isnan(delta) else math.exp(min(0.0, -delta))
        # multinomial reservoir within the subtree
        new_logsum = _logaddexp(log_weight, logw)
        if log_uniform(draws.leaf_uniform()) < logw - new_logsum:
            z_prop, logp_prop, g_prop = z, logp, g
        if i % 2 == 0:
            ckpt[max_depth if i == 0 else _ctz(i)] = (z, r)
        else:
            # every aligned block ending at leaf i, against its first leaf
            checks = []
            for k in range(1, max_depth + 1):
                size = 2**k
                if (i + 1) % size:
                    continue
                a = i + 1 - size
                z_a, r_a = ckpt[max_depth if a == 0 else _ctz(a)]
                checks.append(_turning(z_a, r_a, z, r, inv_mass) if forward
                              else _turning(z, r, z_a, r_a, inv_mass))
            turning = bool(torch.stack(checks).any())
        log_weight = new_logsum
        sum_alpha += alpha
        i += 1
    return _Subtree(z, r, g, z_prop, logp_prop, g_prop, log_weight, sum_alpha, i, turning,
                    divergent)


def transition(val_grad, z0, logp0, g0, eps: float, inv_mass, max_depth: int, draws):
    """One NUTS transition of one chain from ``z0`` (its density ``logp0``
    and gradient ``g0``) at step size ``eps`` (``friedrich_tpu/mcmc/
    nuts.py:150-353``). Returns ``(z, logp, g, accept_stat, depth,
    divergent)``: the proposal with its density and gradient as tensors,
    the trajectory-averaged acceptance statistic, the tree depth and the
    divergence flag as host values."""
    with scope("nuts/transition"):
        r0 = draws.momentum(z0.shape[0]).to(dtype=z0.dtype, device=z0.device) / torch.sqrt(inv_mass)
        h0 = float(_energy(logp0, r0, inv_mass))
        minus = plus = (z0, r0, g0)
        z_prop, logp_prop, g_prop = z0, logp0, g0
        log_weight, sum_alpha, n_alpha = 0.0, 0.0, 0
        depth, turning, divergent = 0, False, False
        while depth < max_depth and not turning and not divergent:
            forward = draws.direction()
            sub = _build_subtree(val_grad, plus if forward else minus, h0, eps, forward, depth,
                                 inv_mass, max_depth, draws)
            if forward:
                plus = (sub.z, sub.r, sub.g)
            else:
                minus = (sub.z, sub.r, sub.g)
            ok = not sub.turning and not sub.divergent
            # biased progressive merge (Stan): take the subtree's proposal with
            # probability min(1, w_sub / w_old)
            u = draws.merge_uniform()
            if ok and log_uniform(u) < sub.log_weight - log_weight:
                z_prop, logp_prop, g_prop = sub.z_prop, sub.logp_prop, sub.g_prop
            if ok:
                log_weight = _logaddexp(log_weight, sub.log_weight)
            # the whole trajectory's U-turn check after the merge
            turning = sub.turning or bool(_turning(minus[0], minus[1], plus[0], plus[1], inv_mass))
            sum_alpha += sub.sum_alpha
            n_alpha += sub.leaves
            depth += 1
            divergent = divergent or sub.divergent
        return z_prop, logp_prop, g_prop, sum_alpha / max(n_alpha, 1), depth, divergent


def sample_nuts(
    logp: Callable[[torch.Tensor], torch.Tensor],
    init_theta: torch.Tensor,
    generator,
    num_warmup: int = 300,
    num_samples: int = 500,
    num_chains: int = 4,
    max_depth: int = 8,
    init_step_size: float = 0.1,
    pool_mean=None,
    pool_sum=None,
    step_size=None,
    inv_mass=None,
) -> NUTSResult:
    """Run ``num_chains`` NUTS chains with the pooled dual-averaging warmup;
    returns the post-warmup draws.

    ``init_theta``: (dim,) start (chains jittered around it) or (chains,
    dim) per-chain starts. ``generator``: a ``torch.Generator`` (on the
    CPU) or an int seed; it draws the starts, the momenta and every
    uniform. Pass
    ``step_size`` and ``inv_mass`` (from a previous result) to skip warmup:
    chain resumption, with ``init_theta=prev.samples[-1]``. ``pool_mean`` /
    ``pool_sum`` pool the warmup statistics across devices.
    """
    generator = as_generator(generator)
    draws = GeneratorDraws(generator)
    val_grad = value_and_grad(logp)
    theta = chain_starts(init_theta, num_chains, generator)
    dtype, device = theta.dtype, theta.device
    logp_v, g = evaluate_chains(val_grad, theta)

    def advance(carry, eps, im):
        out = [transition(val_grad, *chain, eps, im, max_depth, draws) for chain in zip(*carry)]
        z, lp, gr, alpha, depth, div = zip(*out)
        carry = (torch.stack(z), torch.stack(lp), torch.stack(gr))
        return carry, torch.tensor(alpha, dtype=dtype, device=device), depth, div

    def warmup_step(carry, eps, im):
        carry, alpha, _, _ = advance(carry, eps, im)
        return carry, alpha

    if step_size is None or inv_mass is None:
        warm = dual_averaging_warmup(warmup_step, (theta, logp_v, g), lambda c: c[0], num_warmup,
                                     init_step_size, pool_mean, pool_sum)
        carry, eps, inv_mass = warm.carry, warm.step_size, warm.inv_mass
    else:
        carry, eps = (theta, logp_v, g), float(step_size)
        inv_mass = torch.as_tensor(inv_mass, dtype=dtype, device=device)

    samples = theta.new_empty((num_samples, *theta.shape))
    accept = theta.new_empty((num_samples, theta.shape[0]))
    depths, divs = [], []
    for s in range(num_samples):
        carry, accept[s], depth, div = advance(carry, eps, inv_mass)
        samples[s] = carry[0]
        depths.append(depth)
        divs.append(div)
    shape = (num_samples, theta.shape[0])
    return NUTSResult(
        samples=samples,
        accept_prob=accept,
        step_size=torch.tensor(eps, dtype=dtype, device=device),
        inv_mass=inv_mass,
        tree_depth=torch.tensor(depths, dtype=torch.int32, device=device).reshape(shape),
        divergent=torch.tensor(divs, dtype=torch.bool, device=device).reshape(shape),
    )
