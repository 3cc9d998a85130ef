"""Hyperparameter log-posterior whose factorization is spread over the ranks
of a mesh.

Counterpart of ``friedrich_tpu/mcmc/distributed_logprob.py`` (``:55-212``):
every density evaluation runs the row-sharded distributed Cholesky
(``parallel/distributed_cholesky.py``, B2 on the card) and distributed
sweeps, so the samplers reach n where one device cannot hold the factor.
The gradient is analytic (``optimizer.rs:24-60``), as a
``torch.autograd.Function``:

    d LML / d p = 1/2 alpha^T (dK/dp) alpha - 1/2 tr(K^-1 dK/dp)

- the VALUE is exact: the data fit from the sweeps, ``ln|K|`` from each
  rank's diagonal entries of its factor rows, summed by one all-reduce;
- ``alpha^T dK alpha`` is exact and the traces are fixed-probe Hutchinson
  estimates, each rank streaming its rows of ``dK_p [alpha | Z]`` and the
  partial sums travelling in one all-reduce. Fixed probes make the gradient
  a deterministic function of theta, so the samplers stay exact (the
  acceptance test uses the exact energy).

Every rank evaluates the density at the same theta (SPMD); the value and
gradient are the same on every rank.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from ..models.gp import GPState
from ..ops.streamed_matvec import rademacher_probes
from ..parallel.distributed_cholesky import distributed_cholesky_factor
from ..parallel.distributed_solve import distributed_solve_lower, distributed_solve_lower_t
from ..parallel.distributed_solve import gradient_partials
from ..parallel.mesh import Mesh, all_reduce
from .logprob import _sign_vector

LOG_2PI = math.log(2.0 * math.pi)


class _DistributedDensity:
    """What the density reads of the state (never its factor) and the
    rank's rows of it."""

    def __init__(self, mesh: Mesh, state: GPState, prior_mu, prior_sigma, signs, block, probes):
        self.mesh = mesh
        self.x_pad, self.resid, self.n, self.cap = state.x, state.resid, state.n, state.capacity
        self.r0, self.r1 = mesh.rows(self.cap)
        self.x_local = self.x_pad[self.r0:self.r1]
        self.method, self.eps, self.kernel = state.method, state.eps, state.kernel
        self.nb = state.kernel.nb_params
        self.sign_vec = _sign_vector(state, signs)
        self.prior_mu, self.prior_sigma = prior_mu, prior_sigma
        self.block, self.probes = block, probes
        self.live_local = torch.arange(self.r0, self.r1, device=self.x_pad.device) < self.n

    def _raw(self, theta):
        raw = self.sign_vec * torch.exp(theta)
        return raw, self.kernel.with_params(raw[:self.nb]), raw[self.nb]

    def forward_parts(self, theta):
        """``(logp, alpha, K^-1 Z)`` at ``theta``."""
        _, kernel, noise = self._raw(theta)
        l_local, ok = distributed_cholesky_factor(self.mesh, kernel, self.x_local, self.n, noise,
                                                  eps=self.eps, block=self.block,
                                                  method=self.method)
        # the residuals and the probes in one pair of sweeps
        rhs = torch.cat([self.resid[:, None], self.probes], dim=1)
        half = distributed_solve_lower(self.mesh, l_local, rhs, self.block)
        sol = distributed_solve_lower_t(self.mesh, l_local, half, self.block)
        diag = torch.diagonal(l_local, offset=self.r0)
        logdet = all_reduce(self.mesh, 2.0 * torch.sum(torch.where(self.live_local,
                                                                   torch.log(diag), 0.0)))
        del l_local
        ol = half[:, 0]
        lml = -(torch.sum(ol * ol) + logdet + self.n * LOG_2PI) / 2.0
        hyper = -0.5 * torch.sum(((theta - self.prior_mu) / self.prior_sigma) ** 2)
        val = torch.where(ok & torch.isfinite(lml), lml + hyper, -torch.inf)
        return val, sol[:, 0], sol[:, 1:]

    def grad_theta(self, theta, alpha, kinv_z):
        """``d logp / d theta`` (``friedrich_tpu/mcmc/distributed_logprob.py
        :167-191``)."""
        raw, kernel, noise = self._raw(theta)
        data_terms, trace_terms = gradient_partials(self.mesh, kernel, self.x_pad, self.n, alpha,
                                                    self.probes, kinv_z, self.method)
        grad_kernel_raw = (data_terms - trace_terms) / 2.0
        # dK/dnoise = 2 noise I on the live block (optimizer.rs:52-57)
        tr_kinv = torch.mean(torch.einsum("is,is->s", self.probes, kinv_z))
        grad_noise_raw = noise * (torch.dot(alpha, alpha) - tr_kinv)
        grad_raw = torch.cat([grad_kernel_raw, grad_noise_raw[None]])
        # chain rule through raw = sign * exp(theta), then the hyperprior
        return grad_raw * raw - (theta - self.prior_mu) / (self.prior_sigma**2)


class _DistributedLogprob(torch.autograd.Function):
    """The density's value and analytic gradient (the JAX package's
    ``jax.custom_vjp``): forward keeps ``alpha`` and ``K^-1 Z``, never the
    factor."""

    @staticmethod
    def forward(ctx, theta, density):
        val, alpha, kinv_z = density.forward_parts(theta.detach())
        ctx.save_for_backward(theta, alpha, kinv_z)
        ctx.density = density
        return val

    @staticmethod
    def backward(ctx, g):
        theta, alpha, kinv_z = ctx.saved_tensors
        return g * ctx.density.grad_theta(theta.detach(), alpha, kinv_z), None


def make_distributed_hyperparam_logprob(
    mesh: Mesh,
    state: GPState,
    prior_mu: float = 0.0,
    prior_sigma: float = 5.0,
    signs=None,
    block: Optional[int] = None,
    num_probes: int = 16,
    probe_seed: int = 0,
    probes: Optional[torch.Tensor] = None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """``logp(theta)`` over log-magnitude hyperparameters (noise last, fixed
    signs: ``mcmc/logprob.make_hyperparam_logprob``'s parameterization),
    its factorization row-sharded over ``mesh``. ``state`` gives the inputs,
    residuals, live count and kernel template (its factor is not read); its
    capacity must be a multiple of the mesh's size. ``probes`` (cap, s)
    replaces the draw of ``num_probes`` from ``probe_seed``
    (``ops/streamed_matvec.rademacher_probes``)."""
    if probes is None:
        probes = rademacher_probes(state.capacity, state.n, num_probes, probe_seed, state.x.dtype,
                                   state.x.device)
    probes = torch.as_tensor(probes, dtype=state.x.dtype, device=state.x.device)
    density = _DistributedDensity(mesh, state, prior_mu, prior_sigma, signs, block, probes)

    def logp(theta: torch.Tensor) -> torch.Tensor:
        return _DistributedLogprob.apply(theta, density)

    return logp


def sample_hyperparameters_distributed(
    mesh: Mesh,
    state: GPState,
    generator,
    num_warmup: int = 200,
    num_samples: int = 300,
    num_chains: int = 2,
    max_depth: int = 6,
    block: Optional[int] = None,
    num_probes: int = 16,
    prior_mu: float = 0.0,
    prior_sigma: float = 5.0,
    probes: Optional[torch.Tensor] = None,
):
    """NUTS over the GP hyperparameters with every density evaluation
    spread over the mesh. The chains run one after another (each evaluation
    already takes every rank: the opposite trade from ``mcmc/sharded.py``),
    each from its own generator drawn from ``generator``, the same on every
    rank. Returns a :class:`~.nuts.NUTSResult` with samples (num_samples,
    num_chains, dim) and one step size and mass per chain."""
    from ._adapt import as_generator
    from .logprob import initial_signs, initial_theta
    from .nuts import NUTSResult, sample_nuts

    generator = as_generator(generator)
    logp = make_distributed_hyperparam_logprob(
        mesh, state, prior_mu=prior_mu, prior_sigma=prior_sigma, signs=initial_signs(state),
        block=block, num_probes=num_probes, probes=probes,
    )
    theta0 = initial_theta(state)
    results = []
    for _ in range(num_chains):
        seed = int(torch.randint(0, 2**62, (1,), generator=generator))
        results.append(sample_nuts(logp, theta0, seed, num_warmup=num_warmup,
                                   num_samples=num_samples, num_chains=1, max_depth=max_depth))
    return NUTSResult(
        samples=torch.cat([r.samples for r in results], dim=1),
        accept_prob=torch.cat([r.accept_prob for r in results], dim=1),
        step_size=torch.stack([r.step_size for r in results]),
        inv_mass=torch.stack([r.inv_mass for r in results]),
        tree_depth=torch.cat([r.tree_depth for r in results], dim=1),
        divergent=torch.cat([r.divergent for r in results], dim=1),
    )
