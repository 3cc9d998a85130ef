"""Hyperparameter log-posterior: the exact log marginal likelihood of the GP
plus a Gaussian hyperprior, over log-magnitude hyperparameters.

Counterpart of ``friedrich_tpu/mcmc/logprob.py``:

    theta = log(|params|)   with params = [kernel params..., noise]
    logp(theta) = LML(signs * exp(theta)) + sum log N(theta; mu0, sigma0)

Parameter SIGNS are held fixed at their initial values. Two densities: the
dense one differentiates the covariance build (the covariance-tile kernel
with :class:`~..ops.covariance.TrainCovarianceFn`'s backward) and the
Cholesky by autograd; the streamed one factors with the streamed backend
(the panel-strip kernel on the card) and has an analytic backward with
fixed-probe Hutchinson traces, as a ``torch.autograd.Function``. Neither
holds the (cap, cap) factor after it returns.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional

import torch

from ..config import MATMUL_PRECISION_MODES, matmul_precision
from ..models.gp import GPState
from ..ops.cholesky import cholesky_with_substitute_functional, solve_lower, solve_lower_t
from ..ops.covariance import TrainCovarianceFn
from ..ops.streamed import streamed_cholesky_factor
from ..ops.streamed_matvec import rademacher_probes, streamed_grad_matvec

LOG_2PI = math.log(2.0 * math.pi)

#: ``backend="auto"`` uses the dense density up to this capacity and the
#: streamed one above it: the dense backward holds several (cap, cap)
#: matrices, the streamed one none. The JAX package's value, kept for
#: parity: it was chosen on a TPU and is still to be decided on the H100
#: (ROADMAP).
STREAMED_LOGPROB_THRESHOLD = 2048


def _precision_scope(precision: Optional[str]):
    if precision is None:
        return contextlib.nullcontext
    if precision not in MATMUL_PRECISION_MODES:
        raise ValueError(f"unknown precision {precision!r}")
    return lambda: matmul_precision(precision)


def _sign_vector(state: GPState, signs) -> torch.Tensor:
    nb = state.kernel.nb_params
    if signs is None:
        return torch.ones((nb + 1,), dtype=state.x.dtype, device=state.x.device)
    return torch.as_tensor(signs, dtype=state.x.dtype, device=state.x.device)


def make_hyperparam_logprob(
    state: GPState,
    prior_mu: float = 0.0,
    prior_sigma: float = 5.0,
    signs=None,
    backend: str = "auto",
    num_probes: int = 16,
    probe_seed: int = 0,
    precision: Optional[str] = None,
    probes: Optional[torch.Tensor] = None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Return ``logp(theta)`` over log-magnitude hyperparameters.

    ``theta`` has length ``kernel.nb_params + 1`` (noise last); ``signs``
    (same length) fixes each raw parameter's sign, all positive by
    default. The GP prior mean and the residuals are the state's.
    ``backend``: ``"dense"`` (autograd through the build and the
    factorization), ``"streamed"`` (:func:`make_streamed_hyperparam_logprob`)
    or ``"auto"`` (by capacity, :data:`STREAMED_LOGPROB_THRESHOLD`).
    ``num_probes``, ``probe_seed`` and ``probes`` configure the streamed
    gradient. ``precision`` pins the float32 matmul precision of the
    density (``config.MATMUL_PRECISION_MODES``).
    """
    if backend not in ("auto", "dense", "streamed"):
        raise ValueError(f"unknown logprob backend {backend!r}")
    if backend == "auto":
        backend = "streamed" if state.capacity > STREAMED_LOGPROB_THRESHOLD else "dense"
    if backend == "streamed":
        return make_streamed_hyperparam_logprob(
            state, prior_mu=prior_mu, prior_sigma=prior_sigma, signs=signs,
            num_probes=num_probes, probe_seed=probe_seed, precision=precision, probes=probes,
        )
    scope = _precision_scope(precision)
    # capture only what the closure reads — never the (cap, cap) factor
    x_pad, resid, n_live, cap = state.x, state.resid, state.n, state.capacity
    method, eps, kernel_template = state.method, state.eps, state.kernel
    nb = kernel_template.nb_params
    sign_vec = _sign_vector(state, signs)
    live = torch.arange(cap, device=x_pad.device) < n_live

    def logp(theta: torch.Tensor) -> torch.Tensor:
        with scope():
            raw = sign_vec * torch.exp(theta)
            k_pad = TrainCovarianceFn.apply(raw[:nb], raw[nb], kernel_template, x_pad, n_live,
                                            method)
            if eps is not None:
                # the state's cholesky_epsilon carries over: per-pivot
                # substitution keeps the density and its gradient finite at
                # non-PSD hyperparameters
                l_pad = cholesky_with_substitute_functional(k_pad, eps)
            else:
                l_pad, info = torch.linalg.cholesky_ex(k_pad)
                l_pad = l_pad * torch.where(info == 0, 1.0, float("nan"))
            ol = solve_lower(l_pad, resid)
            data_fit = torch.sum(ol * ol)
            logdet = 2.0 * torch.sum(torch.where(live, torch.log(torch.diagonal(l_pad)), 0.0))
            lml = -(data_fit + logdet + n_live * LOG_2PI) / 2.0
            hyper = -0.5 * torch.sum(((theta - prior_mu) / prior_sigma) ** 2)
            # a failed factorization (non-PSD point) gets -inf density
            return torch.where(torch.isfinite(lml), lml + hyper, -torch.inf)

    return logp


class _StreamedLogprob(torch.autograd.Function):
    """The streamed density's value and its analytic gradient (the
    counterpart of the JAX package's ``jax.custom_vjp``): forward saves only
    ``theta``, ``alpha`` and ``K^-1 z``, never the factor."""

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


class _StreamedDensity:
    """What the streamed density reads of the state — never the factor."""

    def __init__(self, state: GPState, prior_mu, prior_sigma, signs, probes, precision):
        self.x_pad, self.resid, self.n, self.cap = state.x, state.resid, state.n, state.capacity
        self.method, self.eps, self.kernel = state.method, state.eps, state.kernel
        self.nb = state.kernel.nb_params
        self.sign_vec = _sign_vector(state, signs)
        self.prior_mu, self.prior_sigma = prior_mu, prior_sigma
        self.probes, self.precision = probes, precision
        self.scope = _precision_scope(precision)
        self.live = torch.arange(self.cap, device=self.x_pad.device) < self.n

    def _raw(self, theta):
        raw = self.sign_vec * torch.exp(theta)
        return raw, self.kernel.with_params(raw[:self.nb]), raw[self.nb]

    def _hyper(self, theta):
        return -0.5 * torch.sum(((theta - self.prior_mu) / self.prior_sigma) ** 2)

    def forward_parts(self, theta):
        with self.scope():
            _, kernel, noise = self._raw(theta)
            # the factor precision picks the panel strip's arithmetic, as in
            # every other factorization of the model
            l_pad, ok = streamed_cholesky_factor(kernel, self.x_pad, self.n, noise, eps=self.eps,
                                                 method=self.method, precision=self.precision)
            # the residuals and the probes in one pair of triangular solves
            half = solve_lower(l_pad, torch.cat([self.resid[:, None], self.probes], dim=1))
            sol = solve_lower_t(l_pad, half)
            ol, alpha, kinv_z = half[:, 0], sol[:, 0], sol[:, 1:]
            logdet = 2.0 * torch.sum(torch.where(self.live, torch.log(torch.diagonal(l_pad)), 0.0))
            del l_pad
            lml = -(torch.sum(ol * ol) + logdet + self.n * LOG_2PI) / 2.0
            val = torch.where(ok & torch.isfinite(lml), lml + self._hyper(theta), -torch.inf)
        return val, alpha, kinv_z

    def grad_theta(self, theta, alpha, kinv_z):
        """``d logp / d theta`` (``friedrich_tpu/mcmc/logprob.py:331-349``):
        ``1/2 alpha^T dK_p alpha - 1/2 tr(K^-1 dK_p)`` per kernel parameter,
        the traces by Hutchinson, the noise term, the chain rule and the
        hyperprior."""
        with self.scope():
            raw, kernel, noise = self._raw(theta)
            # alpha and the probes in one streamed pass over dK
            dk_v = streamed_grad_matvec(kernel, self.x_pad, self.n,
                                        torch.cat([alpha[:, None], self.probes], dim=1),
                                        method=self.method)
            data_terms = dk_v[:, :, 0] @ alpha
            trace_terms = torch.mean(torch.einsum("is,pis->ps", kinv_z, dk_v[:, :, 1:]), dim=1)
            grad_kernel_raw = (data_terms - trace_terms) / 2.0
            tr_kinv = torch.mean(torch.einsum("is,is->s", self.probes, kinv_z))
            grad_noise_raw = noise * (torch.dot(alpha, alpha) - tr_kinv)
        grad_raw = torch.cat([grad_kernel_raw, grad_noise_raw[None]])
        # chain rule d raw / d theta = raw, then the hyperprior
        return grad_raw * raw - (theta - self.prior_mu) / (self.prior_sigma**2)


def make_streamed_hyperparam_logprob(
    state: GPState,
    prior_mu: float = 0.0,
    prior_sigma: float = 5.0,
    signs=None,
    num_probes: int = 16,
    probe_seed: int = 0,
    precision: Optional[str] = None,
    probes: Optional[torch.Tensor] = None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """``logp(theta)`` whose factorization is the streamed build and factor
    (K never materialized; the panel-strip kernel on the card).

    The VALUE is the exact log posterior. The GRADIENT is analytic
    (``optimizer.rs:24-60``):

        d LML / d p = 1/2 alpha^T (dK/dp) alpha - 1/2 tr(K^-1 dK/dp)

    with exact data-fit terms (streamed dK matvecs) and fixed-seed
    Hutchinson traces, so it is deterministic in ``theta``. ``probes``
    (cap, s) replaces the draw of ``num_probes`` from ``probe_seed``.
    """
    if probes is None:
        probes = rademacher_probes(state.capacity, state.n, num_probes, probe_seed,
                                   state.x.dtype, state.x.device)
    probes = torch.as_tensor(probes, dtype=state.x.dtype, device=state.x.device)
    density = _StreamedDensity(state, prior_mu, prior_sigma, signs, probes, precision)

    def logp(theta: torch.Tensor) -> torch.Tensor:
        return _StreamedLogprob.apply(theta, density)

    return logp


def _raw_params(state: GPState) -> torch.Tensor:
    return torch.cat([state.kernel.get_params().to(state.x.dtype).to(state.x.device),
                      torch.as_tensor(state.noise, dtype=state.x.dtype,
                                      device=state.x.device)[None]])


def initial_theta(state: GPState) -> torch.Tensor:
    """The state's hyperparameters as log magnitudes (the start of a fit
    or a chain)."""
    return torch.log(torch.abs(_raw_params(state)) + 1e-12)


def initial_signs(state: GPState) -> torch.Tensor:
    """The sign vector matching :func:`initial_theta` (zero -> +1)."""
    return torch.where(_raw_params(state) < 0, -1.0, 1.0).to(state.x.dtype)
