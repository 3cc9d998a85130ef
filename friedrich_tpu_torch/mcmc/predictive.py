"""Fully-Bayesian prediction: the GP predictive averaged over
hyperparameter draws.

Counterpart of ``friedrich_tpu/mcmc/predictive.py``. Instead of one fitted
(kernel, noise), the predictive is averaged over MCMC draws
``theta_s ~ p(theta | data)``:

    p(y* | x*, D) ~= 1/S sum_s N(m_s(x*), v_s(x*))

with mixture moments ``mean = E_s[m_s]`` and ``var = E_s[v_s + m_s^2] -
mean^2``. Each draw rebuilds the training covariance at its
hyperparameters (the covariance-tile kernel in train mode on the card),
factors it, builds the cross covariance (the kernel in cross mode) and
solves. At most ``chunk_size`` draws are rebuilt at once, as the JAX
package's ``jax.lax.map(batch_size=...)`` does, so that peak memory is
``chunk_size`` (cap, cap) factors whatever the number of draws. The
parameters are rebuilt with the sampling target's fixed signs, and a draw
whose factorization fails is dropped from the mixture, or replaced by the
posterior mean in :func:`sample_predictive`.
"""

from __future__ import annotations

import torch

from ..models.gp import GPState
from ..ops.cholesky import cho_solve, cholesky, solve_lower, solve_lower_t
from ..ops.covariance import (
    cross_covariance,
    cross_covariance_train_padded,
    kernel_diag,
    train_covariance_padded,
)
from ._adapt import as_generator
from .logprob import initial_signs


def _rebuild(state: GPState, thetas: torch.Tensor, signs: torch.Tensor):
    """The kernels, stacked factors and ok flags at a chunk of draws
    (signed log-magnitudes; ``friedrich_tpu/mcmc/predictive.py:37-47``)."""
    nb = state.kernel.nb_params
    kernels, k_pads = [], []
    for theta in thetas:
        raw = signs * torch.exp(theta)
        kernel = state.kernel.with_params(raw[:nb])
        kernels.append(kernel)
        k_pads.append(train_covariance_padded(kernel, state.x, state.n, torch.abs(raw[nb]),
                                              method=state.method))
    l_pads, oks = cholesky(torch.stack(k_pads))
    return kernels, l_pads, oks


def _flat(state: GPState, theta_samples) -> torch.Tensor:
    theta_samples = torch.as_tensor(theta_samples, dtype=state.x.dtype, device=state.x.device)
    return theta_samples.reshape(-1, theta_samples.shape[-1])


def _thin_indices(s: int, take: int) -> list[int]:
    """``take`` indices spread evenly over ``s`` draws, first and last
    included: ``floor(i (s - 1) / (take - 1))``, in integers."""
    return [0] if take == 1 else [i * (s - 1) // (take - 1) for i in range(take)]


def predictive_mixture(
    state: GPState,
    theta_samples,
    xq,
    max_draws: int = 64,
    chunk_size: int = 4,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean, variance) of the hyperparameter-marginalized predictive.

    ``theta_samples``: draws of log-magnitude hyperparameters as returned
    by ``sample_hyperparameters``, any shape (..., dim); flattened and
    thinned evenly to at most ``max_draws`` (:func:`_thin_indices`).
    Draws whose factorization fails are dropped from the average.
    """
    xq = torch.as_tensor(xq, dtype=state.x.dtype, device=state.x.device)
    flat = _flat(state, theta_samples)
    indices = _thin_indices(flat.shape[0], min(max_draws, flat.shape[0]))
    thetas = flat[torch.as_tensor(indices, device=flat.device)]
    signs = initial_signs(state)
    prior_mean = state.prior.mean(xq)
    means, variances, oks = [], [], []
    for c0 in range(0, thetas.shape[0], chunk_size):
        kernels, l_pads, ok = _rebuild(state, thetas[c0:c0 + chunk_size], signs)
        for kernel, l_pad, ok_d in zip(kernels, l_pads, ok):
            c = cross_covariance_train_padded(kernel, state.x, state.n, xq, method=state.method)
            kl = solve_lower(l_pad, c)
            mean = prior_mean + solve_lower_t(l_pad, kl).mT @ state.resid
            var = kernel_diag(kernel, xq) - torch.sum(kl * kl, dim=0)
            ok_d = ok_d & torch.all(torch.isfinite(mean)) & torch.all(torch.isfinite(var))
            means.append(torch.where(ok_d, mean, 0.0))
            variances.append(torch.where(ok_d, var, 0.0))
            oks.append(ok_d)
        del l_pads
    means, variances = torch.stack(means), torch.stack(variances)
    weight = torch.stack(oks).to(means.dtype)
    total = torch.clamp(torch.sum(weight), min=1.0)
    mix_mean = torch.einsum("s,sm->m", weight, means) / total
    second = torch.einsum("s,sm->m", weight, variances + means**2) / total
    return mix_mean, second - mix_mean**2


def sample_predictive(
    state: GPState,
    theta_samples,
    xq,
    generator=None,
    num_draws: int = 32,
    chunk_size: int = 4,
    indices=None,
    z=None,
) -> torch.Tensor:
    """Draws from the marginalized predictive, shape (num_draws, m): a
    random theta per draw, then a sample of that posterior GP at ``xq``. A
    draw whose factorization fails falls back to its posterior mean (0
    where that is not finite).

    ``generator`` (a CPU ``torch.Generator`` or an int seed) draws the
    theta indices and the standard normals; ``indices`` (num_draws,) into
    the flattened draws and ``z`` (num_draws, m) replace them. At most
    ``chunk_size`` covariance rebuilds are held at once.
    """
    xq = torch.as_tensor(xq, dtype=state.x.dtype, device=state.x.device)
    flat = _flat(state, theta_samples)
    if indices is None or z is None:
        if generator is None:
            raise ValueError("sample_predictive needs a generator unless indices= and z= are given")
        gen = as_generator(generator)
        drawn_idx = torch.randint(0, flat.shape[0], (num_draws,), generator=gen)
        drawn_z = torch.randn((num_draws, xq.shape[0]), generator=gen, dtype=torch.float64)
        indices = drawn_idx if indices is None else indices
        z = drawn_z if z is None else z
    thetas = flat[torch.as_tensor(indices, device=flat.device)]
    z = torch.as_tensor(z, dtype=state.x.dtype, device=state.x.device)
    signs = initial_signs(state)
    prior_mean = state.prior.mean(xq)
    eye = 1e-10 * torch.eye(xq.shape[0], dtype=xq.dtype, device=xq.device)
    out = []
    for c0 in range(0, thetas.shape[0], chunk_size):
        kernels, l_pads, ok = _rebuild(state, thetas[c0:c0 + chunk_size], signs)
        for kernel, l_pad, ok_d, z_d in zip(kernels, l_pads, ok, z[c0:c0 + chunk_size]):
            c = cross_covariance_train_padded(kernel, state.x, state.n, xq, method=state.method)
            w = cho_solve(l_pad, c)
            cov = cross_covariance(kernel, xq, xq, method=state.method) - c.mT @ w
            mean = prior_mean + w.mT @ state.resid
            # jitter for the numerical PSD-ness of the posterior covariance
            l_cov, _ = cholesky(cov + eye)
            draw = mean + l_cov @ z_d
            ok_d = ok_d & torch.all(torch.isfinite(draw))
            out.append(torch.where(ok_d, draw, torch.where(torch.isfinite(mean), mean, 0.0)))
        del l_pads
    return torch.stack(out)
