"""Exact-likelihood MAP/MLE hyperparameter fit (corrected variant).

Counterpart of ``friedrich_tpu/models/map_fit.py``. The replicated
reference optimizer (``models/optimizer.py``) uses the reference's
hand-derived per-kernel gradient formulas and its multiplicative ADAM
rules. This module maximizes the EXACT log marginal likelihood (plus a
log-hyperprior: MAP) of ``mcmc/logprob.py``, with standard additive Adam
(``torch.optim.Adam``; its defaults beta = (0.9, 0.999) and eps = 1e-8 are
``optax.adam``'s) in log-magnitude space. Parameter SIGNS are held fixed at
their starting values.

:func:`polish_map` is the short corrective pass the builder runs after a
sub-fit (``set_fit_polish``): the multiplicative rule's convergence test
(every ``|delta| <= convergence_fraction``, ``optimizer.rs:120-121``) can
stop while the exact gradient is not small, and a few exact-LML Adam steps
walk out of that point; at a true optimum they do nothing.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from .. import config
from ..mcmc.logprob import initial_signs, initial_theta, make_hyperparam_logprob
from ..utils.errors import CholeskyError, ConfigError
from .gp import GPState, rebuild_cholesky


def check_density_memory(state: GPState) -> None:
    """Raise :class:`ConfigError` when the density cannot run on the card:
    each evaluation factors a new (cap, cap) matrix in the compute dtype
    beside the model's own factor (bfloat16 under bf16 storage), and the two
    do not fit (``config.two_matrices_fit``) — the fit would end in a device
    OOM."""
    # mean entry size of the model's factor and the density's
    itemsize = (state.l.element_size() + state.x.element_size()) / 2
    if not config.two_matrices_fit(state.capacity, itemsize, state.l.device):
        new_gb = state.capacity**2 * state.x.element_size() / 2**30
        model_gb = state.capacity**2 * state.l.element_size() / 2**30
        raise ConfigError(
            f"the exact-LML fit at capacity {state.capacity} factors a new covariance beside "
            f"the model's factor, and two {new_gb:.1f} GB and {model_gb:.1f} GB factors cannot "
            f"coexist in device memory. Use fit_parameters() (its streamed rebuilds reuse the "
            f"factor's buffer), or fit a subsample."
        )


def _run_adam_on_exact_lml(
    state: GPState,
    num_steps: int,
    learning_rate: float,
    prior_sigma: Optional[float],
    tol: float,
    precision: Optional[str],
    num_probes: int,
    max_time: float,
    probes: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, int]:
    """Adam on the exact-LML density from the state's hyperparameters;
    returns the final theta (log magnitudes) and the steps taken."""
    check_density_memory(state)
    logp = make_hyperparam_logprob(
        state,
        prior_sigma=prior_sigma if prior_sigma is not None else 1e6,
        signs=initial_signs(state),
        precision=precision,
        num_probes=num_probes,
        probes=probes,
    )
    theta = initial_theta(state).clone().requires_grad_(True)
    opt = torch.optim.Adam([theta], lr=learning_rate)
    t0 = time.monotonic()
    prev = float("inf")
    step = 0
    for step in range(1, num_steps + 1):
        opt.zero_grad()
        loss = -logp(theta)
        loss.backward()
        # at a numerically non-PSD point the density is -inf and the
        # gradient non-finite: freeze rather than poison the iterate
        theta.grad = torch.where(torch.isfinite(theta.grad), theta.grad, 0.0)
        opt.step()
        loss = float(loss.detach())
        if abs(prev - loss) < tol:
            break
        prev = loss
        if time.monotonic() - t0 > max_time:
            break
    return theta.detach(), step


def _apply_theta(state: GPState, theta: torch.Tensor) -> GPState:
    nb = state.kernel.nb_params
    raw = initial_signs(state) * torch.exp(theta)
    state = state.replace(kernel=state.kernel.with_params(raw[:nb]), noise=torch.abs(raw[nb]))
    state, ok = rebuild_cholesky(state)
    if not bool(ok):
        raise CholeskyError(
            "MAP fit ended at hyperparameters whose covariance is not PSD; "
            "consider `cholesky_epsilon` or a hyperprior (prior_sigma)."
        )
    return state


def fit_map(
    state: GPState,
    num_steps: int = 200,
    learning_rate: float = 0.05,
    prior_sigma: Optional[float] = None,
    tol: float = 1e-6,
    precision: Optional[str] = None,
    num_probes: int = 16,
    max_time: float = 3600.0,
    probes: Optional[torch.Tensor] = None,
) -> GPState:
    """Fit kernel parameters and noise by maximizing the exact LML (or the
    MAP objective when ``prior_sigma`` is set); returns the refitted state.

    ``precision``: float32 matmul precision of the density.
    ``num_probes`` (or ``probes``) configures the streamed density's
    Hutchinson trace gradient; ``max_time`` bounds wall-clock like the
    reference optimizer's cutoff.
    """
    theta, _ = _run_adam_on_exact_lml(state, num_steps, learning_rate, prior_sigma, tol,
                                      precision, num_probes, max_time, probes)
    return _apply_theta(state, theta)


def polish_map(
    state: GPState,
    num_steps: int = 40,
    learning_rate: float = 0.05,
    tol: float = 1e-4,
    precision: Optional[str] = None,
    num_probes: int = 16,
    max_time: float = 3600.0,
    probes: Optional[torch.Tensor] = None,
) -> GPState:
    """Short exact-LML Adam from the CURRENT hyperparameters (see the
    module docstring): :func:`fit_map`'s mechanics with fewer steps and a
    looser loss-delta tolerance."""
    theta, _ = _run_adam_on_exact_lml(state, num_steps, learning_rate, None, tol, precision,
                                      num_probes, max_time, probes)
    return _apply_theta(state, theta)
