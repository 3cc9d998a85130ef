"""Hyperparameter fitting: multiplicative-ADAM ascent on the marginal
log-likelihood gradient (exact path).

Counterpart of ``friedrich_tpu/models/optimizer.py`` and of the reference
optimizer (``gaussian_process/optimizer.rs``), with its exact update rules:

- ADAM constants beta1=0.9, beta2=0.999, eps=1e-8, lr=0.1
  (``optimizer.rs:79-82``);
- **multiplicative** update ``param *= 1 + delta`` (``optimizer.rs:121``);
- convergence when every ``|delta| <= convergence_fraction``
  (``optimizer.rs:120,138``) plus a wall-clock cutoff;
- zero parameters replaced by 1e-8 at start (``optimizer.rs:88-97``);
- generic path fits the noise in log-space (``optimizer.rs:98,108-110``);
- scaled path (``is_scalable`` kernels): closed-form
  ``scale = r^T K^-1 r / n`` (``optimizer.rs:174``), data-fit term divided
  by the scale (``optimizer.rs:180-186``), then ``kernel.rescale(scale)``
  and ``noise *= scale`` (NOT sqrt(scale) — ``optimizer.rs:262-263``);
- the full covariance Cholesky is rebuilt EVERY iteration
  (``optimizer.rs:133-136, 267-270``), and the converging iteration's
  update is applied before the loop stops (``optimizer.rs:256-270``).

The reference's explicit inverse (``optimizer.rs:32,169``) is a padded
``cho_solve`` against the identity; the dead-block identity contributes
``cap - n`` to ``trace(K^-1)``, which is subtracted where it matters.
The fit functions return ``(state, iterations)``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from ..config import (
    DEFAULT_CONVERGENCE_FRACTION,
    DEFAULT_MAX_ITER,
    DEFAULT_MAX_TIME,
)
from ..ops.cholesky import cho_solve
from ..ops.covariance import gradient_covariances_padded
from ..utils.errors import CholeskyError
from .gp import GPState, log_marginal_likelihood, make_state, rebuild_cholesky, resolve_backend

BETA1 = 0.9
BETA2 = 0.999
ADAM_EPS = 1e-8
LEARNING_RATE = 0.1


@dataclasses.dataclass(frozen=True)
class AdamState:
    params: torch.Tensor  # parameter vector being optimized
    m: torch.Tensor  # first-moment accumulator
    v: torch.Tensor  # second-moment accumulator


def _adam_delta(adam: AdamState, grads: torch.Tensor, i: int) -> tuple[AdamState, torch.Tensor]:
    """One ADAM update; returns new accumulators and the multiplicative
    deltas (``optimizer.rs:113-122``)."""
    m = BETA1 * adam.m + (1.0 - BETA1) * grads
    v = BETA2 * adam.v + (1.0 - BETA2) * grads * grads
    i_f = torch.tensor(float(i), dtype=grads.dtype, device=grads.device)
    mb = m / (1.0 - BETA1**i_f)
    vb = v / (1.0 - BETA2**i_f)
    delta = LEARNING_RATE * mb / (torch.sqrt(vb) + ADAM_EPS)
    return AdamState(params=adam.params * (1.0 + delta), m=m, v=v), delta


def _inverse_and_alpha(state: GPState) -> tuple[torch.Tensor, torch.Tensor]:
    """K^-1 (padded: identity in the dead block) and alpha = K^-1 r."""
    # a bf16-stored factor solves in the residuals' (compute) dtype
    l_mat = state.l.to(state.resid.dtype)
    eye = torch.eye(state.capacity, dtype=l_mat.dtype, device=l_mat.device)
    return cho_solve(l_mat, eye), cho_solve(l_mat, state.resid)


def _per_param_grads(state: GPState, cov_inv: torch.Tensor,
                     alpha: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """data-fit and complexity terms per kernel parameter
    (``optimizer.rs:36-50``): ``alpha^T dK alpha`` and ``tr(K^-1 dK)``."""
    dks = gradient_covariances_padded(state.kernel, state.x, state.n, method=state.method)
    dk_alpha = torch.einsum("pij,j->pi", dks, alpha)
    data_fit = torch.einsum("pi,i->p", dk_alpha, alpha)
    complexity = torch.einsum("ij,pij->p", cov_inv, dks)
    return data_fit, complexity


def _generic_step(state: GPState, adam: AdamState, i: int, convergence_fraction: float):
    """One iteration of the non-scalable fit (``optimize_parameters``,
    ``optimizer.rs:69-149``). Parameter vector = kernel params + ln(noise).

    Returns ``(state, adam, progress, ok, info)``; ``info`` carries the
    step's ``max_delta`` (and a unit ``scale``) for the fit log."""
    cov_inv, alpha = _inverse_and_alpha(state)
    data_fit, complexity = _per_param_grads(state, cov_inv, alpha)
    grads_kernel = (data_fit - complexity) / 2.0

    # noise gradient (``optimizer.rs:52-57``): gradient(K, noise) =
    # 2 noise I; the padded identity block inflates trace(K^-1) by
    # (cap - n) — subtract.
    noise_data_fit = torch.dot(alpha, alpha)
    noise_complexity = torch.trace(cov_inv) - (state.capacity - state.n)
    noise_grad = state.noise * (noise_data_fit - noise_complexity)
    # log-space correction (``optimizer.rs:105-110``)
    noise_grad = noise_grad * state.noise

    grads = torch.cat([grads_kernel, noise_grad[None]])
    adam, delta = _adam_delta(adam, grads, i)
    max_delta = torch.max(torch.abs(delta))
    progress = max_delta > convergence_fraction

    kernel = state.kernel.with_params(adam.params[:-1])
    state = state.replace(kernel=kernel, noise=torch.exp(adam.params[-1]))
    state, ok = rebuild_cholesky(state)
    return state, adam, progress, ok, {"max_delta": max_delta, "scale": torch.ones_like(max_delta)}


def _scaled_step(state: GPState, adam: AdamState, i: int, convergence_fraction: float):
    """One iteration of the scaled fit (``scaled_optimize_parameters``,
    ``optimizer.rs:211-283``). Parameter vector = kernel params only.

    Returns ``(state, adam, progress, ok, info)``; ``info`` carries the
    closed-form ``scale`` (``optimizer.rs:174``) and ``max_delta``."""
    cov_inv, alpha = _inverse_and_alpha(state)
    scale = torch.dot(state.resid, alpha) / state.n
    data_fit, complexity = _per_param_grads(state, cov_inv, alpha)
    grads = (data_fit / scale - complexity) / 2.0  # optimizer.rs:180-192

    adam, delta = _adam_delta(adam, grads, i)
    max_delta = torch.max(torch.abs(delta))
    progress = max_delta > convergence_fraction

    kernel = state.kernel.with_params(adam.params)
    kernel = kernel.rescale(scale)  # optimizer.rs:262
    noise = state.noise * scale  # optimizer.rs:263 (noise *= scale, not sqrt)
    # read parameters back post-rescale (optimizer.rs:264)
    adam = dataclasses.replace(adam, params=kernel.get_params())
    state, ok = rebuild_cholesky(state.replace(kernel=kernel, noise=noise))
    return state, adam, progress, ok, {"max_delta": max_delta, "scale": scale}


def _init_params(vec: torch.Tensor) -> torch.Tensor:
    """Replace exact zeros with 1e-8 so the multiplicative update can move
    them (``optimizer.rs:88-97``)."""
    return torch.where(vec == 0.0, ADAM_EPS, vec)


#: ``gradient="auto"`` switches from the exact dense gradient terms to the
#: streamed Hutchinson fit (``models/large_fit.py``) above this capacity.
#: The JAX package's value, kept for parity: it was chosen on a TPU and is
#: still to be decided on the H100 (ROADMAP).
LARGE_FIT_THRESHOLD = 8192

#: ``subsample="auto"`` policy boundary (see :func:`auto_subsample`).
AUTO_SUBSAMPLE_THRESHOLD = 3 * LARGE_FIT_THRESHOLD  # 24576


def auto_subsample(n: int) -> Optional[int]:
    """Default subsample-size policy for ``subsample="auto"``: ``None``
    (full fit) below :data:`AUTO_SUBSAMPLE_THRESHOLD`, else
    ``max(LARGE_FIT_THRESHOLD, n // 5)``."""
    if n < AUTO_SUBSAMPLE_THRESHOLD:
        return None
    return max(LARGE_FIT_THRESHOLD, n // 5)


def fit_kernel_noise(
    state: GPState,
    max_iter: int = DEFAULT_MAX_ITER,
    convergence_fraction: float = DEFAULT_CONVERGENCE_FRACTION,
    max_time: float = DEFAULT_MAX_TIME,
    fit_log=None,
    gradient: str = "auto",
    num_probes: int = 8,
    seed: int = 0,
) -> tuple[GPState, int]:
    """Run the ADAM fit until convergence / max_iter / max_time; returns
    the fitted state and the number of iterations run. Pass a
    :class:`~friedrich_tpu_torch.utils.fitlog.FitLog` as ``fit_log`` for a
    record per iteration (its likelihood is the exact LML of the rebuilt
    factor, one more solve per iteration).

    Dispatches on ``kernel.is_scalable`` exactly like ``fit_parameters``
    (``mod.rs:434-444``). ``gradient``: ``"exact"`` (the reference's dense
    gradient terms), ``"hutchinson"`` (streamed factor-based terms sized
    for large n, ``models/large_fit.py``) or ``"auto"`` (exact up to
    capacity :data:`LARGE_FIT_THRESHOLD`, Hutchinson above it).
    ``num_probes`` and ``seed`` configure the Hutchinson trace estimator.
    """
    if gradient not in ("auto", "exact", "hutchinson"):
        raise ValueError(f"unknown gradient method {gradient!r}")
    if gradient == "auto":
        gradient = "hutchinson" if state.capacity > LARGE_FIT_THRESHOLD else "exact"
    if gradient == "hutchinson":
        from .large_fit import fit_kernel_noise_large

        return fit_kernel_noise_large(state, max_iter, convergence_fraction, max_time,
                                      num_probes=num_probes, seed=seed, fit_log=fit_log)
    scalable = state.kernel.is_scalable
    kparams = _init_params(state.kernel.get_params())
    if scalable:
        params = kparams
        step = _scaled_step
    else:
        params = torch.cat([kparams, torch.log(state.noise)[None]])
        step = _generic_step
    adam = AdamState(params=params, m=torch.zeros_like(params), v=torch.zeros_like(params))

    t0 = time.monotonic()
    i = 0
    for i in range(1, max_iter + 1):
        state, adam, progress, ok, info = step(state, adam, i, convergence_fraction)
        if not bool(ok):
            raise CholeskyError(
                "Cholesky decomposition failed during hyperparameter fitting; "
                "consider setting `cholesky_epsilon`."
            )
        if fit_log is not None:
            log_iteration(fit_log, i, state, adam, info, scalable)
        if (not bool(progress)) or (time.monotonic() - t0 > max_time):
            break
    return state, i


def log_iteration(fit_log, i: int, state: GPState, adam: AdamState, info: dict,
                  scalable: bool) -> None:
    """One :class:`~friedrich_tpu_torch.utils.fitlog.FitRecord` for
    iteration ``i``: the ADAM parameters, the noise, the scale (scaled path
    only), the largest multiplicative step and the exact LML of ``state``'s
    factor."""
    fit_log.log(
        iteration=i,
        params=[float(v) for v in adam.params],
        noise=float(state.noise),
        scale=float(info["scale"]) if scalable else None,
        max_delta=float(info["max_delta"]),
        likelihood=float(log_marginal_likelihood(state)),
    )


def fit_prior_padded(state: GPState) -> GPState:
    """Refit the prior on the original outputs and re-residualize
    (``fit_parameters``, ``mod.rs:414-421``)."""
    live = torch.arange(state.capacity, device=state.x.device) < state.n
    y_pad = state.resid + torch.where(live, state.prior.mean(state.x), 0.0)
    prior = state.prior.fit_padded(state.x, y_pad, live)
    resid = torch.where(live, y_pad - prior.mean(state.x), 0.0)
    return state.replace(prior=prior, resid=resid)


def subset_indices(n: int, size: int, seed: int, device) -> torch.Tensor:
    """Sorted indices of a fixed-seed random subset of ``range(n)``."""
    gen = torch.Generator().manual_seed(seed)
    idx = torch.randperm(n, generator=gen)[:size]
    return torch.sort(idx).values.to(device)


def fit_subsampled(
    state: GPState,
    subsample: int,
    max_iter: int = DEFAULT_MAX_ITER,
    convergence_fraction: float = DEFAULT_CONVERGENCE_FRACTION,
    max_time: float = DEFAULT_MAX_TIME,
    fit_log=None,
    gradient: str = "auto",
    num_probes: int = 8,
    seed: int = 0,
) -> tuple[GPState, int]:
    """Fit kernel/noise on a RANDOM SUBSET, then one full-n rebuild.

    The hyperparameters are low-dimensional, but the reference fit pays a
    full O(n^3) factorization per ADAM iteration (``optimizer.rs:267-270``);
    fitting on ``subsample`` points costs O(s^3) per iteration and the full
    model pays exactly ONE final factorization. The subset is drawn with a
    fixed seed (deterministic; not the JAX package's subset)."""
    n = state.n
    s = min(subsample, n)
    if s <= 0:
        raise ValueError(f"subsample must be positive, got {subsample}")
    if s >= n:
        return fit_kernel_noise(state, max_iter, convergence_fraction, max_time, fit_log=fit_log,
                                gradient=gradient, num_probes=num_probes, seed=seed)
    idx = subset_indices(n, s, seed, state.x.device)
    x_sub = state.x[idx]
    # the sub-model stores its factor in the compute dtype and takes the
    # factor precision where "auto" streams it (``models/builder.py``)
    streamed = resolve_backend("auto", s, state.x.dtype, state.x.device) == "streamed"
    sub_state, ok = make_state(
        state.kernel, state.prior, state.noise, x_sub,
        state.resid[idx] + state.prior.mean(x_sub), eps=state.eps,
        method=state.method, backend="auto",
        precision=state.precision if streamed else None,
    )
    if not bool(ok):
        raise CholeskyError()
    sub_state, iterations = fit_kernel_noise(
        sub_state, max_iter, convergence_fraction, max_time, fit_log=fit_log, gradient=gradient,
        num_probes=num_probes, seed=seed,
    )
    # the one full-n rebuild writes into the old factor's buffer
    # (``friedrich_tpu/models/optimizer.py:465``)
    state, ok = rebuild_cholesky(state.replace(kernel=sub_state.kernel, noise=sub_state.noise),
                                 reuse_buffer=True)
    if not bool(ok):
        raise CholeskyError()
    return state, iterations


def fit_parameters(
    state: GPState,
    fit_prior: bool = True,
    fit_kernel: bool = True,
    max_iter: int = DEFAULT_MAX_ITER,
    convergence_fraction: float = DEFAULT_CONVERGENCE_FRACTION,
    max_time: float = DEFAULT_MAX_TIME,
    fit_log=None,
    gradient: str = "auto",
    num_probes: int = 8,
    seed: int = 0,
    subsample: Optional[int] = None,
) -> tuple[GPState, int]:
    """Full fit dispatch, mirroring ``fit_parameters`` (``mod.rs:406-445``):
    optionally refit the prior (rebuilding the factor if the kernel is not
    also being fitted), then run the gradient fit, on a random subset when
    ``subsample`` is given (``"auto"``: :func:`auto_subsample`); ``fit_log``
    records each iteration. Returns the state and the number of ADAM
    iterations run."""
    if subsample == "auto":
        subsample = auto_subsample(state.n)
    iterations = 0
    if fit_prior:
        state = fit_prior_padded(state)
        if not fit_kernel:
            # the old factor's buffer takes the new factor, so the two never
            # coexist; on a failed rebuild the old state is lost, as in the
            # JAX package (``friedrich_tpu/models/optimizer.py:495-505``)
            state, ok = rebuild_cholesky(state, reuse_buffer=True)
            if not bool(ok):
                raise CholeskyError()
    if fit_kernel:
        if subsample is not None:
            state, iterations = fit_subsampled(
                state, subsample, max_iter, convergence_fraction, max_time, fit_log=fit_log,
                gradient=gradient, num_probes=num_probes, seed=seed,
            )
        else:
            state, iterations = fit_kernel_noise(
                state, max_iter, convergence_fraction, max_time, fit_log=fit_log,
                gradient=gradient, num_probes=num_probes, seed=seed,
            )
    return state, iterations
