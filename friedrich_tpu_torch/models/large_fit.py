"""Single-device large-n hyperparameter fit.

Counterpart of ``friedrich_tpu/models/large_fit.py``. The exact fit of
``models/optimizer.py`` replicates the reference optimizer
(``gaussian_process/optimizer.rs``), including its explicit inverse and the
(p, cap, cap) gradient-matrix stack (``optimizer.rs:32,169``;
``algebra/mod.rs:129-155``): at capacity 100,512 in float32 the inverse
alone is a second 40 GB matrix. This module is the same multiplicative
ADAM fit with the two dense quantities replaced by factor-based solves,
sized to run wherever the factor itself fits:

    alpha           = K^-1 r            (triangular solves on L)
    data-fit terms  = alpha^T dK alpha  (streamed dK matvec — exact)
    tr(K^-1 dK_p)  ~= mean_z (K^-1 z)^T (dK_p z)   (Hutchinson)
    tr(K^-1)       ~= mean_z z^T (K^-1 z)          (generic path only)

with fixed Rademacher probes (a deterministic fit).

Each iteration is one gradient step from the current factor and one
rebuild. The convergence test runs BEFORE the update is applied: when
every ``|delta| <= convergence_fraction`` the fit stops WITHOUT the final
apply and rebuild, saving one factorization against the reference, which
applies the final sub-threshold update and rebuilds before noticing it
converged (``optimizer.rs:256-270``). This deviation is the JAX package's;
the exact loop of ``models/optimizer.py`` keeps the reference order. The
rebuild writes into the old factor's buffer (``rebuild_cholesky(
reuse_buffer=True)``), so old and new factor never coexist.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from .. import config
from ..ops.streamed_matvec import rademacher_probes, streamed_grad_matvec
from ..utils.errors import CholeskyError, ConfigError
from ..utils.profiling import scope
from .gp import GPState, _cho_solve, rebuild_cholesky, resolve_backend
from .optimizer import AdamState, _adam_delta, _init_params, log_iteration


def make_probes(state: GPState, num_probes: int, seed: int) -> torch.Tensor:
    """The fit's fixed-seed Rademacher probes (cap, num_probes), zero on
    dead rows (``ops/streamed_matvec.rademacher_probes``)."""
    return rademacher_probes(state.capacity, state.n, num_probes, seed, state.resid.dtype,
                             state.resid.device)


def _grad_step_large(state: GPState, adam: AdamState, probes: torch.Tensor, i: int,
                     convergence_fraction: float, scalable: bool):
    """Gradient terms and ADAM deltas from the CURRENT factor, no rebuild.

    Returns ``(adam', kernel', noise', progress, info)`` where the primed
    values already include this iteration's multiplicative update
    (``optimizer.rs:113-122``) and, on the scaled path, the closed-form
    rescale (``optimizer.rs:174,262-263``); ``progress`` is a bool and
    ``info`` carries ``max_delta`` and ``scale`` for the fit log."""
    with scope("fit_large/solves"):
        # a bf16-stored factor goes through the panel sweeps (``models/gp._cho_solve``)
        sol = _cho_solve(state, torch.cat([state.resid[:, None], probes], dim=1))
        alpha, kinv_z = sol[:, 0], sol[:, 1:]
    with scope("fit_large/grad_matvec"):
        dk_v = streamed_grad_matvec(
            state.kernel, state.x, state.n, torch.cat([alpha[:, None], probes], dim=1),
            method=state.method,
        )  # (p, cap, 1 + s)
        data_fit = dk_v[:, :, 0] @ alpha  # alpha^T dK_p alpha — exact
        complexity = torch.mean(torch.einsum("is,pis->ps", kinv_z, dk_v[:, :, 1:]), dim=1)
    with scope("fit_large/adam"):
        if scalable:
            scale = torch.dot(state.resid, alpha) / state.n
            grads = (data_fit / scale - complexity) / 2.0  # optimizer.rs:180-192
            adam, delta = _adam_delta(adam, grads, i)
            kernel = state.kernel.with_params(adam.params).rescale(scale)  # optimizer.rs:262
            noise = state.noise * scale  # optimizer.rs:263 (NOT sqrt)
            adam = dataclasses.replace(adam, params=kernel.get_params())
        else:
            scale = torch.ones((), dtype=alpha.dtype, device=alpha.device)
            grads_kernel = (data_fit - complexity) / 2.0
            # Hutchinson tr(K^-1) over the live block (probes are zero on dead
            # rows); log-space noise update (optimizer.rs:98-110)
            tr_kinv = torch.mean(torch.einsum("is,is->s", probes, kinv_z))
            noise_grad = state.noise * (torch.dot(alpha, alpha) - tr_kinv) * state.noise
            adam, delta = _adam_delta(adam, torch.cat([grads_kernel, noise_grad[None]]), i)
            kernel = state.kernel.with_params(adam.params[:-1])
            noise = torch.exp(adam.params[-1])
    max_delta = torch.max(torch.abs(delta))
    return adam, kernel, noise, bool(max_delta > convergence_fraction), {"max_delta": max_delta,
                                                                          "scale": scale}


def check_fit_memory(state: GPState) -> None:
    """Raise :class:`ConfigError` when a rebuild cannot run on the card:
    every backend but the streamed one holds the old and the new factor (or
    K and L) at once, and two factors of this capacity do not fit
    (``config.two_matrices_fit``). The JAX package's rule
    (``friedrich_tpu/models/large_fit.py:340-362``) with the port's memory
    test, so that the fit fails with the remedy rather than a device OOM."""
    resolved = resolve_backend(state.backend, state.capacity, state.l.dtype, state.l.device)
    itemsize = state.l.element_size()
    if resolved != "streamed" and not config.two_matrices_fit(state.capacity, itemsize,
                                                                state.l.device):
        factor_gb = state.capacity**2 * itemsize / 2**30
        raise ConfigError(
            f"hyperparameter fitting at capacity {state.capacity} needs the 'streamed' "
            f"backend (two {factor_gb:.1f} GB factors cannot coexist in device memory; "
            f"streamed rebuilds reuse the factor's buffer). Use set_backend('streamed') "
            f"or 'auto'."
        )


def fit_kernel_noise_large(
    state: GPState,
    max_iter: int,
    convergence_fraction: float,
    max_time: float,
    num_probes: int = 8,
    seed: int = 0,
    probes: Optional[torch.Tensor] = None,
    fit_log=None,
) -> tuple[GPState, int]:
    """Run the large-n ADAM fit until convergence / max_iter / max_time;
    returns the fitted state and the number of gradient steps taken.

    Dispatches on ``kernel.is_scalable`` like ``fit_parameters``
    (``mod.rs:434-444``). ``probes`` (cap, s) replaces the
    :func:`make_probes` draw of ``num_probes`` and ``seed``; ``fit_log``
    records each applied iteration (a converging step is not applied). Each
    step is a ``fit_large/iteration`` scope, its ``applied`` attribute false
    for the converging step, around ``fit_large/solves``, ``/grad_matvec``,
    ``/adam`` and ``/rebuild``. The input state's factor buffer is
    overwritten by the first rebuild, so use the returned state only; a
    failed rebuild raises :class:`CholeskyError`
    and the state cannot be recovered (the reference panics here,
    ``algebra/mod.rs:90``).
    """
    check_fit_memory(state)
    scalable = state.kernel.is_scalable
    kparams = _init_params(state.kernel.get_params())
    params = kparams if scalable else torch.cat([kparams, torch.log(state.noise)[None]])
    adam = AdamState(params=params, m=torch.zeros_like(params), v=torch.zeros_like(params))
    if probes is None:
        probes = make_probes(state, num_probes, seed)
    probes = probes.to(state.resid.dtype).to(state.resid.device)

    t0 = time.monotonic()
    i = 0
    for i in range(1, max_iter + 1):
        with scope("fit_large/iteration", applied=True) as span:
            adam, kernel, noise, progress, info = _grad_step_large(
                state, adam, probes, i, convergence_fraction, scalable
            )
            if not progress:
                # converged: stop WITHOUT applying the sub-threshold update
                # (see the module docstring)
                if span is not None:
                    span.attrs["applied"] = False
                break
            with scope("fit_large/rebuild"):
                state, ok = rebuild_cholesky(state.replace(kernel=kernel, noise=noise),
                                             reuse_buffer=True)
            ok = bool(ok)
        if not ok:
            raise CholeskyError(
                "Cholesky decomposition failed during hyperparameter fitting; "
                "consider setting `cholesky_epsilon`."
            )
        if fit_log is not None:
            log_iteration(fit_log, i, state, adam, info, scalable)
        if time.monotonic() - t0 > max_time:
            break
    return state, i
