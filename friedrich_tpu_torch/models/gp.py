"""Functional GP core: the model state and its operations.

Counterpart of ``friedrich_tpu/models/gp.py`` (dense, streamed, tiled and
hybrid backends)
and of the reference's ``GaussianProcess`` struct and methods
(``gaussian_process/mod.rs:59-446``). :class:`GPState` is an immutable
dataclass; every operation returns new tensors or a new state.

**Capacity padding.** Training buffers are padded to a capacity (the
analogue of the reference's ``EMatrix``/``EVector`` x1.5 growth,
``extendable_matrix.rs:15-112``), with the identity in the factor's dead
block (see ``ops/covariance.py``), so solves and reductions over the whole
buffer equal the live ones.

State contents mirror the reference struct (``mod.rs:59-79``): prior,
kernel, noise, cholesky_epsilon, training inputs, training outputs
**stored as prior residuals** (``mod.rs:156``), and the Cholesky factor of
the training covariance.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional

import torch

from .. import config
from ..ops.blocked_solve import blocked_cho_solve, blocked_solve_lower, blocked_solve_lower_t
from ..ops.cholesky import cho_solve, cholesky_append_padded, factor, solve_lower, solve_lower_t
from ..ops.covariance import (
    cross_covariance,
    cross_covariance_train_padded,
    kernel_diag,
    train_covariance_padded,
)
from ..ops.hybrid import hybrid_cholesky_factor
from ..ops.streamed import STORAGE_DTYPES, streamed_cholesky_factor
from ..ops.tiled import tiled_cholesky_factor
from ..utils.errors import ConfigError
from ..utils.profiling import scope

LOG_2PI = math.log(2.0 * math.pi)

#: The builder backends (``friedrich_tpu/models/builder.py:130-137``).
BACKENDS = ("dense", "streamed", "tiled", "hybrid", "auto")


@dataclasses.dataclass(frozen=True, eq=False)
class GPState:
    """Immutable GP model state (capacity-padded).

    Reference struct: ``gaussian_process/mod.rs:59-79``.
    """

    x: torch.Tensor  # (cap, d) padded training inputs
    resid: torch.Tensor  # (cap,) padded prior residuals y - prior(x)
    l: torch.Tensor  # (cap, cap) padded Cholesky factor (identity in dead block)
    n: int  # live row count
    noise: torch.Tensor  # () observation-noise std
    kernel: Any
    prior: Any
    eps: Optional[float] = None
    method: str = "gram"
    # "dense" materializes K, then factors it; "streamed" builds and factors
    # K panel by panel, never holding it; "tiled" builds K into one buffer
    # and factors it in place, right-looking (ops/tiled.py); "hybrid" streams
    # a leading region and factors the rest in place (ops/hybrid.py); "auto"
    # picks dense or streamed per build (resolve_backend)
    backend: str = "dense"
    # streamed-backend panel width or width schedule; None = the default
    # (ops/partition.panel_widths)
    block: Any = None
    # factor storage dtype: None (the input dtype) or "bf16" (a bfloat16
    # factor, float32 compute; streamed backend only)
    storage: Optional[str] = None
    # matmul precision mode of the factorizations (streamed backend): None,
    # "bf16", "f32x3" or "f32" (ops/streamed.streamed_cholesky_factor)
    precision: Optional[str] = None

    @property
    def capacity(self) -> int:
        return self.x.shape[0]

    @property
    def input_dim(self) -> int:
        return self.x.shape[1]

    def replace(self, **changes) -> "GPState":
        return dataclasses.replace(self, **changes)


# ---------------------------------------------------------------------------
# Construction
# ---------------------------------------------------------------------------


def pad_capacity(x: torch.Tensor, y_resid: torch.Tensor, cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Zero-pad live data to a capacity."""
    n, d = x.shape
    x_pad = torch.zeros((cap, d), dtype=x.dtype, device=x.device)
    x_pad[:n] = x
    r_pad = torch.zeros((cap,), dtype=y_resid.dtype, device=y_resid.device)
    r_pad[:n] = y_resid
    return x_pad, r_pad


def check_backend(backend: str, storage: Optional[str] = None) -> None:
    """Raise for an unknown backend or factor storage, or bf16 storage asked
    of a backend that is never streamed."""
    if backend not in BACKENDS:
        raise ConfigError(f"unknown backend {backend!r}")
    if storage not in STORAGE_DTYPES:
        raise ConfigError(f"unknown factor storage {storage!r}")
    if storage is not None and backend not in ("streamed", "auto"):
        raise ConfigError(
            f"factor storage {storage!r} requires the 'streamed' backend (got {backend!r})"
        )


def resolve_backend(backend: str, cap: int, dtype: torch.dtype, device) -> str:
    """The backend a build runs: ``"auto"`` is ``"streamed"`` when the
    dense backend's K and L (2 cap^2 entries) would pass
    ``config.TWO_MATRIX_FRACTION`` of the device's memory
    (``config.two_matrices_fit``: always within it on the CPU), and
    ``"dense"`` otherwise. Replaces the JAX package's TPU-measured threshold
    (``friedrich_tpu/models/gp.py:auto_large_threshold``)."""
    if backend != "auto":
        return backend
    itemsize = torch.finfo(dtype).bits // 8
    return "dense" if config.two_matrices_fit(cap, itemsize, device) else "streamed"


def _build_factor(kernel, x_pad, n, noise, eps, method, backend="dense", block=None, l0=None,
                  storage=None, precision=None):
    """The factor of one build (``friedrich_tpu/models/gp.py:131-186``),
    under the named scope ``gp/build_factor[<backend>]``. The tiled and
    hybrid backends take their default tile and panel widths, as in the JAX
    package; ``block`` and ``l0`` are the streamed backend's."""
    with scope(f"gp/build_factor[{backend}]"):
        resolved = resolve_backend(backend, x_pad.shape[0], x_pad.dtype, x_pad.device)
        if storage is not None and resolved != "streamed":
            raise ConfigError(
                f"factor storage {storage!r} requires the 'streamed' backend (got {resolved!r})"
            )
        if resolved == "streamed":
            return streamed_cholesky_factor(kernel, x_pad, n, noise, eps=eps, block=block,
                                            method=method, storage=storage, precision=precision,
                                            l0=l0)
        if precision is not None and backend != "auto":
            raise ConfigError(
                f"factor precision {precision!r} requires the 'streamed' backend (got {backend!r}); "
                f"other backends run float32 matmuls at full precision"
            )
        if resolved == "tiled":
            return tiled_cholesky_factor(kernel, x_pad, n, noise, eps=eps, method=method)
        if resolved == "hybrid":
            return hybrid_cholesky_factor(kernel, x_pad, n, noise, eps=eps, method=method)
        k_pad = train_covariance_padded(kernel, x_pad, n, noise, method=method)
        return factor(k_pad, eps)


def make_state(
    kernel,
    prior,
    noise,
    x: torch.Tensor,
    y: torch.Tensor,
    eps: Optional[float] = None,
    method: str = "gram",
    cap: Optional[int] = None,
    backend: str = "dense",
    storage: Optional[str] = None,
    block=None,
    precision: Optional[str] = None,
) -> tuple[GPState, torch.Tensor]:
    """Build a trained state from live data (``GaussianProcess::new``,
    ``mod.rs:142-167``): residualize against the prior, build the padded
    covariance, factor it.

    Returns ``(state, ok)``; ``ok`` is False if the factorization produced
    non-finite values (caller raises ``CholeskyError``). ``block`` is the
    streamed backend's panel width or schedule; ``storage`` (None or
    ``"bf16"``) and ``precision`` are the streamed factorization's
    (``ops/streamed.streamed_cholesky_factor``). ``precision`` applies where
    ``backend="auto"`` resolves to the streamed backend and raises for
    ``"dense"``, as in the JAX package.
    """
    check_backend(backend, storage)
    n, _ = x.shape
    cap = cap or n
    if cap < n:
        raise ConfigError(
            f"capacity {cap} is smaller than the number of training "
            f"samples {n}"
        )
    eps = float(eps) if eps is not None else None
    kernel = kernel.to(x.dtype, x.device)
    prior = prior.to(x.dtype, x.device)
    noise = torch.as_tensor(noise, dtype=x.dtype, device=x.device)
    x_pad, r_pad = pad_capacity(x, y - prior.mean(x), cap)
    if isinstance(block, list):
        block = tuple(block)
    l_pad, ok = _build_factor(kernel, x_pad, n, noise, eps, method, backend, block,
                              storage=storage, precision=precision)
    state = GPState(
        x=x_pad, resid=r_pad, l=l_pad, n=n, noise=noise, kernel=kernel,
        prior=prior, eps=eps, method=method, backend=backend, block=block,
        storage=storage, precision=precision,
    )
    return state, ok


def rebuild_cholesky(state: GPState, reuse_buffer: bool = False) -> tuple[GPState, torch.Tensor]:
    """Re-factor the training covariance for the current hyperparameters
    (the per-iteration rebuild at ``optimizer.rs:133-136,267-270``).

    ``reuse_buffer=True`` writes the new factor into the CURRENT factor's
    buffer on the streamed backend (the JAX package's donation,
    ``friedrich_tpu/models/gp.py:345-370``), so old and new factor never
    coexist: at a capacity where two factors do not fit the card, that is
    what lets the rebuild run. ``state`` must not be used afterwards: its
    factor is overwritten, and on a failed rebuild (``ok`` False) it cannot
    be recovered. The other backends build a new factor either way.
    """
    l_pad, ok = _build_factor(
        state.kernel, state.x, state.n, state.noise, state.eps, state.method,
        state.backend, state.block, l0=state.l if reuse_buffer else None,
        storage=state.storage, precision=state.precision,
    )
    return state.replace(l=l_pad), ok


def grow_capacity(state: GPState, new_cap: int, copy_factor: bool = True) -> GPState:
    """Capacity growth: zero-pad data, extend the Cholesky factor with the
    identity. Mirrors ``EMatrix`` x1.5 growth
    (``extendable_matrix.rs:30-49``). ``copy_factor=False`` leaves the
    enlarged factor the bare identity, for a caller that rebuilds it at once
    (the bf16-storage append)."""
    cap = state.capacity
    if new_cap <= cap:
        return state
    x, r = pad_capacity(state.x, state.resid, new_cap)
    l_new = torch.eye(new_cap, dtype=state.l.dtype, device=state.l.device)
    if copy_factor:
        l_new[:cap, :cap] = state.l
    return state.replace(x=x, resid=r, l=l_new)


# ---------------------------------------------------------------------------
# Incremental update (``add_samples``, ``mod.rs:173-190``)
# ---------------------------------------------------------------------------


def add_samples_padded(state: GPState, x_new: torch.Tensor, y_new: torch.Tensor,
                       in_place: bool = False) -> GPState:
    """Append ``k`` samples in O(n^2 k) via the blocked Cholesky append.

    Requires capacity >= n + k (the facade grows first). Matches
    ``add_samples`` (``mod.rs:173-190``): residualize against the CURRENT
    prior, grow buffers, rank-update the factor. ``in_place=True`` writes
    the new rows into ``state.l`` itself (shared by the returned state)
    instead of a copy; :func:`repair_failed_append` undoes it.
    """
    n, k = state.n, x_new.shape[0]
    x_pad = state.x.clone()
    x_pad[n:n + k] = x_new
    r_pad = state.resid.clone()
    r_pad[n:n + k] = y_new - state.prior.mean(x_new)
    l_pad = cholesky_append_padded(
        state.l, state.kernel, x_pad, n, k, state.noise,
        eps=state.eps, method=state.method, in_place=in_place,
    )
    return state.replace(x=x_pad, resid=r_pad, l=l_pad, n=n + k)


def add_samples_rebuild(state: GPState, x_new: torch.Tensor, y_new: torch.Tensor,
                        reuse_buffer: bool = False) -> tuple[GPState, torch.Tensor]:
    """Append samples by a whole refactorization: the bf16-storage append
    (``friedrich_tpu/models/gp.py:425-455``). A rank-k update against the
    bfloat16-rounded factor goes indefinite where the float32 one does not,
    so the data buffers take the new rows and the factor is rebuilt.
    ``reuse_buffer=True`` rebuilds into ``state.l`` (whose factor is then
    lost); ``state``'s other buffers are not changed. Returns ``(state,
    ok)`` like :func:`make_state`."""
    n, k = state.n, x_new.shape[0]
    x_pad = state.x.clone()
    x_pad[n:n + k] = x_new
    r_pad = state.resid.clone()
    r_pad[n:n + k] = y_new - state.prior.mean(x_new)
    return rebuild_cholesky(state.replace(x=x_pad, resid=r_pad, n=n + k),
                            reuse_buffer=reuse_buffer)


def repair_failed_append(l_pad: torch.Tensor, n_old: int, k: int) -> None:
    """Put rows ``[n_old, n_old + k)`` of a factor back to the identity
    padding, in place: the only rows an in-place append writes (the JAX
    package's ``_repair_failed_append``, ``friedrich_tpu/models/api.py:67-83``).
    """
    l_pad[n_old:n_old + k] = 0.0
    idx = torch.arange(n_old, n_old + k, device=l_pad.device)
    l_pad[idx, idx] = 1.0


# ---------------------------------------------------------------------------
# Prediction (``mod.rs:226-350``)
# ---------------------------------------------------------------------------


def _use_blocked(state: GPState) -> bool:
    """A bfloat16 factor is solved by the panel sweeps of
    ``ops/blocked_solve.py``, which cast one panel at a time; any other by
    ``torch.linalg.solve_triangular`` on the whole factor."""
    return state.l.dtype == torch.bfloat16


def _solve_lower(state: GPState, c: torch.Tensor) -> torch.Tensor:
    if _use_blocked(state):
        return blocked_solve_lower(state.l, c)
    return solve_lower(state.l, c)


def _solve_lower_t(state: GPState, c: torch.Tensor) -> torch.Tensor:
    if _use_blocked(state):
        return blocked_solve_lower_t(state.l, c)
    return solve_lower_t(state.l, c)


def _cho_solve(state: GPState, c: torch.Tensor) -> torch.Tensor:
    if _use_blocked(state):
        return blocked_cho_solve(state.l, c)
    return cho_solve(state.l, c)


def _train_cross(state: GPState, xq: torch.Tensor) -> torch.Tensor:
    return cross_covariance_train_padded(
        state.kernel, state.x, state.n, xq, method=state.method
    )


class PredictWeights(NamedTuple):
    """Query-independent solves against the trained factor, derived once
    per (factor, residuals) pair and reused across predict batches:
    ``beta = L^-1 resid`` and ``alpha = L^-T beta = K^-1 resid``. The
    posterior mean is then one GEMM and mean+variance one forward sweep
    (the reference re-solves per call, ``mod.rs:226-244``)."""

    beta: torch.Tensor  # (cap,) L^-1 resid (zero in the dead block)
    alpha: torch.Tensor  # (cap,) K^-1 resid (zero in the dead block)


def derive_weights(state: GPState) -> PredictWeights:
    """Compute :class:`PredictWeights` (two single-column sweeps)."""
    with scope("gp/derive_weights"):
        beta = _solve_lower(state, state.resid)
        return PredictWeights(beta=beta, alpha=_solve_lower_t(state, beta))


def predict_mean(
    state: GPState, xq: torch.Tensor, weights: Optional[PredictWeights] = None
) -> torch.Tensor:
    """Posterior mean: ``prior + K(xq, X) K^-1 resid`` (``mod.rs:226-244``)."""
    with scope("gp/predict_mean"):
        c = _train_cross(state, xq)
        if weights is not None:
            return state.prior.mean(xq) + c.mT @ weights.alpha
        w = _cho_solve(state, c)
        return state.prior.mean(xq) + w.mT @ state.resid


def predict_variance(
    state: GPState, xq: torch.Tensor, weights: Optional[PredictWeights] = None
) -> torch.Tensor:
    """Latent predictive variance — observation noise NOT added back,
    matching ``mod.rs:248-273`` (see ``:266-269``)."""
    del weights  # the variance needs only the factor
    with scope("gp/predict_variance"):
        kl = _solve_lower(state, _train_cross(state, xq))
        return kernel_diag(state.kernel, xq) - torch.sum(kl * kl, dim=0)


def sweep_moments(solve, c: torch.Tensor, beta: torch.Tensor,
                  block: Optional[int] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """``(kl^T beta, colsum(kl * kl))`` for ``kl = solve(c)``: the one
    forward sweep that serves a mean and a variance.

    With ``block`` the columns of ``c`` are solved and reduced ``block`` at a
    time, the last block zero-padded, so that every solve has one shape and
    a column's result does not depend on the other columns: what lets a
    server merge requests and answer each as a call of its own rows would
    (``serving.AcceleratedGPServer``). Solves of different widths round
    differently: on an NVIDIA H100 80GB HBM3 (700 W) at capacity 100,512 in
    float32 they differed by up to 3.0e-3 (``chip_smoke.py`` phase 9c,
    PERF.md). Without ``block`` the sweep is one solve of all the columns,
    the cheapest for one call, whose (capacity, m) solution is squared in
    place: the sweep holds two such matrices, ``c`` and ``kl``, not three."""
    if block is None:
        kl = solve(c)
        fit = kl.mT @ beta
        return fit, torch.sum(kl.square_(), dim=0)
    m = c.shape[1]
    fit, quad = c.new_empty(m), c.new_empty(m)
    for lo in range(0, m, block):
        blk = c[:, lo:lo + block]
        k = blk.shape[1]
        kl = solve(torch.nn.functional.pad(blk, (0, block - k)))
        fit[lo:lo + k] = (kl.mT @ beta)[:k]
        quad[lo:lo + k] = torch.sum(kl * kl, dim=0)[:k]
    return fit, quad


def predict_mean_variance(
    state: GPState, xq: torch.Tensor, weights: Optional[PredictWeights] = None,
    block: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean and variance (``mod.rs:290-326``). With ``weights``, ONE forward
    sweep (``kl``) serves both the mean (``kl^T beta``) and the variance;
    ``block`` makes each query's answer independent of the other queries
    (:func:`sweep_moments`) and needs ``weights``."""
    with scope("gp/predict_mean_variance"):
        c = _train_cross(state, xq)
        base = kernel_diag(state.kernel, xq)
        if weights is not None:
            fit, quad = sweep_moments(lambda r: _solve_lower(state, r), c, weights.beta, block)
            return state.prior.mean(xq) + fit, base - quad
        if block is not None:
            raise ValueError("a fixed-width sweep (block) needs the predict weights")
        w = _cho_solve(state, c)
        mean = state.prior.mean(xq) + w.mT @ state.resid
        var = base - torch.sum(c * w, dim=0)  # column-dot form of mod.rs:314-319
        return mean, var


def predict_covariance(state: GPState, xq: torch.Tensor) -> torch.Tensor:
    """Full posterior covariance ``Kqq - (L^-1 Kq)^T (L^-1 Kq)``
    (``mod.rs:329-350``)."""
    kl = _solve_lower(state, _train_cross(state, xq))
    kqq = cross_covariance(state.kernel, xq, xq, method=state.method)
    return kqq - kl.mT @ kl


def posterior(
    state: GPState, xq: torch.Tensor, weights: Optional[PredictWeights] = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean, covariance) of the posterior at ``xq`` — the ``sample_at``
    computation (``mod.rs:371-392``), which uses ``Kq^T K^-1 Kq`` rather
    than the triangular form. With ``weights``: one forward sweep and the
    (equivalent, PSD-by-construction) triangular form ``kl^T kl``."""
    c = _train_cross(state, xq)
    kqq = cross_covariance(state.kernel, xq, xq, method=state.method)
    if weights is not None:
        kl = _solve_lower(state, c)
        return state.prior.mean(xq) + kl.mT @ weights.beta, kqq - kl.mT @ kl
    w = _cho_solve(state, c)
    return state.prior.mean(xq) + w.mT @ state.resid, kqq - c.mT @ w


# ---------------------------------------------------------------------------
# Model-selection scores (``mod.rs:196-220``)
# ---------------------------------------------------------------------------


def _live(state: GPState) -> torch.Tensor:
    return torch.arange(state.capacity, device=state.x.device) < state.n


def likelihood(
    state: GPState, weights: Optional[PredictWeights] = None
) -> torch.Tensor:
    """The reference's ``likelihood()`` — REPLICATED APPROXIMATION.

    Its complexity penalty sums ``ln|k(x_i, x_i) + noise^2|`` over training
    points (``mod.rs:208-213``), which is NOT the true log-determinant; the
    exact score is :func:`log_marginal_likelihood`. ``weights.beta`` (if
    given) IS the forward solve ``L^-1 resid``.
    """
    ol = weights.beta if weights is not None else _solve_lower(state, state.resid)
    data_fit = torch.sum(ol * ol)
    diag = kernel_diag(state.kernel, state.x) + state.noise * state.noise
    complexity = torch.sum(torch.where(_live(state), torch.log(torch.abs(diag)), 0.0))
    return -(data_fit + complexity + state.n * LOG_2PI) / 2.0


def log_marginal_likelihood(
    state: GPState, weights: Optional[PredictWeights] = None
) -> torch.Tensor:
    """Exact log marginal likelihood (corrected variant):
    ``-1/2 (r^T K^-1 r + ln|K| + n ln 2pi)`` with ``ln|K| = 2 sum ln L_ii``."""
    ol = weights.beta if weights is not None else _solve_lower(state, state.resid)
    data_fit = torch.sum(ol * ol)
    diag_l = torch.diagonal(state.l).to(ol.dtype)
    logdet = 2.0 * torch.sum(torch.where(_live(state), torch.log(diag_l), 0.0))
    return -(data_fit + logdet + state.n * LOG_2PI) / 2.0
