"""Large-scale exact GP whose factor lives row-sharded over the ranks of a
mesh.

Counterpart of ``friedrich_tpu/parallel/large_scale.py`` (``LargeScaleGP``,
``:57-491``), combining the distributed pieces of this package:

- **build**: the distributed streamed Cholesky
  (``distributed_cholesky.py``): K never held, the factor row-sharded;
- **predict**: each rank builds its rows of the cross-covariance (one B1
  launch) and one distributed forward sweep serves mean and variance, with
  the query-independent solves ``(beta, alpha) = (L^-1 r, K^-1 r)`` cached
  per trained state (a mean-only predict runs no sweep);
- **fit**: the reference's ADAM rules (``optimizer.rs:69-149``,
  ``:211-283``) with factor-based solves and a Hutchinson trace estimator,
  ``tr(K^-1 dK_p) ~= mean_z (K^-1 z)^T (dK_p z)``, each rank's rows of
  ``dK_p V`` streamed from the inputs and the per-parameter partial sums
  all-reduced once per iteration. The probes are fixed Rademacher vectors
  from a ``torch.Generator`` (or given, ``probes=``), so a fit is
  deterministic.

Every rank holds the (small) padded inputs and residuals whole and its
(cap / W, cap) block of the factor. Every refactorization (a fit step, a
bfloat16-storage append) writes into the rank's own factor buffer, so old
and new factor never coexist: at n = 100,000 on one H100 two float32
factors (40.4 GB each) do not fit. Where the JAX package keeps the old
factor when a refactorization fails, the port refactors the previous
model into the buffer before raising, which leaves the same model.

Every rank calls every method with the same arguments (SPMD); the results
are the same on every rank.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..config import DEFAULT_CONVERGENCE_FRACTION, DEFAULT_MAX_ITER, DEFAULT_MAX_TIME
from ..models.gp import sweep_moments
from ..models.multivariate_normal import MultivariateNormal
from ..models.optimizer import AdamState, _adam_delta, _init_params
from ..ops.covariance import cross_covariance, kernel_diag
from ..ops.streamed_matvec import rademacher_probes
from ..utils.errors import CholeskyError
from ..utils.profiling import scope
from .distributed_append import distributed_cholesky_append
from .distributed_cholesky import distributed_cholesky_factor, local_block
from .distributed_solve import (
    distributed_cho_solve,
    distributed_cross_covariance,
    distributed_solve_lower,
    distributed_solve_lower_sharded_rhs_inplace,
    distributed_solve_lower_t,
    gradient_partials,
)
from .mesh import Mesh, all_reduce

LOG_2PI = float(np.log(2 * np.pi))


def _round_up(cap: int, size: int) -> int:
    return -(-cap // size) * size


class LargeScaleGP:
    """Exact GP whose Cholesky factor is row-sharded over a mesh.

    The API is the JAX package's: ``predict``, ``predict_variance``,
    ``predict_mean_variance``, ``predict_in_batches``, ``sample_at``,
    ``likelihood``, ``log_marginal_likelihood``, ``add_samples`` /
    ``grow``, ``fit_scaled`` / ``fit_generic``. ``x`` (n, d) and ``y`` (n,)
    are the whole training set on every rank; the capacity is rounded up to
    a multiple of the mesh's size. ``block``: the panel width target
    (default ``ops/partition.DEFAULT_PANEL_TARGET``), snapped to a divisor
    of each rank's rows.
    """

    def __init__(self, mesh: Mesh, kernel, prior, noise, x, y, eps: Optional[float] = None,
                 block: Optional[int] = None, method: str = "gram",
                 capacity: Optional[int] = None, storage: Optional[str] = None):
        device = mesh.device
        x = torch.as_tensor(x, device=device)
        dtype = x.dtype
        y = torch.as_tensor(y, dtype=dtype, device=device)
        self.mesh = mesh
        self.kernel = kernel.to(dtype, device)
        self.prior = prior.to(dtype, device)
        self.block = block
        self.method = method
        self.eps = eps
        # "bf16": the factor's row blocks stored in bfloat16 (float32
        # compute), half the memory and half the broadcast rows; an append
        # then refactorizes (a rank-k update against the rounded factor goes
        # indefinite, models/gp.add_samples_rebuild)
        self.storage = storage
        n, d = x.shape
        cap = _round_up(max(capacity or n, n), mesh.size)
        self.n = n
        self.x = torch.zeros((cap, d), dtype=dtype, device=device)
        self.x[:n] = x
        self.resid = torch.zeros((cap,), dtype=dtype, device=device)
        self.resid[:n] = y - self.prior.mean(x)
        self.noise = torch.as_tensor(noise, dtype=dtype, device=device)
        self.l_local: Optional[torch.Tensor] = None
        self._cached_weights = None
        #: ADAM iterations of the last ``fit_scaled`` / ``fit_generic``.
        self.fit_iterations = 0
        self._factor()

    @classmethod
    def from_factor(cls, mesh: Mesh, kernel, prior, noise, x_pad, resid, n: int,
                    l_local: torch.Tensor, eps: Optional[float] = None,
                    block: Optional[int] = None, method: str = "gram",
                    storage: Optional[str] = None) -> "LargeScaleGP":
        """A model from its padded inputs and residuals (capacity a multiple
        of the mesh's size) and this rank's row block of a factor, without
        refactoring (``interop.large_scale_from_arrays``)."""
        gp = cls.__new__(cls)
        device = mesh.device
        x_pad = torch.as_tensor(x_pad, device=device)
        dtype = x_pad.dtype
        r0, r1 = mesh.rows(x_pad.shape[0])
        if l_local.shape != (r1 - r0, x_pad.shape[0]):
            raise ValueError(f"factor block {tuple(l_local.shape)} is not this rank's rows of "
                             f"capacity {x_pad.shape[0]}")
        gp.mesh, gp.block, gp.method, gp.eps, gp.storage = mesh, block, method, eps, storage
        gp.kernel, gp.prior = kernel.to(dtype, device), prior.to(dtype, device)
        gp.n, gp.x = int(n), x_pad
        gp.resid = torch.as_tensor(resid, dtype=dtype, device=device)
        gp.noise = torch.as_tensor(noise, dtype=dtype, device=device)
        gp.l_local = l_local.to(device)
        gp._cached_weights = None
        gp.fit_iterations = 0
        return gp

    # -- factorization ---------------------------------------------------------

    @property
    def capacity(self) -> int:
        return self.x.shape[0]

    @property
    def x_local(self) -> torch.Tensor:
        """This rank's rows of the padded inputs."""
        r0, r1 = self.mesh.rows(self.capacity)
        return self.x[r0:r1]

    def _refactor(self, kernel=None, noise=None, n: Optional[int] = None) -> torch.Tensor:
        """Factor the training covariance (at ``kernel``, ``noise`` and ``n``,
        by default the model's) into this rank's factor buffer, reused when
        its shape still fits; returns ``ok``."""
        rows = self.capacity // self.mesh.size
        l0 = self.l_local
        if l0 is not None and l0.shape != (rows, self.capacity):
            l0 = self.l_local = None  # a grown capacity: free the old block first
        _, _, block = local_block(self.mesh, self.capacity, self.block)
        with scope("large_scale/factor", cap=self.capacity, world=self.mesh.size, block=block):
            self.l_local, ok = distributed_cholesky_factor(
                self.mesh, self.kernel if kernel is None else kernel, self.x_local,
                self.n if n is None else n, self.noise if noise is None else noise,
                eps=self.eps, block=self.block, method=self.method, storage=self.storage,
                l0=l0,
            )
        self._cached_weights = None
        return ok

    def _factor(self) -> None:
        if not bool(self._refactor()):
            raise CholeskyError()

    # -- cached predict weights --------------------------------------------------

    @property
    def _weights(self) -> tuple[torch.Tensor, torch.Tensor]:
        """``(beta, alpha) = (L^-1 r, K^-1 r)``, derived once per (factor,
        residuals) pair and reused by every predict and score."""
        if self._cached_weights is None:
            beta = distributed_solve_lower(self.mesh, self.l_local, self.resid, self.block)
            alpha = distributed_solve_lower_t(self.mesh, self.l_local, beta, self.block)
            self._cached_weights = (beta, alpha)
        return self._cached_weights

    # -- prediction ----------------------------------------------------------------

    def _query(self, xq) -> torch.Tensor:
        return torch.as_tensor(xq, dtype=self.x.dtype, device=self.mesh.device)

    def _cross(self, xq: torch.Tensor) -> torch.Tensor:
        """This rank's rows of ``K(X, xq)`` (one B1 launch)."""
        return distributed_cross_covariance(self.mesh, self.kernel, self.x_local, self.n, xq,
                                            method=self.method)

    def _sweep(self, c_local: torch.Tensor) -> torch.Tensor:
        """``L^-1 C`` replicated from this rank's rows of C, swept once (the
        rows are consumed in place)."""
        return distributed_solve_lower_sharded_rhs_inplace(self.mesh, self.l_local, c_local, self.block)

    def _solve_lower_strip(self, xq: torch.Tensor) -> torch.Tensor:
        """``L^-1 K(X, xq)`` replicated: the cross-covariance's rows built
        on their ranks and swept once."""
        return self._sweep(self._cross(xq))

    def predict(self, xq) -> torch.Tensor:
        """Sweep-free mean: each rank's rows of the cross-covariance against
        the cached ``K^-1 r``, summed by one (m,) all-reduce."""
        xq = self._query(xq)
        _, alpha = self._weights
        r0, r1 = self.mesh.rows(self.capacity)
        fit = all_reduce(self.mesh, self._cross(xq).mT @ alpha[r0:r1])
        return self.prior.mean(xq) + fit

    def predict_variance(self, xq) -> torch.Tensor:
        xq = self._query(xq)
        kl = self._solve_lower_strip(xq)
        return kernel_diag(self.kernel, xq) - torch.sum(kl.square_(), dim=0)

    def predict_mean_variance(self, xq, block: Optional[int] = None) -> tuple[torch.Tensor, torch.Tensor]:
        """One distributed forward sweep serves both moments: the mean is
        ``kl^T beta``, the variance ``k(x, x) - sum kl^2`` (squared in
        place). With ``block`` the queries are swept ``block`` columns at a
        time, the last block zero-padded (``models/gp.sweep_moments``), so
        that a query's answer does not depend on the others of the call:
        what ``serving.AcceleratedGPServer`` relies on."""
        xq = self._query(xq)
        beta, _ = self._weights
        fit, quad = sweep_moments(self._sweep, self._cross(xq), beta, block)
        return self.prior.mean(xq) + fit, kernel_diag(self.kernel, xq) - quad

    def predict_in_batches(self, xq, batch_size: int = 8192) -> tuple[torch.Tensor, torch.Tensor]:
        """(mean, variance) of a large query set, ``batch_size`` rows at a
        time. The JAX package pads the last chunk so that jit compiles one
        shape; eager PyTorch has nothing to compile, so the port does not
        pad (``OutOfCoreGP.predict_in_batches`` does the same)."""
        xq = self._query(xq)
        means, variances = [], []
        for lo in range(0, xq.shape[0], batch_size):
            mean, var = self.predict_mean_variance(xq[lo:lo + batch_size])
            means.append(mean)
            variances.append(var)
        return torch.cat(means), torch.cat(variances)

    def sample_at(self, xq) -> MultivariateNormal:
        """The posterior at ``xq`` (its m x m covariance held whole), in the
        triangular form ``Kqq - kl^T kl`` (``mod.rs:371-392``)."""
        xq = self._query(xq)
        beta, _ = self._weights
        kl = self._solve_lower_strip(xq)
        kqq = cross_covariance(self.kernel, xq, xq, method=self.method)
        return MultivariateNormal(self.prior.mean(xq) + kl.mT @ beta, kqq - kl.mT @ kl)

    # -- incremental update --------------------------------------------------------

    def _grow_buffers(self, new_capacity: int) -> bool:
        """Grow the inputs and residuals only; the factor is stale until the
        caller refactors. Returns whether the capacity grew."""
        cap = self.capacity
        if new_capacity <= cap:
            return False
        new_capacity = _round_up(new_capacity, self.mesh.size)
        x = self.x.new_zeros((new_capacity, self.x.shape[1]))
        x[:cap] = self.x
        resid = self.resid.new_zeros((new_capacity,))
        resid[:cap] = self.resid
        self.x, self.resid = x, resid
        return True

    def grow(self, new_capacity: int) -> None:
        """Re-shard to a larger capacity and rebuild the factor (O(n^3));
        reserve capacity up front where possible."""
        if self._grow_buffers(new_capacity):
            self._factor()

    def _unstage(self, k: int) -> None:
        self.x[self.n:self.n + k] = 0.0
        self.resid[self.n:self.n + k] = 0.0

    def add_samples(self, x_new, y_new, auto_grow: bool = False) -> None:
        """O(n^2 k) distributed rank-k append into reserved capacity; with
        ``auto_grow=True`` an overflow grows the capacity 1.5x and rebuilds
        instead of raising. A failed append raises ``CholeskyError`` and
        leaves the model as it was."""
        x_new = self._query(x_new)
        y_new = torch.as_tensor(y_new, dtype=self.resid.dtype, device=self.mesh.device)
        k = x_new.shape[0]
        cap = self.capacity
        if self.n + k > cap:
            if not auto_grow:
                raise ValueError(
                    f"capacity {cap} exceeded ({self.n}+{k}); construct with a larger "
                    f"`capacity`, call grow(), or pass auto_grow=True (re-sharded growth "
                    f"rebuilds in O(n^3))"
                )
            new_cap = max(self.n + k, int(cap * 1.5))
            if self.storage == "bf16":
                # the bf16 append refactors anyway: growth and append cost one
                # factorization
                self._grow_buffers(new_cap)
            else:
                self.grow(new_cap)
        self.x[self.n:self.n + k] = x_new
        self.resid[self.n:self.n + k] = y_new - self.prior.mean(x_new)
        if self.storage == "bf16":
            if not bool(self._refactor(n=self.n + k)):
                self._unstage(k)
                self._refactor()  # the previous model, at the (new) sharding
                raise CholeskyError(
                    "distributed add_samples: refactorization with the new points failed; "
                    "consider `cholesky_epsilon` or more noise. The model was left unchanged."
                )
            self.n += k
            return
        ok = distributed_cholesky_append(self.mesh, self.l_local, self.kernel, self.x_local, self.n,
                                         x_new, self.noise, eps=self.eps, block=self.block,
                                         method=self.method)
        if not ok:
            self._unstage(k)
            raise CholeskyError(
                "distributed add_samples: rank-update failed (appended points make the "
                "covariance non-PSD); consider `cholesky_epsilon` or more noise. The model "
                "was left unchanged."
            )
        self.n += k
        self._cached_weights = None

    # -- scores ----------------------------------------------------------------------

    def likelihood(self) -> float:
        """The reference's approximate likelihood (``mod.rs:196-220``): its
        complexity term sums ``ln|k(x_i, x_i) + noise^2|`` over live points."""
        ol = self._weights[0]
        diag = kernel_diag(self.kernel, self.x) + self.noise * self.noise
        live = torch.arange(self.capacity, device=self.x.device) < self.n
        complexity = torch.sum(torch.where(live, torch.log(torch.abs(diag)), 0.0))
        return -(float(torch.sum(ol * ol)) + float(complexity) + self.n * LOG_2PI) / 2.0

    def log_marginal_likelihood(self) -> float:
        """Exact LML; ``ln|K|`` from each rank's diagonal entries of the
        factor, summed by one all-reduce."""
        ol = self._weights[0]
        r0, r1 = self.mesh.rows(self.capacity)
        diag = torch.diagonal(self.l_local, offset=r0).to(self.x.dtype)
        live = torch.arange(r0, r1, device=diag.device) < self.n
        logdet = all_reduce(self.mesh, 2.0 * torch.sum(torch.where(live, torch.log(diag), 0.0)))
        return -(float(torch.sum(ol * ol)) + float(logdet) + self.n * LOG_2PI) / 2.0

    # -- hyperparameter fit ---------------------------------------------------------

    def _probes(self, num_probes: int, seed: int) -> torch.Tensor:
        """Fixed-seed Rademacher probes (cap, num_probes) from a
        ``torch.Generator``, zero on dead rows; the same on every rank."""
        return rademacher_probes(self.capacity, self.n, num_probes, seed, self.x.dtype,
                                 self.mesh.device)

    def _gradient_terms(self, probes: torch.Tensor):
        """``(alpha, alpha^T dK alpha, Hutchinson tr(K^-1 dK), K^-1 Z)``
        from the current factor: two distributed sweeps over ``[r | Z]``
        and the rows' partial sums (:func:`gradient_partials`)."""
        rhs = torch.cat([self.resid[:, None], probes], dim=1)
        sol = distributed_cho_solve(self.mesh, self.l_local, rhs, self.block)
        alpha, kinv_z = sol[:, 0], sol[:, 1:]
        data_fit, complexity = gradient_partials(self.mesh, self.kernel, self.x, self.n, alpha,
                                                 probes, kinv_z, self.method)
        return alpha, data_fit, complexity, kinv_z

    def _step(self, adam: AdamState, probes: torch.Tensor, i: int, scaled: bool,
              conv: float) -> tuple[AdamState, bool]:
        """One fit iteration (the JAX package's ``_make_fit_step``): the
        gradient from the current factor, the ADAM update, the refactor at
        the new hyperparameters into the factor's own buffer. A failed
        refactor puts the previous model back and raises."""
        alpha, data_fit, complexity, kinv_z = self._gradient_terms(probes)
        if scaled:
            scale = torch.dot(self.resid, alpha) / self.n
            grads = (data_fit / scale - complexity) / 2.0
            adam, delta = _adam_delta(adam, grads, i)
            kernel = self.kernel.with_params(adam.params).rescale(scale)
            noise = self.noise * scale
            adam = dataclasses.replace(adam, params=kernel.get_params())
        else:
            grads_kernel = (data_fit - complexity) / 2.0
            # noise gradient (optimizer.rs:52-57), Hutchinson tr(K^-1), and the
            # log-space correction (optimizer.rs:105-110)
            tr_kinv = torch.mean(torch.einsum("is,is->s", probes, kinv_z))
            noise_grad = self.noise * (torch.dot(alpha, alpha) - tr_kinv) * self.noise
            adam, delta = _adam_delta(adam, torch.cat([grads_kernel, noise_grad[None]]), i)
            kernel = self.kernel.with_params(adam.params[:-1])
            noise = torch.exp(adam.params[-1])
        progress = bool(torch.any(torch.abs(delta) > conv))
        if not bool(self._refactor(kernel, noise)):
            self._refactor()
            raise CholeskyError(
                "distributed fit: factorization failed at the updated hyperparameters; "
                "consider `cholesky_epsilon`."
            )
        self.kernel, self.noise = kernel, noise
        return adam, progress

    def _run_fit(self, params: torch.Tensor, probes: Optional[torch.Tensor], num_probes: int,
                 seed: int, scaled: bool, max_iter: int, convergence_fraction: float,
                 max_time: float) -> None:
        if probes is None:
            probes = self._probes(num_probes, seed)
        probes = torch.as_tensor(probes, dtype=self.x.dtype, device=self.mesh.device)
        adam = AdamState(params=params, m=torch.zeros_like(params), v=torch.zeros_like(params))
        t0 = time.monotonic()
        self.fit_iterations = 0
        for i in range(1, max_iter + 1):
            adam, progress = self._step(adam, probes, i, scaled, convergence_fraction)
            self.fit_iterations = i
            if not progress or time.monotonic() - t0 > max_time:
                break

    def fit_scaled(self, max_iter: int = DEFAULT_MAX_ITER,
                   convergence_fraction: float = DEFAULT_CONVERGENCE_FRACTION,
                   max_time: float = DEFAULT_MAX_TIME, num_probes: int = 8, seed: int = 0,
                   probes: Optional[torch.Tensor] = None) -> None:
        """Scaled ADAM fit (``optimizer.rs:211-283``) with Hutchinson
        traces; a scalable kernel only. ``probes`` (cap, s) replaces the draw
        of ``num_probes`` from ``seed``."""
        if not self.kernel.is_scalable:
            raise NotImplementedError(
                "large-scale fit currently implements the scaled path "
                "(scalable kernels: SquaredExp/Exponential/Matern)"
            )
        self._run_fit(_init_params(self.kernel.get_params()), probes, num_probes, seed, True,
                      max_iter, convergence_fraction, max_time)

    def fit_generic(self, max_iter: int = DEFAULT_MAX_ITER,
                    convergence_fraction: float = DEFAULT_CONVERGENCE_FRACTION,
                    max_time: float = DEFAULT_MAX_TIME, num_probes: int = 8, seed: int = 0,
                    probes: Optional[torch.Tensor] = None) -> None:
        """Generic ADAM fit (``optimizer.rs:69-149``): any kernel, the noise
        in log-space, ``tr(K^-1 dK)`` and ``tr(K^-1)`` by Hutchinson."""
        params = torch.cat([_init_params(self.kernel.get_params()), torch.log(self.noise)[None]])
        self._run_fit(params, probes, num_probes, seed, False, max_iter, convergence_fraction,
                      max_time)
