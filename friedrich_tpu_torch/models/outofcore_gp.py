"""Out-of-core exact GP: the factor in host memory, the work on one card.

Counterpart of ``friedrich_tpu/models/outofcore_gp.py``. ``OutOfCoreGP``
keeps its Cholesky factor in host memory (``ops/outofcore.py``), so n is
bounded by host memory and the host link, not by the card's memory. The
predict surface mirrors ``GaussianProcess`` where it makes sense at this
scale (reference ``gaussian_process/mod.rs:226-350``):

- ``predict`` (mean) is sweep-free after the first call: the cached
  ``alpha = K^-1 r`` makes each batch one covariance strip and a GEMM;
- ``predict_variance`` / ``predict_mean_variance`` stream L once per batch
  (one forward sweep);
- ``add_samples`` refactors (O(n^3)), growing the capacity x1.5 when needed,
  and restores the model on failure.

``fit_scaled`` / ``fit_generic`` run the Hutchinson-trace ADAM of
``models/large_fit.py`` (``optimizer.rs:211-283`` / ``:69-149`` rules) with
the solves streamed through the host factor and one refactorization per
iteration. The probes come from a ``torch.Generator``; ``probes=`` replaces
them (to replay the JAX package's).
"""

from __future__ import annotations

import math
import time
from typing import Optional

import torch

from ..config import GROWTH_FACTOR, resolve_device
from ..ops.covariance import cross_covariance, cross_covariance_train_padded, kernel_diag
from ..ops.outofcore import (
    HOST_DTYPES,
    check_host_factor,
    outofcore_cho_solve,
    outofcore_cholesky_factor,
    outofcore_solve_lower,
    outofcore_solve_lower_t,
)
from ..ops.streamed_matvec import rademacher_probes, streamed_grad_matvec
from ..utils.errors import CholeskyError, ConfigError
from .gp import LOG_2PI, sweep_moments
from .multivariate_normal import MultivariateNormal
from .optimizer import ADAM_EPS, AdamState, _adam_delta


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device=device)


class OutOfCoreGP:
    """Exact GP whose Cholesky factor lives in host memory. Computes in
    float32 on ``device`` (CUDA unless ``config.set_device`` says
    otherwise)."""

    def __init__(self, kernel, prior, noise: float, x, y, eps: Optional[float] = None,
                 block: int = 4096, method: str = "gram", storage: Optional[str] = None,
                 capacity: Optional[int] = None, device=None):
        self._setup(kernel, prior, noise, eps, block, method, storage, device)
        x = _f32(x, self.device)
        y = _f32(y, self.device)
        n, d = x.shape
        cap = max(capacity or n, n)
        self.n = n
        self.x = torch.zeros((cap, d), dtype=torch.float32, device=self.device)
        self.x[:n] = x
        self.resid = torch.zeros((cap,), dtype=torch.float32, device=self.device)
        self.resid[:n] = y - self.prior.mean(x)
        self.l_host = None
        self._factor()

    def _setup(self, kernel, prior, noise, eps, block, method, storage, device) -> None:
        if storage not in HOST_DTYPES:
            raise ConfigError(f"storage must be None or 'bf16', got {storage!r}")
        self.device = resolve_device(device)
        self.kernel = kernel.to(torch.float32, self.device)
        self.prior = prior.to(torch.float32, self.device)
        self.noise = _f32(noise, self.device)
        self.eps, self.block, self.method, self.storage = eps, block, method, storage
        self._cached_weights = None

    @classmethod
    def from_factor(cls, kernel, prior, noise: float, x_pad, resid, n: int,
                    l_host: torch.Tensor, eps: Optional[float] = None, block: int = 4096,
                    method: str = "gram", storage: Optional[str] = None,
                    device=None) -> "OutOfCoreGP":
        """A model from its padded inputs and residuals, live count and host
        factor, without refactoring (``interop.outofcore_from_arrays``). The
        factor is used in place, page-locked first when ``device`` is the
        card."""
        gp = cls.__new__(cls)
        gp._setup(kernel, prior, noise, eps, block, method, storage, device)
        gp.x = _f32(x_pad, gp.device)
        gp.resid = _f32(resid, gp.device)
        gp.n = int(n)
        gp.l_host = check_host_factor(l_host, gp.x.shape[0], HOST_DTYPES[storage], gp.device)
        return gp

    # -- factorization ---------------------------------------------------------

    def _factor(self) -> None:
        # the host factor's buffer takes the new factor (a refit or append
        # at an unchanged capacity allocates and page-locks nothing)
        self.l_host, ok = outofcore_cholesky_factor(
            self.kernel, self.x, self.n, self.noise, eps=self.eps, block=self.block,
            method=self.method, storage=self.storage, l0=self.l_host,
        )
        self._cached_weights = None
        if not ok:
            raise CholeskyError()

    @property
    def _weights(self) -> tuple[torch.Tensor, torch.Tensor]:
        """``(beta, alpha) = (L^-1 r, K^-1 r)``: two streamed sweeps, paid
        once per trained state."""
        if self._cached_weights is None:
            beta = outofcore_solve_lower(self.l_host, self.resid)
            alpha = outofcore_solve_lower_t(self.l_host, beta)
            self._cached_weights = (beta, alpha)
        return self._cached_weights

    # -- prediction ------------------------------------------------------------

    def _cross(self, xq: torch.Tensor) -> torch.Tensor:
        return cross_covariance_train_padded(self.kernel, self.x, self.n, xq, method=self.method)

    def predict(self, xq) -> torch.Tensor:
        """Posterior mean: one covariance strip and one GEMM against the
        cached ``K^-1 resid``; the factor is not read."""
        xq = _f32(xq, self.device)
        _, alpha = self._weights
        return self.prior.mean(xq) + self._cross(xq).mT @ alpha

    def predict_variance(self, xq) -> torch.Tensor:
        xq = _f32(xq, self.device)
        kl = outofcore_solve_lower(self.l_host, self._cross(xq))
        return kernel_diag(self.kernel, xq) - torch.sum(kl * kl, dim=0)

    def predict_mean_variance(self, xq, block: Optional[int] = None) -> tuple[torch.Tensor, torch.Tensor]:
        """One streamed forward sweep serves both moments; with ``block``,
        ``block`` columns at a time, so that each query's answer does not
        depend on the others of the call (``models/gp.sweep_moments``)."""
        xq = _f32(xq, self.device)
        beta, _ = self._weights
        fit, quad = sweep_moments(lambda r: outofcore_solve_lower(self.l_host, r), self._cross(xq),
                                  beta, block)
        return self.prior.mean(xq) + fit, kernel_diag(self.kernel, xq) - quad

    def predict_in_batches(self, xq, batch_size: int = 8192) -> tuple[torch.Tensor, torch.Tensor]:
        xq = _f32(xq, self.device)
        parts = [self.predict_mean_variance(xq[lo:lo + batch_size])
                 for lo in range(0, xq.shape[0], batch_size)]
        return torch.cat([m for m, _ in parts]), torch.cat([v for _, v in parts])

    def sample_at(self, xq) -> MultivariateNormal:
        """Posterior sampler at ``xq`` (the m x m covariance stays dense)."""
        xq = _f32(xq, self.device)
        beta, _ = self._weights
        kl = outofcore_solve_lower(self.l_host, self._cross(xq))
        cov = cross_covariance(self.kernel, xq, xq, method=self.method) - kl.mT @ kl
        return MultivariateNormal(self.prior.mean(xq) + kl.mT @ beta, cov)

    # -- scores ----------------------------------------------------------------

    def _live(self) -> torch.Tensor:
        return torch.arange(self.x.shape[0], device=self.device) < self.n

    def likelihood(self) -> float:
        """The reference's approximate score (``mod.rs:196-220``)."""
        ol = self._weights[0]
        data_fit = float(torch.sum(ol * ol))
        diag = kernel_diag(self.kernel, self.x) + self.noise * self.noise
        complexity = float(torch.sum(torch.where(self._live(), torch.log(torch.abs(diag)), 0.0)))
        return -(data_fit + complexity + self.n * LOG_2PI) / 2.0

    def log_marginal_likelihood(self) -> float:
        ol = self._weights[0]
        data_fit = float(torch.sum(ol * ol))
        diag = torch.diagonal(self.l_host)[:self.n].double()
        logdet = 2.0 * float(torch.sum(torch.log(diag)))
        return -(data_fit + logdet + self.n * LOG_2PI) / 2.0

    # -- mutation --------------------------------------------------------------

    def add_samples(self, x_new, y_new) -> None:
        """Append by refactorization (O(n^3)); grows the capacity x1.5 when
        it is exceeded. On a failed factorization the model is refactored
        at the old n and :class:`CholeskyError` raised."""
        x_new = _f32(x_new, self.device)
        y_new = _f32(y_new, self.device)
        k = x_new.shape[0]
        cap = self.x.shape[0]
        if self.n + k > cap:
            new_cap = max(self.n + k, math.ceil(cap * GROWTH_FACTOR))
            x = torch.zeros((new_cap, self.x.shape[1]), dtype=torch.float32, device=self.device)
            x[:cap] = self.x
            resid = torch.zeros((new_cap,), dtype=torch.float32, device=self.device)
            resid[:cap] = self.resid
            self.x, self.resid = x, resid
            self.l_host = None  # the old host factor goes before the new one is made
        n_old = self.n
        self.x[n_old:n_old + k] = x_new
        self.resid[n_old:n_old + k] = y_new - self.prior.mean(x_new)
        self.n += k
        try:
            self._factor()
        except CholeskyError:
            self.n = n_old
            self.x[n_old:n_old + k] = 0.0
            self.resid[n_old:n_old + k] = 0.0
            self._factor()  # the old data factored before
            raise CholeskyError(
                "add_samples: refactorization with the new points failed; consider "
                "`cholesky_epsilon` or more noise. The model was restored."
            )

    def set_hyperparameters(self, kernel=None, noise: Optional[float] = None, prior=None) -> None:
        """Replace kernel/noise/prior and refactor."""
        if prior is not None:
            live = self._live()
            y_pad = self.resid + torch.where(live, self.prior.mean(self.x), 0.0)
            self.prior = prior.to(torch.float32, self.device)
            self.resid = torch.where(live, y_pad - self.prior.mean(self.x), 0.0)
        if kernel is not None:
            self.kernel = kernel.to(torch.float32, self.device)
        if noise is not None:
            self.noise = _f32(noise, self.device)
        self._factor()

    # -- hyperparameter fit ----------------------------------------------------

    def _probes(self, num_probes: int, seed: int) -> torch.Tensor:
        """Fixed-seed Rademacher probes, zero on dead rows
        (``ops/streamed_matvec.rademacher_probes``)."""
        return rademacher_probes(self.x.shape[0], self.n, num_probes, seed, torch.float32,
                                 self.device)

    def _gradient_terms(self, probes: torch.Tensor):
        """``alpha = K^-1 r``, the exact data-fit terms ``alpha^T dK_p
        alpha`` and the Hutchinson traces ``tr(K^-1 dK_p)``, with the
        residuals and the probes solved together through the host factor
        and multiplied by dK in one streamed pass."""
        sol = outofcore_cho_solve(self.l_host, torch.cat([self.resid[:, None], probes], dim=1))
        alpha, kinv_z = sol[:, 0], sol[:, 1:]
        dk_v = streamed_grad_matvec(self.kernel, self.x, self.n,
                                    torch.cat([alpha[:, None], probes], dim=1), method=self.method)
        data_fit = dk_v[:, :, 0] @ alpha
        complexity = torch.mean(torch.einsum("is,pis->ps", kinv_z, dk_v[:, :, 1:]), dim=1)
        return alpha, data_fit, complexity, kinv_z

    def _run_fit(self, scaled: bool, max_iter, convergence_fraction, max_time, num_probes, seed,
                 probes) -> None:
        if probes is None:
            probes = self._probes(num_probes, seed)
        probes = _f32(probes, self.device)
        kparams = self.kernel.get_params()
        kparams = torch.where(kparams == 0.0, ADAM_EPS, kparams)
        params = kparams if scaled else torch.cat([kparams, torch.log(self.noise)[None]])
        adam = AdamState(params=params, m=torch.zeros_like(params), v=torch.zeros_like(params))
        t0 = time.monotonic()
        for i in range(1, max_iter + 1):
            alpha, data_fit, complexity, kinv_z = self._gradient_terms(probes)
            if scaled:
                scale = torch.dot(self.resid, alpha) / self.n
                grads = (data_fit / scale - complexity) / 2.0
                adam, delta = _adam_delta(adam, grads, i)
                self.kernel = self.kernel.with_params(adam.params).rescale(scale)
                self.noise = self.noise * scale
                adam = AdamState(params=self.kernel.get_params(), m=adam.m, v=adam.v)
            else:
                grads_kernel = (data_fit - complexity) / 2.0
                tr_kinv = torch.mean(torch.einsum("is,is->s", probes, kinv_z))
                noise_grad = self.noise * (torch.dot(alpha, alpha) - tr_kinv) * self.noise
                adam, delta = _adam_delta(adam, torch.cat([grads_kernel, noise_grad[None]]), i)
                self.kernel = self.kernel.with_params(adam.params[:-1])
                self.noise = torch.exp(adam.params[-1])
            progress = bool(torch.any(torch.abs(delta) > convergence_fraction))
            try:
                self._factor()
            except CholeskyError:
                raise CholeskyError(
                    "out-of-core fit: factorization failed at the updated hyperparameters; "
                    "consider `cholesky_epsilon`."
                )
            if (not progress) or (time.monotonic() - t0 > max_time):
                break

    def fit_scaled(self, max_iter: int = 100, convergence_fraction: float = 0.05,
                   max_time: float = 3600.0, num_probes: int = 8, seed: int = 0,
                   probes: Optional[torch.Tensor] = None) -> None:
        """Scaled ADAM fit (``optimizer.rs:211-283`` rules), scalable kernels
        only; the solves stream through the host factor. ``probes`` (cap, s)
        replaces the draw of ``num_probes`` from ``seed``."""
        if not self.kernel.is_scalable:
            raise NotImplementedError(
                "fit_scaled needs a scalable kernel (SquaredExp/Exponential/Matern); use "
                "fit_generic"
            )
        self._run_fit(True, max_iter, convergence_fraction, max_time, num_probes, seed, probes)

    def fit_generic(self, max_iter: int = 100, convergence_fraction: float = 0.05,
                    max_time: float = 3600.0, num_probes: int = 8, seed: int = 0,
                    probes: Optional[torch.Tensor] = None) -> None:
        """Generic-path ADAM fit (``optimizer.rs:69-149`` rules): any
        kernel, noise fitted in log space."""
        self._run_fit(False, max_iter, convergence_fraction, max_time, num_probes, seed, probes)
