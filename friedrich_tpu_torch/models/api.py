"""User-facing GaussianProcess class (L3 API).

Counterpart of ``friedrich_tpu/models/api.py``: an object-oriented facade
over the functional core in ``models/gp.py``, mirroring the reference's
public surface (``gaussian_process/mod.rs``): ``default``, ``builder``,
``new``, ``predict``, ``predict_variance``, ``predict_mean_variance``,
``predict_covariance``, ``sample_at``, ``add_samples``, ``likelihood``,
``fit_parameters`` — with the same polymorphic input/output behavior (see
``conversion.py``). The wrapper owns an immutable :class:`GPState` and
swaps it on mutation.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch

from .. import config
from ..config import (
    DEFAULT_CONVERGENCE_FRACTION,
    DEFAULT_MAX_ITER,
    DEFAULT_MAX_TIME,
    GROWTH_FACTOR,
)
from ..conversion import as_input_matrix, as_output_vector
from ..utils.errors import CholeskyError, ConfigError, ShapeError
from . import gp as core
from .multivariate_normal import MultivariateNormal
from .optimizer import fit_parameters as _fit_parameters

#: ``predict_in_batches`` default chunk of queries.
DEFAULT_PREDICT_BATCH = 8192

_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    torch.float32: torch.float32, torch.float64: torch.float64,
}


def check_dtype(dtype) -> torch.dtype:
    """The model dtype named by ``dtype`` ('float32', 'float64' or a torch
    dtype); raises ConfigError for anything else."""
    if dtype not in _DTYPES:
        raise ConfigError(f"model dtype must be float32 or float64, got {dtype}")
    return _DTYPES[dtype]


class GaussianProcess:
    """A trained Gaussian process (reference ``mod.rs:59-79``)."""

    def __init__(self, state: core.GPState):
        self._state = state
        #: ADAM iterations run by the last :meth:`fit_parameters`.
        self.fit_iterations = 0

    # -- derived predict weights (cached per factor/residual pair) ----------

    @property
    def _state(self) -> core.GPState:
        return self.__state

    @_state.setter
    def _state(self, state: core.GPState) -> None:
        self.__state = state
        self.__weights = None  # any state change invalidates the cache

    @property
    def _weights(self) -> core.PredictWeights:
        """``L^-1 resid`` / ``K^-1 resid``, derived lazily once per trained
        state and reused across predict/score calls."""
        if self.__weights is None:
            self.__weights = core.derive_weights(self.__state)
        return self.__weights

    # -- constructors -------------------------------------------------------

    @classmethod
    def default(cls, training_inputs, training_outputs, device=None) -> "GaussianProcess":
        """Gaussian kernel + constant prior, both fitted
        (``mod.rs:96-102``)."""
        return (
            cls.builder(training_inputs, training_outputs, device=device)
            .fit_kernel()
            .fit_prior()
            .train()
        )

    @classmethod
    def builder(cls, training_inputs, training_outputs, device=None):
        """Start a builder (``mod.rs:129-135``)."""
        from .builder import GaussianProcessBuilder

        return GaussianProcessBuilder(training_inputs, training_outputs, device=device)

    @classmethod
    def new(
        cls,
        prior,
        kernel,
        noise: float,
        cholesky_epsilon: Optional[float],
        training_inputs,
        training_outputs,
        method: str = "gram",
        capacity: Optional[int] = None,
        backend: str = "dense",
        storage: Optional[str] = None,
        dtype=None,
        device=None,
        panel_block=None,
        precision: Optional[str] = None,
    ) -> "GaussianProcess":
        """Raw constructor (``mod.rs:142-167``). ``dtype`` overrides the
        default compute dtype; ``device`` the default device (CUDA unless
        ``config.set_device`` says otherwise). ``backend``: ``"dense"``,
        ``"streamed"`` or ``"auto"`` (``models/gp.resolve_backend``);
        ``panel_block``: the streamed backend's panel width or width
        schedule (default ``ops/partition.panel_widths``); ``storage``
        (None or ``"bf16"``) and ``precision``: the factor storage dtype and
        the matmul precision of every factorization of the model (streamed
        backend; builder ``set_factor_storage``, ``set_factor_precision``)."""
        if noise < 0:
            raise ConfigError(
                f"The noise parameter should be non-negative but we tried to "
                f"set it to {noise}"
            )
        if cholesky_epsilon is not None and cholesky_epsilon <= 0:
            raise ConfigError("cholesky_epsilon must be strictly positive")
        if dtype is not None:
            dtype = check_dtype(dtype)
        x, _ = as_input_matrix(training_inputs, dtype=dtype, device=device)
        y = as_output_vector(training_outputs, dtype=dtype, device=x.device)
        if x.shape[0] != y.shape[0]:
            raise ShapeError(
                f"{x.shape[0]} input rows vs {y.shape[0]} outputs"
            )
        state, ok = core.make_state(
            kernel, prior, noise, x, y, eps=cholesky_epsilon, method=method,
            cap=capacity, backend=backend, storage=storage, block=panel_block,
            precision=precision,
        )
        if not bool(ok):
            raise CholeskyError()
        return cls(state)

    # -- accessors -----------------------------------------------------------

    @property
    def state(self) -> core.GPState:
        return self._state

    @property
    def kernel(self):
        return self._state.kernel

    @property
    def prior(self):
        return self._state.prior

    @property
    def noise(self) -> float:
        return float(self._state.noise)

    @property
    def cholesky_epsilon(self) -> Optional[float]:
        return self._state.eps

    @property
    def num_samples(self) -> int:
        return self._state.n

    # -- prediction ----------------------------------------------------------

    def _query(self, inputs) -> tuple[torch.Tensor, Any]:
        xq, adapter = as_input_matrix(
            inputs, dtype=self._state.x.dtype, device=self._state.x.device
        )
        if xq.shape[1] != self._state.input_dim:
            raise ShapeError(
                f"query dim {xq.shape[1]} != training dim {self._state.input_dim}"
            )
        return xq, adapter

    def predict(self, inputs):
        """Posterior mean (``mod.rs:226-244``): one covariance strip and one
        GEMM against the cached ``K^-1 resid`` weights."""
        xq, adapter = self._query(inputs)
        return adapter.vector(core.predict_mean(self._state, xq, self._weights))

    def predict_variance(self, inputs):
        """Latent posterior variance (``mod.rs:248-273``)."""
        xq, adapter = self._query(inputs)
        return adapter.vector(core.predict_variance(self._state, xq, self._weights))

    def predict_mean_variance(self, inputs):
        """Shared-weights (mean, variance) (``mod.rs:290-326``) — one
        forward sweep per batch against the cached ``L^-1 resid``."""
        xq, adapter = self._query(inputs)
        mean, var = core.predict_mean_variance(self._state, xq, self._weights)
        return adapter.pair(mean, var)

    def predict_covariance(self, inputs) -> torch.Tensor:
        """Full posterior covariance matrix (``mod.rs:329-350``)."""
        xq, _ = self._query(inputs)
        return core.predict_covariance(self._state, xq)

    def predict_in_batches(
        self, inputs, batch_size: Optional[int] = None
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """(mean, variance) for large query sets, processed in chunks of
        ``batch_size`` queries (default :data:`DEFAULT_PREDICT_BATCH`) so the
        (capacity, batch) covariance strip stays bounded."""
        batch_size = batch_size or DEFAULT_PREDICT_BATCH
        xq, _ = self._query(inputs)
        means, variances = [], []
        for lo in range(0, xq.shape[0], batch_size):
            mean, var = core.predict_mean_variance(
                self._state, xq[lo:lo + batch_size], self._weights
            )
            means.append(mean)
            variances.append(var)
        return torch.cat(means), torch.cat(variances)

    def sample_at(self, inputs) -> MultivariateNormal:
        """Posterior sampler at the given points (``mod.rs:371-392``)."""
        xq, adapter = self._query(inputs)
        mean, cov = core.posterior(self._state, xq, self._weights)
        return MultivariateNormal(mean, cov, adapter)

    # -- scores ---------------------------------------------------------------

    def likelihood(self) -> float:
        """The reference's approximate likelihood (``mod.rs:196-220``)."""
        return float(core.likelihood(self._state, self._weights))

    def log_marginal_likelihood(self) -> float:
        """Exact log marginal likelihood (corrected variant)."""
        return float(core.log_marginal_likelihood(self._state, self._weights))

    # -- mutation --------------------------------------------------------------

    def add_samples(self, inputs, outputs) -> None:
        """Incremental O(n^2 k) update (``mod.rs:173-190``), atomic: on a
        failed rank-update the model is left unchanged.

        When the old and the appended factor would not fit the card together
        (``config.two_matrices_fit``), the append writes the new rows into
        the factor in place, and a failed one puts them back to the
        identity padding (``models/gp.repair_failed_append``), as the JAX
        package's donated append does.

        A bf16-stored model appends by a whole refactorization
        (``models/gp.add_samples_rebuild``): into a new factor where two
        bf16 factors fit the card, and the model is unchanged on failure;
        into the factor's own buffer where they do not, and a failure
        refactors the model at the old n (the JAX package's recovery of a
        grown buffer). A grown model rebuilds into its fresh buffer."""
        state = self._state
        x_new, _ = as_input_matrix(inputs, dtype=state.x.dtype, device=state.x.device)
        y_new = as_output_vector(outputs, dtype=state.resid.dtype, device=state.x.device)
        if x_new.shape[0] != y_new.shape[0]:
            raise ShapeError("inputs/outputs row mismatch")
        if x_new.shape[1] != state.input_dim:
            raise ShapeError(
                f"new sample dim {x_new.shape[1]} != training dim "
                f"{state.input_dim}"
            )
        n, k, cap = state.n, x_new.shape[0], state.capacity
        grew = n + k > cap
        if grew:
            # amortized growth, extendable_matrix.rs:38 (x1.5 policy); a
            # bf16-storage append rebuilds, so the old factor is not copied
            state = core.grow_capacity(state, max(n + k, math.ceil(cap * GROWTH_FACTOR)),
                                       copy_factor=state.storage != "bf16")
        if state.storage == "bf16":
            self._append_rebuild(state, x_new, y_new, grew)
            return
        in_place = not config.two_matrices_fit(state.capacity, state.l.element_size(),
                                               state.l.device)
        new_state = core.add_samples_padded(state, x_new, y_new, in_place=in_place)
        # validate BEFORE committing: a failed rank-update must not leave the
        # model corrupted for callers that catch the error and keep using it
        if not bool(torch.all(torch.isfinite(torch.diagonal(new_state.l)))):
            if in_place:
                core.repair_failed_append(state.l, n, k)
            raise CholeskyError(
                "add_samples: rank-update of the Cholesky factor failed "
                "(new points make the covariance non-PSD); consider setting "
                "`cholesky_epsilon` or increasing the noise. The model was "
                "left unchanged."
            )
        self._state = new_state

    def _append_rebuild(self, state: core.GPState, x_new, y_new, grew: bool) -> None:
        """The bf16-storage append (``friedrich_tpu/models/api.py:315-349``)
        under the port's two-matrix memory rule."""
        own = grew or not config.two_matrices_fit(state.capacity, state.l.element_size(),
                                                  state.l.device)
        new_state, ok = core.add_samples_rebuild(state, x_new, y_new, reuse_buffer=own)
        if not bool(ok):
            if own and not grew:
                # the failed factor is in the model's buffer: refactor at the
                # old n (its data are unchanged), as the JAX package restores
                # a grown buffer
                restored, ok_old = core.rebuild_cholesky(state, reuse_buffer=True)
                if bool(ok_old):
                    self._state = restored
            raise CholeskyError(
                "add_samples: refactorization with the new points failed; consider setting "
                "`cholesky_epsilon` or increasing the noise. The model was left unchanged."
            )
        self._state = new_state

    def fit_parameters(
        self,
        fit_prior: bool = True,
        fit_kernel: bool = True,
        max_iter: int = DEFAULT_MAX_ITER,
        convergence_fraction: float = DEFAULT_CONVERGENCE_FRACTION,
        max_time: float = DEFAULT_MAX_TIME,
        fit_log=None,
        gradient: str = "auto",
        num_probes: int = 8,
        seed: int = 0,
        subsample=None,
    ) -> None:
        """Refit prior/kernel/noise (``mod.rs:406-445``). Pass a
        :class:`~friedrich_tpu_torch.utils.fitlog.FitLog` as ``fit_log`` for
        a record per iteration. ``gradient``:
        ``"exact"``, ``"hutchinson"`` or ``"auto"`` (Hutchinson above
        capacity 8,192), ``num_probes`` and ``seed`` the Hutchinson
        estimator's probes; ``subsample``: fit the hyperparameters on a
        random subset of that size (int, or ``"auto"``) and pay one full
        factorization at the end. See ``models/optimizer.py``."""
        self._state, self.fit_iterations = _fit_parameters(
            self._state,
            fit_prior=fit_prior,
            fit_kernel=fit_kernel,
            max_iter=max_iter,
            convergence_fraction=convergence_fraction,
            max_time=max_time,
            fit_log=fit_log,
            gradient=gradient,
            num_probes=num_probes,
            seed=seed,
            subsample=subsample,
        )

    def set_hyperparameters(self, kernel=None, noise: Optional[float] = None,
                            prior=None) -> None:
        """Replace kernel/noise/prior and rebuild the factor (and residuals
        when the prior changes). The reference exposes these as public
        mutable fields (``mod.rs:59-73``) but leaves the factor stale."""
        state = self._state
        dtype, device = state.x.dtype, state.x.device
        if prior is not None:
            prior = prior.to(dtype, device)
            live = torch.arange(state.capacity, device=device) < state.n
            y_pad = state.resid + torch.where(live, state.prior.mean(state.x), 0.0)
            resid = torch.where(live, y_pad - prior.mean(state.x), 0.0)
            state = state.replace(prior=prior, resid=resid)
        if kernel is not None:
            state = state.replace(kernel=kernel.to(dtype, device))
        if noise is not None:
            if noise < 0:
                raise ConfigError("noise must be non-negative")
            state = state.replace(noise=torch.as_tensor(noise, dtype=dtype, device=device))
        state, ok = core.rebuild_cholesky(state)
        if not bool(ok):
            raise CholeskyError()
        self._state = state

    def fit_map(
        self,
        num_steps: int = 200,
        learning_rate: float = 0.05,
        prior_sigma: Optional[float] = None,
    ) -> None:
        """Corrected variant of ``fit_parameters``: maximize the EXACT log
        marginal likelihood by autodiff (works for any kernel composition;
        see ``models/map_fit.py``)."""
        from .map_fit import fit_map as _fit_map

        self._state = _fit_map(
            self._state, num_steps=num_steps, learning_rate=learning_rate,
            prior_sigma=prior_sigma,
        )

    # -- persistence -------------------------------------------------------------

    def save(self, path: str) -> None:
        """Serialize the full trained model (reference: serde derives,
        ``mod.rs:58``) in the JAX package's format. Round-trips to
        bit-identical predictions."""
        from ..utils.serialization import save_gp

        save_gp(self, path)

    @classmethod
    def load(cls, path: str) -> "GaussianProcess":
        """A model written by :meth:`save` or by the JAX package, on the
        default device (CUDA unless ``config.set_device`` says otherwise)."""
        from ..utils.serialization import load_gp

        return load_gp(path)
