"""Fluent builder for GaussianProcess configuration.

Counterpart of ``friedrich_tpu/models/builder.py`` and of the reference's
``GaussianProcessBuilder`` (``gaussian_process/builder.rs:35-215``),
including its defaults:

- ConstantPrior(0), Gaussian kernel (``builder.rs:71-72``);
- noise = 10% of the output standard deviation (``builder.rs:73``);
- max_iter=100, convergence_fraction=0.05, max_time=1h
  (``builder.rs:76-78``);
- no cholesky_epsilon (``builder.rs:83``);
- parameters are NOT fitted unless ``fit_kernel()`` / ``fit_prior()`` are
  called (``builder.rs:74-75``).

``train()`` runs the kernel heuristic fit first (when fitting was
requested), builds the GP, then runs ``fit_parameters``
(``builder.rs:189-214``) — or, above the sub-fit threshold, fits the
hyperparameters on a subset first and builds the full model once.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from ..config import (
    DEFAULT_CONVERGENCE_FRACTION,
    DEFAULT_MAX_ITER,
    DEFAULT_MAX_TIME,
    MATMUL_PRECISION_MODES,
)
from ..conversion import as_input_matrix, as_output_vector
from ..kernels import Gaussian
from ..priors import ConstantPrior
from ..utils.errors import ConfigError
from .api import GaussianProcess, check_dtype
from .gp import check_backend, resolve_backend
from .optimizer import auto_subsample, subset_indices


def _clock(device: torch.device) -> float:
    """Host time after the device's queued work has finished."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


class GaussianProcessBuilder:
    def __init__(self, training_inputs, training_outputs, device=None):
        self._x, _ = as_input_matrix(training_inputs, device=device)
        self._y = as_output_vector(training_outputs, device=self._x.device)
        self._prior = ConstantPrior.default(self._x.shape[1])
        self._kernel = Gaussian()
        # 10% of output std by default (builder.rs:73); population variance.
        self._noise = 0.1 * float(torch.sqrt(torch.var(self._y, correction=0)))
        self._cholesky_epsilon: Optional[float] = None
        self._should_fit_kernel = False
        self._should_fit_prior = False
        self._max_iter = DEFAULT_MAX_ITER
        self._convergence_fraction = DEFAULT_CONVERGENCE_FRACTION
        self._max_time = DEFAULT_MAX_TIME
        self._method = "gram"
        self._capacity: Optional[int] = None
        self._backend = "dense"
        self._panel_block = None
        self._storage: Optional[str] = None
        self._precision: Optional[str] = None
        self._dtype: Optional[torch.dtype] = None
        # "auto": the reference's full fit below n=24,576; above it, fit the
        # hyperparameters on a max(8192, n // 5) subset, then build the
        # full model once (optimizer.auto_subsample)
        self._fit_subsample = "auto"
        self._fit_gradient = "auto"
        self._fit_polish = False
        #: Wall-clock seconds of each step of the last :meth:`train`
        #: (device work included), and the sub-fit's ADAM iterations.
        self.timings: dict = {}

    # -- setters (builder.rs:102-182) ----------------------------------------

    def set_prior(self, prior) -> "GaussianProcessBuilder":
        self._prior = prior
        return self

    def set_noise(self, noise: float) -> "GaussianProcessBuilder":
        if noise < 0:
            raise ConfigError(
                f"The noise parameter should be non-negative but we tried to "
                f"set it to {noise}"
            )
        self._noise = noise
        return self

    def set_kernel(self, kernel) -> "GaussianProcessBuilder":
        self._kernel = kernel
        return self

    def set_cholesky_epsilon(self, eps: Optional[float]) -> "GaussianProcessBuilder":
        if eps is not None and eps <= 0:
            raise ConfigError("cholesky_epsilon must be strictly positive")
        self._cholesky_epsilon = eps
        return self

    def set_fit_parameters(
        self, max_iter: int, convergence_fraction: float
    ) -> "GaussianProcessBuilder":
        self._max_iter = max_iter
        self._convergence_fraction = convergence_fraction
        return self

    def set_max_time(self, max_time_seconds: float) -> "GaussianProcessBuilder":
        self._max_time = max_time_seconds
        return self

    def fit_kernel(self) -> "GaussianProcessBuilder":
        self._should_fit_kernel = True
        return self

    def fit_prior(self) -> "GaussianProcessBuilder":
        self._should_fit_prior = True
        return self

    # -- extensions of the JAX package -----------------------------------------

    def set_distance_method(self, method: str) -> "GaussianProcessBuilder":
        """'gram' (GEMM identity, default), 'gram_bf16' (bfloat16 inputs
        with float32 accumulation) or 'direct' (broadcast difference,
        closest to the reference)."""
        if method not in ("gram", "gram_bf16", "direct"):
            raise ConfigError(f"unknown distance method {method!r}")
        self._method = method
        return self

    def set_capacity(self, capacity: int) -> "GaussianProcessBuilder":
        """Pre-reserve padded capacity for incremental add_samples."""
        self._capacity = capacity
        return self

    def set_backend(self, backend: str) -> "GaussianProcessBuilder":
        """'dense' (materialize K, then factor), 'streamed' (build and factor
        K panel by panel, never holding it) or 'auto' (streamed on a card
        where the dense backend's K and L would not fit,
        ``models/gp.resolve_backend``). 'tiled' and 'hybrid' are not ported
        yet and raise."""
        check_backend(backend)
        self._backend = backend
        return self

    def set_dtype(self, dtype) -> "GaussianProcessBuilder":
        """Compute dtype for the model ('float32'/'float64' or a torch
        dtype), overriding the default (float64 under ``enable_x64``,
        float32 otherwise)."""
        self._dtype = check_dtype(dtype)
        return self

    def set_factor_storage(self, storage: Optional[str]) -> "GaussianProcessBuilder":
        """Factor storage dtype: None (the input dtype, default) or 'bf16'
        (a bfloat16 factor, float32 compute: half the factor's memory;
        needs the 'streamed' backend and float32 inputs). See
        ``ops/streamed.streamed_cholesky_factor``."""
        if storage not in (None, "bf16"):
            raise ConfigError(f"unknown factor storage {storage!r}")
        self._storage = storage
        return self

    def set_factor_precision(self, precision: Optional[str]) -> "GaussianProcessBuilder":
        """Matmul precision of every factorization of the model (build and
        fit rebuilds; streamed backend): None (default), 'bf16' (one pass of
        bfloat16-rounded operands), 'f32x3' or 'f32' (both near float32:
        the 3xTF32 product on the card, as None)."""
        if precision is not None and precision not in MATMUL_PRECISION_MODES:
            raise ConfigError(
                f"unknown factor precision {precision!r}; pick one of "
                f"{sorted(MATMUL_PRECISION_MODES)}"
            )
        self._precision = precision
        return self

    def set_panel_block(self, block) -> "GaussianProcessBuilder":
        """Panel width of the streamed backend's full-n build: a width
        (snapped to a divisor of the capacity), a schedule of widths summing
        to the capacity, or None for the default
        (``ops/partition.panel_widths``)."""
        widths = block if isinstance(block, (tuple, list)) else (block,)
        if block is not None and any(not isinstance(w, int) or w <= 0 for w in widths):
            raise ConfigError("panel block must be strictly positive")
        self._panel_block = block
        return self

    def set_fit_subsample(self, subsample) -> "GaussianProcessBuilder":
        """Fit strategy for ``train()``: ``"auto"`` (default — the full fit
        below n=24,576, else a ``max(8192, n // 5)`` random subset and ONE
        full-n factorization), an int (explicit subset size), or ``None``
        (the reference's full fit at any size)."""
        if subsample is not None and subsample != "auto":
            if not isinstance(subsample, int) or subsample <= 0:
                raise ConfigError(
                    f"fit subsample must be a positive int, 'auto', or "
                    f"None, got {subsample!r}"
                )
        self._fit_subsample = subsample
        return self

    def set_fit_polish(self, polish) -> "GaussianProcessBuilder":
        """Exact-LML corrective pass after the sub-fit ADAM: ``True`` runs
        :func:`~.map_fit.polish_map` (a short Adam on the exact LML) on the
        sub-model from the multiplicative ADAM's endpoint, before the
        full-n build. Default ``False``; only the sub-fit flow uses it."""
        if not isinstance(polish, bool):
            raise ConfigError(f"fit polish must be a bool, got {polish!r}")
        self._fit_polish = polish
        return self

    def set_fit_gradient(self, gradient: str) -> "GaussianProcessBuilder":
        """Gradient method for ``train()``'s fit: 'auto' (default: exact up
        to capacity 8,192, Hutchinson above), 'exact' or 'hutchinson'
        (``models/optimizer.fit_kernel_noise``)."""
        if gradient not in ("auto", "exact", "hutchinson"):
            raise ConfigError(f"unknown fit gradient {gradient!r}")
        self._fit_gradient = gradient
        return self

    # -- train (builder.rs:189-214) ----------------------------------------------

    def _new(self, prior, kernel, noise, x, y, **kw) -> GaussianProcess:
        return GaussianProcess.new(
            prior, kernel, noise, self._cholesky_epsilon, x, y,
            method=self._method, dtype=self._dtype, device=x.device, **kw,
        )

    def _new_full(self, prior, kernel, noise, x, y) -> GaussianProcess:
        """The full-n model with every backend and factor knob of the
        builder."""
        return self._new(
            prior, kernel, noise, x, y, capacity=self._capacity, backend=self._backend,
            panel_block=self._panel_block, storage=self._storage, precision=self._precision,
        )

    def train(self) -> GaussianProcess:
        x, y = self._x, self._y
        if self._dtype is not None:
            x = x.to(self._dtype)
            y = y.to(self._dtype)
        if self._storage == "bf16":
            if self._backend != "streamed":
                raise ConfigError("set_factor_storage('bf16') requires set_backend('streamed')")
            if x.dtype != torch.float32:
                raise ConfigError(
                    f"set_factor_storage('bf16') requires float32 inputs (got {x.dtype}; call "
                    f"set_dtype('float32') — parity mode defaults to float64 under enable_x64)"
                )
        self.timings = {}
        kernel = self._kernel
        if self._should_fit_kernel:
            t0 = _clock(x.device)
            kernel = kernel.heuristic_fit(x, y)
            self.timings["heuristic"] = _clock(x.device) - t0
            sub = self._resolved_subsample(x.shape[0])
            if sub is not None:
                return self._train_subfit_first(x, y, kernel, sub)
        t0 = _clock(x.device)
        gp = self._new_full(self._prior, kernel, self._noise, x, y)
        self.timings["build"] = _clock(x.device) - t0
        if self._should_fit_prior or self._should_fit_kernel:
            t0 = _clock(x.device)
            gp.fit_parameters(
                fit_prior=self._should_fit_prior,
                fit_kernel=self._should_fit_kernel,
                max_iter=self._max_iter,
                convergence_fraction=self._convergence_fraction,
                max_time=self._max_time,
                gradient=self._fit_gradient,
            )
            self.timings["fit"] = _clock(x.device) - t0
            self.timings["fit_iterations"] = gp.fit_iterations
        return gp

    def _resolved_subsample(self, n: int):
        """The effective sub-fit size for train(), or None for the
        reference flow."""
        sub = self._fit_subsample
        if sub == "auto":
            sub = auto_subsample(n)
        if sub is not None and sub >= n:
            sub = None
        return sub

    def _train_subfit_first(self, x, y, kernel, sub: int) -> GaussianProcess:
        """Subsampled training flow: fit hyperparameters on the subset
        FIRST, then build the full-n model exactly ONCE at the fitted
        parameters (the reference order would pay a full-n factorization
        at the heuristic parameters only to throw it away):

        1. prior fitted on the FULL data (kernel-independent), matching the
           reference's prior-before-kernel order inside ``fit_parameters``
           (``mod.rs:414-421``);
        2. kernel + noise fitted on a fixed-seed random subset (and
           polished, with ``set_fit_polish(True)``);
        3. ONE full-n build at the fitted hyperparameters, with every
           storage, precision and backend knob of the builder.

        The sub-model stores its factor in the input dtype. It takes the
        builder's factor precision where ``"auto"`` streams it; with bf16
        storage and no precision the JAX package gives it "f32", which on
        the card is the same arithmetic as None.
        """
        t0 = _clock(x.device)
        prior = self._prior
        if self._should_fit_prior:
            prior = prior.fit(x, y)
        idx = subset_indices(x.shape[0], sub, 0, x.device)
        streamed = resolve_backend("auto", sub, x.dtype, x.device) == "streamed"
        sub_gp = self._new(
            prior, kernel, self._noise, x[idx], y[idx], backend="auto",
            precision=self._precision if streamed else None,
        )
        sub_gp.fit_parameters(
            fit_prior=False,
            fit_kernel=True,
            max_iter=self._max_iter,
            convergence_fraction=self._convergence_fraction,
            max_time=self._max_time,
            gradient=self._fit_gradient,
        )
        self.timings["subfit"] = _clock(x.device) - t0
        self.timings["subfit_iterations"] = sub_gp.fit_iterations
        if self._fit_polish:
            from .map_fit import polish_map

            # short exact-LML corrective pass from the ADAM endpoint, at the
            # sub-model's size
            t0 = _clock(x.device)
            sub_gp = GaussianProcess(polish_map(sub_gp.state, precision=sub_gp.state.precision,
                                                max_time=self._max_time))
            self.timings["polish"] = _clock(x.device) - t0
        t0 = _clock(x.device)
        gp = self._new_full(prior, sub_gp.kernel, sub_gp.noise, x, y)
        self.timings["build"] = _clock(x.device) - t0
        return gp
