"""Posterior sampler: multivariate normal over query points.

Counterpart of ``friedrich_tpu/models/multivariate_normal.py`` and of the
reference's ``MultivariateNormal``
(``gaussian_process/multivariate_normal.rs:44-74``): stores the mean and the
Cholesky factor of the posterior covariance; ``sample = mean + L z`` with
``z ~ N(0, I)`` drawn from an explicit ``torch.Generator``. A failed
covariance factorization raises :class:`CholeskyError` (the reference
panics, ``multivariate_normal.rs:57``, with no epsilon fallback).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..conversion import OutputAdapter
from ..ops.cholesky import cholesky
from ..utils.errors import CholeskyError


class MultivariateNormal:
    """Sampleable posterior distribution at fixed query points."""

    def __init__(self, mean: torch.Tensor, covariance: torch.Tensor,
                 adapter: OutputAdapter | None = None):
        self._mean = mean
        l_mat, _ = cholesky(covariance)
        if not bool(torch.all(torch.isfinite(torch.diagonal(l_mat)))):
            raise CholeskyError(
                "MultivariateNormal: Cholesky decomposition of the posterior "
                "covariance failed (it is numerically non-PSD). Add noise or "
                "query fewer/better-separated points."
            )
        self._chol = l_mat
        self._adapter = adapter or OutputAdapter("torch")

    def mean(self):
        """The distribution mean (``multivariate_normal.rs:62-65``)."""
        return self._adapter.vector(self._mean)

    def _normal(self, shape, generator: Optional[torch.Generator]) -> torch.Tensor:
        device = generator.device if generator is not None else self._mean.device
        z = torch.randn(shape, generator=generator, dtype=self._mean.dtype, device=device)
        return z.to(self._mean.device)

    def sample(self, generator: Optional[torch.Generator] = None):
        """One draw: ``mean + L z`` (``multivariate_normal.rs:68-73``)."""
        z = self._normal(self._mean.shape, generator)
        return self._adapter.vector(self._mean + self._chol @ z)

    def sample_n(self, generator: Optional[torch.Generator], num: int) -> torch.Tensor:
        """``num`` draws at once, shape (num, m)."""
        z = self._normal((num,) + tuple(self._mean.shape), generator)
        return self._mean[None, :] + z @ self._chol.mT
