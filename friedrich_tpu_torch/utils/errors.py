"""Structured errors, with the JAX package's messages.

The reference library handles failure by panicking (``expect``) — e.g.
``algebra/mod.rs:90`` (Cholesky), ``gaussian_process/mod.rs:203,263,345``
(triangular solves), ``multivariate_normal.rs:57`` (sampler Cholesky),
``prior.rs:148`` (linear-prior SVD solve). These typed exceptions let
callers recover (e.g. retry with ``cholesky_epsilon``).
"""

from __future__ import annotations


class FriedrichError(Exception):
    """Base class for all friedrich errors."""


class CholeskyError(FriedrichError):
    """Cholesky factorization produced non-finite values.

    Mirrors the panic at reference ``algebra/mod.rs:90``; the message points
    users at ``cholesky_epsilon`` exactly like the reference does.
    """

    def __init__(self, msg: str | None = None):
        super().__init__(
            msg
            or "Cholesky decomposition failed; consider setting "
            "`cholesky_epsilon` via the GaussianProcessBuilder. On TPU in "
            "float32, also consider `set_factor_precision('f32x3'|'f32')`: "
            "the default MXU mode rounds matmul operands to bfloat16, "
            "which cannot factor densely-correlated covariances (e.g. "
            "heuristic lengthscales at large n) with small noise."
        )


class ShapeError(FriedrichError):
    """Input shapes are inconsistent with the model/training data."""


class ConfigError(FriedrichError):
    """Invalid configuration value (negative noise, bad epsilon, ...)."""


def not_ported(what: str) -> ConfigError:
    """The error for a path of the JAX package this port does not run yet."""
    return ConfigError(
        f"{what} is not yet ported to friedrich_tpu_torch; see ROADMAP.md"
    )
