"""Model layer (L3): GP state, prediction, fitting, sampling, builder."""

from .api import GaussianProcess
from .builder import GaussianProcessBuilder
from .gp import (
    GPState,
    PredictWeights,
    add_samples_padded,
    add_samples_rebuild,
    derive_weights,
    likelihood,
    log_marginal_likelihood,
    make_state,
    posterior,
    predict_covariance,
    predict_mean,
    predict_mean_variance,
    predict_variance,
    rebuild_cholesky,
)
from .multivariate_normal import MultivariateNormal
from .optimizer import fit_kernel_noise, fit_parameters
from .outofcore_gp import OutOfCoreGP

__all__ = [
    "GaussianProcess",
    "GaussianProcessBuilder",
    "GPState",
    "PredictWeights",
    "derive_weights",
    "MultivariateNormal",
    "OutOfCoreGP",
    "add_samples_padded",
    "add_samples_rebuild",
    "likelihood",
    "log_marginal_likelihood",
    "make_state",
    "posterior",
    "predict_covariance",
    "predict_mean",
    "predict_mean_variance",
    "predict_variance",
    "rebuild_cholesky",
    "fit_kernel_noise",
    "fit_parameters",
]
