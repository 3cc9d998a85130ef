"""Hyperparameter densities over GP hyperparameters (counterpart of
``friedrich_tpu/mcmc/``): the exact-likelihood log-posterior that the MAP
fit (``models/map_fit.py``) maximizes. The samplers (NUTS, HMC) and
diagnostics of the JAX package are not ported yet (ROADMAP)."""

from .logprob import (
    initial_signs,
    initial_theta,
    make_hyperparam_logprob,
    make_streamed_hyperparam_logprob,
)

__all__ = [
    "initial_theta",
    "initial_signs",
    "make_hyperparam_logprob",
    "make_streamed_hyperparam_logprob",
]
