"""MCMC over GP hyperparameters (counterpart of ``friedrich_tpu/mcmc/``):
exact-likelihood densities, NUTS and HMC with pooled warmup adaptation,
convergence diagnostics, and the predictive marginalized over the draws.
The multi-device samplers and densities of the JAX package
(``mcmc/sharded.py``, ``mcmc/distributed_logprob.py``) are not ported yet
(ROADMAP A15)."""

from .diagnostics import ess, rhat, summary
from .hmc import HMCResult, sample_hmc
from .logprob import (
    initial_signs,
    initial_theta,
    make_hyperparam_logprob,
    make_streamed_hyperparam_logprob,
)
from .nuts import NUTSResult, sample_nuts
from .predictive import predictive_mixture, sample_predictive


def sample_hyperparameters(
    gp_or_state,
    generator,
    num_warmup: int = 300,
    num_samples: int = 500,
    num_chains: int = 4,
    sampler: str = "nuts",
    backend: str = "auto",
    precision: str | None = None,
    num_probes: int = 16,
    **kwargs,
):
    """Posterior over the log-hyperparameters of a trained GP.

    Takes a ``GaussianProcess`` or a ``GPState``; ``generator`` is a CPU
    ``torch.Generator`` or an int seed. ``sampler`` is ``"nuts"`` (default)
    or ``"hmc"``; the other keywords go to :func:`sample_nuts` or
    :func:`sample_hmc`. Samples are log([kernel params..., noise]), with
    each parameter's sign fixed at its current one. ``backend`` picks the
    density's factorization (``"dense"``, ``"streamed"`` or ``"auto"`` by
    capacity — see :func:`make_hyperparam_logprob`), ``precision`` its
    float32 matmul precision and ``num_probes`` the streamed density's
    Hutchinson probes (the JAX package's 16 by default).
    """
    if sampler not in ("nuts", "hmc"):
        raise ValueError(f"unknown sampler {sampler!r}")
    state = getattr(gp_or_state, "state", gp_or_state)
    logp = make_hyperparam_logprob(state, signs=initial_signs(state), backend=backend,
                                   num_probes=num_probes, precision=precision)
    fn = sample_nuts if sampler == "nuts" else sample_hmc
    return fn(logp, initial_theta(state), generator, num_warmup=num_warmup,
              num_samples=num_samples, num_chains=num_chains, **kwargs)


__all__ = [
    "ess",
    "rhat",
    "summary",
    "HMCResult",
    "sample_hmc",
    "NUTSResult",
    "sample_nuts",
    "initial_theta",
    "initial_signs",
    "make_hyperparam_logprob",
    "make_streamed_hyperparam_logprob",
    "sample_hyperparameters",
    "predictive_mixture",
    "sample_predictive",
]
