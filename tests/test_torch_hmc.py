"""The port's HMC against the JAX package's.

One step, fed the JAX package's key schedule through a replaying draws
object, gives JAX's position, density, gradient and acceptance statistic:
on a correlated Gaussian, on the dense and the streamed GP densities, and
on a density that is -inf on a region (the reject path). Whole runs
recover the analytic moments of a correlated Gaussian and the
grid-quadrature moments of a GP hyperparameter posterior within their
Monte-Carlo error. float64 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from friedrich_tpu.mcmc import hmc as jhmc
from friedrich_tpu_torch import config
from friedrich_tpu_torch.mcmc import _adapt as tadapt
from friedrich_tpu_torch.mcmc import hmc as thmc
from friedrich_tpu_torch.mcmc import rhat, sample_hyperparameters
from test_torch_nuts import (
    PREC,
    _gaussian,
    _gp_densities,
    _minus_inf_region,
    example_problem,
    moments_within_mcse,
    quadrature_moments,
)

# One step: num_leapfrog leapfrogs in another library, rounding only.
RTOL = 1e-9
JITTER = 0.2


@pytest.fixture(autouse=True)
def _port_on_cpu_in_f64():
    config.enable_x64()
    config.set_device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class JaxHmcDraws:
    """The numbers of one JAX step of one chain: the split of its key into
    momentum, accept and jitter keys (``friedrich_tpu/mcmc/hmc.py:168-178``)."""

    def __init__(self, key):
        self.k_mom, self.k_acc, self.k_jit = jax.random.split(key, 3)

    def jitter_uniform(self):
        return float(jax.random.uniform(self.k_jit, (), jnp.float64))

    def momentum(self, dim):
        return torch.as_tensor(np.array(jax.random.normal(self.k_mom, (dim,), jnp.float64)))

    def accept_uniform(self):
        return float(jax.random.uniform(self.k_acc, (), jnp.float64))


def _chain_key(seed):
    """The key of chain 0's first step in ``sample_hmc`` with explicit
    starts and adaptation (no jitter of the starts, no warmup):
    ``friedrich_tpu/mcmc/hmc.py:189-192, 212-213``."""
    _, ks = jax.random.split(jax.random.PRNGKey(seed))
    return jax.random.split(jax.random.split(ks, 1)[0], 1)[0]


# (target, start, step size, inverse mass, leapfrogs, seeds)
CASES = {
    "gaussian": (_gaussian, [0.5, -0.3], 0.3, [1.0, 0.7], 10, (0, 1, 2)),
    "minus_inf_region": (_minus_inf_region, [0.59, 0.1], 0.1, [1.0, 1.0], 10, (3, 4, 8, 9)),
    "gp_dense": ("dense", None, 0.02, [1.0, 1.0, 1.0], 8, (5,)),
    "gp_streamed": ("streamed", None, 0.005, [1.0, 1.0, 1.0], 8, (10,)),
}


@pytest.mark.parametrize("case", CASES)
def test_replayed_step_matches_jax(case, monkeypatch):
    target, start, eps, inv_mass, num_leapfrog, seeds = CASES[case]
    if isinstance(target, str):
        jlogp, tlogp, start = _gp_densities(target, monkeypatch)
    else:
        jlogp, tlogp = target()
    z0 = np.asarray(start, dtype=np.float64)
    im = np.asarray(inv_mass, dtype=np.float64)
    val_grad = tadapt.value_and_grad(tlogp)
    logp0, g0 = val_grad(torch.as_tensor(z0))
    accepted = []
    for seed in seeds:
        want = jhmc.sample_hmc(jlogp, jnp.asarray(z0)[None], jax.random.PRNGKey(seed), num_samples=1,
                               num_chains=1, num_leapfrog=num_leapfrog, jitter=JITTER, step_size=eps,
                               inv_mass=jnp.asarray(im))
        theta, logp, g, accept = thmc.hmc_step(val_grad, torch.as_tensor(z0), logp0, g0, eps,
                                               torch.as_tensor(im), num_leapfrog, JITTER,
                                               JaxHmcDraws(_chain_key(seed)))
        jtheta = np.asarray(want.samples[0, 0])
        np.testing.assert_allclose(theta.numpy(), jtheta, rtol=RTOL, atol=1e-12)
        np.testing.assert_allclose(float(logp), float(want.final_logp[0]), rtol=RTOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(jax.grad(jlogp)(jnp.asarray(jtheta))),
                                   rtol=RTOL, atol=1e-12)
        np.testing.assert_allclose(accept, float(want.accept_prob[0, 0]), rtol=RTOL, atol=1e-14)
        accepted.append(not np.array_equal(jtheta, z0))
    # the -inf region rejects (a step into it has log_accept -inf); the
    # others move
    assert not all(accepted) if case == "minus_inf_region" else any(accepted)


def test_hmc_recovers_a_correlated_gaussian():
    res = thmc.sample_hmc(_gaussian()[1], torch.zeros(2, dtype=torch.float64), 0, num_warmup=200,
                          num_samples=400, num_chains=4, num_leapfrog=8)
    moments_within_mcse(res.samples, [0.0, 0.0], np.linalg.inv(PREC))
    assert float(res.accept_prob.mean()) > 0.5
    assert bool(torch.all(rhat(res.samples) < 1.1))
    assert res.final_logp.shape == (4,) and res.inv_mass.shape == (2,)


def test_hmc_resumes_from_a_previous_adaptation():
    logp = _gaussian()[1]
    first = thmc.sample_hmc(logp, torch.zeros(2, dtype=torch.float64), 0, num_warmup=50,
                            num_samples=5, num_chains=2, num_leapfrog=4)
    calls = []
    resumed = thmc.sample_hmc(lambda x: calls.append(1) or logp(x), first.samples[-1], 1,
                              num_samples=3, num_chains=2, num_leapfrog=4,
                              step_size=first.step_size, inv_mass=first.inv_mass)
    # no warmup: two starting densities and 4 leapfrogs per chain per step
    assert len(calls) == 2 + 3 * 2 * 4
    assert torch.equal(resumed.step_size, first.step_size)
    assert torch.equal(resumed.inv_mass, first.inv_mass)


def test_hmc_gp_posterior_matches_grid_quadrature():
    _, _, state = example_problem()
    mean, cov = quadrature_moments()
    res = sample_hyperparameters(state, 2, num_warmup=100, num_samples=200, num_chains=2,
                                 sampler="hmc", num_leapfrog=6)
    moments_within_mcse(res.samples, mean, cov)
    with pytest.raises(ValueError, match="unknown sampler"):
        sample_hyperparameters(state, 2, sampler="mala")
