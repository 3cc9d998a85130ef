"""The port's warmup adaptation (dual averaging of the step size, pooled
Welford diagonal mass, two phases) against the JAX package's, driven by a
deterministic step function: an acceptance statistic that is a fixed
function of the step size and positions that move deterministically (a
contraction, so that rounding does not grow over the steps).
float64 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from friedrich_tpu.mcmc import _adapt as ja
from friedrich_tpu_torch.mcmc import _adapt as ta

# The same scalar recursions on the host and in XLA: rtol 1e-12.
RTOL = 1e-12
CHAINS, DIM = 3, 4
SCALES = np.array([0.5, 1.0, 2.0, 4.0])


def _jax_step(carry, eps, inv_mass, key):
    del key
    theta, t = carry
    phase = 0.3 * t + eps + 0.5 * jnp.arange(CHAINS)
    theta = 0.6 * theta + jnp.sin(phase)[:, None] * jnp.sqrt(inv_mass) * SCALES
    alpha = 1.0 / (1.0 + (eps * (1.0 + 0.5 * jnp.arange(CHAINS))) ** 2)
    return (theta, t + 1.0), alpha


def _torch_step(carry, eps, inv_mass):
    theta, t = carry
    phase = 0.3 * t + eps + 0.5 * torch.arange(CHAINS, dtype=torch.float64)
    theta = 0.6 * theta + torch.sin(phase)[:, None] * torch.sqrt(inv_mass) * torch.as_tensor(SCALES)
    alpha = 1.0 / (1.0 + (eps * (1.0 + 0.5 * torch.arange(CHAINS, dtype=torch.float64))) ** 2)
    return (theta, t + 1.0), alpha


HOOKS = {
    "local": (None, None),
    # as if each statistic were pooled over two devices holding the same chains
    "pooled": (lambda v: v, lambda v: 2.0 * v),
}


@pytest.mark.parametrize("hooks", HOOKS)
@pytest.mark.parametrize("num_warmup,init_step_size", [(2, 0.1), (13, 0.3), (120, 0.05)])
def test_warmup_matches_jax(num_warmup, init_step_size, hooks):
    theta0 = np.random.default_rng(num_warmup).normal(size=(CHAINS, DIM))
    pool_mean, pool_sum = HOOKS[hooks]
    want = ja.dual_averaging_warmup(
        _jax_step, (jnp.asarray(theta0), jnp.asarray(0.0)), lambda c: c[0], num_warmup, DIM,
        jnp.float64, jax.random.PRNGKey(0), init_step_size, pool_mean, pool_sum)
    got = ta.dual_averaging_warmup(
        _torch_step, (torch.as_tensor(theta0), 0.0), lambda c: c[0], num_warmup, init_step_size,
        pool_mean, pool_sum)
    np.testing.assert_allclose(got.step_size, float(want.step_size), rtol=RTOL)
    np.testing.assert_allclose(got.inv_mass.numpy(), np.asarray(want.inv_mass), rtol=RTOL)
    np.testing.assert_allclose(got.carry[0].numpy(), np.asarray(want.carry[0]), rtol=RTOL, atol=1e-13)
    assert got.carry[1] == float(want.carry[1])


def test_warmup_keeps_the_identity_mass_below_three_draws():
    # two warmup steps: one Welford step of 3 chains, count 3 > 2; with one
    # chain the count stays at 1 and the mass stays the identity
    def step(theta, eps, inv_mass):
        return 0.5 * theta + eps, torch.ones(1, dtype=torch.float64)

    got = ta.dual_averaging_warmup(step, torch.ones((1, DIM), dtype=torch.float64), lambda c: c, 2)
    assert torch.equal(got.inv_mass, torch.ones(DIM, dtype=torch.float64))


def test_generator_draws_and_value_and_grad():
    gen_a, gen_b = ta.as_generator(7), torch.Generator().manual_seed(7)
    assert ta.as_generator(gen_b) is gen_b
    a, b = ta.GeneratorDraws(gen_a), ta.GeneratorDraws(gen_b)
    assert [a.uniform(), a.direction(), a.leaf_uniform()] == [b.uniform(), b.direction(),
                                                              b.leaf_uniform()]
    assert torch.equal(a.momentum(5), b.momentum(5))
    val_grad = ta.value_and_grad(lambda x: -0.5 * torch.sum(x * x))
    val, grad = val_grad(torch.tensor([1.0, -2.0], dtype=torch.float64))
    assert float(val) == -2.5 and torch.equal(grad, torch.tensor([-1.0, 2.0], dtype=torch.float64))
    assert not val.requires_grad and not grad.requires_grad
