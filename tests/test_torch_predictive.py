"""The port's hyperparameter-marginalized predictive against the JAX
package's at the same draws: ``predictive_mixture`` with its own thinning
where it picks the JAX package's indices, ``sample_predictive`` with the JAX
package's indices and normals passed as ``indices=`` / ``z=``. A draw whose factorization fails is
among them: dropped from the mixture, its posterior mean in the samples.
float64 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import friedrich_tpu.kernels as jk
import friedrich_tpu.priors as jp
import friedrich_tpu_torch.kernels as tk
import friedrich_tpu_torch.priors as tp
from friedrich_tpu.mcmc import predictive as jpred
from friedrich_tpu.models import gp as jgp
from friedrich_tpu_torch import config
from friedrich_tpu_torch.mcmc import predictive as tpred
from friedrich_tpu_torch.models import gp as tgp

# The same builds, factorizations and solves in another library: rtol 1e-9.
RTOL = 1e-9
#: log [ls, ampl, noise] of a draw whose covariance is numerically rank one:
#: its factorization fails in both packages.
NON_PSD = [8.0, 0.0, -25.0]


@pytest.fixture(autouse=True)
def _port_on_cpu_in_f64():
    config.enable_x64()
    config.set_device("cpu")
    yield


def _problem(n=30, cap=36, seed=0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-3, 3, size=(n, 1)), axis=0)
    y = np.sin(x[:, 0]) + 0.2 * rng.normal(size=n)
    xq = np.linspace(-3.5, 3.5, 11)[:, None]
    jstate, _ = jgp.make_state(jk.SquaredExp(ls=1.0, ampl=1.0), jp.ConstantPrior(c=0.2), 0.3,
                               jnp.asarray(x), jnp.asarray(y), cap=cap)
    tstate, _ = tgp.make_state(tk.SquaredExp(ls=1.0, ampl=1.0), tp.ConstantPrior(c=0.2), 0.3,
                               torch.as_tensor(x), torch.as_tensor(y), cap=cap)
    # (12 draws, 2 chains, 3) around the state's hyperparameters; three
    # draws cannot be factored, the first flattened one among them
    thetas = np.log([1.0, 1.0, 0.3]) + 0.3 * rng.normal(size=(12, 2, 3))
    for s, c in ((0, 0), (5, 1), (9, 0)):
        thetas[s, c] = NON_PSD
    return jstate, tstate, thetas, xq


def test_the_non_psd_draw_fails_in_both_packages():
    jstate, tstate, _, _ = _problem()
    signs = np.ones(3)
    assert not bool(jpred._rebuild(jstate, jnp.asarray(NON_PSD), jnp.asarray(signs))[3])
    assert not bool(tpred._rebuild(tstate, torch.tensor([NON_PSD], dtype=torch.float64),
                                   torch.as_tensor(signs))[2][0])


@pytest.mark.parametrize("chunk_size", (1, 3))
@pytest.mark.parametrize("max_draws", (1, 7, 24))
def test_predictive_mixture_matches_jax(max_draws, chunk_size):
    jstate, tstate, thetas, xq = _problem()
    want_mean, want_var = jpred.predictive_mixture(jstate, jnp.asarray(thetas), jnp.asarray(xq),
                                                   max_draws=max_draws, chunk_size=chunk_size)
    # both thinnings pick the same draws here (the JAX package's float
    # linspace, truncated, against the port's integer floor)
    s = thetas.shape[0] * thetas.shape[1]
    take = min(max_draws, s)
    assert tpred._thin_indices(s, take) == np.array(jnp.linspace(0, s - 1, take).astype(jnp.int32)).tolist()
    mean, var = tpred.predictive_mixture(tstate, thetas, xq, max_draws=max_draws,
                                         chunk_size=chunk_size)
    # one draw: the failed one, so nothing is left to mix
    assert np.all(var.numpy() > 0) if max_draws > 1 else not np.any(var.numpy())
    np.testing.assert_allclose(mean.numpy(), np.asarray(want_mean), rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(var.numpy(), np.asarray(want_var), rtol=RTOL, atol=1e-12)


def test_predictive_mixture_thins_evenly_and_drops_failed_draws():
    _, tstate, thetas, xq = _problem()
    flat = thetas.reshape(-1, 3)
    # 24 draws thinned to 7: the exact integer thinning i * 23 // 6; 100 to
    # 64: first and last kept, steps of 1 or 2
    picked = [0, 3, 7, 11, 15, 19, 23]
    assert tpred._thin_indices(24, 7) == picked
    spread = tpred._thin_indices(100, 64)
    assert spread[0] == 0 and spread[-1] == 99 and set(np.diff(spread)) == {1, 2}
    assert tpred._thin_indices(5, 1) == [0] and tpred._thin_indices(5, 5) == list(range(5))
    default = tpred.predictive_mixture(tstate, thetas, xq, max_draws=7)
    explicit = tpred.predictive_mixture(tstate, flat[picked], xq, max_draws=7)
    assert all(torch.equal(a, b) for a, b in zip(default, explicit))
    # the failed draw (index 0) counts for nothing
    without = tpred.predictive_mixture(tstate, flat[picked[1:]], xq, max_draws=7)
    for a, b in zip(default, without):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("chunk_size", (4, 40))
def test_sample_predictive_matches_jax(chunk_size):
    jstate, tstate, thetas, xq = _problem()
    key = jax.random.PRNGKey(6)
    want = jpred.sample_predictive(jstate, jnp.asarray(thetas), jnp.asarray(xq), key, num_draws=40,
                                   chunk_size=chunk_size)
    # the JAX package's indices and normals (friedrich_tpu/mcmc/predictive.py:122-125)
    key_idx, key_norm = jax.random.split(key)
    idx = np.array(jax.random.randint(key_idx, (40,), 0, thetas.shape[0] * thetas.shape[1]))
    z = np.array(jax.random.normal(key_norm, (40, xq.shape[0]), jnp.float64))
    failed = np.isin(idx, [0, 11, 18])  # flattened positions of the NON_PSD draws
    assert failed.any() and not failed.all()
    got = tpred.sample_predictive(tstate, thetas, xq, num_draws=40, chunk_size=chunk_size,
                                  indices=idx, z=z)
    assert got.shape == (40, xq.shape[0])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-12)


def test_sample_predictive_draws_from_its_generator():
    _, tstate, thetas, xq = _problem()
    a = tpred.sample_predictive(tstate, thetas, xq, 3, num_draws=9)
    b = tpred.sample_predictive(tstate, thetas, xq, torch.Generator().manual_seed(3), num_draws=9)
    assert a.shape == (9, 11) and torch.equal(a, b) and bool(torch.isfinite(a).all())
    with pytest.raises(ValueError, match="needs a generator"):
        tpred.sample_predictive(tstate, thetas, xq, num_draws=9)
