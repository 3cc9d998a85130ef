"""The exact-likelihood densities and MAP fit of the PyTorch port against the
JAX package: both densities' values and gradients (the streamed one with
the JAX package's probes), the covariance build's backward
(``TrainCovarianceFn``), ``fit_map`` and ``polish_map``, and the builder's
polish and Hutchinson options. float64 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import friedrich_tpu as jft
import friedrich_tpu.kernels as jk
import friedrich_tpu.priors as jp
import friedrich_tpu_torch as tft
import friedrich_tpu_torch.kernels as tk
import friedrich_tpu_torch.priors as tp
from friedrich_tpu.mcmc import logprob as jlogprob
from friedrich_tpu.models import gp as jgp
from friedrich_tpu.models import map_fit as jmap
from friedrich_tpu.ops.covariance import train_covariance_padded as j_train_cov
from friedrich_tpu_torch import config
from friedrich_tpu_torch.mcmc import logprob as tlogprob
from friedrich_tpu_torch.models import builder as tbuilder
from friedrich_tpu_torch.models import gp as tgp
from friedrich_tpu_torch.models import large_fit as tlf
from friedrich_tpu_torch.models import map_fit as tmap
from friedrich_tpu_torch.ops import covariance as tcov
from friedrich_tpu_torch.ops.cholesky import cholesky_with_substitute, cholesky_with_substitute_functional

# A density and its gradient: the same build, factorization and solves in
# another order, so rtol 1e-9. The covariance's backward: 1e-10. A whole
# Adam run compounds over its steps: final theta at rtol 1e-8. The
# builder's flows (fit, then build) as tests/test_torch_fit.py: 1e-7.
RTOL_DENSITY = 1e-9
TOL_BACKWARD = 1e-10
RTOL_THETA = 1e-8
RTOL_FLOW = 1e-7


@pytest.fixture(autouse=True)
def _port_on_cpu_in_f64():
    config.enable_x64()
    config.set_device("cpu")
    yield


KERNELS = {
    "SquaredExp": lambda m: m.SquaredExp(ls=0.9, ampl=1.2),
    "RationalQuadratic": lambda m: m.RationalQuadratic(alpha=1.1, ls=0.8),
    "Sum": lambda m: m.Matern1(ls=1.1, ampl=0.7) + m.Linear(c=0.4),
}


def _data(n, d=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    y = np.sin(x[:, 0]) + 0.5 * np.cos(x[:, 1]) + 0.1 * rng.normal(size=n)
    return x, y


def _states(name, n=60, cap=64, noise=0.3, eps=None, seed=0):
    x, y = _data(n, seed=seed)
    kf = KERNELS[name]
    jstate, ok = jgp.make_state(kf(jk), jp.ConstantPrior(c=0.1), noise, jnp.asarray(x),
                                jnp.asarray(y), cap=cap, eps=eps)
    assert bool(ok)
    tstate, ok = tgp.make_state(kf(tk), tp.ConstantPrior(c=0.1), noise, torch.as_tensor(x),
                                torch.as_tensor(y), cap=cap, eps=eps)
    assert bool(ok)
    return jstate, tstate


def _jax_density_probes(jstate, num_probes, seed):
    """The probes of the JAX package's streamed density
    (``friedrich_tpu/mcmc/logprob.py:255-258``) as numpy."""
    z = jnp.sign(jax.random.normal(jax.random.PRNGKey(seed), (jstate.capacity, num_probes),
                                   dtype=jstate.x.dtype))
    return np.array(jnp.where((jnp.arange(jstate.capacity) < jstate.n)[:, None], z, 0.0))


def _value_and_grad(logp, theta):
    theta = torch.as_tensor(theta).clone().requires_grad_(True)
    val = logp(theta)
    val.backward()
    return float(val.detach()), theta.grad.numpy()


@pytest.mark.parametrize("eps", (None, 1e-6), ids=("plain", "eps"))
@pytest.mark.parametrize("backend", ("dense", "streamed"))
@pytest.mark.parametrize("name", KERNELS)
def test_density_value_and_gradient_match_jax(name, backend, eps):
    jstate, tstate = _states(name, eps=eps)
    signs = np.array(jlogprob.initial_signs(jstate))
    theta = np.asarray(jlogprob.initial_theta(jstate)) + 0.05
    jlogp = jlogprob.make_hyperparam_logprob(jstate, prior_sigma=3.0, signs=signs, backend=backend,
                                             num_probes=6)
    want_val, want_grad = jax.value_and_grad(jlogp)(jnp.asarray(theta))
    probes = _jax_density_probes(jstate, 6, 0) if backend == "streamed" else None
    tlogp = tlogprob.make_hyperparam_logprob(tstate, prior_sigma=3.0, signs=signs, backend=backend,
                                             probes=probes)
    val, grad = _value_and_grad(tlogp, theta)
    np.testing.assert_allclose(val, float(want_val), rtol=RTOL_DENSITY)
    np.testing.assert_allclose(grad, np.asarray(want_grad), rtol=RTOL_DENSITY, atol=1e-12)


@pytest.mark.parametrize("backend", ("dense", "streamed"))
def test_density_is_minus_infinity_where_the_factorization_fails(backend):
    x, y = _data(40, seed=1)
    state, ok = tgp.make_state(tk.Linear(c=1.0), tp.ConstantPrior(c=0.0), 0.1, torch.as_tensor(x),
                               torch.as_tensor(y))
    assert bool(ok)
    # c held negative by its sign: K = X X^T - 50 + noise^2 I is indefinite
    signs = torch.tensor([-1.0, 1.0], dtype=torch.float64)
    theta = torch.log(torch.tensor([50.0, 0.1], dtype=torch.float64)).requires_grad_(True)
    val = tlogprob.make_hyperparam_logprob(state, signs=signs, backend=backend)(theta)
    assert float(val.detach()) == -np.inf
    val.backward()  # the fits replace a non-finite gradient by zero


def test_density_backend_auto_and_initial_theta():
    jstate, tstate = _states("Sum")
    np.testing.assert_allclose(tlogprob.initial_theta(tstate).numpy(),
                               np.asarray(jlogprob.initial_theta(jstate)), rtol=1e-15)
    np.testing.assert_array_equal(tlogprob.initial_signs(tstate).numpy(),
                                  np.asarray(jlogprob.initial_signs(jstate)))
    assert tlogprob.STREAMED_LOGPROB_THRESHOLD == jlogprob.STREAMED_LOGPROB_THRESHOLD == 2048
    with pytest.raises(ValueError, match="unknown logprob backend"):
        tlogprob.make_hyperparam_logprob(tstate, backend="tiled")


def test_functional_substitute_cholesky_equals_the_in_place_one():
    rng = np.random.default_rng(5)
    a = rng.normal(size=(150, 100))
    k = torch.as_tensor(a @ a.T / 100)  # rank 100: the last pivots are substituted
    want = cholesky_with_substitute(k, 1e-3, block=64)
    got = cholesky_with_substitute_functional(k.clone().requires_grad_(True), 1e-3, block=64)
    assert bool(torch.isfinite(want).all()) and float(want[-1, -1]) == np.sqrt(1e-3)
    assert torch.equal(got.detach(), want)
    got.sum().backward()  # autograd runs through it


BACKWARD_KERNELS = {
    "SquaredExp": lambda m: m.SquaredExp(ls=0.9, ampl=1.3),
    "Matern2": lambda m: m.Matern2(ls=1.1, ampl=0.7),
    "Multiquadric": lambda m: m.Multiquadric(c=0.7),
    "Composite": lambda m: m.Matern2(ls=1.1, ampl=0.7) * m.RationalQuadratic(alpha=1.5, ls=1.2)
    + m.Linear(c=0.4) * m.SquaredExp(ls=0.9, ampl=1.3),
}


@pytest.mark.parametrize("strip", (1 << 22, 2000), ids=("whole", "strips"))
@pytest.mark.parametrize("name", BACKWARD_KERNELS)
def test_train_covariance_backward_matches_autograd_and_jax(name, strip, monkeypatch):
    monkeypatch.setattr(tcov, "BACKWARD_STRIP_ENTRIES", strip)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(90, 4))
    g = rng.normal(size=(90, 90))
    n, noise = 80, 0.3
    kernel = BACKWARD_KERNELS[name](tk).to(torch.float64, "cpu")
    params = kernel.get_params().clone().requires_grad_(True)
    nz = torch.tensor(noise, dtype=torch.float64, requires_grad=True)
    xt = torch.as_tensor(x)
    k = tcov.TrainCovarianceFn.apply(params, nz, kernel, xt, n, "gram")
    torch.testing.assert_close(k.detach(), tcov.train_covariance_padded(kernel, xt, n, noise),
                               rtol=0, atol=0)
    gp, gn = torch.autograd.grad(torch.sum(torch.as_tensor(g) * k), (params, nz))
    # autograd through the plain builder
    p2 = params.detach().clone().requires_grad_(True)
    n2 = nz.detach().clone().requires_grad_(True)
    k2 = tcov.plain_train_covariance_padded(kernel.with_params(p2), xt, n, n2)
    wp, wn = torch.autograd.grad(torch.sum(torch.as_tensor(g) * k2), (p2, n2))
    np.testing.assert_allclose(gp.numpy(), wp.numpy(), rtol=TOL_BACKWARD, atol=TOL_BACKWARD)
    np.testing.assert_allclose(float(gn), float(wn), rtol=TOL_BACKWARD)
    # jax.grad through the JAX package's build
    jkernel = BACKWARD_KERNELS[name](jk)

    def jloss(p, s):
        return jnp.sum(jnp.asarray(g) * j_train_cov(jkernel.with_params(p), jnp.asarray(x), n, s))

    jp_, jn_ = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(params.detach().numpy()), noise)
    np.testing.assert_allclose(gp.numpy(), np.asarray(jp_), rtol=TOL_BACKWARD, atol=TOL_BACKWARD)
    np.testing.assert_allclose(float(gn), float(jn_), rtol=TOL_BACKWARD)


# The analytic reference of the backward (the smoke and the card's tests
# hold the backward to it) for the kernels whose pointwise gradients are
# their maps' derivatives.
@pytest.mark.parametrize("name", ("SquaredExp", "Sum"))
def test_analytic_covariance_grads_match_the_backward(name):
    rng = np.random.default_rng(8)
    x = torch.as_tensor(rng.normal(size=(70, 4)))
    g = torch.as_tensor(rng.normal(size=(70, 70)))
    kernel = KERNELS[name](tk).to(torch.float64, "cpu")
    params = kernel.get_params().clone().requires_grad_(True)
    nz = torch.tensor(0.3, dtype=torch.float64, requires_grad=True)
    k = tcov.TrainCovarianceFn.apply(params, nz, kernel, x, 61, "gram")
    gp, gn = torch.autograd.grad(torch.sum(g * k), (params, nz))
    wp, wn = tcov.analytic_train_covariance_grads(kernel, x, 61, 0.3, g)
    np.testing.assert_allclose(gp.numpy(), wp.numpy(), rtol=TOL_BACKWARD, atol=TOL_BACKWARD)
    np.testing.assert_allclose(float(gn), float(wn), rtol=TOL_BACKWARD)


@pytest.mark.parametrize("which", ("fit_map", "polish_map"))
def test_map_fits_refuse_a_capacity_where_two_factors_do_not_fit(which, monkeypatch):
    _, tstate = _states("SquaredExp", n=60, cap=64, seed=3)
    # a card on which one 64 x 64 float64 factor fits but not two
    monkeypatch.setattr(config, "device_memory_bytes", lambda device=None: 2 * 64 * 64 * 8)
    with pytest.raises(tft.ConfigError, match="two .* factors cannot coexist"):
        getattr(tmap, which)(tstate, num_steps=2)
    monkeypatch.setattr(config, "device_memory_bytes", lambda device=None: 4 * 64 * 64 * 8)
    getattr(tmap, which)(tstate, num_steps=2)


def _theta(kernel, noise):
    return np.log(np.abs(np.concatenate([np.asarray(kernel.get_params(), dtype=np.float64),
                                         [float(noise)]])))


@pytest.mark.parametrize("backend", ("dense", "streamed"))
@pytest.mark.parametrize("which", ("fit_map", "polish_map"))
def test_map_fits_match_jax(which, backend, monkeypatch):
    if backend == "streamed":
        # reach the streamed density at a test size on both sides
        monkeypatch.setattr(jlogprob, "STREAMED_LOGPROB_THRESHOLD", 32)
        monkeypatch.setattr(tlogprob, "STREAMED_LOGPROB_THRESHOLD", 32)
    jstate, tstate = _states("Sum", n=56, cap=64, seed=2)
    kwargs = dict(num_steps=12) if which == "fit_map" else dict(num_steps=8)
    jfit = getattr(jmap, which)(jstate, **kwargs)
    probes = _jax_density_probes(jstate, 16, 0)
    tfit = getattr(tmap, which)(tstate, probes=probes, **kwargs)
    np.testing.assert_allclose(_theta(tfit.kernel, tfit.noise), _theta(jfit.kernel, jfit.noise),
                               rtol=RTOL_THETA)
    np.testing.assert_allclose(tfit.l.numpy(), np.asarray(jfit.l), rtol=RTOL_THETA, atol=1e-10)


def test_fit_map_with_a_hyperprior_matches_jax():
    jstate, tstate = _states("SquaredExp", n=50, cap=50, seed=4)
    jfit = jmap.fit_map(jstate, num_steps=10, learning_rate=0.1, prior_sigma=0.5)
    tfit = tmap.fit_map(tstate, num_steps=10, learning_rate=0.1, prior_sigma=0.5)
    np.testing.assert_allclose(_theta(tfit.kernel, tfit.noise), _theta(jfit.kernel, jfit.noise),
                               rtol=RTOL_THETA)


def test_facade_fit_map_matches_jax():
    x, y = _data(40, seed=6)
    jgp_ = jft.GaussianProcess.new(jp.ConstantPrior(c=0.0), jk.SquaredExp(), 0.2, None, x, y)
    tgp_ = tft.GaussianProcess.new(tp.ConstantPrior(c=0.0), tk.SquaredExp(), 0.2, None, x, y)
    jgp_.fit_map(num_steps=15)
    tgp_.fit_map(num_steps=15)
    np.testing.assert_allclose(_theta(tgp_.kernel, tgp_.noise), _theta(jgp_.kernel, jgp_.noise),
                               rtol=RTOL_THETA)
    xq = np.random.default_rng(7).normal(size=(5, 3))
    np.testing.assert_allclose(tgp_.predict(xq), jgp_.predict(xq), rtol=RTOL_THETA)


def _same_subset(monkeypatch, n, sub):
    # the JAX builder draws its subset from jax.random; hand the port the
    # same indices (its own draw comes from a torch.Generator)
    jidx = np.sort(np.asarray(jax.random.permutation(jax.random.PRNGKey(0), n)[:sub]))
    monkeypatch.setattr(tbuilder, "subset_indices",
                        lambda n_, s, seed, device: torch.as_tensor(jidx, device=device))


@pytest.mark.parametrize("option", ("polish", "hutchinson"))
def test_builder_options_match_jax(option, monkeypatch):
    n, sub = 90, 40
    x, y = _data(n, seed=8)
    xq = np.random.default_rng(9).normal(size=(7, 3))
    _same_subset(monkeypatch, n, sub)
    jb = (jft.GaussianProcessBuilder(x, y).set_noise(0.3).set_capacity(96).set_fit_subsample(sub)
          .set_fit_parameters(100, 0.05).fit_kernel().fit_prior())
    tb = (tft.GaussianProcessBuilder(x, y).set_noise(0.3).set_capacity(96).set_fit_subsample(sub)
          .set_fit_parameters(100, 0.05).fit_kernel().fit_prior())
    if option == "polish":
        jb, tb = jb.set_fit_polish(True), tb.set_fit_polish(True)
    else:
        jb, tb = jb.set_fit_gradient("hutchinson"), tb.set_fit_gradient("hutchinson")

        def jax_probes(state, num_probes, seed):
            z = jnp.sign(jax.random.normal(jax.random.PRNGKey(seed), (state.capacity, num_probes),
                                           dtype=jnp.float64))
            z = np.array(jnp.where((jnp.arange(state.capacity) < state.n)[:, None], z, 0.0))
            return torch.as_tensor(z, device=state.x.device)

        # the JAX package's probes (large_fit.make_probes), drawn from jax.random
        monkeypatch.setattr(tlf, "make_probes", jax_probes)
    jgp_, tgp_ = jb.train(), tb.train()
    expected = {"heuristic", "subfit", "subfit_iterations", "build"}
    assert set(tb.timings) == (expected | {"polish"} if option == "polish" else expected)
    np.testing.assert_allclose(_theta(tgp_.kernel, tgp_.noise), _theta(jgp_.kernel, jgp_.noise),
                               rtol=RTOL_FLOW)
    np.testing.assert_allclose(tgp_.predict(xq), jgp_.predict(xq), rtol=RTOL_FLOW, atol=1e-9)
