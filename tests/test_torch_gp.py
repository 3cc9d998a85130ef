"""GP core of the PyTorch port against the JAX package, on states carried
across with ``friedrich_tpu_torch.interop``: state fields, predict
weights, every predict, posterior, likelihood and LML, ``add_samples``,
and the posterior sampler."""

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
from friedrich_tpu.models import gp as jgp
from friedrich_tpu.utils.serialization import _kernel_spec, _prior_spec
from friedrich_tpu_torch import config, interop
from friedrich_tpu_torch.models import gp as tgp

# float64 on both sides; the paths differ in LAPACK/BLAS summation order
RTOL = 1e-10
ATOL = 1e-12


@pytest.fixture(autouse=True)
def _port_on_cpu_in_f64():
    config.enable_x64()
    config.set_device("cpu")
    yield


def to_port(jstate):
    """A JAX GPState carried across as numpy arrays and specs."""
    arrays = {k: np.asarray(getattr(jstate, k)) for k in ("x", "resid", "l", "n", "noise")}
    return interop.state_from_arrays(
        arrays, _kernel_spec(jstate.kernel), _prior_spec(jstate.prior),
        eps=jstate.eps, method=jstate.method, device="cpu", backend=jstate.backend,
        block=jstate.block,
    )


def close(got, want, rtol=RTOL, atol=ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


CASES = {
    "se-constant": (lambda m: m.SquaredExp(ls=1.4, ampl=0.8), lambda m: m.ConstantPrior(c=0.3)),
    "matern1-zero": (lambda m: m.Matern1(ls=1.1, ampl=1.2), lambda m: m.ZeroPrior()),
    "sum-linear": (
        lambda m: m.Linear(c=0.2) * m.SquaredExp(ls=1.5, ampl=0.5) + m.RationalQuadratic(alpha=1.3, ls=0.9),
        lambda m: m.LinearPrior(weights=[0.1, -0.2, 0.3], intercept=0.5),
    ),
}


def _data(n=60, d=3, seed=31):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    y = np.sin(x[:, 0]) + 0.5 * x[:, 1] + 0.1 * rng.normal(size=n)
    xq = rng.normal(size=(9, d))
    return x, y, xq


def _models(case, cap=80):
    kf, pf = CASES[case]
    x, y, xq = _data()
    prior_j = pf(jp)
    if isinstance(prior_j, jp.LinearPrior):
        prior_j = prior_j.replace(weights=jnp.asarray(prior_j.weights))
    jstate, jok = jgp.make_state(kf(jk), prior_j, 0.3, jnp.asarray(x), jnp.asarray(y), cap=cap)
    tstate, tok = tgp.make_state(kf(tk), pf(tp), 0.3, torch.as_tensor(x), torch.as_tensor(y), cap=cap)
    assert bool(jok) and bool(tok)
    return jstate, tstate, xq


@pytest.mark.parametrize("case", CASES)
def test_make_state_fields_match_jax(case):
    jstate, tstate, _ = _models(case)
    for field in ("x", "resid", "l", "noise"):
        close(getattr(tstate, field), getattr(jstate, field))
    assert tstate.n == int(jstate.n)
    carried = to_port(jstate)
    arrays, kspec, pspec, static = interop.state_to_arrays(carried)
    assert kspec == _kernel_spec(jstate.kernel) and pspec == _prior_spec(jstate.prior)
    assert static == {"eps": jstate.eps, "method": jstate.method, "backend": jstate.backend,
                      "block": jstate.block, "storage": jstate.storage,
                      "precision": jstate.precision}
    for field in ("x", "resid", "l", "noise"):
        np.testing.assert_array_equal(arrays[field], np.asarray(getattr(jstate, field)))


@pytest.mark.parametrize("case", CASES)
def test_predictions_and_scores_match_jax(case):
    jstate, _, xq_np = _models(case)
    tstate = to_port(jstate)
    xq_j, xq_t = jnp.asarray(xq_np), torch.as_tensor(xq_np)
    jw, tw = jgp.derive_weights(jstate), tgp.derive_weights(tstate)
    close(tw.beta, jw.beta)
    close(tw.alpha, jw.alpha)
    for weighted in (False, True):
        jwt, twt = (jw, tw) if weighted else (None, None)
        close(tgp.predict_mean(tstate, xq_t, twt), jgp.predict_mean(jstate, xq_j, jwt))
        close(tgp.predict_variance(tstate, xq_t, twt), jgp.predict_variance(jstate, xq_j, jwt))
        for got, want in zip(tgp.predict_mean_variance(tstate, xq_t, twt),
                             jgp.predict_mean_variance(jstate, xq_j, jwt)):
            close(got, want)
        for got, want in zip(tgp.posterior(tstate, xq_t, twt), jgp.posterior(jstate, xq_j, jwt)):
            close(got, want)
        close(tgp.likelihood(tstate, twt), jgp.likelihood(jstate, jwt))
        close(tgp.log_marginal_likelihood(tstate, twt), jgp.log_marginal_likelihood(jstate, jwt))
    close(tgp.predict_covariance(tstate, xq_t), jgp.predict_covariance(jstate, xq_j))


@pytest.mark.parametrize("grow", (False, True), ids=("in-capacity", "grown"))
def test_facade_add_samples_matches_jax(grow):
    x, y, xq = _data(n=50)
    cap = 64 if not grow else 52  # 50 + 8 overflows 52: x1.5 growth to 78
    rng = np.random.default_rng(32)
    x_new = rng.normal(size=(8, 3))
    y_new = np.cos(x_new[:, 0])
    j = jft.GaussianProcess.new(jp.ConstantPrior(c=0.1), jk.Matern2(ls=1.2, ampl=0.9), 0.25, None, x, y,
                                capacity=cap)
    t = tft.GaussianProcess.new(tp.ConstantPrior(c=0.1), tk.Matern2(ls=1.2, ampl=0.9), 0.25, None, x, y,
                                capacity=cap)
    j.add_samples(x_new, y_new)
    t.add_samples(x_new, y_new)
    assert t.num_samples == j.num_samples == 58
    assert t.state.capacity == j.state.capacity == (78 if grow else 64)
    for field in ("x", "resid", "l"):
        close(getattr(t.state, field), getattr(j.state, field))
    close(torch.as_tensor(t.predict(xq)), j.predict(xq))
    close(torch.as_tensor(t.predict_variance(xq)), j.predict_variance(xq))


def test_facade_add_samples_is_atomic_on_failure():
    # as tests/test_add_samples.py::test_failed_add_samples_leaves_model_unchanged
    gp = tft.GaussianProcess.new(tp.ZeroPrior(), tk.SquaredExp(ls=1.0, ampl=1.0), 0.0, None,
                                 [[1.0], [2.0], [3.0]], [1.0, 2.0, 3.0], capacity=8)
    before = gp.state
    before_pred = gp.predict([1.5])
    with pytest.raises(tft.CholeskyError):
        gp.add_samples([[1.0], [1.0]], [1.0, 1.0])  # duplicates, zero noise
    assert gp.state is before and gp.num_samples == 3
    assert gp.predict([1.5]) == before_pred
    gp.add_samples([[4.0]], [4.0])
    assert gp.num_samples == 4


def test_sampler_is_mean_plus_factor_times_z():
    jstate, _, xq_np = _models("se-constant")
    jgp_ = jft.GaussianProcess(jstate)
    tgp_ = tft.GaussianProcess(to_port(jstate))
    jmvn, tmvn = jgp_.sample_at(xq_np), tgp_.sample_at(xq_np)
    close(tmvn._mean, jmvn._mean)
    close(tmvn._chol, jmvn._chol, rtol=1e-8, atol=1e-10)
    z = np.random.default_rng(33).normal(size=9)
    close(tmvn._mean + tmvn._chol @ torch.as_tensor(z), jmvn._mean + jmvn._chol @ jnp.asarray(z),
          rtol=1e-8, atol=1e-10)
    gen = torch.Generator().manual_seed(5)
    draw = tmvn.sample(torch.Generator().manual_seed(5))
    expect = tmvn._mean + tmvn._chol @ torch.randn(9, generator=gen, dtype=torch.float64)
    np.testing.assert_array_equal(draw, expect.numpy())
    draws = tmvn.sample_n(torch.Generator().manual_seed(6), 4)
    assert draws.shape == (4, 9) and bool(torch.isfinite(draws).all())
