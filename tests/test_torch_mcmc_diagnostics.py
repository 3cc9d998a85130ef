"""The port's MCMC diagnostics against the JAX package's on the same draws
(split chains, split R-hat, bulk ESS, the summary), and against the closed
forms of ``tests/test_diagnostics_golden.py``: the AR(1) chain's
integrated autocorrelation time and the split-R-hat detection cases.
float64 on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from friedrich_tpu.mcmc import diagnostics as jd
from friedrich_tpu_torch.mcmc import diagnostics as td

# The same FFTs and reductions in another library: rtol 1e-10.
RTOL = 1e-10


def _ar1(phi: float, s: int, c: int, d: int = 1, seed: int = 0) -> np.ndarray:
    """Stationary AR(1) chains, unit marginal variance, shape (s, c, d)."""
    rng = np.random.default_rng(seed)
    x = np.zeros((s, c, d))
    x[0] = rng.normal(size=(c, d))
    innov = rng.normal(size=(s, c, d)) * np.sqrt(1.0 - phi * phi)
    for t in range(1, s):
        x[t] = phi * x[t - 1] + innov[t]
    return x


def _unmixed(s=400, c=4, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(s, c, 2)) * 0.5 + np.array([-10.0, -3.0, 3.0, 10.0])[None, :c, None]


DRAWS = {
    "iid": lambda: np.random.default_rng(1).normal(size=(500, 4, 3)),
    "ar1_0.5": lambda: _ar1(0.5, 800, 4, 2, seed=2),
    "ar1_0.95": lambda: _ar1(0.95, 1200, 3, 2, seed=3),
    "odd_length": lambda: np.random.default_rng(4).normal(size=(301, 2, 4)),
    "unmixed": _unmixed,
    "drifting": lambda: np.random.default_rng(5).normal(size=(600, 4, 1))
    + np.linspace(0.0, 3.0, 600)[:, None, None],
}


@pytest.mark.parametrize("name", DRAWS)
def test_diagnostics_match_jax(name):
    x = DRAWS[name]()
    xt = torch.as_tensor(x)
    np.testing.assert_array_equal(td.split_chains(xt).numpy(), np.asarray(jd.split_chains(jnp.asarray(x))))
    np.testing.assert_allclose(td.rhat(xt).numpy(), np.asarray(jd.rhat(jnp.asarray(x))), rtol=RTOL)
    np.testing.assert_allclose(td.ess(xt).numpy(), np.asarray(jd.ess(jnp.asarray(x))), rtol=RTOL)
    np.testing.assert_allclose(td.ess(xt, max_lag=37).numpy(),
                               np.asarray(jd.ess(jnp.asarray(x), max_lag=37)), rtol=RTOL)
    got, want = td.summary(xt), jd.summary(jnp.asarray(x))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=RTOL, err_msg=key)


def test_diagnostics_take_numpy_and_keep_the_dtype():
    x = np.random.default_rng(6).normal(size=(100, 2, 3)).astype(np.float32)
    r, e = td.rhat(x), td.ess(x)
    assert r.dtype == e.dtype == torch.float32 and r.shape == e.shape == (3,)
    assert td.split_chains(np.zeros((11, 3, 2))).shape == (5, 6, 2)


@pytest.mark.parametrize("phi", [0.0, 0.5, 0.9])
def test_ess_matches_ar1_closed_form(phi):
    s, c = 4000, 8
    expected = s * c / ((1 + phi) / (1 - phi))
    got = float(td.ess(torch.as_tensor(_ar1(phi, s, c)))[0])
    # single-realization estimator noise: 15 % (as the golden test)
    assert abs(got - expected) / expected < 0.15, (phi, got, expected)


def test_rhat_detects_a_drift_within_every_chain():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1000, 4, 1))
    x[500:] += 3.0
    assert float(td.rhat(torch.as_tensor(x))[0]) > 1.5
    assert float(td.rhat(torch.as_tensor(rng.normal(size=(1000, 4, 1))))[0]) < 1.01


def test_unmixed_chains_collapse_ess():
    x = _unmixed()
    assert float(td.rhat(torch.as_tensor(x))[0]) > 2.0
    assert float(td.ess(torch.as_tensor(x))[0]) < 50
    good = np.random.default_rng(0).normal(size=(400, 4, 1))
    assert float(td.ess(torch.as_tensor(good))[0]) > 0.5 * 400 * 4
