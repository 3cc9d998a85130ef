"""The port's fit log against the JAX package's: the records of the exact
fit (scaled and generic paths), of the Hutchinson fit (with the JAX
package's probes) and of the facade's ``fit_parameters``, field by field;
and ``mcmc_summary_table``, checked as ``tests/test_mcmc.py:179-216`` checks
the JAX package's and against the JAX package's table. float64 on the CPU."""

import dataclasses

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
from friedrich_tpu.models import large_fit as jlf
from friedrich_tpu.models import optimizer as jopt
from friedrich_tpu.utils import fitlog as jlog
from friedrich_tpu_torch import config
from friedrich_tpu_torch.models import gp as tgp
from friedrich_tpu_torch.models import large_fit as tlf
from friedrich_tpu_torch.models import optimizer as topt
from friedrich_tpu_torch.utils import fitlog as tlog

# A whole fit compounds the multiplicative update over its iterations, as
# tests/test_torch_large_fit.py: rtol 1e-8.
RTOL = 1e-8


@pytest.fixture(autouse=True)
def _port_on_cpu_in_f64():
    config.enable_x64()
    config.set_device("cpu")
    yield


KERNELS = {
    "scalable": lambda m: m.SquaredExp(ls=1.0, ampl=1.0),
    "generic": lambda m: m.RationalQuadratic(alpha=1.0, ls=1.0),
}


def _states(name, n=40, cap=48, seed=11):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 2))
    y = np.sin(x[:, 0]) + 0.1 * rng.normal(size=n)
    kf = KERNELS[name]
    jstate, _ = jgp.make_state(kf(jk), jp.ZeroPrior(), 0.2, jnp.asarray(x), jnp.asarray(y), cap=cap)
    tstate, _ = tgp.make_state(kf(tk), tp.ZeroPrior(), 0.2, torch.as_tensor(x), torch.as_tensor(y),
                               cap=cap)
    return jstate, tstate


def _assert_records_match(got, want, scalable):
    assert len(got) == len(want) > 0
    for g, w in zip(got.records, want.records):
        g, w = dataclasses.asdict(g), dataclasses.asdict(w)
        assert g["iteration"] == w["iteration"]
        np.testing.assert_allclose(g["params"], w["params"], rtol=RTOL)
        for key in ("noise", "max_delta", "likelihood"):
            np.testing.assert_allclose(g[key], w[key], rtol=RTOL, err_msg=key)
        if scalable:
            np.testing.assert_allclose(g["scale"], w["scale"], rtol=RTOL)
        else:
            assert g["scale"] is None and w["scale"] is None


@pytest.mark.parametrize("name", KERNELS)
def test_exact_fit_records_match_jax(name):
    jstate, tstate = _states(name)
    jl, tl = jlog.FitLog(), tlog.FitLog()
    jfit = jopt.fit_kernel_noise(jstate, 6, 1e-12, 3600.0, fit_log=jl, gradient="exact")
    tfit, iterations = topt.fit_kernel_noise(tstate, 6, 1e-12, 3600.0, fit_log=tl, gradient="exact")
    assert iterations == len(tl) == 6
    _assert_records_match(tl, jl, name == "scalable")
    # each record's likelihood is the exact LML of that iteration's state
    np.testing.assert_allclose(tl.records[-1].likelihood, float(tgp.log_marginal_likelihood(tfit)),
                               rtol=1e-12)
    np.testing.assert_allclose(float(tgp.log_marginal_likelihood(tfit)),
                               float(jgp.log_marginal_likelihood(jfit)), rtol=RTOL)


@pytest.mark.parametrize("name", KERNELS)
def test_hutchinson_fit_records_match_jax(name):
    jstate, tstate = _states(name, n=56, cap=64)
    probes = jlf.make_probes(jstate, 8, 0)
    jl, tl = jlog.FitLog(), tlog.FitLog()
    jopt.fit_kernel_noise(jstate, 8, 0.05, 3600.0, fit_log=jl, gradient="hutchinson")
    _, iterations = tlf.fit_kernel_noise_large(tstate, 8, 0.05, 3600.0,
                                               probes=torch.as_tensor(np.array(probes)), fit_log=tl)
    # a converging step is not applied, so it is not logged
    assert len(tl) in (iterations, iterations - 1)
    _assert_records_match(tl, jl, name == "scalable")


def test_facade_fit_parameters_threads_the_log():
    rng = np.random.default_rng(5)
    x, y = rng.normal(size=(30, 1)), rng.normal(size=30)
    jl, tl = jlog.FitLog(), tlog.FitLog()
    jgp_ = jft.GaussianProcess.new(jp.ConstantPrior(c=0.0), jk.SquaredExp(ls=1.0, ampl=1.0), 0.3, None,
                                   x, y)
    tgp_ = tft.GaussianProcess.new(tp.ConstantPrior(c=0.0), tk.SquaredExp(ls=1.0, ampl=1.0), 0.3, None,
                                   x, y, device="cpu")
    jgp_.fit_parameters(max_iter=5, convergence_fraction=1e-12, fit_log=jl, sync_every=1)
    tgp_.fit_parameters(max_iter=5, convergence_fraction=1e-12, fit_log=tl)
    assert tgp_.fit_iterations == len(tl) == 5
    _assert_records_match(tl, jl, scalable=True)
    # through the subsampled fit too (the port's subset is its own)
    tl = tlog.FitLog()
    tgp_.fit_parameters(max_iter=3, convergence_fraction=1e-12, fit_log=tl, subsample=20)
    assert len(tl) == tgp_.fit_iterations == 3


def test_fit_records_are_populated_and_serialize(capsys):
    _, tstate = _states("generic")
    log = tlog.FitLog(verbose=True)
    topt.fit_kernel_noise(tstate, 2, 1e-12, 3600.0, fit_log=log)
    assert all(r.scale is None and np.isfinite(r.max_delta) and np.isfinite(r.likelihood)
               for r in log.records)
    printed = capsys.readouterr().out.strip().splitlines()
    assert printed == [r.to_json() for r in log.records]


def test_mcmc_summary_table_matches_jax():
    rng = np.random.default_rng(11)
    samples = rng.normal(size=(50, 4, 2))
    accept, divergent = rng.uniform(size=(50, 4)), rng.uniform(size=(50, 4)) < 0.1
    got = tlog.mcmc_summary_table(torch.as_tensor(samples), torch.as_tensor(accept),
                                  torch.as_tensor(divergent))
    want = jlog.mcmc_summary_table(jnp.asarray(samples), jnp.asarray(accept), jnp.asarray(divergent))
    assert "rhat" in got and "ess" in got and "divergence rate" in got
    assert got == want
    assert tlog.mcmc_summary_table(samples) == jlog.mcmc_summary_table(jnp.asarray(samples))
