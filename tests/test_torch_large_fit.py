"""The large-n fit of the PyTorch port against the JAX package: the streamed
gradient-covariance matvec, one Hutchinson step and a whole Hutchinson fit
with the JAX package's probes, the exact traces with identity probes, the
``gradient="auto"`` dispatch and the memory rule. float64 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import friedrich_tpu.kernels as jk
import friedrich_tpu.priors as jp
import friedrich_tpu_torch as tft
import friedrich_tpu_torch.kernels as tk
import friedrich_tpu_torch.priors as tp
from friedrich_tpu.models import gp as jgp
from friedrich_tpu.models import large_fit as jlf
from friedrich_tpu.models import optimizer as jopt
from friedrich_tpu.ops.streamed_matvec import streamed_grad_matvec as j_matvec
from friedrich_tpu.utils.fitlog import FitLog
from friedrich_tpu_torch import config
from friedrich_tpu_torch.models import gp as tgp
from friedrich_tpu_torch.models import large_fit as tlf
from friedrich_tpu_torch.models import optimizer as topt
from friedrich_tpu_torch.ops.covariance import gradient_covariances_padded
from friedrich_tpu_torch.ops.streamed_matvec import streamed_grad_matvec as t_matvec

# One step: the same solves and matvecs in another summation order, so
# rtol 1e-9. A whole fit compounds the multiplicative update over its
# iterations: rtol 1e-8.
RTOL_STEP = 1e-9
RTOL_FIT = 1e-8


@pytest.fixture(autouse=True)
def _port_on_cpu_in_f64():
    config.enable_x64()
    config.set_device("cpu")
    yield


KERNELS = {
    "scalable": lambda m: m.SquaredExp(ls=0.9, ampl=1.2),
    "generic": lambda m: m.RationalQuadratic(alpha=1.1, ls=0.8),
    "sum": lambda m: m.Matern1(ls=1.1, ampl=0.7) + m.Linear(c=0.4),
}


def _data(n, d=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    y = np.sin(x[:, 0]) + 0.5 * np.cos(x[:, 1]) + 0.1 * rng.normal(size=n)
    return x, y


def _states(name, n=64, cap=None, noise=0.3, seed=0):
    x, y = _data(n, seed=seed)
    kf = KERNELS[name]
    jstate, ok = jgp.make_state(kf(jk), jp.ConstantPrior(c=0.0), noise, jnp.asarray(x),
                                jnp.asarray(y), cap=cap)
    assert bool(ok)
    tstate, ok = tgp.make_state(kf(tk), tp.ConstantPrior(c=0.0), noise, torch.as_tensor(x),
                                torch.as_tensor(y), cap=cap)
    assert bool(ok)
    return jstate, tstate


def _params(kernel, noise):
    return np.concatenate([np.asarray(kernel.get_params(), dtype=np.float64), [float(noise)]])


@pytest.mark.parametrize("vector", (False, True), ids=("matrix", "vector"))
@pytest.mark.parametrize("name", ("scalable", "sum"))
def test_streamed_grad_matvec_matches_jax(name, vector):
    # capacity 300 with a block (128) that does not divide it: snapped to 100
    x, _ = _data(280)
    x_pad = np.zeros((300, 3))
    x_pad[:280] = x
    rng = np.random.default_rng(1)
    v = rng.normal(size=(300,) if vector else (300, 5))
    want = np.asarray(j_matvec(KERNELS[name](jk), jnp.asarray(x_pad), 280, jnp.asarray(v), block=128))
    got = t_matvec(KERNELS[name](tk).to(torch.float64, "cpu"), torch.as_tensor(x_pad), 280,
                   torch.as_tensor(v), block=128)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    # and the materialized gradient stack of the exact path
    dks = gradient_covariances_padded(KERNELS[name](tk).to(torch.float64, "cpu"),
                                      torch.as_tensor(x_pad), 280)
    dense = torch.einsum("pij,j...->pi...", dks, torch.as_tensor(v))
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=1e-12, atol=1e-12)


def _adams(jstate, tstate, scalable):
    jparams = jstate.kernel.get_params()
    tparams = tstate.kernel.get_params()
    if not scalable:
        jparams = jnp.concatenate([jparams, jnp.log(jstate.noise)[None]])
        tparams = torch.cat([tparams, torch.log(tstate.noise)[None]])
    jadam = jopt.AdamState(params=jparams, m=jnp.zeros_like(jparams), v=jnp.zeros_like(jparams))
    tadam = topt.AdamState(params=tparams, m=torch.zeros_like(tparams), v=torch.zeros_like(tparams))
    return jadam, tadam


@pytest.mark.parametrize("name", ("scalable", "generic"))
def test_one_hutchinson_step_matches_jax(name):
    jstate, tstate = _states(name, n=56, cap=64)
    scalable = name == "scalable"
    jadam, tadam = _adams(jstate, tstate, scalable)
    probes = jlf.make_probes(jstate, 8, 0)
    conv = 0.05
    jadam2, jkernel, jnoise, jprogress, jinfo = jlf._grad_step_large(
        jstate, jadam, probes, jnp.asarray(3), jnp.asarray(conv), scalable)
    tadam2, tkernel, tnoise, tprogress, tinfo = tlf._grad_step_large(
        tstate, tadam, torch.as_tensor(np.array(probes)), 3, conv, scalable)
    for field in ("params", "m", "v"):
        np.testing.assert_allclose(getattr(tadam2, field).numpy(), np.asarray(getattr(jadam2, field)),
                                   rtol=RTOL_STEP)
    np.testing.assert_allclose(_params(tkernel, tnoise), _params(jkernel, jnoise), rtol=RTOL_STEP)
    assert tprogress == bool(jprogress)
    for key in ("max_delta", "scale"):
        np.testing.assert_allclose(float(tinfo[key]), float(jinfo[key]), rtol=RTOL_STEP)


@pytest.mark.parametrize("name", ("scalable", "generic"))
def test_identity_probes_give_the_exact_step(name):
    # probes sqrt(cap) I (zero on dead rows): the Hutchinson traces are the
    # exact traces, so one step equals one exact-optimizer step
    jstate, tstate = _states(name, n=48, cap=64)
    scalable = name == "scalable"
    _, tadam = _adams(jstate, tstate, scalable)
    probes = torch.eye(64, dtype=torch.float64) * np.sqrt(64)
    probes[48:] = 0.0
    tadam_l, kernel_l, noise_l, _, _ = tlf._grad_step_large(tstate, tadam, probes, 1, 0.05, scalable)
    step = topt._scaled_step if scalable else topt._generic_step
    state_e, adam_e, _, ok, _ = step(tstate, tadam, 1, 0.05)
    assert bool(ok)
    np.testing.assert_allclose(tadam_l.params.numpy(), adam_e.params.numpy(), rtol=1e-8)
    np.testing.assert_allclose(_params(kernel_l, noise_l), _params(state_e.kernel, state_e.noise),
                               rtol=1e-8)


# the scalable fit converges; the generic one's noise keeps moving, so it
# runs to max_iter
@pytest.mark.parametrize("name,max_iter,converges", (("scalable", 60, True), ("generic", 25, False)))
def test_whole_hutchinson_fit_matches_jax(name, max_iter, converges):
    jstate, tstate = _states(name, n=120, cap=128, seed=3)
    probes = jlf.make_probes(jstate, 8, 0)
    log = FitLog()
    # the JAX per-iteration loop (with a log) is the one the port mirrors
    jfit = jopt.fit_kernel_noise(jstate, max_iter, 0.05, 3600.0, fit_log=log,
                                 gradient="hutchinson")
    tfit, iterations = tlf.fit_kernel_noise_large(tstate, max_iter, 0.05, 3600.0,
                                                  probes=torch.as_tensor(np.array(probes)))
    # the log holds the applied iterations; a converging step is not applied
    if converges:
        assert iterations < max_iter and iterations == len(log) + 1
    else:
        assert iterations == max_iter == len(log)
    np.testing.assert_allclose(_params(tfit.kernel, tfit.noise), _params(jfit.kernel, jfit.noise),
                               rtol=RTOL_FIT)
    np.testing.assert_allclose(tfit.l.numpy(), np.asarray(jfit.l), rtol=RTOL_FIT, atol=1e-10)


def test_auto_gradient_dispatches_to_hutchinson_above_the_threshold(monkeypatch):
    _, tstate = _states("scalable", n=60, cap=70)
    monkeypatch.setattr(topt, "LARGE_FIT_THRESHOLD", 64)
    calls = []
    real = tlf.fit_kernel_noise_large
    monkeypatch.setattr(tlf, "fit_kernel_noise_large",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    fit, iterations = topt.fit_kernel_noise(tstate, 20, 0.05, 3600.0)
    assert calls == [{"num_probes": 8, "seed": 0, "fit_log": None}] and iterations >= 1
    # the same fit with its own probes, asked for by name
    _, tstate = _states("scalable", n=60, cap=70)
    named, _ = topt.fit_kernel_noise(tstate, 20, 0.05, 3600.0, gradient="hutchinson")
    assert torch.equal(named.l, fit.l)
    # at the threshold the exact path runs
    _, small = _states("scalable", n=60, cap=64)
    topt.fit_kernel_noise(small, 3, 0.05, 3600.0)
    assert len(calls) == 2


def test_fit_needs_the_streamed_backend_when_two_factors_do_not_fit(monkeypatch):
    _, tstate = _states("scalable", n=60, cap=64)
    monkeypatch.setattr(config, "device_memory_bytes", lambda device=None: 2 * 64 * 64 * 8)
    with pytest.raises(tft.ConfigError, match="needs the 'streamed' backend"):
        tlf.fit_kernel_noise_large(tstate, 5, 0.05, 3600.0)
    # the streamed backend rebuilds into the factor's buffer: it runs
    streamed = tstate.replace(backend="streamed", l=tstate.l.contiguous())
    fit, _ = tlf.fit_kernel_noise_large(streamed, 5, 0.05, 3600.0)
    assert fit.l.data_ptr() == streamed.l.data_ptr()
