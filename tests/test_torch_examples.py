"""The port's twins of ``examples/`` (``friedrich_tpu_torch/examples/``)
against the JAX scripts on the CPU, small sizes, the same seeds.

Each JAX script is loaded from its path (as ``tests/test_misc.py`` loads
``examples/bayesian_optimization.py``) and run, or stopped where it would
start a long run, with a recording stand-in where its ``main`` returns
nothing. Where both sides draw random numbers (the Hutchinson probes), the
port is handed the JAX package's. Tolerances, each set from the dtype:

- float64 flows (``bayesian_optimization``, ``serving_deployment``, the
  float64 ``distributed_gp`` flow): 1e-8 relative on LMLs, 1e-8 absolute
  on acquisitions, served answers and means;
- float32 flows (``large_scale_fit``, ``outofcore_gp``, the float32
  ``distributed_gp`` flow, ``precision_modes``' float32 modes): float32
  rounding through factorizations of a few hundred points and fits of up
  to 40 ADAM steps, 1e-4 relative on LMLs and fitted values, 1e-4
  absolute on means;
- one bfloat16 pass or bfloat16 storage (``precision_modes``): 0.05, the
  bf16 gate of ``PERF.md`` section 2 (on the CPU the JAX package's
  precision modes do not round, the port's do);
- the samplers (``bayesian_hyperparameters``, whose chains are the port's
  own draws): finite draws and split R-hat below 1.1 per parameter.
"""

import importlib.util
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import friedrich_tpu.kernels as fk
import friedrich_tpu.priors as fp
from friedrich_tpu.models import large_fit as jlf
from friedrich_tpu.parallel.large_scale import LargeScaleGP
from friedrich_tpu.parallel.mesh import make_matrix_mesh
from friedrich_tpu_torch import config
from friedrich_tpu_torch.examples import (
    bayesian_hyperparameters,
    bayesian_optimization,
    distributed_gp,
    large_scale_fit,
    outofcore_gp,
    precision_modes,
    serving_deployment,
)
from friedrich_tpu_torch.models import large_fit as tlf
from torch_parallel_ranks import run_world

ROOT = pathlib.Path(__file__).resolve().parents[1]
F64_RTOL = F64_ATOL = 1e-8
F32_RTOL = F32_ATOL = 1e-4
BF16_ATOL = 0.05
#: Seconds a spawned world may take (a hung collective fails the test).
WORLD_TIMEOUT_S = 150.0


@pytest.fixture(autouse=True)
def _port_on_cpu_in_f64():
    config.enable_x64()
    config.set_device("cpu")
    yield


def _script(name, monkeypatch=None, env=None):
    """The JAX script ``examples/<name>.py`` as a fresh module (run at load
    where the script runs at import)."""
    if env:
        for key, value in env.items():
            monkeypatch.setenv(key, value)
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}", ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# ---------------------------------------------------------------------------
# bayesian_optimization: the acquisitions
# ---------------------------------------------------------------------------


def _recorded(module, monkeypatch):
    calls = []
    inner = module.objective

    def objective(x):
        calls.append(np.array(x, dtype=np.float64))
        return inner(x)

    monkeypatch.setattr(module, "objective", objective)
    return calls


def test_bayesian_optimization_acquires_what_the_jax_script_acquires(monkeypatch):
    jscript = _script("bayesian_optimization")
    jcalls = _recorded(jscript, monkeypatch)
    tcalls = _recorded(bayesian_optimization, monkeypatch)
    jbest = jscript.main(num_iters=6, seed=0)
    tbest = bayesian_optimization.main(num_iters=6, seed=0, device="cpu")
    assert len(tcalls) == len(jcalls) == 7  # the initial design, then 6 acquisitions
    for got, want in zip(tcalls, jcalls):
        np.testing.assert_allclose(got, want, rtol=0, atol=F64_ATOL)
    np.testing.assert_allclose(tbest, jbest, rtol=0, atol=F64_ATOL)


def test_expected_improvement_matches_scipy_form():
    from scipy.stats import norm

    mean = np.array([0.1, 0.5, 0.9, 0.2])
    var = np.array([0.04, 1e-14, 0.3, 0.0])
    best, xi = 0.4, 0.01
    std = np.sqrt(np.maximum(var, 1e-12))
    z = (mean - best - xi) / std
    want = (mean - best - xi) * norm.cdf(z) + std * norm.pdf(z)
    got = bayesian_optimization.expected_improvement(torch.as_tensor(mean), torch.as_tensor(var), best, xi)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-15)


# ---------------------------------------------------------------------------
# serving_deployment: the served answers
# ---------------------------------------------------------------------------


def test_serving_deployment_serves_what_the_jax_script_serves():
    jmean, jmean2 = _script("serving_deployment").main(n=120)
    tmean, tmean2 = serving_deployment.main(n=120, device="cpu")
    np.testing.assert_allclose(tmean, jmean, rtol=0, atol=F64_ATOL)
    np.testing.assert_allclose(tmean2, jmean2, rtol=0, atol=F64_ATOL)


# ---------------------------------------------------------------------------
# distributed_gp: a world of 2 gloo ranks
# ---------------------------------------------------------------------------

DIST_N, DIST_D = 128, 4


def _jax_distributed(dtype):
    """The script's flow in the JAX package on 8 virtual devices, in
    ``dtype``: its numbers, and the fit's probes for the port."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(DIST_N, DIST_D)).astype(np.float32)
    y = (np.sin(x[:, 0]) + 0.1 * rng.normal(size=DIST_N)).astype(np.float32)
    gp = LargeScaleGP(make_matrix_mesh(len(jax.devices())), fk.SquaredExp(ls=1.0, ampl=1.0),
                      fp.ConstantPrior.default(1), noise=0.2, x=jnp.asarray(x, dtype),
                      y=jnp.asarray(y, dtype), block=DIST_N // 8, capacity=2 * DIST_N)
    out = {"lml": gp.log_marginal_likelihood(), "probes": np.asarray(gp._probes(8, 0))}
    gp.fit_scaled(max_iter=10)
    out["lml_fit"] = gp.log_marginal_likelihood()
    out["kernel_params"] = np.asarray(gp.kernel.get_params())
    out["noise"] = float(gp.noise)
    xq = jnp.asarray(rng.normal(size=(256, DIST_D)).astype(np.float32), dtype)
    out["mean"] = np.asarray(gp.predict_mean_variance(xq)[0])
    x_new = rng.normal(size=(32, DIST_D)).astype(np.float32)
    gp.add_samples(jnp.asarray(x_new, dtype), jnp.asarray(np.sin(x_new[:, 0]), dtype))
    out["lml_append"] = gp.log_marginal_likelihood()
    return out


@pytest.fixture(scope="module")
def distributed():
    want = {name: _jax_distributed(dtype) for name, dtype in (("float64", jnp.float64),
                                                               ("float32", jnp.float32))}
    calls = [(name, "example_distributed_gp", dict(n=DIST_N, d=DIST_D, seed=0, dtype=name,
                                                   probes=want[name]["probes"]))
             for name in want]
    return want, run_world(2, calls, timeout=WORLD_TIMEOUT_S)


@pytest.mark.parametrize("dtype,rtol,atol", [("float64", F64_RTOL, F64_ATOL),
                                             ("float32", F32_RTOL, F32_ATOL)])
def test_distributed_gp_flow_matches_jax(distributed, dtype, rtol, atol):
    want, ranks = distributed
    want, got = want[dtype], ranks[0][dtype]
    assert got["ranks"] == 2
    for key in ("lml", "lml_fit", "lml_append", "noise"):
        np.testing.assert_allclose(got[key], want[key], rtol=rtol, err_msg=key)
    np.testing.assert_allclose(got["kernel_params"], want["kernel_params"], rtol=rtol)
    np.testing.assert_allclose(got["mean"], want["mean"], rtol=0, atol=atol)
    assert got["served_max_abs_diff"] == 0.0
    for info in ranks[1:]:
        assert info[dtype]["lml_append"] == got["lml_append"]
    assert np.isfinite(got["draws"]).all() and got["draws"].shape == (5, 8)


def test_distributed_gp_main_spawns_its_world():
    want = _jax_distributed(jnp.float32)
    # the flow above is the JAX script's: its model ends where the script's does
    jgp = _script("distributed_gp").main(n=DIST_N, d=DIST_D)
    np.testing.assert_allclose(want["lml_append"], jgp.log_marginal_likelihood(), rtol=1e-12)
    got = distributed_gp.main(n=DIST_N, d=DIST_D, world=2, device="cpu")
    assert got["ranks"] == 2
    np.testing.assert_allclose(got["lml"], want["lml"], rtol=F32_RTOL)
    assert np.isfinite(got["lml_fit"]) and got["lml_fit"] > got["lml"]
    assert got["served_max_abs_diff"] == 0.0


# ---------------------------------------------------------------------------
# bayesian_hyperparameters: the model, then the samplers' gates
# ---------------------------------------------------------------------------


class _Stop(Exception):
    pass


def test_bayesian_hyperparameters_model_matches_the_jax_script(monkeypatch):
    jscript = _script("bayesian_hyperparameters")
    seen = {}

    def stop(gp, *args, **kwargs):
        seen["gp"] = gp
        raise _Stop

    monkeypatch.setattr(jscript, "mcmc", types.SimpleNamespace(sample_hyperparameters=stop))
    with pytest.raises(_Stop):
        jscript.main()
    tgp = bayesian_hyperparameters.model(60, 0, device="cpu")
    np.testing.assert_allclose(tgp.log_marginal_likelihood(), seen["gp"].log_marginal_likelihood(),
                               rtol=F64_RTOL)
    np.testing.assert_array_equal(tgp.state.x.numpy(), np.asarray(seen["gp"].state.x))


def _gates(samples, chains):
    from friedrich_tpu_torch.mcmc import rhat

    samples = torch.as_tensor(samples)
    assert samples.shape[1:] == (chains, 3)
    assert bool(torch.isfinite(samples).all())
    assert bool((rhat(samples) < 1.1).all()), rhat(samples)


@pytest.fixture
def one_thread():
    # the samplers' tiny operations run faster on one thread
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_bayesian_hyperparameters_single_device_run(one_thread):
    # 100 + 150 transitions: half the script's, long enough for its 4 chains
    # to mix (60 + 60 gave R-hat 1.25 on the amplitude)
    gp = bayesian_hyperparameters.model(60, 0, device="cpu")
    res = bayesian_hyperparameters.single_device(gp, 0, num_warmup=100, num_samples=150)
    _gates(res.samples, 4)


def test_bayesian_hyperparameters_multi_rank_runs():
    from friedrich_tpu_torch.parallel.multihost import spawn

    (lead, follower) = spawn(2, bayesian_hyperparameters._spawned_rank, timeout=WORLD_TIMEOUT_S, n=60,
                             seed=0, dtype=torch.float64, x64=True, num_warmup=15, num_samples=15)
    for name, chains in (("chain-sharded", 4), ("distributed density", 2)):
        samples = torch.as_tensor(lead[name])
        assert samples.shape == (15, chains, 3) and bool(torch.isfinite(samples).all())
        np.testing.assert_array_equal(follower[name], lead[name])


# ---------------------------------------------------------------------------
# large_scale_fit: the three fits' LMLs, the JAX package's probes handed over
# ---------------------------------------------------------------------------

FIT_N = 600


def _jax_probes(state, num_probes, seed):
    jdtype = jnp.float32 if state.resid.dtype == torch.float32 else jnp.float64
    like = types.SimpleNamespace(capacity=state.capacity, n=state.n, resid=jnp.zeros((), jdtype))
    return torch.as_tensor(np.array(jlf.make_probes(like, num_probes, seed)), device=state.resid.device)


def test_large_scale_fit_matches_the_jax_script(monkeypatch):
    jscript = _script("large_scale_fit", monkeypatch, env={"FRIEDRICH_EXAMPLE_N": str(FIT_N)})
    monkeypatch.setattr(tlf, "make_probes", _jax_probes)
    got = large_scale_fit.main(n=FIT_N, device="cpu")
    np.testing.assert_allclose(got["subsampled"]["lml"], jscript.gp.log_marginal_likelihood(), rtol=F32_RTOL)
    np.testing.assert_allclose(got["hutchinson"]["lml"], jscript.gp2.log_marginal_likelihood(),
                               rtol=F32_RTOL)
    np.testing.assert_allclose(got["auto"]["lml"], jscript.gp3.log_marginal_likelihood(), rtol=F32_RTOL)
    for key, jgp in (("subsampled", jscript.gp), ("hutchinson", jscript.gp2), ("auto", jscript.gp3)):
        np.testing.assert_allclose(got[key]["ls"], float(jgp.kernel.get_params()[0]), rtol=F32_RTOL)
        np.testing.assert_allclose(got[key]["noise"], jgp.noise, rtol=F32_RTOL)
    np.testing.assert_allclose(got["predictions"], np.asarray(jscript.gp.predict(jscript.xq)), rtol=0,
                               atol=F32_ATOL)
    assert got["lml_initial"] < got["subsampled"]["lml"]


# ---------------------------------------------------------------------------
# outofcore_gp: the means and variances
# ---------------------------------------------------------------------------


def test_outofcore_gp_matches_the_jax_script(monkeypatch):
    jscript = _script("outofcore_gp")
    seen = []

    class Recording(jscript.OutOfCoreGP):
        def predict_mean_variance(self, xq):
            out = super().predict_mean_variance(xq)
            seen.append((np.asarray(out[0]), np.asarray(out[1]), self.log_marginal_likelihood()))
            return out

    monkeypatch.setattr(jscript, "OutOfCoreGP", Recording)
    jscript.main(n=512, m=64)
    got = outofcore_gp.main(n=512, m=64, device="cpu")
    (want_mean, want_var, want_lml), = seen
    np.testing.assert_allclose(got["mean"], want_mean, rtol=0, atol=F32_ATOL)
    np.testing.assert_allclose(got["var"], want_var, rtol=0, atol=F32_ATOL)
    np.testing.assert_allclose(got["lml"], want_lml, rtol=F32_RTOL)
    assert got["n"] == 512 + 64


# ---------------------------------------------------------------------------
# precision_modes: the means of each mode (float32: x64 off in both)
# ---------------------------------------------------------------------------


@pytest.fixture
def float32_default(monkeypatch):
    monkeypatch.setattr(config, "_x64", False)
    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", True)


def test_precision_modes_match_the_jax_script(float32_default):
    want = _script("precision_modes").main(n=512, m=64)
    got = precision_modes.main(n=512, m=64, device="cpu")
    pairs = {"f32": ("f32", F32_ATOL), "f32x3": ("f32x3", F32_ATOL),
             "bf16": ("ambient(bf16)", BF16_ATOL),
             "default+bf16store": ("ambient(bf16)+bf16store", BF16_ATOL)}
    assert sorted(got) == sorted(pairs)
    for label, (jlabel, atol) in pairs.items():
        assert got[label].dtype == np.float32
        np.testing.assert_allclose(got[label], want[jlabel], rtol=0, atol=atol, err_msg=label)
