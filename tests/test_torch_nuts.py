"""The port's NUTS against the JAX package's.

One transition, fed the JAX package's key schedule through a replaying
draws object, gives JAX's position, density, gradient, acceptance
statistic, depth and divergence flag: on a correlated Gaussian, on the
dense and the streamed GP densities, on a density that is -inf on a region
(the divergence path) and on a run that reaches ``max_depth``. Whole runs
recover the analytic moments of two Gaussians and the grid-quadrature
moments of a GP hyperparameter posterior within their Monte-Carlo error.
float64 on the CPU."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import friedrich_tpu.kernels as jk
import friedrich_tpu.priors as jp
import friedrich_tpu_torch.kernels as tk
import friedrich_tpu_torch.priors as tp
from friedrich_tpu.mcmc import logprob as jlogprob
from friedrich_tpu.mcmc import nuts as jnuts
from friedrich_tpu.models import gp as jgp
from friedrich_tpu_torch import config
from friedrich_tpu_torch.mcmc import _adapt as tadapt
from friedrich_tpu_torch.mcmc import ess, rhat
from friedrich_tpu_torch.mcmc import logprob as tlogprob
from friedrich_tpu_torch.mcmc import nuts as tnuts
from friedrich_tpu_torch.mcmc import sample_hyperparameters
from friedrich_tpu_torch.models import gp as tgp

# One transition: the same leapfrogs and densities in another library, so
# rounding only, over at most 2^max_depth - 1 leapfrogs: rtol 1e-9.
RTOL = 1e-9


# -- references of the whole-sampler tests (here and in test_torch_hmc.py):
# Monte-Carlo error bounds on moments, and the grid quadrature of the GP
# hyperparameter posterior of examples/bayesian_hyperparameters.py, in
# numpy, independent of both packages

# Every moment within this many Monte-Carlo standard errors.
MCSE_BOUND = 4.0


def moments_within_mcse(samples, mean, cov):
    """Each mean, variance and covariance of ``samples`` (draws, chains,
    dim) within MCSE_BOUND of its Monte-Carlo standard error, sd(f) /
    sqrt(ess(f)) for f the coordinate, its squared deviation or the product
    of two deviations from the truth."""
    x = samples.numpy()
    dev = x - np.asarray(mean)
    funcs = {f"mean {i}": (x[..., i], mean[i]) for i in range(x.shape[-1])}
    for i in range(x.shape[-1]):
        for j in range(i, x.shape[-1]):
            funcs[f"cov {i},{j}"] = (dev[..., i] * dev[..., j], cov[i][j])
    for name, (f, truth) in funcs.items():
        mcse = f.std() / np.sqrt(float(ess(torch.as_tensor(f[..., None]))[0]))
        assert abs(f.mean() - truth) <= MCSE_BOUND * mcse, (name, f.mean(), truth, mcse)


def example_problem(n=60, seed=0):
    """The data of ``examples/bayesian_hyperparameters.py`` (float32 values,
    held in float64) and the port's state of its GP: zero prior,
    SquaredExp(ls=1, ampl=1), noise 0.3."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-3.0, 3.0, size=(n, 1)).astype(np.float32).astype(np.float64)
    y = (np.sin(2.0 * x[:, 0]) + 0.3 * rng.normal(size=n)).astype(np.float32).astype(np.float64)
    state, ok = tgp.make_state(tk.SquaredExp(ls=1.0, ampl=1.0), tp.ZeroPrior(), 0.3, torch.as_tensor(x),
                               torch.as_tensor(y))
    assert bool(ok)
    return x, y, state


def log_density(x, y, thetas, prior_sigma=5.0):
    """The SquaredExp GP's exact log marginal likelihood plus the N(0, 5^2)
    hyperprior at each row of ``thetas`` = log [ls, ampl, noise]."""
    d2 = (x[:, None, 0] - x[None, :, 0]) ** 2
    out = []
    for chunk in np.array_split(thetas, max(1, len(thetas) // 2000)):
        ls, ampl, noise = np.exp(chunk).T
        k = ampl[:, None, None] * np.exp(-d2[None] / (2.0 * ls[:, None, None] ** 2))
        k = k + (noise**2)[:, None, None] * np.eye(len(x))[None]
        chol = np.linalg.cholesky(k)
        ol = np.linalg.solve(chol, np.broadcast_to(y, (len(chunk), len(y)))[..., None])[..., 0]
        logdet = 2.0 * np.sum(np.log(np.diagonal(chol, axis1=1, axis2=2)), axis=1)
        lml = -0.5 * (np.sum(ol * ol, axis=1) + logdet + len(x) * np.log(2.0 * np.pi))
        out.append(lml - 0.5 * np.sum((chunk / prior_sigma) ** 2, axis=1))
    return np.concatenate(out)


#: A box holding the posterior's mass, 24 points per axis (spacing about
#: half of each marginal's standard deviation, where a sum over the grid is
#: already accurate far below the Monte-Carlo error).
AXES = (np.linspace(-2.2, 1.0, 24), np.linspace(-3.0, 7.0, 24), np.linspace(-1.75, -0.7, 24))


@functools.lru_cache(maxsize=1)
def quadrature_moments():
    """Posterior mean and covariance of log [ls, ampl, noise] by grid
    quadrature; asserts that the box's faces carry no mass."""
    x, y, _ = example_problem()
    grid = np.stack(np.meshgrid(*AXES, indexing="ij"), axis=-1).reshape(-1, 3)
    logw = log_density(x, y, grid)
    w = np.exp(logw - logw.max())
    w /= w.sum()
    faces = np.zeros(grid.shape[0], dtype=bool)
    for i, ax in enumerate(AXES):
        faces |= (grid[:, i] == ax[0]) | (grid[:, i] == ax[-1])
    assert w[faces].sum() < 1e-4
    mean = w @ grid
    return mean, (grid - mean).T @ ((grid - mean) * w[:, None])


@pytest.fixture(autouse=True)
def _port_on_cpu_in_f64():
    config.enable_x64()
    config.set_device("cpu")
    # the samplers run many tiny ops; one thread each is faster for them
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class JaxNutsDraws:
    """The numbers of one JAX transition (``friedrich_tpu/mcmc/nuts.py``),
    replayed in the order the port asks for them: the momentum key
    (``:160-161``), per doubling the split into key, direction, merge and
    tree keys (``:292-293``), per leaf the split of the tree key and its
    uniform (``:226-228``), the merge uniform (``:316``)."""

    def __init__(self, rng):
        self.r_key, self.key = jax.random.split(rng)
        self.merge_key = self.tree_key = None

    def momentum(self, dim):
        return torch.as_tensor(np.array(jax.random.normal(self.r_key, (dim,), jnp.float64)))

    def direction(self):
        self.key, dir_key, self.merge_key, self.tree_key = jax.random.split(self.key, 4)
        return bool(jax.random.bernoulli(dir_key))

    def leaf_uniform(self):
        self.tree_key, sub = jax.random.split(self.tree_key)
        return float(jax.random.uniform(sub, (), jnp.float64))

    def merge_uniform(self):
        return float(jax.random.uniform(self.merge_key, (), jnp.float64))


PREC = np.linalg.inv(np.array([[2.0, 0.9], [0.9, 1.0]]))


def _gaussian():
    return (lambda x: -0.5 * x @ jnp.asarray(PREC) @ x,
            lambda x: -0.5 * x @ torch.as_tensor(PREC) @ x)


def _minus_inf_region():
    # -inf where x0 > 0.6: a leaf that steps there diverges
    return (lambda x: jnp.where(x[0] > 0.6, -jnp.inf, -0.5 * jnp.sum(x * x)),
            lambda x: torch.where(x[0] > 0.6, -torch.inf, -0.5 * torch.sum(x * x)))


def _gp_states(n=40, cap=None, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 2))
    y = np.sin(x[:, 0]) + 0.1 * rng.normal(size=n)
    jstate, ok = jgp.make_state(jk.SquaredExp(ls=1.0, ampl=1.0), jp.ZeroPrior(), 0.3, jnp.asarray(x),
                                jnp.asarray(y), cap=cap)
    assert bool(ok)
    tstate, ok = tgp.make_state(tk.SquaredExp(ls=1.0, ampl=1.0), tp.ZeroPrior(), 0.3, torch.as_tensor(x),
                                torch.as_tensor(y), cap=cap)
    assert bool(ok)
    return jstate, tstate


def _jax_probes(jstate, num_probes=16, seed=0):
    """The JAX streamed density's probes (``friedrich_tpu/mcmc/logprob.py:255-258``)."""
    z = jnp.sign(jax.random.normal(jax.random.PRNGKey(seed), (jstate.capacity, num_probes), jnp.float64))
    return np.array(jnp.where((jnp.arange(jstate.capacity) < jstate.n)[:, None], z, 0.0))


def _gp_densities(backend, monkeypatch):
    """The dense density at n = 40, or (``"streamed"``) the same data at
    capacity 48, above a threshold monkeypatched to 32 in both packages, so
    that ``backend="auto"`` picks the streamed density."""
    if backend == "dense":
        jstate, tstate = _gp_states()
        probes = None
    else:
        monkeypatch.setattr(jlogprob, "STREAMED_LOGPROB_THRESHOLD", 32)
        monkeypatch.setattr(tlogprob, "STREAMED_LOGPROB_THRESHOLD", 32)
        jstate, tstate = _gp_states(cap=48)
        probes = _jax_probes(jstate)
    signs = np.array(jlogprob.initial_signs(jstate))
    jlogp = jlogprob.make_hyperparam_logprob(jstate, signs=signs)
    tlogp = tlogprob.make_hyperparam_logprob(tstate, signs=signs, probes=probes)
    theta0 = np.asarray(jlogprob.initial_theta(jstate)) + np.array([0.05, -0.1, 0.08])
    return jlogp, tlogp, theta0


# (target, start, step size, inverse mass, max_depth, keys)
CASES = {
    "gaussian": (_gaussian, [0.5, -0.3], 0.3, [1.0, 0.7], 8, (0, 1, 2)),
    "minus_inf_region": (_minus_inf_region, [0.4, 0.1], 0.5, [1.0, 1.0], 8, (3, 4)),
    "max_depth": (_gaussian, [0.5, -0.3], 0.01, [1.0, 1.0], 4, (5,)),
    "gp_dense": ("dense", None, 0.02, [1.0, 1.0, 1.0], 6, (6, 7)),
    "gp_streamed": ("streamed", None, 0.02, [1.0, 1.0, 1.0], 6, (9,)),
}


def _run_both(case, monkeypatch):
    target, start, eps, inv_mass, max_depth, seeds = CASES[case]
    if isinstance(target, str):
        jlogp, tlogp, start = _gp_densities(target, monkeypatch)
    else:
        jlogp, tlogp = target()
    z0 = np.asarray(start, dtype=np.float64)
    jtrans = jnuts._make_transition(jlogp, max_depth)
    jlogp0, jg0 = jax.value_and_grad(jlogp)(jnp.asarray(z0))
    val_grad = tadapt.value_and_grad(tlogp)
    tlogp0, tg0 = val_grad(torch.as_tensor(z0))
    im = np.asarray(inv_mass, dtype=np.float64)
    out = []
    for seed in seeds:
        rng = jax.random.PRNGKey(seed)
        want = jtrans(rng, jnp.asarray(z0), jlogp0, jg0, jnp.asarray(eps), jnp.asarray(im))
        got = tnuts.transition(val_grad, torch.as_tensor(z0), tlogp0, tg0, eps, torch.as_tensor(im),
                               max_depth, JaxNutsDraws(rng))
        out.append((got, want))
    return out, max_depth


@pytest.mark.parametrize("case", CASES)
def test_replayed_transition_matches_jax(case, monkeypatch):
    runs, max_depth = _run_both(case, monkeypatch)
    for (z, logp, g, accept, depth, divergent), want in runs:
        jz, jlogp, jg, jaccept, jdepth, jdiv = (np.asarray(w) for w in want)
        assert depth == int(jdepth) and divergent == bool(jdiv)
        np.testing.assert_allclose(z.numpy(), jz, rtol=RTOL, atol=1e-12)
        np.testing.assert_allclose(float(logp), float(jlogp), rtol=RTOL)
        np.testing.assert_allclose(g.numpy(), jg, rtol=RTOL, atol=1e-12)
        np.testing.assert_allclose(accept, float(jaccept), rtol=RTOL, atol=1e-14)
    depths = [r[0][4] for r in runs]
    divergent = [r[0][5] for r in runs]
    # each case exercises what it names
    if case == "minus_inf_region":
        assert all(divergent)
    elif case == "max_depth":
        assert depths == [max_depth] and not any(divergent)
    else:
        assert not any(divergent) and all(0 < d < max_depth for d in depths)


def test_streamed_density_gradient_is_deterministic(monkeypatch):
    _, tlogp, theta0 = _gp_densities("streamed", monkeypatch)
    val_grad = tadapt.value_and_grad(tlogp)
    (v1, g1), (v2, g2) = val_grad(torch.as_tensor(theta0)), val_grad(torch.as_tensor(theta0))
    assert torch.equal(v1, v2) and torch.equal(g1, g2)
    # the default probes are drawn once, when the density is made
    _, tstate = _gp_states(cap=48)
    logp = tlogprob.make_streamed_hyperparam_logprob(tstate)
    val_grad = tadapt.value_and_grad(logp)
    assert torch.equal(val_grad(torch.as_tensor(theta0))[1], val_grad(torch.as_tensor(theta0))[1])


def test_ctz_and_logaddexp():
    assert [tnuts._ctz(i) for i in (1, 2, 3, 4, 6, 8, 12, 64)] == [0, 1, 0, 2, 1, 3, 2, 6]
    for a, b in ((0.3, -1.2), (-np.inf, 2.0), (5.0, -np.inf), (-np.inf, -np.inf), (700.0, 699.0)):
        assert tnuts._logaddexp(a, b) == pytest.approx(float(np.logaddexp(a, b)), rel=1e-15)


def test_nuts_recovers_a_correlated_gaussian():
    cov = np.linalg.inv(PREC)
    res = tnuts.sample_nuts(_gaussian()[1], torch.zeros(2, dtype=torch.float64), 0, num_warmup=200,
                            num_samples=400, num_chains=4)
    moments_within_mcse(res.samples, [0.0, 0.0], cov)
    assert float(res.divergent.double().mean()) < 0.05
    assert bool(torch.all(rhat(res.samples) < 1.1))
    assert res.samples.shape == (400, 4, 2) and res.tree_depth.shape == (400, 4)


def test_nuts_recovers_an_anisotropic_gaussian():
    """Condition number 1e4 before the mass adaptation
    (``tests/test_mcmc.py:218``)."""
    scales = np.array([0.01, 0.1, 1.0, 3.0, 10.0])
    s_t = torch.as_tensor(scales)
    res = tnuts.sample_nuts(lambda x: -0.5 * torch.sum((x / s_t) ** 2),
                            torch.zeros(5, dtype=torch.float64), 3, num_warmup=300, num_samples=500,
                            num_chains=2, max_depth=6)
    moments_within_mcse(res.samples, np.zeros(5), np.diag(scales**2))
    assert bool(torch.all(rhat(res.samples) < 1.1))


def test_nuts_gp_posterior_matches_grid_quadrature():
    x, y, state = example_problem()
    # the quadrature's density is the port's density
    logp = tlogprob.make_hyperparam_logprob(state)
    probe = np.array([[0.1, -0.2, -1.0], [-0.3, 0.4, -1.3]])
    np.testing.assert_allclose(log_density(x, y, probe),
                               [float(logp(torch.as_tensor(t))) for t in probe], rtol=1e-10)
    mean, cov = quadrature_moments()
    res = sample_hyperparameters(state, 1, num_warmup=150, num_samples=300, num_chains=2, max_depth=6)
    assert float(res.divergent.double().mean()) < 0.05
    moments_within_mcse(res.samples, mean, cov)


def test_sample_hyperparameters_passes_num_probes_to_the_streamed_density():
    _, _, state = example_problem()
    run = dict(num_warmup=3, num_samples=2, num_chains=1, max_depth=3)
    got = sample_hyperparameters(state, 4, backend="streamed", num_probes=5, **run)
    logp = tlogprob.make_hyperparam_logprob(state, signs=tlogprob.initial_signs(state),
                                            backend="streamed", num_probes=5)
    want = tnuts.sample_nuts(logp, tlogprob.initial_theta(state), 4, **run)
    default = sample_hyperparameters(state, 4, backend="streamed", **run)
    assert torch.equal(got.samples, want.samples)
    assert not torch.equal(got.samples, default.samples)
