"""The port's multi-rank MCMC (``friedrich_tpu_torch/mcmc/distributed_logprob.py``,
``mcmc/sharded.py``) on the CPU: the distributed density's value and
gradient against the JAX package's on a mesh of as many virtual devices,
with its probes; one NUTS transition on that density against the JAX
transition, replaying the JAX keys' numbers; the chain-sharded samplers
against the single-process port sampler (held against the JAX package in
``tests/test_torch_nuts.py`` and ``tests/test_torch_hmc.py``), run once per
rank in this process on that rank's chains and generator, with the warmup
pooled across the runs; and ``sample_hyperparameters_distributed``.

The port runs in a world of 2 gloo ranks (``tests/torch_parallel_ranks.py``),
spawned once for the file (``tests/test_torch_parallel.py`` runs worlds of
1, 2 and 4).
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import friedrich_tpu.kernels as jk
import friedrich_tpu.priors as jp
from friedrich_tpu.mcmc import logprob as jlogprob
from friedrich_tpu.mcmc import nuts as jnuts
from friedrich_tpu.mcmc.distributed_logprob import make_distributed_hyperparam_logprob
from friedrich_tpu.models import gp as jgp
from friedrich_tpu.parallel.mesh import make_matrix_mesh

from friedrich_tpu_torch import config
from friedrich_tpu_torch import kernels as tk
from friedrich_tpu_torch import priors as tp
from friedrich_tpu_torch.mcmc import _adapt as tadapt
from friedrich_tpu_torch.mcmc import hmc as thmc
from friedrich_tpu_torch.mcmc import logprob as tlogprob
from friedrich_tpu_torch.mcmc import nuts as tnuts
from friedrich_tpu_torch.mcmc.sharded import rank_generators
from friedrich_tpu_torch.models import gp as tgp
from torch_parallel_ranks import run_world

WORLDS = (2,)
RTOL = 1e-9
SE = {"class": "SquaredExp", "params": {"ls": 1.0, "ampl": 1.0}}
ZERO = {"class": "ZeroPrior"}


def _data(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 2))
    return x, np.sin(x.sum(axis=1)) + 0.1 * rng.normal(size=n)


X48, Y48 = _data(48, 0)
X42, Y42 = _data(42, 1)
X24, Y24 = _data(24, 2)


def _jstate(x, y, cap=None):
    state, ok = jgp.make_state(jk.SquaredExp(ls=1.0, ampl=1.0), jp.ZeroPrior(), 0.3,
                               jnp.asarray(x), jnp.asarray(y), cap=cap)
    assert bool(ok)
    return state


def _tstate(x, y, cap=None):
    state, ok = tgp.make_state(tk.SquaredExp(ls=1.0, ampl=1.0), tp.ZeroPrior(), 0.3,
                               torch.as_tensor(x), torch.as_tensor(y), cap=cap)
    assert bool(ok)
    return state


def _jax_probes(jstate, num_probes=16, seed=0):
    """The JAX distributed density's probes
    (``friedrich_tpu/mcmc/distributed_logprob.py:89-93``)."""
    z = jnp.sign(jax.random.normal(jax.random.PRNGKey(seed), (jstate.capacity, num_probes),
                                   jnp.float64))
    return np.array(jnp.where((jnp.arange(jstate.capacity) < jstate.n)[:, None], z, 0.0))


def _density_case(x, y, cap):
    jstate = _jstate(x, y, cap)
    signs = np.array(jlogprob.initial_signs(jstate))
    theta0 = np.asarray(jlogprob.initial_theta(jstate))
    thetas = [theta0] + [theta0 + 0.3 * np.random.default_rng(s).normal(size=3) for s in range(3)]
    return dict(kernel=SE, prior=ZERO, noise=0.3, x=x, y=y, cap=cap or len(x), block=8,
                probes=_jax_probes(jstate), signs=signs, thetas=thetas)


DENSITY = _density_case(X48, Y48, None)
PADDED = _density_case(X42, Y42, 64)


class RecordingDraws:
    """Hands out another draws object's numbers and records them by purpose,
    for a rank to replay (``torch_parallel_ranks.ReplayDraws``)."""

    def __init__(self, draws):
        self.draws, self.recorded = draws, []

    def _record(self, purpose, value):
        self.recorded.append((purpose, value.numpy() if isinstance(value, torch.Tensor) else value))
        return value

    def momentum(self, dim):
        return self._record("momentum", self.draws.momentum(dim))

    def direction(self):
        return self._record("direction", self.draws.direction())

    def leaf_uniform(self):
        return self._record("leaf_uniform", self.draws.leaf_uniform())

    def merge_uniform(self):
        return self._record("merge_uniform", self.draws.merge_uniform())


#: one transition: (start offset, step size, inverse mass, max_depth, key)
TRANSITION = (np.array([0.05, -0.1, 0.08]), 0.02, np.ones(3), 6, 9)


def _transition_case():
    """The JAX keys' numbers as the port's transition asks for them, recorded
    on the port's single-device streamed density with the same probes."""
    from test_torch_nuts import JaxNutsDraws

    config.enable_x64()
    config.set_device("cpu")
    offset, eps, im, max_depth, seed = TRANSITION
    z0 = DENSITY["thetas"][0] + offset
    tlogp = tlogprob.make_streamed_hyperparam_logprob(
        _tstate(X48, Y48), signs=DENSITY["signs"], probes=torch.as_tensor(DENSITY["probes"]))
    val_grad = tadapt.value_and_grad(tlogp)
    logp0, g0 = val_grad(torch.as_tensor(z0))
    draws = RecordingDraws(JaxNutsDraws(jax.random.PRNGKey(seed)))
    tnuts.transition(val_grad, torch.as_tensor(z0), logp0, g0, eps, torch.as_tensor(im), max_depth,
                     draws)
    case = {k: DENSITY[k] for k in ("kernel", "prior", "noise", "x", "y", "cap", "block", "probes",
                                    "signs")}
    return dict(case, z0=z0, eps=eps, inv_mass=im, max_depth=max_depth, recorded=draws.recorded)


SAMPLER = dict(kernel=SE, prior=ZERO, noise=0.3, x=X24, y=Y24, seed=5, num_chains=4)
NUTS_KW = dict(num_warmup=10, num_samples=8, max_depth=4)
HMC_KW = dict(num_warmup=10, num_samples=8, num_leapfrog=4)


def _theta0():
    return np.asarray(tlogprob.initial_theta(_tstate(X24, Y24)))


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def world(request):
    w = request.param
    theta0 = _theta0()
    calls = [
        ("density", "density", DENSITY),
        ("padded", "density", PADDED),
        ("transition", "transition", _transition_case()),
        ("nuts", "sampler", dict(SAMPLER, kind="nuts", theta0=theta0, kwargs=NUTS_KW)),
        ("hmc", "sampler", dict(SAMPLER, kind="hmc", theta0=theta0, kwargs=HMC_KW)),
        ("distributed", "distributed_sampler",
         dict(kernel=SE, prior=ZERO, noise=0.3, x=X24, y=Y24, cap=24, block=4, seed=3,
              num_chains=2, num_warmup=4, num_samples=4, num_probes=8)),
    ]
    return w, run_world(w, calls)


def _jax_density(w, case):
    return make_distributed_hyperparam_logprob(
        make_matrix_mesh(n_devices=w), _jstate(case["x"], case["y"], case["cap"]),
        signs=jnp.asarray(case["signs"]), block=case["block"], num_probes=16)


@pytest.mark.parametrize("case", ["density", "padded"])
def test_density_value_and_gradient_match_jax(world, case):
    w, results = world
    spec = {"density": DENSITY, "padded": PADDED}[case]
    vg = jax.value_and_grad(_jax_density(w, spec))
    for r in results:
        res = r[case]
        for theta, value, grad in zip(spec["thetas"], res["values"], res["grads"]):
            jv, jg = vg(jnp.asarray(theta))
            np.testing.assert_allclose(value, float(jv), rtol=RTOL)
            np.testing.assert_allclose(grad, np.asarray(jg), rtol=RTOL, atol=1e-12)


def test_transition_on_the_distributed_density_matches_jax(world):
    w, results = world
    offset, eps, im, max_depth, seed = TRANSITION
    jlogp = _jax_density(w, DENSITY)
    z0 = jnp.asarray(DENSITY["thetas"][0] + offset)
    jlogp0, jg0 = jax.value_and_grad(jlogp)(z0)
    want = jnuts._make_transition(jlogp, max_depth)(jax.random.PRNGKey(seed), z0, jlogp0, jg0,
                                                    jnp.asarray(eps), jnp.asarray(im))
    jz, jlp, jg, jaccept, jdepth, jdiv = (np.asarray(v) for v in want)
    for r in results:
        res = r["transition"]
        assert res["depth"] == int(jdepth) and res["divergent"] == bool(jdiv)
        assert 0 < res["depth"] < max_depth
        np.testing.assert_allclose(res["z"], jz, rtol=RTOL, atol=1e-12)
        np.testing.assert_allclose(res["logp"], float(jlp), rtol=RTOL)
        np.testing.assert_allclose(res["g"], jg, rtol=RTOL, atol=1e-12)
        np.testing.assert_allclose(res["accept"], float(jaccept), rtol=RTOL, atol=1e-14)


class _ThreadPool:
    """The sharded samplers' pooling replayed in one process: ``size``
    threads, one per rank, whose ``pool_sum`` adds every thread's value in
    rank order, as the ranks' all-reduce does."""

    def __init__(self, size):
        self.size = size
        self.slots = [None] * size
        self.barrier = threading.Barrier(size, timeout=120)

    def hooks(self, rank):
        def pool_sum(v):
            self.slots[rank] = v.detach().clone()
            self.barrier.wait()
            total = self.slots[0].clone()
            for other in self.slots[1:]:
                total = total + other
            self.barrier.wait()  # every thread has read the slots
            return total

        def pool_mean(v):
            return pool_sum(v) / self.size

        return pool_mean, pool_sum


def _single_process(kind, w):
    """The port's sampler in this process, once per rank of the sharded
    run: that rank's chains and generator, with the warmup statistics
    pooled across the runs; the runs' chains joined in rank order."""
    config.enable_x64()
    config.set_device("cpu")
    gen = tadapt.as_generator(SAMPLER["seed"])
    chains = SAMPLER["num_chains"]
    local = chains // w
    starts = tadapt.chain_starts(torch.as_tensor(_theta0()), chains, gen)
    gens = rank_generators(gen, w)
    pool = _ThreadPool(w)
    results, errors = [None] * w, []

    def run(rank):
        try:
            logp = tlogprob.make_hyperparam_logprob(_tstate(X24, Y24), backend="dense")
            pool_mean, pool_sum = pool.hooks(rank)
            sampler, kw = ((tnuts.sample_nuts, NUTS_KW) if kind == "nuts"
                           else (thmc.sample_hmc, HMC_KW))
            results[rank] = sampler(logp, starts[rank * local:(rank + 1) * local], gens[rank],
                                    num_chains=local, pool_mean=pool_mean, pool_sum=pool_sum, **kw)
        except BaseException as e:  # noqa: BLE001 - re-raised in the test's thread
            errors.append(e)
            pool.barrier.abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(w)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads), "a sampler thread hung"
    if errors:
        raise errors[0]
    chain_axis = {"samples": 1, "accept_prob": 1, "tree_depth": 1, "divergent": 1, "final_logp": 0}
    out = {}
    for name, value in results[0]._asdict().items():
        if name in chain_axis:
            value = torch.cat([getattr(r, name) for r in results], dim=chain_axis[name])
        out[name] = value  # step_size, inv_mass: pooled, the same in every run
    return out


@pytest.fixture
def one_thread():
    # the samplers run many tiny ops; one thread is faster for them
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("kind", ["nuts", "hmc"])
def test_sharded_sampler_matches_single_process(world, kind, one_thread):
    w, results = world
    want = _single_process(kind, w)
    for r in results:
        res = r[kind]
        assert res["samples"].shape == (8, SAMPLER["num_chains"], 3)
        for name, value in want.items():
            np.testing.assert_allclose(res[name], value.numpy(), rtol=RTOL, atol=1e-12,
                                       err_msg=name)


def test_distributed_sampler_runs_the_same_chains_on_every_rank(world):
    _, results = world
    res = results[0]["distributed"]
    assert res["samples"].shape == (4, 2, 3)
    assert np.all(np.isfinite(res["samples"]))
    assert res["step_size"].shape == (2,) and res["inv_mass"].shape == (2, 3)
    for r in results[1:]:
        for name, value in r["distributed"].items():
            np.testing.assert_array_equal(value, res[name], err_msg=name)
