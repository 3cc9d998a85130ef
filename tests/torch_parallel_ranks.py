"""Ranks of the port's multi-rank tests (``tests/test_torch_parallel*.py``).

:func:`run_world` starts a world of CPU processes (gloo, a file store in a
temporary directory: ``parallel/multihost.spawn``), each of which calls the named functions of this
module in turn with its mesh and the given keyword arguments (numpy inputs,
spec dicts) and hands back what they return. Spawned ranks import this
module, so it imports torch and the port only, never JAX: the tests hold
the results against the JAX package in their own process.
"""

from __future__ import annotations

import numpy as np
import torch

#: Seconds a world may take before its ranks are stopped and the test fails
#: (a hung collective fails instead of holding the suite).
WORLD_TIMEOUT_S = 240.0


def run_world(world: int, calls: list, timeout: float = WORLD_TIMEOUT_S) -> list[dict]:
    """Run ``calls``, a list of ``(key, function name, kwargs)``, on every
    rank of a world of ``world`` processes (``parallel/multihost.spawn``);
    returns one dict per rank, rank order, of ``key -> result``. Raises with
    the failing rank's traceback, or when the world outlasts ``timeout``."""
    from friedrich_tpu_torch.parallel.multihost import spawn

    return spawn(world, _run_calls, timeout=timeout, calls=calls)


def _run_calls(mesh, calls: list) -> dict:
    from friedrich_tpu_torch import config

    config.set_device("cpu")
    config.enable_x64()
    return {key: globals()[name](mesh, **kwargs) for key, name, kwargs in calls}


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _kernel(spec, dtype=torch.float64):
    from friedrich_tpu_torch.interop import kernel_from_spec

    return kernel_from_spec(spec).to(dtype, "cpu")


def _prior(spec, dtype=torch.float64):
    from friedrich_tpu_torch.interop import prior_from_spec

    return prior_from_spec(spec).to(dtype, "cpu")


def _np(t):
    if isinstance(t, torch.Tensor):
        t = t.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return t


def _counted(fn):
    """``(fn(), the collectives it sent)``."""
    from friedrich_tpu_torch.parallel.mesh import COLLECTIVES

    COLLECTIVES.clear()
    out = fn()
    return out, dict(COLLECTIVES)


def _factor(mesh, kernel, x_pad, n, noise, block, **kw):
    from friedrich_tpu_torch.parallel.distributed_cholesky import distributed_cholesky_factor

    x = torch.as_tensor(x_pad)
    r0, r1 = mesh.rows(x.shape[0])
    return distributed_cholesky_factor(mesh, _kernel(kernel, x.dtype), x[r0:r1].contiguous(), n,
                                       noise, block=block, **kw)


# ---------------------------------------------------------------------------
# tests/test_torch_parallel.py: factor, solves, append, collectives
# ---------------------------------------------------------------------------


def factor(mesh, kernel, x_pad, n, noise, block, eps=None, storage=None):
    (l_local, ok), counts = _counted(lambda: _factor(mesh, kernel, x_pad, n, noise, block, eps=eps,
                                                     storage=storage))
    return {"l": _np(l_local), "ok": bool(ok), "collectives": counts,
            "dtype": str(l_local.dtype)}


def solves(mesh, kernel, x_pad, n, noise, block, c, xq):
    from friedrich_tpu_torch.parallel import distributed_solve as ds

    l_local, ok = _factor(mesh, kernel, x_pad, n, noise, block)
    c = torch.as_tensor(c)
    x = torch.as_tensor(x_pad)
    r0, r1 = mesh.rows(x.shape[0])
    out = {"ok": bool(ok)}
    runs = {
        "forward": lambda: ds.distributed_solve_lower(mesh, l_local, c, block),
        "backward": lambda: ds.distributed_solve_lower_t(mesh, l_local, c, block),
        "sharded": lambda: ds.distributed_solve_lower_sharded_rhs(mesh, l_local, c[r0:r1], block),
        "cho": lambda: ds.distributed_cho_solve(mesh, l_local, c, block),
        "vector": lambda: ds.distributed_solve_lower(mesh, l_local, c[:, 0], block),
        "cross": lambda: ds.distributed_cross_covariance(mesh, _kernel(kernel), x[r0:r1], n,
                                                         torch.as_tensor(xq)),
    }
    for name, fn in runs.items():
        res, counts = _counted(fn)
        out[name], out[f"{name}_collectives"] = _np(res), counts
    return out


def append(mesh, kernel, x_pad, n, noise, block, x_new):
    from friedrich_tpu_torch.parallel.distributed_append import distributed_cholesky_append

    l_local, _ = _factor(mesh, kernel, x_pad, n, noise, block)
    k = len(x_new)
    x2 = torch.as_tensor(x_pad).clone()
    x2[n:n + k] = torch.as_tensor(x_new)
    r0, r1 = mesh.rows(x2.shape[0])
    ok = distributed_cholesky_append(mesh, l_local, _kernel(kernel), x2[r0:r1].contiguous(), n,
                                     torch.as_tensor(x_new), noise, block=block)
    retrain, _ = _factor(mesh, kernel, x2.numpy(), n + k, noise, block)
    return {"ok": ok, "l": _np(l_local), "retrain": _np(retrain)}


def fit_step_collectives(mesh, kernel, x, y, noise, block, num_probes):
    """The collectives of one ``LargeScaleGP`` fit iteration and of its
    refactorization alone."""
    from friedrich_tpu_torch.models.optimizer import AdamState
    from friedrich_tpu_torch.parallel import LargeScaleGP
    from friedrich_tpu_torch.priors import ZeroPrior

    gp = LargeScaleGP(mesh, _kernel(kernel), ZeroPrior(), noise, x, y, block=block)
    probes = gp._probes(num_probes, 0)
    params = gp.kernel.get_params()
    adam = AdamState(params=params, m=torch.zeros_like(params), v=torch.zeros_like(params))
    _, step = _counted(lambda: gp._step(adam, probes, 1, True, 0.05))
    _, refactor = _counted(lambda: gp._refactor())
    return {"step": step, "refactor": refactor, "cap": gp.capacity}


# ---------------------------------------------------------------------------
# tests/test_torch_parallel_large_scale.py: LargeScaleGP and sharded.py
# ---------------------------------------------------------------------------


def _large(mesh, kernel, prior, noise, x, y, block, **kw):
    from friedrich_tpu_torch.parallel import LargeScaleGP

    return LargeScaleGP(mesh, _kernel(kernel), _prior(prior), noise, x, y, block=block, **kw)


def ls_predict(mesh, kernel, prior, noise, x, y, block, xq, capacity=None, batch_size=None):
    gp = _large(mesh, kernel, prior, noise, x, y, block, capacity=capacity)
    mean, var = gp.predict_mean_variance(xq)
    out = {"mean": _np(mean), "var": _np(var), "predict": _np(gp.predict(xq)),
           "variance": _np(gp.predict_variance(xq)), "lml": gp.log_marginal_likelihood(),
           "likelihood": gp.likelihood(), "capacity": gp.capacity}
    post = gp.sample_at(xq)
    out["sample_mean"] = _np(post.mean())
    out["draw"] = _np(post.sample(torch.Generator().manual_seed(0)))
    if batch_size is not None:
        mb, vb = gp.predict_in_batches(xq, batch_size=batch_size)
        out["batched_mean"], out["batched_var"] = _np(mb), _np(vb)
    return out


def ls_fit(mesh, kernel, prior, noise, x, y, block, probes, max_iter, scaled,
           convergence_fraction=1e-12):
    gp = _large(mesh, kernel, prior, noise, x, y, block)
    before = gp.log_marginal_likelihood()
    fit = gp.fit_scaled if scaled else gp.fit_generic
    fit(max_iter=max_iter, convergence_fraction=convergence_fraction, probes=torch.as_tensor(probes))
    return {"params": _np(gp.kernel.get_params()), "noise": float(gp.noise), "lml_before": before,
            "lml": gp.log_marginal_likelihood()}


def ls_append(mesh, kernel, prior, noise, x, y, block, x_new, y_new, xq, capacity=None,
              storage=None):
    gp = _large(mesh, kernel, prior, noise, x, y, block, capacity=capacity, storage=storage)
    out = {}
    try:
        gp.add_samples(x_new, y_new)
        out["raised"] = None
    except ValueError as e:
        out["raised"] = str(e)
        gp.add_samples(x_new, y_new, auto_grow=True)
    mean, var = gp.predict_mean_variance(xq)
    out.update({"n": gp.n, "capacity": gp.capacity, "mean": _np(mean), "var": _np(var),
                "predict": _np(gp.predict(xq))})
    try:
        gp.add_samples(np.zeros((gp.capacity, x.shape[1])), np.zeros(gp.capacity))
        out["overflow_raised"] = False
    except ValueError:
        out["overflow_raised"] = True
    return out


def ls_cache(mesh, kernel, prior, noise, x, y, block, capacity, xq, x_new, y_new, probes):
    from friedrich_tpu_torch.parallel import LargeScaleGP

    gp = _large(mesh, kernel, prior, noise, x, y, block, capacity=capacity)
    out = {"empty_at_start": gp._cached_weights is None}
    before = _np(gp.predict(xq))
    w0 = gp._cached_weights
    gp.predict_mean_variance(xq)
    out["reused"] = w0 is not None and gp._cached_weights is w0
    gp.fit_scaled(max_iter=2, convergence_fraction=1e-12, probes=torch.as_tensor(probes))
    out["dropped_by_fit"] = gp._cached_weights is None
    after_fit = _np(gp.predict(xq))
    out["moved"] = not np.allclose(before, after_fit)
    gp.add_samples(x_new, y_new)
    out["dropped_by_append"] = gp._cached_weights is None
    out["got"] = _np(gp.predict(xq))
    fresh = LargeScaleGP(mesh, gp.kernel, _prior(prior), float(gp.noise),
                         np.concatenate([x, x_new]), np.concatenate([y, y_new]), block=block)
    out["fresh"] = _np(fresh.predict(xq))
    out["params"], out["noise"] = _np(gp.kernel.get_params()), float(gp.noise)
    return out


def ls_append_failure(mesh, kernel, prior, x, y, block, capacity, xq, storage=None):
    """Appending exact duplicates at zero noise fails; the model must stay
    as it was."""
    from friedrich_tpu_torch.utils.errors import CholeskyError

    x = np.asarray(x, dtype=np.float32 if storage == "bf16" else np.float64)
    gp = _large(mesh, kernel, prior, 0.0, x, np.asarray(y, x.dtype), block, capacity=capacity,
                storage=storage)
    before = _np(gp.predict(xq))
    try:
        gp.add_samples(x[:5], np.asarray(y[:5], x.dtype))
        raised = False
    except CholeskyError:
        raised = True
    return {"raised": raised, "n": gp.n, "before": before, "after": _np(gp.predict(xq))}


def outofcore_vs_large(mesh, x, y, block, max_iter, num_probes):
    """``OutOfCoreGP``'s fit (one process) against ``LargeScaleGP``'s on the
    mesh (float32, the same probes: ``tests/test_outofcore_gp.py:132``)."""
    from friedrich_tpu_torch.kernels import SquaredExp
    from friedrich_tpu_torch.models.outofcore_gp import OutOfCoreGP
    from friedrich_tpu_torch.parallel import LargeScaleGP
    from friedrich_tpu_torch.priors import ZeroPrior

    x32, y32 = np.asarray(x, np.float32), np.asarray(y, np.float32)
    kern = SquaredExp(ls=0.8, ampl=1.0)
    ref = LargeScaleGP(mesh, kern, ZeroPrior(), 0.3, x32, y32, block=block)
    ref.fit_scaled(max_iter=max_iter, num_probes=num_probes, seed=0)
    gp = OutOfCoreGP(kern, ZeroPrior(), 0.3, x32, y32, block=block, device="cpu")
    gp.fit_scaled(max_iter=max_iter, num_probes=num_probes, seed=0)
    return {"large_params": _np(ref.kernel.get_params()), "large_noise": float(ref.noise),
            "ooc_params": _np(gp.kernel.get_params()), "ooc_noise": float(gp.noise)}


def _state(kernel, prior, noise, x, y, cap):
    from friedrich_tpu_torch.models import gp as core

    state, ok = core.make_state(_kernel(kernel), _prior(prior), noise, torch.as_tensor(x),
                                torch.as_tensor(y), cap=cap)
    assert bool(ok)
    return state


def sharded(mesh, kernel, prior, noise, x, y, cap, xq, scalable):
    from friedrich_tpu_torch.models.optimizer import AdamState
    from friedrich_tpu_torch.parallel import (
        make_sharded_build_and_factor,
        make_sharded_predict,
        make_sharded_train_step,
        shard_state,
    )

    state = _state(kernel, prior, noise, x, y, cap)
    l_local, ok = make_sharded_build_and_factor(mesh)(state.kernel, state.x, state.n, state.noise)
    sstate = shard_state(state, mesh)
    mean, var = make_sharded_predict(mesh)(sstate, torch.as_tensor(xq))
    params = state.kernel.get_params()
    if not scalable:
        params = torch.cat([params, torch.log(state.noise)[None]])
    adam = AdamState(params=params, m=torch.zeros_like(params), v=torch.zeros_like(params))
    out_state, out_adam, progress, step_ok = make_sharded_train_step(mesh, scalable)(
        sstate, adam, 1, 0.05)
    return {"l": _np(l_local), "ok": bool(ok), "mean": _np(mean), "var": _np(var),
            "step_l": _np(out_state.l), "step_ok": bool(step_ok),
            "adam_params": _np(out_adam.params), "noise": float(out_state.noise),
            "progress": bool(progress)}


# ---------------------------------------------------------------------------
# tests/test_torch_parallel_mcmc.py: the distributed density, the samplers
# ---------------------------------------------------------------------------


def _density(mesh, kernel, prior, noise, x, y, cap, block, probes, signs):
    from friedrich_tpu_torch.mcmc.distributed_logprob import make_distributed_hyperparam_logprob

    state = _state(kernel, prior, noise, x, y, cap)
    return make_distributed_hyperparam_logprob(mesh, state, signs=signs, block=block,
                                               probes=torch.as_tensor(probes))


def density(mesh, kernel, prior, noise, x, y, cap, block, probes, signs, thetas):
    from friedrich_tpu_torch.mcmc._adapt import value_and_grad

    val_grad = value_and_grad(_density(mesh, kernel, prior, noise, x, y, cap, block, probes, signs))
    out = [val_grad(torch.as_tensor(t)) for t in thetas]
    return {"values": [float(v) for v, _ in out], "grads": [_np(g) for _, g in out]}


class ReplayDraws:
    """A transition's random numbers replayed from a recorded list of
    ``(purpose, value)``, each asked for by the same purpose in turn."""

    def __init__(self, recorded):
        self.recorded = list(recorded)

    def _next(self, purpose):
        got, value = self.recorded.pop(0)
        assert got == purpose, f"asked for {purpose}, recorded {got}"
        return value

    def momentum(self, dim):
        return torch.as_tensor(self._next("momentum"))

    def direction(self):
        return self._next("direction")

    def leaf_uniform(self):
        return self._next("leaf_uniform")

    def merge_uniform(self):
        return self._next("merge_uniform")


def transition(mesh, kernel, prior, noise, x, y, cap, block, probes, signs, z0, eps, inv_mass,
               max_depth, recorded):
    from friedrich_tpu_torch.mcmc import nuts
    from friedrich_tpu_torch.mcmc._adapt import value_and_grad

    val_grad = value_and_grad(_density(mesh, kernel, prior, noise, x, y, cap, block, probes, signs))
    z0 = torch.as_tensor(z0)
    logp0, g0 = val_grad(z0)
    z, logp, g, accept, depth, divergent = nuts.transition(
        val_grad, z0, logp0, g0, eps, torch.as_tensor(inv_mass), max_depth, ReplayDraws(recorded))
    return {"z": _np(z), "logp": float(logp), "g": _np(g), "accept": accept, "depth": depth,
            "divergent": divergent}


def sampler(mesh, kind, kernel, prior, noise, x, y, theta0, seed, num_chains, kwargs):
    from friedrich_tpu_torch.mcmc import make_hyperparam_logprob
    from friedrich_tpu_torch.mcmc.sharded import sample_hmc_sharded, sample_nuts_sharded
    from friedrich_tpu_torch.parallel import make_chain_mesh

    state = _state(kernel, prior, noise, x, y, None)
    logp = make_hyperparam_logprob(state, backend="dense")
    fn = sample_nuts_sharded if kind == "nuts" else sample_hmc_sharded
    res = fn(make_chain_mesh(mesh.size), logp, torch.as_tensor(theta0), seed, num_chains=num_chains,
             **kwargs)
    return {k: _np(v) for k, v in res._asdict().items()}


def distributed_sampler(mesh, kernel, prior, noise, x, y, cap, block, seed, num_chains, num_warmup,
                        num_samples, num_probes):
    from friedrich_tpu_torch.mcmc.distributed_logprob import sample_hyperparameters_distributed

    state = _state(kernel, prior, noise, x, y, cap)
    res = sample_hyperparameters_distributed(mesh, state, seed, num_warmup=num_warmup,
                                             num_samples=num_samples, num_chains=num_chains,
                                             max_depth=4, block=block, num_probes=num_probes)
    return {k: _np(v) for k, v in res._asdict().items()}


def ls_from_arrays(mesh, arrays, kernel, prior, block, xq):
    """A JAX ``LargeScaleGP``'s arrays as this rank's model, without
    refactoring (``interop.large_scale_from_arrays``)."""
    from friedrich_tpu_torch.interop import large_scale_from_arrays

    gp = large_scale_from_arrays(mesh, arrays, kernel, prior, block=block)
    mean, var = gp.predict_mean_variance(xq)
    return {"mean": _np(mean), "var": _np(var), "lml": gp.log_marginal_likelihood(),
            "l_local": _np(gp.l_local)}


# ---------------------------------------------------------------------------
# tests/test_torch_serving_large_scale.py: a LargeScaleGP served from rank 0
# ---------------------------------------------------------------------------


def _serve_clients(port, requests, clients):
    """``requests`` sent round-robin by ``clients`` client threads at once
    (so that the server merges them); the replies in request order."""
    import threading

    from friedrich_tpu_torch import serving

    replies, errors = [None] * len(requests), []
    barrier = threading.Barrier(clients)

    def run(i):
        try:
            with serving.GPClient(port=port, timeout=60.0) as c:
                barrier.wait()
                for k in range(i, len(requests), clients):
                    replies[k] = c.predict_mean_variance(requests[k])
        except Exception as e:  # reported to the test
            errors.append(repr(e))

    threads = [threading.Thread(target=run, args=(i,)) for i in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60.0)
    return replies, errors


def ls_serve(mesh, arrays, kernel, prior, block, requests, xq, solve_width, clients):
    """The carried model served: rank 0 runs ``AcceleratedGPServer`` and
    ``clients`` client threads, every other rank ``serving.follow``. Every
    rank first answers each request in process at the server's width, and
    ``xq`` at widths 8 and none."""
    from friedrich_tpu_torch import ConfigError, serving
    from friedrich_tpu_torch.interop import large_scale_from_arrays
    from friedrich_tpu_torch.parallel.mesh import COLLECTIVES

    # the "direct" distance makes the cross covariance elementwise, as the
    # covariance kernel is on the card: a query's answer is then the same
    # bits wherever a merged chunk puts it
    gp = large_scale_from_arrays(mesh, arrays, kernel, prior, block=block, method="direct")
    xq = torch.as_tensor(xq)
    out = {"one_solve": [_np(t) for t in gp.predict_mean_variance(xq)],
           "width_8": [_np(t) for t in gp.predict_mean_variance(xq, block=8)],
           "in_process": [[_np(t) for t in gp.predict_mean_variance(torch.as_tensor(q),
                                                                     block=solve_width)]
                          for q in requests]}
    COLLECTIVES.clear()
    if mesh.rank != 0:
        out["sweeps"] = serving.follow(gp)
        out["collectives"] = dict(COLLECTIVES)
        return out
    with serving.AcceleratedGPServer(gp, block=solve_width) as srv:
        with serving.GPClient(port=srv.port, timeout=60.0) as c:
            try:
                c.predict(np.zeros((2, gp.x.shape[1] + 1)))
                out["wrong_width"] = "answered"
            except ConfigError as e:
                out["wrong_width"] = str(e)
            out["wrong_width_collectives"] = dict(COLLECTIVES)
        out["served"], out["errors"] = _serve_clients(srv.port, requests, clients)
    out["sweeps"] = sum(srv.dispatches.values())
    out["broken"] = repr(srv.broken) if srv.broken is not None else None
    out["collectives"] = dict(COLLECTIVES)
    return out


def ls_serve_follower_fails(mesh, arrays, kernel, prior, block, requests):
    """Rank 1's model raises in its second sweep, and rank 1 leaves the
    world: rank 0 must answer that request and every later one with an
    error, not wait."""
    import torch.distributed as dist

    from friedrich_tpu_torch import ConfigError, serving
    from friedrich_tpu_torch.interop import large_scale_from_arrays

    gp = large_scale_from_arrays(mesh, arrays, kernel, prior, block=block)
    if mesh.rank != 0:
        calls = []
        inner = gp.predict_mean_variance

        def flaky(xq, block=None):
            calls.append(1)
            if len(calls) == 2:
                raise RuntimeError("rank 1 failed inside the sweep")
            return inner(xq, block=block)

        gp.predict_mean_variance = flaky
        if mesh.rank == 1:
            try:
                serving.follow(gp)
                return {"raised": None}
            except RuntimeError as e:
                dist.destroy_process_group()  # what the rank's exit would do
                return {"raised": str(e)}
        return {"raised": None}
    statuses = []
    with serving.AcceleratedGPServer(gp) as srv:
        with serving.GPClient(port=srv.port, timeout=60.0) as c:
            for q in requests:
                try:
                    c.predict_mean_variance(q)
                    statuses.append("ok")
                except ConfigError as e:
                    statuses.append(str(e))
    return {"statuses": statuses, "broken": srv.broken is not None}


# ---------------------------------------------------------------------------
# tests/test_torch_examples.py: the distributed_gp twin's flow on each rank
# ---------------------------------------------------------------------------


def example_distributed_gp(mesh, n, d, seed, dtype, probes):
    """``friedrich_tpu_torch.examples.distributed_gp.run`` on this rank, with
    the given Hutchinson probes; its numbers and whether rank 0's served
    answers equal the in-process ones."""
    from friedrich_tpu_torch.examples.distributed_gp import run

    _, out = run(mesh, n=n, d=d, seed=seed, dtype=getattr(torch, dtype), probes=torch.as_tensor(probes))
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_sharded_builder.py: the builder's sharded backend
# ---------------------------------------------------------------------------


def _hyper(gp) -> dict:
    return {"kernel": _np(gp.kernel.get_params()), "noise": float(gp.noise),
            "prior": float(gp.prior.c)}


def builder_subfit(mesh, x, y, xq, subsample):
    """``train()`` with the sharded backend and a sub-fit, beside the
    one-card builder's on the same data."""
    from friedrich_tpu_torch import GaussianProcess

    x, y = torch.as_tensor(x), torch.as_tensor(y)

    def builder(backend):
        return (GaussianProcess.builder(x, y, device="cpu").set_noise(1.0).set_backend(backend)
                .set_fit_subsample(subsample).fit_kernel().fit_prior())

    sharded = builder("sharded")
    gp = sharded.train()
    one = builder("dense").train()
    mean, var = gp.predict_mean_variance(torch.as_tensor(xq))
    return {"type": type(gp).__name__, "mesh": (gp.mesh.rank, gp.mesh.size),
            "capacity": gp.capacity, "timings": sorted(sharded.timings), **_hyper(gp),
            "one": _hyper(one), "mean": _np(mean), "var": _np(var)}


def builder_full_fit(mesh, x, y, max_iter):
    """``train()`` with the sharded backend and no sub-fit, beside the same
    steps taken by hand: the prior and the heuristic kernel on the full
    data, a ``LargeScaleGP`` and its ``fit_scaled``."""
    from friedrich_tpu_torch import GaussianProcess
    from friedrich_tpu_torch.kernels import Gaussian
    from friedrich_tpu_torch.parallel import LargeScaleGP
    from friedrich_tpu_torch.priors import ConstantPrior

    x, y = torch.as_tensor(x), torch.as_tensor(y)
    builder = (GaussianProcess.builder(x, y, device="cpu").set_noise(1.0).set_backend("sharded")
               .set_fit_subsample(None).set_fit_parameters(max_iter, 0.05).fit_kernel().fit_prior())
    gp = builder.train()
    by_hand = LargeScaleGP(mesh, Gaussian().heuristic_fit(x, y), ConstantPrior().fit(x, y), 1.0,
                           x, y)
    by_hand.fit_scaled(max_iter=max_iter, convergence_fraction=0.05)
    return {"type": type(gp).__name__, "timings": dict(builder.timings), **_hyper(gp),
            "by_hand": _hyper(by_hand), "iterations": by_hand.fit_iterations}


def build_counts(mesh, x, y, block):
    """One ``LargeScaleGP`` build: its broadcasts' bytes and counts, its
    spans, and the shapes of its B2 calls as the kernel's wrapper counts a
    launch (``panel_strip_cuda.launch_shape``; the CPU runs B2's plain
    version, which launches nothing)."""
    from friedrich_tpu_torch.kernels import Gaussian
    from friedrich_tpu_torch.ops.cuda import panel_strip_cuda
    from friedrich_tpu_torch.parallel import LargeScaleGP, distributed_cholesky as dc, mesh as m
    from friedrich_tpu_torch.priors import ZeroPrior
    from friedrich_tpu_torch.utils import profiling

    original, calls = dc.panel_strip, []

    def recorded(kernel, x_tail, xj, l_full, n, noise, j0, block, method="gram", precision=None,
                 prefix=None, end=None, panel_rows=None, row0=None):
        calls.append(panel_strip_cuda.launch_shape(x_tail.shape[0], block, prefix.shape[1],
                                                   x_tail.shape[1], x_tail.dtype,
                                                   panel_rows is not None))
        return original(kernel, x_tail, xj, l_full, n, noise, j0, block, method, precision,
                        prefix, end, panel_rows, row0)

    counts, sent = dict(m.COLLECTIVES), dict(m.COLLECTIVE_BYTES)
    dc.panel_strip = recorded
    try:
        with profiling.record_spans():
            profiling.drain()
            LargeScaleGP(mesh, Gaussian(ls=1.5, ampl=1.0), ZeroPrior(), 0.5, torch.as_tensor(x),
                         torch.as_tensor(y), block=block)
            spans = profiling.drain()
    finally:
        dc.panel_strip = original
    delta = {kind: sum(v - counts.get(k, 0) for k, v in m.COLLECTIVES.items() if k[0] == kind)
             for kind in ("broadcast", "all_reduce")}
    return {"counts": delta,
            "bytes": {k: v - sent.get(k, 0) for k, v in m.COLLECTIVE_BYTES.items()},
            "spans": [(s.name, dict(s.attrs)) for s in spans], "launches": calls}
