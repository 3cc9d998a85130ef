"""Ranks of the port's multi-rank tests (``tests/test_torch_parallel*.py``).

:func:`run_world` starts a world of CPU processes (gloo, a file store in a
temporary directory), each of which calls the named functions of this
module in turn with its mesh and the given keyword arguments (numpy inputs,
spec dicts) and hands back what they return. Spawned ranks import this
module, so it imports torch and the port only, never JAX: the tests hold
the results against the JAX package in their own process.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time
import traceback

import numpy as np
import torch

#: Seconds a world may take before its ranks are stopped and the test fails
#: (a hung collective fails instead of holding the suite).
WORLD_TIMEOUT_S = 240.0


def run_world(world: int, calls: list, timeout: float = WORLD_TIMEOUT_S) -> list[dict]:
    """Run ``calls``, a list of ``(key, function name, kwargs)``, on every
    rank of a world of ``world`` processes; returns one dict per rank, rank
    order, of ``key -> result``. Raises ``AssertionError`` with the failing
    rank's traceback, or when the world outlasts ``timeout``."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        url = f"file://{tmp}/store"
        procs = [ctx.Process(target=_rank_main, args=(r, world, url, calls, tmp))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        errors = [open(os.path.join(tmp, f"{r}.err")).read() for r in range(world)
                  if os.path.exists(os.path.join(tmp, f"{r}.err"))]
        if errors:
            raise AssertionError(f"a rank of the world of {world} failed:\n" + "\n".join(errors))
        if hung:
            raise AssertionError(f"ranks {hung} of the world of {world} outlasted {timeout} s")
        results = []
        for r, p in enumerate(procs):
            if p.exitcode != 0:
                raise AssertionError(f"rank {r} of the world of {world} exited with {p.exitcode}")
            with open(os.path.join(tmp, f"{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results


def _rank_main(rank: int, world: int, url: str, calls: list, out_dir: str) -> None:
    try:
        torch.set_num_threads(1)
        from friedrich_tpu_torch import config
        from friedrich_tpu_torch.parallel import make_matrix_mesh, multihost

        config.set_device("cpu")
        config.enable_x64()
        multihost.initialize(url, world, rank, device="cpu")
        mesh = make_matrix_mesh(world)
        results = {key: globals()[name](mesh, **kwargs) for key, name, kwargs in calls}
        with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
        multihost.shutdown()
    except Exception:  # reported to the test, then the rank ends
        with open(os.path.join(out_dir, f"{rank}.err"), "w") as f:
            f.write(f"rank {rank}:\n{traceback.format_exc()}")
        os._exit(1)


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
