"""Entry points of the port: a compile-check forward step and a multi-rank
dry run.

Counterparts of ``__graft_entry__.py``'s ``entry()`` (``:33-41``) and
``dryrun_multichip()`` (``:44-``):

- :func:`entry` returns ``(fn, example_args)``: the posterior mean and
  variance of a tiny RBF model (``models/gp.predict_mean_variance``) and
  its arguments;
- :func:`dryrun_multichip` runs the whole multi-rank stack once on tiny
  shapes on a world of ``n`` ranks: the sharded exact training step, the
  distributed factorization and solves (float32 and bfloat16 storage), the
  distributed append, the sharded build and predict, chain-sharded NUTS,
  and ``LargeScaleGP`` (fit, predict, append; bfloat16 storage).

Both run on the card unless the caller asks for the CPU (``device="cpu"``,
where the dry run's ranks talk through gloo).
"""

from __future__ import annotations

import sys
from typing import Optional

import numpy as np
import torch

from .config import resolve_device

#: Seconds a dry run's ranks may take before they are stopped and the run
#: fails.
DRYRUN_TIMEOUT_S = 600.0


def _tiny_state(n: int = 32, d: int = 4, cap: Optional[int] = None, device=None,
                dtype=torch.float32):
    from .kernels import SquaredExp
    from .models import gp as core
    from .priors import ConstantPrior

    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(n, d)), dtype=dtype, device=device)
    y = torch.as_tensor(rng.normal(size=(n,)), dtype=dtype, device=device)
    state, ok = core.make_state(SquaredExp(ls=1.0, ampl=1.0), ConstantPrior(c=0.0), 0.1, x, y,
                                cap=cap)
    if not bool(ok):
        raise RuntimeError("entry: the tiny model's factorization failed")
    return state


def entry(device=None):
    """``(fn, example_args)``: the forward step of the flagship model (an
    exact RBF GP's posterior mean and variance over 64 queries, n = 256,
    d = 8) and its arguments, on ``device`` (the card by default)."""
    from .models import gp as core

    device = resolve_device(device)
    state = _tiny_state(n=256, d=8, device=device)
    xq = torch.as_tensor(np.random.default_rng(1).normal(size=(64, 8)), dtype=state.x.dtype,
                         device=device)
    return core.predict_mean_variance, (state, xq)


def _check(ok, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {what}")


def _dryrun_rank(n_devices: int) -> None:
    """The stack of ``__graft_entry__.dryrun_multichip`` on this rank of an
    initialized world of ``n_devices`` ranks."""
    from .kernels import SquaredExp
    from .mcmc import initial_theta, make_hyperparam_logprob
    from .mcmc.sharded import sample_nuts_sharded
    from .models.optimizer import AdamState
    from .parallel import (
        LargeScaleGP,
        make_chain_mesh,
        make_matrix_mesh,
        make_sharded_build_and_factor,
        make_sharded_predict,
        make_sharded_train_step,
        shard_state,
    )
    from .parallel.distributed_append import distributed_cholesky_append
    from .parallel.distributed_cholesky import distributed_cholesky_factor
    from .parallel.distributed_solve import distributed_cho_solve
    from .priors import ConstantPrior

    mesh = make_matrix_mesh(n_devices)
    dev = mesh.device
    # capacity a multiple of the ranks (no panel straddles two); at least 16
    cap = max(8 * n_devices, 16)
    full = _tiny_state(n=cap - 4, d=4, cap=cap, device=dev)
    state = shard_state(full, mesh)
    r0, r1 = mesh.rows(cap)
    x_local = state.x[r0:r1]

    # (1) the exact training step, the factor row-sharded
    params = state.kernel.get_params()
    adam = AdamState(params=params, m=torch.zeros_like(params), v=torch.zeros_like(params))
    state, adam, _, ok = make_sharded_train_step(mesh, scalable=True)(state, adam, 1, 0.05)
    _check(bool(ok), "sharded training step: Cholesky failed")

    # (2) distributed Cholesky and cho_solve; (2a) bfloat16 storage
    l_sh, ok = distributed_cholesky_factor(mesh, state.kernel, x_local, state.n, state.noise,
                                           block=8)
    _check(bool(ok), "distributed Cholesky failed")
    w = distributed_cho_solve(mesh, l_sh, state.resid[:, None], block=8)
    _check(w.shape == (cap, 1), f"distributed cho_solve gave {tuple(w.shape)}")
    l_bf, ok = distributed_cholesky_factor(mesh, state.kernel, x_local, state.n, state.noise,
                                           block=8, storage="bf16")
    _check(bool(ok) and l_bf.dtype == torch.bfloat16, "distributed bf16-storage Cholesky failed")
    w_bf = distributed_cho_solve(mesh, l_bf, state.resid[:, None], block=8)
    _check(w_bf.dtype == state.x.dtype, "a sweep of the bf16 factor left the input dtype")

    # (2b) distributed rank-k append
    x_app = torch.as_tensor(np.random.default_rng(3).normal(size=(4, 4)), dtype=state.x.dtype,
                            device=dev)
    x_pad2 = state.x.clone()
    x_pad2[state.n:state.n + 4] = x_app
    appended = distributed_cholesky_append(mesh, l_sh, state.kernel, x_pad2[r0:r1].contiguous(),
                                           state.n, x_app, state.noise, block=8)
    _check(appended, "distributed append failed")

    # (3) the sharded build and factor; (4) the sharded predict
    l_mat, ok = make_sharded_build_and_factor(mesh)(state.kernel, state.x, state.n, state.noise)
    _check(bool(ok), "sharded build and factor failed")
    xq = torch.as_tensor(np.random.default_rng(2).normal(size=(n_devices * 4, 4)),
                         dtype=state.x.dtype, device=dev)
    mean, var = make_sharded_predict(mesh)(state.replace(l=l_mat), xq)
    _check(mean.shape == var.shape == (n_devices * 4,), "sharded predict shapes")

    # (5) chain-sharded NUTS over the hyperparameter posterior
    logp = make_hyperparam_logprob(full.replace(kernel=state.kernel, noise=state.noise))
    res = sample_nuts_sharded(make_chain_mesh(n_devices), logp, initial_theta(full), 0,
                              num_chains=n_devices, num_warmup=3, num_samples=3, max_depth=3)
    _check(res.samples.shape[1] == n_devices, "chain-sharded NUTS lost chains")

    # (6) LargeScaleGP end to end; (6a) with bfloat16 storage
    rng = np.random.default_rng(7)
    n_ls = cap - 4
    x_ls = rng.normal(size=(n_ls, 4)).astype(np.float32)
    y_ls = np.sin(x_ls[:, 0]).astype(np.float32)
    lgp = LargeScaleGP(mesh, SquaredExp(ls=1.0, ampl=1.0), ConstantPrior(c=0.0), 0.5, x_ls, y_ls,
                       block=8, capacity=cap)
    lgp.fit_scaled(max_iter=2, num_probes=2)
    xq_ls = torch.as_tensor(rng.normal(size=(8, 4)), dtype=torch.float32, device=dev)
    m_ls, v_ls = lgp.predict_mean_variance(xq_ls)
    _check(bool(torch.isfinite(m_ls).all()) and bool((v_ls >= -1e-4).all()),
           "LargeScaleGP predictions not finite or negative variances")
    lgp.add_samples(x_ls[:4] + 0.5, y_ls[:4])
    _check(lgp.n == n_ls + 4, "LargeScaleGP append")
    lgp_bf = LargeScaleGP(mesh, SquaredExp(ls=1.0, ampl=1.0), ConstantPrior(c=0.0), 0.8, x_ls,
                          y_ls, block=8, capacity=cap, storage="bf16")
    _check(lgp_bf.l_local.dtype == torch.bfloat16, "LargeScaleGP bf16 storage")
    _check(bool(torch.isfinite(lgp_bf.predict(xq_ls)).all()), "LargeScaleGP bf16 predictions")


def _dryrun_worker(rank: int, n_devices: int, url: str, device_type: str) -> None:
    from .config import set_device
    from .parallel import multihost

    # one thread a rank: the ranks share the host's cores
    torch.set_num_threads(1)
    device = "cpu" if device_type == "cpu" else f"cuda:{rank}"
    if device_type == "cpu":
        set_device("cpu")
    multihost.initialize(url, n_devices, rank, device=device)
    try:
        _dryrun_rank(n_devices)
    finally:
        multihost.shutdown()


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Run the multi-rank stack once on a world of ``n_devices`` ranks: in
    this process where it is already one rank of such a world
    (``parallel.multihost.initialize``), else in ``n_devices`` processes it
    starts (one card each, NCCL; ``device="cpu"``: CPU ranks, gloo) and
    waits for, raising if any fails or outlasts :data:`DRYRUN_TIMEOUT_S`."""
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from .parallel.multihost import free_port

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() == n_devices:
        _dryrun_rank(n_devices)
        return
    device_type = resolve_device(device).type
    ctx = mp.get_context("spawn")
    url = f"tcp://127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=_dryrun_worker, args=(r, n_devices, url, device_type))
             for r in range(n_devices)]
    for p in procs:
        p.start()
    failed = []
    for r, p in enumerate(procs):
        p.join(DRYRUN_TIMEOUT_S)
        if p.is_alive():
            failed.append(f"rank {r} timed out")
        elif p.exitcode != 0:
            failed.append(f"rank {r} exited with {p.exitcode}")
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    if failed:
        raise RuntimeError(f"dryrun_multichip({n_devices}): {', '.join(failed)}")


if __name__ == "__main__":
    fn, args = entry(sys.argv[1] if len(sys.argv) > 1 else None)
    out = fn(*args)
    print("entry OK:", [tuple(o.shape) for o in out])
    count = torch.cuda.device_count() if args[0].x.is_cuda else 2
    dryrun_multichip(count, args[0].x.device.type)
    print(f"dryrun_multichip({count}) OK")
