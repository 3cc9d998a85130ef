"""Distributed exact GP over a world of ranks with ``LargeScaleGP``: the
twin of ``examples/distributed_gp.py``.

The reference is single-process (nalgebra on one CPU); the port's
distributed engine shards the covariance factor by rows across the ranks
of a ``torch.distributed`` world, one card each, so that one model can span
several cards: the Cholesky runs as streamed panels, each broadcast by the
rank that owns it (the panel-strip kernel builds every rank's strip),
predictions sweep the row blocks with one all-reduce per panel, and the
hyperparameter fit takes Hutchinson-trace gradients whose partial sums are
all-reduced once per iteration. The model is then served: rank 0 runs
``AcceleratedGPServer`` while every other rank runs ``serving.follow``.

Where the JAX script runs 8 virtual CPU devices, this twin runs, on the
CPU, a world of ``world`` gloo ranks that it spawns (8 by default); on the
card, the world ``torch.distributed`` names through the environment (one
process per card under ``torchrun``), or a world of one through NCCL.
Every rank runs the same program (SPMD): where JAX's single controller
drives every device, each rank here is a process of its own.

Run: ``python -m friedrich_tpu_torch.examples.distributed_gp`` (the card;
``torchrun --nproc-per-node=W -m friedrich_tpu_torch.examples.distributed_gp``
for W cards), or ``main(device="cpu")``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels, priors, serving
from ..config import resolve_device
from ..parallel import LargeScaleGP
from ..parallel.multihost import joined, spawn


def run(mesh, n: int = 1024, d: int = 4, seed: int = 0, dtype=torch.float32, probes=None):
    """The script's flow on this rank of ``mesh``; every rank calls it with
    the same arguments. ``probes`` (capacity, s) replaces the fit's
    Hutchinson probes drawn from a ``torch.Generator``. Returns the model
    and rank 0's numbers (the other ranks' are the same)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (np.sin(x[:, 0]) + 0.1 * rng.normal(size=n)).astype(np.float32)

    def tensor(a):
        return torch.as_tensor(a, dtype=dtype, device=mesh.device)

    lead = mesh.rank == 0
    if lead:
        print(f"mesh: {mesh.size} rank{'s' if mesh.size > 1 else ''} on {mesh.device}")
    gp = LargeScaleGP(
        mesh,
        kernels.SquaredExp(ls=1.0, ampl=1.0),
        priors.ConstantPrior.default(1),
        noise=0.2,
        x=tensor(x),
        y=tensor(y),
        block=n // 8,
        capacity=2 * n,  # reserve room: appends below stay O(n^2 k)
    )
    out = {"ranks": mesh.size, "lml": gp.log_marginal_likelihood()}
    if lead:
        print(f"trained: n={gp.n}, LML={out['lml']:.3f}")

    # hyperparameter fit: ADAM on the row-sharded Hutchinson-trace gradients
    gp.fit_scaled(max_iter=10, probes=probes)
    out["lml_fit"] = gp.log_marginal_likelihood()
    out["kernel_params"] = gp.kernel.get_params().cpu().numpy()
    out["noise"] = float(gp.noise)
    if lead:
        print(f"after fit_scaled(10): LML={out['lml_fit']:.3f}")

    # predictions: one distributed forward sweep against the row blocks
    xq = tensor(rng.normal(size=(256, d)).astype(np.float32))
    mean, var = gp.predict_mean_variance(xq)
    out["mean"], out["var"] = mean.cpu().numpy(), var.cpu().numpy()
    if lead:
        print(f"predict 256 points: mean[:3]={out['mean'][:3].round(3)} "
              f"var range=({out['var'].min():.3f}, {out['var'].max():.3f})")

    # incremental training: distributed O(n^2 k) Cholesky append
    x_new = rng.normal(size=(32, d)).astype(np.float32)
    gp.add_samples(tensor(x_new), tensor(np.sin(x_new[:, 0])))
    out["lml_append"] = gp.log_marginal_likelihood()
    if lead:
        print(f"after add_samples(32): n={gp.n}, LML={out['lml_append']:.3f}")

    # posterior sampling at query points
    mvn = gp.sample_at(xq[:8])
    out["draws"] = mvn.sample_n(torch.Generator().manual_seed(0), 5).cpu().numpy()
    if lead:
        print(f"5 posterior draws at 8 points: shape={out['draws'].shape}")

    # serving: rank 0 answers over the wire, every other rank follows; the
    # in-process answers at the server's solve width first, on every rank
    want, _ = gp.predict_mean_variance(xq, block=256)
    if lead:
        with serving.AcceleratedGPServer(gp, block=256) as srv:
            with serving.GPClient(port=srv.port) as client:
                served = client.predict(xq.cpu().numpy())
        out["served_max_abs_diff"] = float(np.abs(served - want.cpu().numpy()).max())
        print(f"served 256 points: max |served - in-process| = {out['served_max_abs_diff']:.2e}")
    else:
        serving.follow(gp)
    return gp, out


def _spawned_rank(mesh, **kwargs) -> dict:
    return run(mesh, **kwargs)[1]


def main(n: int = 1024, d: int = 4, seed: int = 0, world: int = 8, device=None):
    """The script's flow. On the CPU with no process group, on ``world``
    gloo ranks spawned for the call: returns rank 0's numbers (the model
    ends with its ranks). Otherwise this process is a rank (of the world
    that exists or the environment names, else of a world of one): returns
    its ``LargeScaleGP``, as the JAX script returns its model."""
    import torch.distributed as dist

    if resolve_device(device).type == "cpu" and world > 1 and not dist.is_initialized():
        return spawn(world, _spawned_rank, n=n, d=d, seed=seed)[0]
    with joined(device) as mesh:
        return run(mesh, n=n, d=d, seed=seed)[0]


if __name__ == "__main__":
    main()
