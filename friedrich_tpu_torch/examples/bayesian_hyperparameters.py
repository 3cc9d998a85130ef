"""Fully Bayesian GP on the port: NUTS over the hyperparameters and the
marginalized prediction; the twin of
``examples/bayesian_hyperparameters.py``.

The reference fits a single point estimate of the kernel parameters
(multiplicative ADAM, ``optimizer.rs``). The port adds the full posterior:
NUTS with pooled warmup on the exact log-marginal-likelihood surface,
convergence diagnostics (R-hat, ESS), and a predictive mixture that
marginalizes predictions over the hyperparameter draws, which widens the
error bars honestly where the data cannot pin the lengthscale down.

Over a world of ranks the same posterior is sampled two more ways, both
run here at the same points: the chains spread over the ranks
(``mcmc.sharded``), or every density evaluation's factorization spread
over them for models past one card's memory
(``mcmc.sample_hyperparameters_distributed``). They run shorter chains
than the single-device sampler. On the CPU they run on 2 gloo ranks
spawned for the call; on the card, on the world ``torch.distributed``
names through the environment, or a world of one through NCCL.

Run: ``python -m friedrich_tpu_torch.examples.bayesian_hyperparameters``
(the card), or ``main(device="cpu")``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import GaussianProcess, config, kernels, mcmc, priors
from ..config import resolve_device
from ..parallel import make_chain_mesh
from ..parallel.multihost import joined, spawn

NAMES = ("log ls", "log ampl", "log noise")
#: Ranks of the world spawned for the multi-rank samplers on the CPU.
CPU_WORLD = 2


def data(n: int, seed: int):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-3.0, 3.0, size=(n, 1)).astype(np.float32)
    y = (np.sin(2.0 * x[:, 0]) + 0.3 * rng.normal(size=n)).astype(np.float32)
    return x, y


def model(n: int, seed: int, dtype=None, device=None) -> GaussianProcess:
    x, y = data(n, seed)
    return GaussianProcess.new(priors.ZeroPrior(), kernels.SquaredExp(ls=1.0, ampl=1.0), 0.3, None,
                               x, y, dtype=dtype, device=device)


def print_summary(samples, label: str = "") -> dict:
    stats = mcmc.summary(samples)
    for i, name in enumerate(NAMES):
        print(f"{label}{name:>10}: mean={float(stats['mean'][i]):+.3f} "
              f"sd={float(stats['std'][i]):.3f} rhat={float(stats['rhat'][i]):.3f} "
              f"ess={float(stats['ess'][i]):.0f}")
    return stats


def single_device(gp: GaussianProcess, seed: int, num_warmup: int = 200, num_samples: int = 300):
    """The script's flow: 4 chains with pooled warmup, their summary, and the
    mixture over up to 32 draws against the point estimate."""
    res = mcmc.sample_hyperparameters(gp, torch.Generator().manual_seed(seed),
                                      num_warmup=num_warmup, num_samples=num_samples,
                                      num_chains=4)
    print_summary(res.samples)

    # marginalized prediction: mixture over (up to) 32 posterior draws
    xq = np.linspace(-4.0, 4.0, 9, dtype=np.float32)[:, None]
    mix_mean, mix_var = mcmc.predictive_mixture(gp.state, res.samples, xq, max_draws=32)
    mix_mean, mix_var = mix_mean.cpu().numpy(), mix_var.cpu().numpy()
    pt_mean, pt_var = gp.predict_mean_variance(xq)
    for i in (0, 4, 8):
        print(f"x={xq[i, 0]:+.1f}: point {pt_mean[i]:+.3f}±{np.sqrt(pt_var[i]):.3f}  "
              f"marginal {mix_mean[i]:+.3f}±{np.sqrt(mix_var[i]):.3f}")
    print("(marginal bars ≥ point bars: hyperparameter uncertainty included)")
    return res


def multi_rank(mesh, n: int, seed: int, dtype, num_warmup: int = 50, num_samples: int = 50) -> dict:
    """On every rank of ``mesh`` (the same arguments on each): NUTS with 4
    chains spread over the ranks, then NUTS with 2 chains on the density
    whose factorization spreads over them. Returns both runs' samples;
    raises if a draw is not finite."""
    state = model(n, seed, dtype=dtype, device=mesh.device).state
    lead = mesh.rank == 0
    logp = mcmc.make_hyperparam_logprob(state, signs=mcmc.initial_signs(state))
    sharded = mcmc.sample_nuts_sharded(make_chain_mesh(mesh.size), logp, mcmc.initial_theta(state),
                                       seed + 1, num_chains=4, num_warmup=num_warmup,
                                       num_samples=num_samples)
    distributed = mcmc.sample_hyperparameters_distributed(mesh, state, seed + 2, num_warmup=num_warmup,
                                                          num_samples=num_samples, num_chains=2)
    out = {}
    for name, res in (("chain-sharded", sharded), ("distributed density", distributed)):
        samples = res.samples.cpu()
        if not bool(torch.isfinite(samples).all()):
            raise FloatingPointError(f"{name} NUTS drew non-finite samples")
        if lead:
            print(f"{name} NUTS over {mesh.size} rank{'s' if mesh.size > 1 else ''}, "
                  f"{samples.shape[1]} chains:")
            print_summary(samples, "  ")
        out[name] = samples.numpy()
    return out


def main(n: int = 60, seed: int = 0, device=None):
    """The script's flow on one device, then the two multi-rank samplers
    (on :data:`CPU_WORLD` spawned gloo ranks on the CPU, else as a rank of the world
    that exists or the environment names, or of a world of one). Returns the
    single-device sampler's result, as the JAX script does."""
    import torch.distributed as dist

    gp = model(n, seed, device=device)
    print(f"point-estimate LML: {gp.log_marginal_likelihood():.3f}")
    res = single_device(gp, seed)
    dtype = gp.state.x.dtype
    if resolve_device(device).type == "cpu" and not dist.is_initialized():
        spawn(CPU_WORLD, _spawned_rank, n=n, seed=seed, dtype=dtype, x64=dtype == torch.float64)
    else:
        with joined(device) as mesh:
            multi_rank(mesh, n, seed, dtype)
    return res


def _spawned_rank(mesh, x64: bool, **kwargs) -> dict:
    config.set_device("cpu")
    if x64:
        config.enable_x64()
    return multi_rank(mesh, **kwargs)


if __name__ == "__main__":
    main()
