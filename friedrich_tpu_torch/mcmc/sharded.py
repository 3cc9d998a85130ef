"""Chain-sharded MCMC: the chains spread over the ranks of a mesh.

Counterpart of ``friedrich_tpu/mcmc/sharded.py`` (``:41-118``). Chains are
independent, so each rank runs ``num_chains / W`` of them with a generator
of its own; the only traffic is the pooled warmup adaptation, whose
``pool_mean`` / ``pool_sum`` hooks (``mcmc/_adapt.py``) become all-reduces
over the mesh. After warmup every rank samples on its own, and the draws
are combined on every rank at the end (one all-reduce of a zero-filled
buffer per result field).

The starts (jittered around ``init_theta`` when it is one vector) and each
rank's generator seed come from ``generator`` on every rank alike
(:func:`rank_generators`), so a run is reproducible: each rank's share is
``sample_nuts`` on that rank's chains and generator, with the warmup
statistics pooled.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..parallel.mesh import Mesh, all_reduce, gather_rows
from ._adapt import as_generator, chain_starts
from .hmc import HMCResult, sample_hmc
from .nuts import NUTSResult, sample_nuts


def rank_generators(generator: torch.Generator, size: int) -> list[torch.Generator]:
    """The generators of a mesh of ``size`` ranks, rank order, seeded from
    ``generator`` (after the chains' starts are drawn)."""
    seeds = torch.randint(0, 2**62, (size,), generator=generator)
    return [torch.Generator().manual_seed(int(s)) for s in seeds]


def _sharded(sampler_fn, mesh: Mesh, logp: Callable, init_theta: torch.Tensor, generator,
             num_chains: int, **kwargs):
    size = mesh.size
    if num_chains % size:
        raise ValueError(f"num_chains {num_chains} % ranks {size} != 0")
    local = num_chains // size
    generator = as_generator(generator)
    theta0 = chain_starts(init_theta, num_chains, generator)
    gen = rank_generators(generator, size)[mesh.rank]

    def pool_sum(v):
        return all_reduce(mesh, v.detach().clone())

    def pool_mean(v):
        return pool_sum(v) / size

    res = sampler_fn(logp, theta0[mesh.rank * local:(mesh.rank + 1) * local], gen,
                     num_chains=local, pool_mean=pool_mean, pool_sum=pool_sum, **kwargs)
    per_chain = {"samples": 1, "accept_prob": 1, "tree_depth": 1, "divergent": 1, "final_logp": 0}
    fields = {}
    for name, value in res._asdict().items():
        if name in per_chain:
            axis = per_chain[name]
            gathered = gather_rows(mesh, value.movedim(axis, 0).to(
                torch.float64 if value.dtype.is_floating_point else torch.int64).contiguous())
            value = gathered.movedim(0, axis).to(value.dtype)
        fields[name] = value  # step_size, inv_mass: pooled, the same on every rank
    return type(res)(**fields)


def sample_nuts_sharded(mesh: Mesh, logp, init_theta, generator, num_chains: int = 8,
                        **kwargs) -> NUTSResult:
    """NUTS (``mcmc/nuts.sample_nuts``) with the chains spread over the
    mesh's ranks; the result, all chains, on every rank."""
    return _sharded(sample_nuts, mesh, logp, init_theta, generator, num_chains, **kwargs)


def sample_hmc_sharded(mesh: Mesh, logp, init_theta, generator, num_chains: int = 8,
                       **kwargs) -> HMCResult:
    """HMC (``mcmc/hmc.sample_hmc``) with the chains spread over the mesh's
    ranks; the result, all chains, on every rank."""
    return _sharded(sample_hmc, mesh, logp, init_theta, generator, num_chains, **kwargs)
