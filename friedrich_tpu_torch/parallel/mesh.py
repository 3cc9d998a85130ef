"""Process groups of the multi-rank layer, their row layout, and the two
collectives the layer uses.

Counterpart of ``friedrich_tpu/parallel/mesh.py``. The JAX package lays the
(cap, cap) matrices out in 2-D blocks over an (r, c) device mesh for XLA's
partitioner; PyTorch has none, so the port lays everything out by ROWS:
rank ``r`` of a mesh of ``W`` ranks holds rows ``[r cap / W, (r + 1) cap /
W)`` of the training inputs' padded buffer and of the Cholesky factor (a
(cap / W, cap) block). Every left-looking panel touches all rows, so the
row layout keeps the ranks balanced (``parallel/distributed_cholesky.py``).

A mesh is a :class:`Mesh`: this process's rank in the default
``torch.distributed`` process group, the group's size and the device this
rank computes on. The layer talks only through :func:`broadcast` and :func:`all_reduce`
(the only collectives gloo takes on CUDA tensors, and what the JAX
package's ``psum``/``pmin`` become): a gather is an all-reduce of a
zero-filled buffer. Both count what they send in :data:`COLLECTIVES`, by
kind, shape and dtype, so that tests can pin the communication contract
(``tests/test_comm_volume.py``'s). A mesh of one rank sends nothing.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Optional

import torch
import torch.distributed as dist

from ..utils.errors import ConfigError

#: Collectives sent by :func:`broadcast` and :func:`all_reduce` in this
#: process: ``(kind, shape, dtype name) -> count``.
COLLECTIVES: collections.Counter = collections.Counter()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The default process group as the multi-rank layer sees it: this
    process's ``rank`` in it, its ``size``, and the ``device`` this rank
    computes on."""

    rank: int
    size: int
    device: torch.device

    def rows(self, cap: int) -> tuple[int, int]:
        """``[r0, r1)``: this rank's rows of a buffer of ``cap`` rows; raises
        unless the mesh's size divides ``cap``."""
        if cap % self.size:
            raise ValueError(f"capacity {cap} not divisible by {self.size} ranks")
        local = cap // self.size
        return self.rank * local, (self.rank + 1) * local


def make_matrix_mesh(n_devices: Optional[int] = None) -> Mesh:
    """The mesh of the row-sharded matrices: every rank of the default
    process group, on the device ``initialize()`` chose for this rank.
    ``n_devices``, if given, must be the group's size."""
    if not dist.is_available() or not dist.is_initialized():
        raise ConfigError(
            "no torch.distributed process group: call "
            "friedrich_tpu_torch.parallel.multihost.initialize() first (a world of one "
            "where the environment names none)"
        )
    size = dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"the process group has {size} ranks, asked for {n_devices}")
    from .multihost import rank_device

    return Mesh(rank=dist.get_rank(), size=size, device=torch.device(rank_device()))


def make_chain_mesh(n_devices: Optional[int] = None) -> Mesh:
    """The mesh of chain-parallel MCMC (``mcmc/sharded.py``): the same
    description of the group (the chains' layout is the rank's share)."""
    return make_matrix_mesh(n_devices)


def row_sharding(mesh: Mesh) -> Callable[[torch.Tensor], torch.Tensor]:
    """``t -> `` this rank's row block of ``t`` (rows ``mesh.rows(len(t))``)
    on the mesh's device: the layout of the training inputs and residuals
    as the distributed functions take them."""

    def place(t: torch.Tensor) -> torch.Tensor:
        r0, r1 = mesh.rows(t.shape[0])
        return t[r0:r1].to(mesh.device).contiguous()

    return place


def matrix_sharding(mesh: Mesh) -> Callable[[torch.Tensor], torch.Tensor]:
    """``L -> `` this rank's (cap / W, cap) row block of a square (cap, cap)
    matrix: the layout of the factor (rows, not JAX's 2-D blocks)."""
    rows = row_sharding(mesh)

    def place(t: torch.Tensor) -> torch.Tensor:
        if t.ndim != 2 or t.shape[0] != t.shape[1]:
            raise ValueError(f"matrix_sharding takes a square matrix, got {tuple(t.shape)}")
        return rows(t)

    return place


def replicated(mesh: Mesh) -> Callable[[torch.Tensor], torch.Tensor]:
    """``t -> `` rank 0's ``t`` on every rank, on the mesh's device (one
    broadcast): the layout of everything small (inputs, residuals,
    hyperparameters), which every rank holds whole."""

    def place(t: torch.Tensor) -> torch.Tensor:
        return broadcast(mesh, t.to(mesh.device).contiguous().clone(), 0)

    return place


def _check_contiguous(t: torch.Tensor) -> None:
    # a collective works on the tensor's storage in order: a strided view
    # (a column-major solve's output) would be scrambled
    if not t.is_contiguous():
        raise ValueError(f"collectives take contiguous tensors, got strides {t.stride()}")


def broadcast(mesh: Mesh, t: torch.Tensor, src: int) -> torch.Tensor:
    """Rank ``src``'s ``t`` into ``t`` on every rank of the mesh, in place;
    returns ``t``. ``t`` must be contiguous and of the same shape on every
    rank."""
    _check_contiguous(t)
    if mesh.size > 1:
        COLLECTIVES[("broadcast", tuple(t.shape), str(t.dtype).split(".")[-1])] += 1
        dist.broadcast(t, src=src)
    return t


def all_reduce(mesh: Mesh, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """``t`` reduced over the mesh (``"sum"``, ``"min"`` or ``"max"``) into
    ``t`` on every rank, in place; returns ``t``."""
    _check_contiguous(t)
    if mesh.size > 1:
        COLLECTIVES[("all_reduce", tuple(t.shape), str(t.dtype).split(".")[-1])] += 1
        reduce_op = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
                     "max": dist.ReduceOp.MAX}[op]
        dist.all_reduce(t, op=reduce_op)
    return t


def gather_rows(mesh: Mesh, t_local: torch.Tensor) -> torch.Tensor:
    """Every rank's row block of equal size, stacked in rank order on every
    rank: an all-reduce of a zero-filled buffer (the JAX package's masked
    ``psum``)."""
    rows = t_local.shape[0]
    out = t_local.new_zeros((rows * mesh.size, *t_local.shape[1:]))
    out[mesh.rank * rows:(mesh.rank + 1) * rows] = t_local
    return all_reduce(mesh, out)
