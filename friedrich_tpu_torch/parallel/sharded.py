"""The exact single-model steps of ``models/`` over a mesh, on the row
layout.

Counterpart of ``friedrich_tpu/parallel/sharded.py`` (``:26-91``). The JAX
package constrains K, its gradients, the factor and K^-1 to 2-D blocks and
lets XLA's partitioner place the collectives. The port writes them out on
the row layout (``parallel/mesh.py``): the factor comes from the
distributed factorization (``distributed_cholesky.py``), each rank's
column block of K^-1 from ``distributed_cho_solve``, and the exact
gradient of ``models/optimizer.py``'s steps is each rank's partial traces
over its rows, summed by one all-reduce. The results equal the
single-device step's.

A sharded state is a ``models/gp.GPState`` whose ``l`` is this rank's
(cap / W, cap) row block of the factor; every other field is whole on
every rank.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models import gp as core
from ..models.optimizer import AdamState, _adam_delta
from ..ops.covariance import kernel_diag
from ..ops.distance import diag_features, pairwise_features
from .distributed_cholesky import distributed_cholesky_factor
from .distributed_solve import (
    distributed_cho_solve,
    distributed_cross_covariance,
    distributed_solve_lower,
    distributed_solve_lower_sharded_rhs_inplace,
)
from .mesh import Mesh, all_reduce, matrix_sharding


def shard_state(state: core.GPState, mesh: Mesh) -> core.GPState:
    """The state on the mesh's device with its factor row-sharded: this
    rank's row block of ``state.l`` (``matrix_sharding``), the rest whole."""
    dev = mesh.device
    return state.replace(
        x=state.x.to(dev), resid=state.resid.to(dev), l=matrix_sharding(mesh)(state.l),
        noise=state.noise.to(dev), kernel=state.kernel.to(state.x.dtype, dev),
        prior=state.prior.to(state.x.dtype, dev),
    )


def make_sharded_build_and_factor(mesh: Mesh):
    """``build_factor(kernel, x_pad, n, noise) -> (l_local, ok)``: the
    covariance build and Cholesky factorization of the padded inputs
    ``x_pad`` (whole on every rank), row-sharded over the mesh."""

    def build_factor(kernel, x_pad, n, noise):
        r0, r1 = mesh.rows(x_pad.shape[0])
        return distributed_cholesky_factor(mesh, kernel, x_pad[r0:r1].contiguous(), int(n), noise)

    return build_factor


def _gradient_rows(kernel, x_pad: torch.Tensor, n: int, r0: int, r1: int,
                   method: str) -> torch.Tensor:
    """Rows ``[r0, r1)`` of ``ops/covariance.gradient_covariances_padded``:
    (p, r1 - r0, cap), analytic diagonal, zero outside the live block."""
    cap = x_pad.shape[0]
    feats = pairwise_features(x_pad[r0:r1], x_pad, kernel.needs, method=method)
    stacked = torch.stack(list(kernel.pointwise_grads(feats)), dim=0)
    dgrads = torch.stack(list(kernel.pointwise_grads(diag_features(x_pad, kernel.needs))), dim=0)
    rows = torch.arange(r0, r1, device=x_pad.device)[:, None]
    cols = torch.arange(cap, device=x_pad.device)[None, :]
    stacked = torch.where((rows == cols)[None], dgrads[:, None, :], stacked)
    return torch.where(((rows < n) & (cols < n))[None], stacked, 0.0)


def _inverse_columns(mesh: Mesh, l_local: torch.Tensor, dtype) -> torch.Tensor:
    """This rank's (cap, R) column block of K^-1 (padded: identity in the
    dead block): one ``distributed_cho_solve`` per rank's block of the
    identity, every rank taking part in each."""
    rows, cap = l_local.shape
    mine = None
    for r in range(mesh.size):
        e = torch.zeros((cap, rows), dtype=dtype, device=l_local.device)
        e[r * rows:(r + 1) * rows] = torch.eye(rows, dtype=dtype, device=l_local.device)
        cols = distributed_cho_solve(mesh, l_local, e)
        if r == mesh.rank:
            mine = cols
    return mine


def _exact_terms(mesh: Mesh, state: core.GPState):
    """``(alpha, alpha^T dK_p alpha, tr(K^-1 dK_p), tr(K^-1))`` of the
    sharded state, the traces from this rank's rows summed by one
    all-reduce (``models/optimizer._per_param_grads``'s terms)."""
    dtype = state.resid.dtype
    rows, cap = state.l.shape
    r0, r1 = mesh.rows(cap)
    cov_cols = _inverse_columns(mesh, state.l, dtype)  # K^-1[:, r0:r1]
    alpha = distributed_cho_solve(mesh, state.l, state.resid)
    dks = _gradient_rows(state.kernel, state.x, state.n, r0, r1, state.method)
    data_fit = torch.einsum("pij,j->pi", dks, alpha) @ alpha[r0:r1]
    # K^-1 is symmetric: its rows r0:r1 are the columns' transpose
    complexity = torch.einsum("ji,pij->p", cov_cols, dks)
    trace = torch.sum(torch.diagonal(cov_cols, offset=-r0))[None]
    partial = all_reduce(mesh, torch.cat([data_fit, complexity, trace]))
    p = data_fit.shape[0]
    return alpha, partial[:p], partial[p:2 * p], partial[2 * p]


def make_sharded_train_step(mesh: Mesh, scalable: bool = True):
    """``step(state, adam, i, conv) -> (state, adam, progress, ok)``: one
    exact fit iteration of a sharded state (``models/optimizer.
    _scaled_step`` or ``_generic_step``), the refactor row-sharded."""

    def step(state: core.GPState, adam: AdamState, i, conv):
        alpha, data_fit, complexity, trace = _exact_terms(mesh, state)
        if scalable:
            scale = torch.dot(state.resid, alpha) / state.n
            grads = (data_fit / scale - complexity) / 2.0  # optimizer.rs:180-192
            adam, delta = _adam_delta(adam, grads, int(i))
            kernel = state.kernel.with_params(adam.params).rescale(scale)  # optimizer.rs:262
            noise = state.noise * scale  # optimizer.rs:263
            adam = dataclasses.replace(adam, params=kernel.get_params())
        else:
            grads_kernel = (data_fit - complexity) / 2.0
            # noise gradient (optimizer.rs:52-57): the padded identity block
            # adds cap - n to tr(K^-1); log-space correction (:105-110)
            noise_complexity = trace - (state.capacity - state.n)
            noise_grad = state.noise * (torch.dot(alpha, alpha) - noise_complexity) * state.noise
            adam, delta = _adam_delta(adam, torch.cat([grads_kernel, noise_grad[None]]), int(i))
            kernel = state.kernel.with_params(adam.params[:-1])
            noise = torch.exp(adam.params[-1])
        progress = torch.max(torch.abs(delta)) > conv
        r0, r1 = mesh.rows(state.capacity)
        l_local, ok = distributed_cholesky_factor(mesh, kernel, state.x[r0:r1], state.n, noise,
                                                  eps=state.eps, method=state.method)
        return state.replace(kernel=kernel, noise=noise, l=l_local), adam, progress, ok

    return step


def make_sharded_predict(mesh: Mesh):
    """``predict(state, xq) -> (mean, variance)`` of a sharded state: each
    rank builds its rows of ``K(X, xq)`` (B1), one distributed forward
    sweep serves both moments, replicated. (The JAX package shards the
    queries over the devices; with the factor's rows spread over the ranks,
    every rank takes part in every query's sweep.)"""

    def predict(state: core.GPState, xq: torch.Tensor):
        xq = torch.as_tensor(xq, dtype=state.x.dtype, device=mesh.device)
        r0, r1 = mesh.rows(state.capacity)
        beta = distributed_solve_lower(mesh, state.l, state.resid)
        c_local = distributed_cross_covariance(mesh, state.kernel, state.x[r0:r1], state.n, xq,
                                               method=state.method)
        kl = distributed_solve_lower_sharded_rhs_inplace(mesh, state.l, c_local, None)
        mean = state.prior.mean(xq) + kl.mT @ beta
        var = kernel_diag(state.kernel, xq) - torch.sum(kl.square_(), dim=0)
        return mean, var

    return predict
