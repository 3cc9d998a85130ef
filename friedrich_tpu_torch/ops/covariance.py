"""Covariance-matrix builders (the compute core, L2).

Counterpart of ``friedrich_tpu/ops/covariance.py`` and of the reference's
``algebra/mod.rs:41-155``.

**Capacity padding.** Training buffers are padded to a capacity; the
training covariance is the IDENTITY outside the live n x n block:

    K_pad = [[K_live, 0], [0, I]]

so ``chol(K_pad) = [[L_live, 0], [0, I]]`` and triangular solves against
zero-padded right-hand sides give zero in the dead region.

**Dispatch.** ``cross_covariance``, ``train_covariance_padded`` and
``cross_covariance_train_padded`` launch the CUDA covariance-tile kernel
(``ops/cuda/covariance_cuda.py``) for tensors on the GPU, and run their
plain PyTorch versions (the ``plain_*`` functions below, which the kernel
is held against) for tensors on the CPU. ``gradient_covariances_padded`` is
plain PyTorch on every device.

**Gradient.** The kernel has no backward; :class:`TrainCovarianceFn` gives
the training covariance one, for the exact-likelihood density
(``mcmc/logprob.py``): its forward is the dispatch above, its backward
differentiates the plain builder strip by strip (the JAX package
differentiates an XLA build there, outside any Pallas kernel).
"""

from __future__ import annotations

import torch

from .cuda import covariance_cuda
from .distance import diag_features, pairwise_features


def plain_cross_covariance(kernel, x1: torch.Tensor, x2: torch.Tensor,
                           method: str = "gram") -> torch.Tensor:
    """Plain version of :func:`cross_covariance`."""
    feats = pairwise_features(x1, x2, kernel.needs, method=method)
    return kernel.pointwise(feats)


def kernel_diag(kernel, x: torch.Tensor) -> torch.Tensor:
    """k(x_i, x_i) per row — the prior variance of each point."""
    return kernel.pointwise(diag_features(x, kernel.needs))


def plain_train_covariance_block(kernel, x1: torch.Tensor, x2: torch.Tensor, n: int, noise,
                                 row0: int = 0, col0: int = 0,
                                 method: str = "gram") -> torch.Tensor:
    """One block of the padded training covariance: rows ``row0 ..
    row0+m1`` (inputs ``x1``) by columns ``col0 .. col0+m2`` (inputs
    ``x2``), with the analytic diagonal and the identity outside the live
    ``n x n`` block decided from those global indices."""
    k = plain_cross_covariance(kernel, x1, x2, method=method)
    # The diagonal is k(x,x) + noise^2 with EXACTLY zero distance — set it
    # from the analytic per-row kernel diagonal rather than the pairwise
    # tile, whose gram-identity cancellation (|x|^2+|x|^2-2x.x) otherwise
    # puts the matmul's rounding error directly on the pivots.
    kd = kernel_diag(kernel, x2) + noise * noise
    ridx = torch.arange(row0, row0 + x1.shape[0], device=x1.device)
    cidx = torch.arange(col0, col0 + x2.shape[0], device=x1.device)
    diag = ridx[:, None] == cidx[None, :]
    k = torch.where(diag, kd[None, :], k)
    live = (ridx[:, None] < n) & (cidx[None, :] < n)
    return torch.where(live, k, diag.to(k.dtype))


def plain_train_covariance_padded(kernel, x_pad: torch.Tensor, n: int, noise,
                                  method: str = "gram",
                                  rows: tuple[int, int] | None = None,
                                  cols: tuple[int, int] | None = None) -> torch.Tensor:
    """Plain version of :func:`train_covariance_padded`; ``rows=(r0, r1)``
    and ``cols=(c0, c1)`` build only that block."""
    cap = x_pad.shape[0]
    r0, r1 = rows if rows is not None else (0, cap)
    c0, c1 = cols if cols is not None else (0, cap)
    return plain_train_covariance_block(kernel, x_pad[r0:r1], x_pad[c0:c1], n, noise,
                                        row0=r0, col0=c0, method=method)


def plain_cross_covariance_train_padded(kernel, x_pad: torch.Tensor, n: int,
                                        xq: torch.Tensor,
                                        method: str = "gram") -> torch.Tensor:
    """Plain version of :func:`cross_covariance_train_padded`."""
    c = plain_cross_covariance(kernel, x_pad, xq, method=method)
    idx = torch.arange(x_pad.shape[0], device=x_pad.device)
    return torch.where((idx < n)[:, None], c, 0.0)


def plain_covariance_tile(kernel, x1: torch.Tensor, x2: torch.Tensor, n: int, noise=0.0,
                          train: bool = False, method: str = "gram",
                          row0: int = 0) -> torch.Tensor:
    """Plain version of the kernel's wrapper ``covariance_cuda.covariance``,
    with its signature: the function a launch is held against, and the one
    that takes the wrapper's place to run a path with the plain versions."""
    if train:
        return plain_train_covariance_block(kernel, x1, x2, n, noise, row0=row0, method=method)
    rows = torch.arange(row0, row0 + x1.shape[0], device=x1.device)
    return torch.where((rows < n)[:, None], plain_cross_covariance(kernel, x1, x2, method), 0.0)


def cross_covariance(kernel, x1: torch.Tensor, x2: torch.Tensor,
                     method: str = "gram") -> torch.Tensor:
    """K(X1, X2): one row per row of x1, one column per row of x2.

    Counterpart of ``make_covariance_matrix`` (``algebra/mod.rs:41-54``).
    """
    if x1.device.type == "cpu":
        return plain_cross_covariance(kernel, x1, x2, method=method)
    return covariance_cuda.covariance(kernel, x1, x2, x1.shape[0], method=method)


def train_covariance_padded(kernel, x_pad: torch.Tensor, n: int, noise,
                            method: str = "gram") -> torch.Tensor:
    """Padded training covariance: K + noise^2 I on the live block, identity
    on the dead block.

    Counterpart of the matrix built by ``make_cholesky_cov_matrix``
    (``algebra/mod.rs:59-79``): kernel evals plus ``noise^2`` (squared, not
    raw noise — ``algebra/mod.rs:78``) on the diagonal.

    Args:
      x_pad: (cap, d) padded inputs (dead rows' contents are irrelevant).
      n: live row count.
      noise: observation-noise standard deviation.
    """
    if x_pad.device.type == "cpu":
        return plain_train_covariance_padded(kernel, x_pad, n, noise, method=method)
    return covariance_cuda.covariance(
        kernel, x_pad, x_pad, n, noise=noise, train=True, method=method
    )


def cross_covariance_train_padded(kernel, x_pad: torch.Tensor, n: int,
                                  xq: torch.Tensor,
                                  method: str = "gram") -> torch.Tensor:
    """K(X_train_pad, Xq) with dead training rows zeroed: (cap, m).

    Zero rows in the dead region make padded triangular solves exact (see
    module docstring). Used by every predict path
    (``gaussian_process/mod.rs:234``, ``:257``, ``:297``, ``:378``).
    """
    if x_pad.device.type == "cpu":
        return plain_cross_covariance_train_padded(kernel, x_pad, n, xq, method=method)
    return covariance_cuda.covariance(kernel, x_pad, xq, n, method=method)


def gradient_covariances_padded(kernel, x_pad: torch.Tensor, n: int,
                                method: str = "gram") -> torch.Tensor:
    """Stacked per-parameter covariance gradients, zero outside the live
    block: (p, cap, cap).

    Counterpart of ``make_gradient_covariance_matrices``
    (``algebra/mod.rs:129-155``). The zero dead region means traces and
    quadratic forms over the full buffer equal the live ones.
    """
    feats = pairwise_features(x_pad, x_pad, kernel.needs, method=method)
    stacked = torch.stack(list(kernel.pointwise_grads(feats)), dim=0)
    # Diagonal from the analytic zero-distance features, for the same
    # reason as in train_covariance_padded: the gram tile's cancellation
    # puts matmul rounding on the diagonal, which feeds the optimizer's
    # trace terms tr(K^-1 dK) directly.
    dfeats = diag_features(x_pad, kernel.needs)
    dgrads = torch.stack(list(kernel.pointwise_grads(dfeats)), dim=0)
    idx = torch.arange(x_pad.shape[0], device=x_pad.device)
    diag = idx[:, None] == idx[None, :]
    stacked = torch.where(diag[None, :, :], dgrads[:, :, None], stacked)
    live = (idx[:, None] < n) & (idx[None, :] < n)
    return torch.where(live[None, :, :], stacked, 0.0)


def analytic_train_covariance_grads(kernel, x_pad: torch.Tensor, n: int, noise,
                                    g: torch.Tensor,
                                    method: str = "gram") -> tuple[torch.Tensor, torch.Tensor]:
    """The gradient of ``sum(g * K_pad)`` in the kernel's raw parameters
    and the noise, from the analytic covariance gradients: ``sum(g * dK_p)``
    per parameter (:func:`gradient_covariances_padded`) and ``2 noise``
    times the live diagonal's sum. An independent reference for
    :class:`TrainCovarianceFn`'s backward (autograd through the plain
    builder), exact for every kernel whose ``pointwise_grads`` are the
    derivatives of its map — not Matern2 or Multiquadric, which keep the
    reference's own formulas."""
    grad_params = torch.sum(g * gradient_covariances_padded(kernel, x_pad, n, method), dim=(1, 2))
    return grad_params, 2 * noise * torch.diagonal(g)[:n].sum()


#: Entries of one row strip of :class:`TrainCovarianceFn`'s backward.
BACKWARD_STRIP_ENTRIES = 1 << 22


class TrainCovarianceFn(torch.autograd.Function):
    """:func:`train_covariance_padded` of ``kernel.with_params(params)`` and
    ``noise``, differentiable in ``params`` (the kernel's raw parameter
    vector) and ``noise``; not in ``x_pad``.

    Forward: the dispatch (the covariance-tile kernel on the card, the
    plain builder on the CPU), with the parameters detached: the kernel's
    wrapper reads them on the host. Backward: ``sum(G * K)`` over row
    strips of the plain builder, differentiated by autograd, so that the
    gradient is the exact derivative of the covariance (the analytic
    diagonal and its ``2 noise`` included) for every kernel, and memory is
    one strip of :data:`BACKWARD_STRIP_ENTRIES` entries, not ``p`` (cap, cap)
    matrices. Call it as ``TrainCovarianceFn.apply(params, noise, kernel,
    x_pad, n, method)``.
    """

    @staticmethod
    def forward(ctx, params, noise, kernel, x_pad, n, method):
        ctx.save_for_backward(params, noise)
        ctx.kernel, ctx.x_pad, ctx.n, ctx.method = kernel, x_pad, n, method
        return train_covariance_padded(kernel.with_params(params.detach()), x_pad, n,
                                       noise.detach(), method=method)

    @staticmethod
    def backward(ctx, grad_out):
        params, noise = ctx.saved_tensors
        x_pad, n = ctx.x_pad, ctx.n
        cap = x_pad.shape[0]
        rows = max(1, BACKWARD_STRIP_ENTRIES // cap)
        grad_params, grad_noise = torch.zeros_like(params), torch.zeros_like(noise)
        with torch.enable_grad():
            p = params.detach().requires_grad_(True)
            nz = noise.detach().requires_grad_(True)
            kernel = ctx.kernel.with_params(p)
            for r0 in range(0, cap, rows):
                block = plain_train_covariance_block(kernel, x_pad[r0:r0 + rows], x_pad, n, nz,
                                                     row0=r0, method=ctx.method)
                gp, gn = torch.autograd.grad(torch.sum(grad_out[r0:r0 + rows] * block), (p, nz))
                grad_params += gp
                grad_noise += gn
        return grad_params, grad_noise, None, None, None, None
