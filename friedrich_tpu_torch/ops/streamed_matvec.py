"""Streamed gradient-covariance matrix products.

Counterpart of ``friedrich_tpu/ops/streamed_matvec.py:23-82``. The large-n
fit needs products with the (cap, cap) gradient matrices dK/dtheta_p, which
the reference materializes (``algebra/mod.rs:129-155``) — infeasible at
n = 100,000. Here panels of dK are generated from the inputs one column
block at a time and multiplied into ``V`` at once: memory is one (cap, B)
strip per parameter. The JAX package computes this outside any Pallas
kernel, so plain PyTorch (``torch.matmul`` for the products) is its port.
"""

from __future__ import annotations

from typing import Optional

import torch

from .distance import diag_features, pairwise_features
from .partition import pick_block

#: Panel-width target of :func:`streamed_grad_matvec` (the JAX package's).
DEFAULT_MATVEC_BLOCK = 1024
#: Entries of one (cap, B) strip that the default panel width may reach
#: (64 MB a strip in float32): a smaller capacity takes fewer, wider panels,
#: each of them the same few dozen launches from the host.
MATVEC_STRIP_ENTRIES = 1 << 24


def rademacher_probes(cap: int, n: int, num_probes: int, seed: int, dtype,
                      device) -> torch.Tensor:
    """Fixed-seed Rademacher probes (cap, num_probes), zero on dead rows so
    that a Hutchinson estimate sees only the live block. Drawn on the CPU
    from a ``torch.Generator`` and moved to ``device``; they differ from
    the JAX package's ``jax.random`` probes."""
    gen = torch.Generator().manual_seed(seed)
    z = torch.sign(torch.randn((cap, num_probes), generator=gen, dtype=dtype))
    z[n:] = 0.0
    return z.to(device)


def streamed_grad_matvec(kernel, x_pad: torch.Tensor, n: int, v: torch.Tensor,
                         block: Optional[int] = None,
                         method: str = "gram",
                         rows: Optional[tuple[int, int]] = None) -> torch.Tensor:
    """``(p, cap, m) = stack_p [dK_p @ V]`` with dK never materialized; a
    vector ``v`` gives ``(p, cap)``.

    Dead rows and columns of dK are zero (as in
    ``ops/covariance.gradient_covariances_padded``), so products over the
    full buffer equal the live ones. The panel width is ``block`` snapped
    to a divisor of the capacity; by default the larger of
    :data:`DEFAULT_MATVEC_BLOCK` and :data:`MATVEC_STRIP_ENTRIES` / the rows.
    ``rows=(r0, r1)``: only those rows of the products, ``(p, r1 - r0,
    m)`` (a rank's rows in ``parallel/``).
    """
    cap = x_pad.shape[0]
    r0, r1 = (0, cap) if rows is None else rows
    if block is None:
        block = max(DEFAULT_MATVEC_BLOCK, MATVEC_STRIP_ENTRIES // max(r1 - r0, 1))
    b = pick_block(cap, block)
    v2 = v if v.ndim == 2 else v[:, None]
    x_rows = x_pad[r0:r1]
    row_idx = torch.arange(r0, r1, device=x_pad.device)[:, None]
    acc = torch.zeros((kernel.nb_params, r1 - r0, v2.shape[1]), dtype=x_pad.dtype,
                      device=x_pad.device)
    for j0 in range(0, cap, b):
        xj = x_pad[j0:j0 + b]
        feats = pairwise_features(x_rows, xj, kernel.needs, method=method)
        grads = kernel.pointwise_grads(feats)  # p x (cap, b)
        del feats
        # analytic diagonal (distance exactly zero), as in
        # ops/covariance.gradient_covariances_padded
        dgrads = kernel.pointwise_grads(diag_features(xj, kernel.needs))
        cols = torch.arange(j0, j0 + b, device=x_pad.device)[None, :]
        diag = row_idx == cols
        live = (row_idx < n) & (cols < n)
        vj = v2[j0:j0 + b]
        for p, (g, dg) in enumerate(zip(grads, dgrads)):
            g = torch.where(live, torch.where(diag, dg[None, :], g), 0.0)
            acc[p] += torch.matmul(g, vj)
        del grads
    return acc if v.ndim == 2 else acc[..., 0]
