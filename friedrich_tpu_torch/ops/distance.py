"""Pairwise feature (distance / inner-product) computation.

Counterpart of ``friedrich_tpu/ops/distance.py``: whole tiles of pairwise
features, to which a kernel's elementwise map is applied.

    sqdist(X1, X2) = ||x||^2 + ||y||^2 - 2 * X1 @ X2^T   (one GEMM)

Three squared-distance methods:

- ``gram``: the GEMM identity above; small negative rounding residue
  clamped to zero. Default.
- ``gram_bf16``: the same identity with the GEMM inputs rounded to bfloat16
  and accumulated in float32; the squared norms stay full precision and
  the result returns to the input dtype.
- ``direct``: broadcast (x1-x2)^2 sum, O(n*m*d) memory; closest to the
  reference's ``(x1 - x2).norm_squared()`` (``kernel.rs:558``).
"""

from __future__ import annotations

from typing import FrozenSet

import torch

DOT = "dot"
SQDIST = "sqdist"
DIST = "dist"


def _gram_bf16(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    # products of two bfloat16 values are exact in float32, so a float32
    # matmul of the rounded inputs is the bf16-in / f32-accumulate product
    a = x1.to(torch.bfloat16).to(torch.float32)
    b = x2.to(torch.bfloat16).to(torch.float32)
    return (a @ b.T).to(x1.dtype)


def pairwise_features(
    x1: torch.Tensor,
    x2: torch.Tensor,
    needs: FrozenSet[str],
    method: str = "gram",
) -> dict[str, torch.Tensor]:
    """Compute the pairwise features required by a kernel.

    Args:
      x1: (n, d) rows.
      x2: (m, d) rows.
      needs: subset of {"dot", "sqdist", "dist"}.
      method: "gram", "gram_bf16" or "direct".

    Returns:
      dict mapping feature name -> (n, m) tensor.
    """
    feats: dict[str, torch.Tensor] = {}
    need_sq = SQDIST in needs or DIST in needs
    gram_like = method in ("gram", "gram_bf16")
    dot = None
    if DOT in needs or (need_sq and gram_like):
        dot = _gram_bf16(x1, x2) if method == "gram_bf16" else x1 @ x2.T
    if DOT in needs:
        feats[DOT] = dot
    if need_sq:
        if gram_like:
            n1 = torch.sum(x1 * x1, dim=-1)
            n2 = torch.sum(x2 * x2, dim=-1)
            sq = n1[:, None] + n2[None, :] - 2.0 * dot
            sq = torch.clamp_min(sq, 0.0)
        elif method == "direct":
            diff = x1[:, None, :] - x2[None, :, :]
            sq = torch.sum(diff * diff, dim=-1)
        else:
            raise ValueError(f"unknown distance method {method!r}")
        feats[SQDIST] = sq
        if DIST in needs:
            feats[DIST] = torch.sqrt(sq)
    return feats


def diag_features(x: torch.Tensor, needs: FrozenSet[str]) -> dict[str, torch.Tensor]:
    """Features of each row paired with itself: sqdist=dist=0, dot=||x||^2.

    Used for the k(x, x) diagonal in predictive variance
    (reference ``gaussian_process/mod.rs:266-269``).
    """
    feats: dict[str, torch.Tensor] = {}
    n = x.shape[0]
    if DOT in needs:
        feats[DOT] = torch.sum(x * x, dim=-1)
    if SQDIST in needs:
        feats[SQDIST] = torch.zeros((n,), dtype=x.dtype, device=x.device)
    if DIST in needs:
        feats[DIST] = torch.zeros((n,), dtype=x.dtype, device=x.device)
    return feats
