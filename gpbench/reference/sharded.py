"""The plain reference of ``gp.py`` with its factor held in row blocks over
the ranks of the default ``torch.distributed`` process group, for a model
whose factor no single card holds (a float32 factor at n = 200,000 is
160 GB).

The arithmetic is ``gp.py``'s: the left-looking panel Cholesky at ``PANEL``
columns, every matmul in float32 with TF32 off, or in TF32 with
``tf32=True`` (the control). Rank ``r`` of ``W`` holds the contiguous rows
``bounds(n, W)[r]`` of the factor, every column of them (zeros above the
diagonal); the rows need not divide evenly. One panel step:

1. the panel's rows of the factor to its left, ``L[j:j+b, :j]``, go from
   the ranks that hold them to every rank (broadcast);
2. each rank forms its own rows of the panel's strip, the kernel block less
   the downdate, on the diagonal ``ampl + noise^2`` exactly;
3. the strip's diagonal block goes from its owners to every rank, and
   every rank factors it alike;
4. each rank writes its rows of the panel: the diagonal block's rows, and
   below them the strip solved against its transpose.

At n = 200,000 over four ranks a rank holds its 40 GB block, one strip of
its rows (0.41 GB at 2,048 columns) and the panel's rows (at most 2,048 x
200,000 x 4 B = 1.64 GB).

Predictions are a blocked forward solve of ``L [beta | V] = [r | K(X, q)]``:
the panels, cut also at the ranks' bounds so that each has one owner, are
solved by their owner in turn and broadcast, and each rank takes the solved
rows out of its own rows below them. Mean and latent variance accumulate
panel by panel on every rank.

Only broadcast and all-reduce cross between ranks. Without a process group
this is a world of one, ``gp.py``'s arithmetic in panels.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .gp import PANEL, QUERY_BLOCK, kernel_block, mm, precision


def rank_and_size() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def bounds(n: int, size: int) -> list[tuple[int, int]]:
    """``[r0, r1)`` of each rank's rows: contiguous, in rank order, their
    lengths differing by one at most."""
    return [(r * n // size, (r + 1) * n // size) for r in range(size)]


def owner(blocks: list, row: int) -> int:
    return next(q for q, (q0, q1) in enumerate(blocks) if q0 <= row < q1)


class Factor:
    """This rank's rows ``rows = [r0, r1)`` of the lower factor of an
    ``n x n`` matrix, ``block`` (r1 - r0, n), and every rank's bounds."""

    def __init__(self, block: torch.Tensor, rows: tuple, blocks: list, n: int):
        self.block, self.rows, self.blocks, self.n = block, rows, blocks, n


def replicate(blocks: list, rank: int, lo: int, hi: int, cols: int, source, like) -> torch.Tensor:
    """Rows ``[lo, hi)`` of a matrix held in row blocks, ``cols`` wide, on
    every rank: each owner's part broadcast from it. ``source(a, b)`` gives
    this rank's rows ``[a, b)`` (global indices)."""
    out = torch.empty((hi - lo, cols), dtype=like.dtype, device=like.device)
    for q, (q0, q1) in enumerate(blocks):
        a, b = max(lo, q0), min(hi, q1)
        if a >= b:
            continue
        part = out[a - lo:b - lo]
        if q == rank:
            part.copy_(source(a, b))
        if len(blocks) > 1:
            dist.broadcast(part, src=q)
    return out


def cholesky(x: torch.Tensor, ls: float, ampl: float, noise: float, tf32: bool = False,
             panel: int = PANEL) -> Factor:
    """This rank's rows of the lower Cholesky factor of ``K(x, x) + noise^2
    I``; every rank holds all of ``x``. Raises ``ValueError`` on every rank
    where a diagonal block is not positive definite."""
    n = x.shape[0]
    rank, size = rank_and_size()
    blocks = bounds(n, size)
    r0, r1 = blocks[rank]
    block = torch.zeros((r1 - r0, n), dtype=x.dtype, device=x.device)
    with precision(tf32):
        for j in range(0, n, panel):
            b = min(panel, n - j)
            lo = max(j, r0)  # this rank's first row at or below the panel
            strip = None
            if lo < r1:
                strip = kernel_block(x[lo:r1], x[j:j + b], ls, ampl, tf32)
                # the diagonal at zero distance exactly
                top = min(j + b, r1) - lo
                if top > 0:
                    strip[:top, lo - j:lo - j + top].diagonal().fill_(abs(ampl) + noise * noise)
            if j:
                rows = replicate(blocks, rank, j, j + b, j,
                                 lambda a, c: block[a - r0:c - r0, :j], x)
                if strip is not None:
                    strip.sub_(mm(block[lo - r0:, :j], rows.mT, tf32))
                del rows
            top = replicate(blocks, rank, j, j + b, b, lambda a, c: strip[a - lo:c - lo], x)
            diag, info = torch.linalg.cholesky_ex(top)
            if int(info) != 0:
                raise ValueError(f"reference factor: panel at column {j} is not positive definite")
            if strip is not None:
                mid = min(max(j + b, lo), r1)  # this rank's rows [lo, mid) are the panel's own
                if mid > lo:
                    block[lo - r0:mid - r0, j:j + b] = diag[lo - j:mid - j]
                if mid < r1:
                    block[mid - r0:, j:j + b] = torch.linalg.solve_triangular(
                        diag.mT, strip[mid - lo:], upper=True, left=False)
            del strip, diag, top
    return Factor(block, (r0, r1), blocks, n)


def predict(factor: Factor, x: torch.Tensor, resid: torch.Tensor, prior: float, ls: float,
            ampl: float, xq: torch.Tensor, tf32: bool = False,
            live: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Posterior mean and latent variance at the rows of ``xq``, as float64
    tensors on the host on every rank, for the model over the first
    ``live`` rows (default all) of ``x``, whose factor is the leading block
    of ``factor``."""
    rank, size = rank_and_size()
    n = factor.n if live is None else live
    r0, r1 = factor.rows
    end = min(r1, n)  # this rank's live rows are [r0, end)
    edges = sorted({*range(0, n, PANEL), *(q0 for q0, _ in factor.blocks if q0 < n), n})
    means, variances = [], []
    with precision(tf32):
        for lo in range(0, xq.shape[0], QUERY_BLOCK):
            q = xq[lo:lo + QUERY_BLOCK]
            m = q.shape[0]
            rhs = None
            if r0 < end:
                rhs = torch.cat([resid[r0:end, None], kernel_block(x[r0:end], q, ls, ampl, tf32)],
                                dim=1)
            fit = torch.zeros(m, dtype=x.dtype, device=x.device)
            quad = torch.zeros(m, dtype=x.dtype, device=x.device)
            for j, k in zip(edges, edges[1:]):
                src = owner(factor.blocks, j)
                if src == rank:
                    v = torch.linalg.solve_triangular(factor.block[j - r0:k - r0, j:k],
                                                      rhs[j - r0:k - r0], upper=False).contiguous()
                else:
                    v = torch.empty((k - j, m + 1), dtype=x.dtype, device=x.device)
                if size > 1:
                    dist.broadcast(v, src=src)
                below = max(k, r0)
                if below < end:
                    rhs[below - r0:].sub_(mm(factor.block[below - r0:end - r0, j:k], v, tf32))
                fit.add_(mm(v[:, 1:].mT, v[:, :1], tf32)[:, 0])
                quad.add_(torch.sum(v[:, 1:] * v[:, 1:], dim=0))
                del v
            means.append((prior + fit).double().cpu())
            variances.append((abs(ampl) - quad).double().cpu())
            del rhs
    return torch.cat(means), torch.cat(variances)
