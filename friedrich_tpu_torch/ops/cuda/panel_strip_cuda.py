"""Wrapper of the hand-written CUDA panel-strip kernel
(``friedrich_tpu_torch/csrc/panel_strip.cu``), the port of the Pallas kernel
``friedrich_tpu/ops/pallas/panel_fused.py:_fused_panel_strip_impl``
(``:99-177``, body ``_fused_body`` ``:51-96``).

One launch writes the (cap - j0, B) pre-factor strip of the streamed
Cholesky's panel at column offset ``j0``: the padded training covariance
``K(X[j0:], X[j0:j0+B])`` minus the downdate
``L[j0:, :j0] @ L[j0:j0+B, :j0].T``, each element written once. The
downdate dominates, about cap^3 / 3 operations over a factorization. In
float32 it runs on the tensor cores as three TF32 products of split
operands (3xTF32, ``wgmma`` fed by TMA, or by ``cp.async`` where the
capacity is not a multiple of 4); in float64 on the CUDA cores (see the
source's note).

The wrapper takes CUDA tensors only and raises on anything the kernel does
not take. Its plain PyTorch version is ``ops/panel_fused.plain_panel_strip``.
"""

from __future__ import annotations

import torch

from .build import METHODS, check_launch, library, program

#: Kernel launches made by this wrapper in this process.
LAUNCHES = 0

#: Relative error of one float32 product a*b formed by the 3xTF32 split,
#: on top of float32 accumulation: a_lo b_lo is dropped and the low parts
#: are rounded, 3 * 2^-22 (1 + 2^-11)^2 < 2^-20 (derivation in the source).
#: The downdate's tolerance adds SPLIT_ERROR * (|L_tail| |L_rows|^T).
SPLIT_ERROR = 2.0**-20


def panel_strip(kernel, x_tail: torch.Tensor, xj: torch.Tensor,
                l_full: torch.Tensor, n: int, noise, j0: int, block: int,
                method: str = "gram") -> torch.Tensor:
    """The (cap - j0, block) pre-factor strip as one kernel launch.

    ``x_tail`` holds rows ``j0..cap`` of the padded inputs, ``xj`` rows
    ``j0..j0+block``; ``l_full`` is the whole (cap, cap) factor, of which
    rows ``j0..cap`` of the first ``j0`` columns are read in place.
    """
    global LAUNCHES
    tensors = (x_tail, xj, l_full)
    if not all(isinstance(t, torch.Tensor) for t in tensors):
        raise TypeError("panel-strip kernel takes tensors")
    if not all(t.is_cuda and t.device == x_tail.device for t in tensors):
        raise ValueError(
            f"panel-strip kernel takes CUDA tensors on one device, got "
            f"{[str(t.device) for t in tensors]}"
        )
    dtype = x_tail.dtype
    if dtype not in (torch.float32, torch.float64) or any(t.dtype != dtype for t in tensors):
        raise ValueError(
            f"panel-strip kernel takes float32 or float64 inputs of one dtype, "
            f"got {[t.dtype for t in tensors]}"
        )
    if l_full.ndim != 2 or l_full.shape[0] != l_full.shape[1]:
        raise ValueError(f"panel-strip kernel takes a square factor, got {tuple(l_full.shape)}")
    cap = l_full.shape[0]
    rest = cap - j0
    if not (0 <= j0 and 1 <= block <= rest):
        raise ValueError(f"panel [{j0}, {j0 + block}) does not fit capacity {cap}")
    if (x_tail.ndim != 2 or xj.ndim != 2 or x_tail.shape[0] != rest
            or xj.shape != (block, x_tail.shape[1])):
        raise ValueError(
            f"panel-strip kernel takes x_tail ({rest}, d) and xj ({block}, d), "
            f"got {tuple(x_tail.shape)} and {tuple(xj.shape)}"
        )
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("panel-strip kernel takes contiguous inputs")
    if method not in METHODS:
        raise ValueError(f"unknown distance method {method!r}")
    if max(cap, x_tail.shape[1]) >= 2**31 or rest > 65535 * 128:
        raise ValueError(f"panel-strip kernel takes capacities up to {65535 * 128}")
    out = torch.empty((rest, block), dtype=dtype, device=x_tail.device)
    prog, needs = program(kernel)
    lib = library()
    fn = lib.friedrich_panel_strip_f32 if dtype == torch.float32 else lib.friedrich_panel_strip_f64
    l_rows = l_full[j0:].data_ptr()  # row j0 of the factor; rows j0..j0+block are its first
    stream = torch.cuda.current_stream(x_tail.device).cuda_stream
    err = fn(
        x_tail.data_ptr(), xj.data_ptr(), l_rows, l_rows, out.data_ptr(),
        rest, block, x_tail.shape[1], cap, j0, j0, j0, int(n), float(noise),
        METHODS[method], needs, prog, stream,
    )
    check_launch(err, "panel-strip kernel")
    LAUNCHES += 1
    return out
