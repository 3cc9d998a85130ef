"""Wrapper of the hand-written CUDA panel-strip kernel
(``friedrich_tpu_torch/csrc/panel_strip.cuh``, entry points in
``panel_strip.cu``, ``panel_strip_1pass.cu`` and ``panel_strip_bf16.cu``), the
port of the Pallas kernel
``friedrich_tpu/ops/pallas/panel_fused.py:_fused_panel_strip_impl``
(``:99-177``, body ``_fused_body`` ``:51-96``).

One launch writes the (cap - j0, B) pre-factor strip of the streamed
Cholesky's panel at column offset ``j0``: the padded training covariance
``K(X[j0:], X[j0:j0+B])`` minus the downdate ``P @ P[:B].T`` of the prefix
``P = L[j0:, :j0]``, each element written once. The downdate dominates,
about cap^3 / 3 operations over a factorization, so the kernels are bound
by the tensor cores' rate and by how fast their operands reach them. Its
instantiations:

- ``"tf32x3"``: a float32 prefix, three TF32 products of split operands on
  the tensor cores (``wgmma`` fed by TMA, or by ``cp.async`` where the row
  stride is not a multiple of 4);
- ``"one_pass"``: a float32 prefix under the factor precision ``"bf16"``:
  both operands rounded to bfloat16, one bf16 product;
- ``"bf16"``: a bfloat16 prefix (the factor storage ``"bf16"``), one bf16
  product;
- ``"f64"``: float64 on the FP64 tensor cores (``mma.sync`` m16n8k16 fed
  by TMA, or by ``cp.async`` where the row stride is odd), each product a
  float64 FMA and the sums float64.

``"one_pass"`` and ``"bf16"`` share one kernel (``panel_strip_ws_kernel``):
a producer warpgroup keeps TMA loads in flight on a ring of stages with a
full and an empty barrier per slot (plain loads where TMA cannot take the
row stride), and two consumer warpgroups run bf16 ``wgmma`` with one group
in flight and promote their tensor-core sums into float32 registers every
512 products. What bounds it is the L2 traffic of its 128 x 128 tiles
(PERF.md). The single pass converts its float32 A fragments in registers
and rounds the panel's own rows to bfloat16 once per launch into a scratch
buffer this wrapper allocates (B x j0 bfloat16). Each product is exact in
float32 and the sums are float32.

The prefix is read in place from the factor (``l_full``, row stride cap; the
strip's rows may end before the factor's, ``end``: the hybrid
factorization's leading region) or given explicitly (``prefix``, a contiguous (cap - j0, C) tensor whose first B
rows are the strip's columns; the out-of-core factorization uploads it in
chunks). The wrapper takes CUDA tensors only and raises on anything the
kernel does not take. Its plain PyTorch version is
``ops/panel_fused.plain_panel_strip``.
"""

from __future__ import annotations

import torch

from .build import METHODS, check_launch, library, program

#: Kernel launches made by this wrapper in this process, in all and by
#: instantiation (:func:`variant`).
LAUNCHES = 0
LAUNCHES_BY_VARIANT = {"tf32x3": 0, "one_pass": 0, "bf16": 0, "f64": 0}

#: Relative error of one float32 product a*b formed by the 3xTF32 split,
#: on top of float32 accumulation: a_lo b_lo is dropped and the low parts
#: are rounded, 3 * 2^-22 (1 + 2^-11)^2 < 2^-20 (derivation in the source).
#: The downdate's tolerance adds SPLIT_ERROR * (|L_tail| |L_rows|^T). The
#: other instantiations form each product exactly from the operands their
#: plain version sees (bfloat16 values), so they add nothing.
SPLIT_ERROR = 2.0**-20

_ENTRY = {"tf32x3": "friedrich_panel_strip_f32", "one_pass": "friedrich_panel_strip_f32_1pass",
          "bf16": "friedrich_panel_strip_bf16", "f64": "friedrich_panel_strip_f64"}


def variant(dtype: torch.dtype, prefix_dtype: torch.dtype, precision=None) -> str:
    """The instantiation that computes a strip of inputs ``dtype`` against a
    prefix of ``prefix_dtype`` under the factor ``precision``; raises
    ``ValueError`` for a pairing no instantiation takes."""
    if dtype == torch.float64 and prefix_dtype == torch.float64:
        return "f64"
    if dtype == torch.float32 and prefix_dtype == torch.bfloat16:
        if precision not in (None, "bf16"):
            raise ValueError(f"a bfloat16 prefix has no precision {precision!r}")
        return "bf16"
    if dtype == torch.float32 and prefix_dtype == torch.float32:
        return "one_pass" if precision == "bf16" else "tf32x3"
    raise ValueError(
        f"panel-strip kernel takes float32 or float64 inputs with a prefix of the same dtype, "
        f"or float32 inputs with a bfloat16 prefix; got {dtype} and {prefix_dtype}"
    )


def panel_strip(kernel, x_tail: torch.Tensor, xj: torch.Tensor,
                l_full: torch.Tensor | None, n: int, noise, j0: int, block: int,
                method: str = "gram", precision=None,
                prefix: torch.Tensor | None = None, end: int | None = None) -> torch.Tensor:
    """The (end - j0, block) pre-factor strip as one kernel launch.

    ``x_tail`` holds rows ``j0..end`` of the padded inputs, ``xj`` rows
    ``j0..j0+block``. The prefix is either rows ``j0..end`` of the first
    ``j0`` columns of ``l_full``, the whole (cap, cap) factor, read in place
    (``end`` defaults to cap), or, with ``l_full=None``, ``prefix`` itself,
    (cap - j0, C), and ``end`` is None. ``precision`` is the factor
    precision (:func:`variant`).
    """
    global LAUNCHES
    if (l_full is None) == (prefix is None):
        raise ValueError("panel-strip kernel takes either l_full or prefix")
    lmat = l_full if prefix is None else prefix
    tensors = (x_tail, xj, lmat)
    if not all(isinstance(t, torch.Tensor) for t in tensors):
        raise TypeError("panel-strip kernel takes tensors")
    if not all(t.is_cuda and t.device == x_tail.device for t in tensors):
        raise ValueError(
            f"panel-strip kernel takes CUDA tensors on one device, got "
            f"{[str(t.device) for t in tensors]}"
        )
    dtype = x_tail.dtype
    if xj.dtype != dtype:
        raise ValueError(f"panel-strip kernel takes inputs of one dtype, got {dtype} and {xj.dtype}")
    kind = variant(dtype, lmat.dtype, precision)
    if lmat.ndim != 2:
        raise ValueError(f"panel-strip kernel takes a 2-D prefix, got {tuple(lmat.shape)}")
    if prefix is None:
        if l_full.shape[0] != l_full.shape[1]:
            raise ValueError(f"panel-strip kernel takes a square factor, got {tuple(l_full.shape)}")
        cap = l_full.shape[0]
        end = cap if end is None else end
        if not j0 < end <= cap:
            raise ValueError(f"panel-strip rows [{j0}, {end}) do not fit capacity {cap}")
        rest, kdim, ldl = end - j0, j0, cap
        rows = l_full[j0:]  # row j0 of the factor; rows j0..j0+block are its first
    else:
        if end is not None:
            raise ValueError("panel-strip kernel takes an end row only with l_full")
        rest, kdim = prefix.shape
        ldl, cap = kdim, rest + j0
        rows = prefix
    if not (0 <= j0 and 1 <= block <= rest):
        raise ValueError(f"panel [{j0}, {j0 + block}) does not fit rows [{j0}, {j0 + rest})")
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
    if max(cap, ldl, x_tail.shape[1]) >= 2**31 or rest > 65535 * 128:
        raise ValueError(f"panel-strip kernel takes capacities up to {65535 * 128}")
    out = torch.empty((rest, block), dtype=dtype, device=x_tail.device)
    prog, needs = program(kernel)
    fn = getattr(library(), _ENTRY[kind])
    stream = torch.cuda.current_stream(x_tail.device).cuda_stream
    pointers = [x_tail.data_ptr(), xj.data_ptr(), rows.data_ptr(), rows.data_ptr()]
    if kind == "one_pass":
        # the panel's own rows rounded to bfloat16, rows 16-byte aligned
        scratch = torch.empty((block, -(-kdim // 8) * 8) if kdim else (0,), dtype=torch.bfloat16,
                              device=x_tail.device)
        pointers.append(scratch.data_ptr() if kdim else None)
    err = fn(
        *pointers, out.data_ptr(), rest, block, x_tail.shape[1], ldl, kdim, j0, j0, int(n),
        float(noise), METHODS[method], needs, prog, stream,
    )
    check_launch(err, "panel-strip kernel")
    LAUNCHES += 1
    LAUNCHES_BY_VARIANT[kind] += 1
    return out
