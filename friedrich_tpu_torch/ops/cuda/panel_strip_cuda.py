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
factorization's leading region) or given explicitly (``prefix``, (rows, C) of
unit column stride whose first B rows are the strip's columns: a contiguous
chunk the out-of-core factorization uploads, or the owner's view of its row
block in the distributed factorization). Below the panel's rank the panel's
rows are not the strip's: they arrive by broadcast as ``panel_rows``, the
kernel's second operand, and ``row0`` places the strip's first row. The wrapper takes CUDA tensors only and raises on anything the
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
#: Of those, the launches with the panel's rows as their own operand
#: (``panel_rows``: a rank of the distributed factorization below the panel).
LAUNCHES_TWO_OPERAND = {"tf32x3": 0, "one_pass": 0, "bf16": 0, "f64": 0}

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


def _rows_operand(t: torch.Tensor, what: str) -> int:
    """The row stride of a prefix operand, which the kernel reads as rows of
    unit column stride; raises for any other layout."""
    if t.ndim != 2:
        raise ValueError(f"panel-strip kernel takes a 2-D {what}, got {tuple(t.shape)}")
    if t.shape[1] > 0 and (t.stride(1) != 1 or t.stride(0) < t.shape[1]):
        raise ValueError(f"panel-strip kernel takes a {what} of rows with unit column stride, "
                         f"got strides {t.stride()}")
    return t.stride(0) if t.shape[1] > 0 else max(t.shape[1], 1)


def panel_strip(kernel, x_tail: torch.Tensor, xj: torch.Tensor,
                l_full: torch.Tensor | None, n: int, noise, j0: int, block: int,
                method: str = "gram", precision=None,
                prefix: torch.Tensor | None = None, end: int | None = None,
                panel_rows: torch.Tensor | None = None, row0: int | None = None) -> torch.Tensor:
    """The (rows, block) pre-factor strip as one kernel launch.

    ``x_tail`` holds the strip's rows of the padded inputs, ``xj`` rows
    ``j0..j0+block``. The prefix is either rows ``j0..end`` of the first
    ``j0`` columns of ``l_full``, the whole (cap, cap) factor, read in place
    (``end`` defaults to cap), or, with ``l_full=None``, ``prefix`` itself,
    (rows, C) of unit column stride (a contiguous tensor, or a view of a
    row-sharded factor). ``precision`` is the factor precision
    (:func:`variant`).

    One operand (the streamed factorization): the strip's rows start at
    global row ``j0`` and its columns are the prefix's first ``block`` rows.
    Two operands (a rank of the distributed factorization below the panel):
    ``panel_rows`` (block, >= C) holds the panel's rows of the prefix, of
    the prefix's dtype, and ``row0`` is the global row of the strip's first
    row; with ``prefix`` only.
    """
    global LAUNCHES
    if (l_full is None) == (prefix is None):
        raise ValueError("panel-strip kernel takes either l_full or prefix")
    if panel_rows is None and row0 is not None and row0 != j0:
        raise ValueError(f"a one-operand strip starts at row j0={j0}, got row0={row0}")
    if panel_rows is not None and prefix is None:
        raise ValueError("panel-strip kernel takes panel_rows only with an explicit prefix")
    lmat = l_full if prefix is None else prefix
    tensors = (x_tail, xj, lmat) + (() if panel_rows is None else (panel_rows,))
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
    if panel_rows is not None and panel_rows.dtype != lmat.dtype:
        raise ValueError(f"panel-strip kernel takes panel rows of the prefix's dtype {lmat.dtype}, "
                         f"got {panel_rows.dtype}")
    if lmat.ndim != 2:
        raise ValueError(f"panel-strip kernel takes a 2-D prefix, got {tuple(lmat.shape)}")
    first = j0 if row0 is None else int(row0)
    if prefix is None:
        if l_full.shape[0] != l_full.shape[1] or not l_full.is_contiguous():
            raise ValueError(f"panel-strip kernel takes a contiguous square factor, got "
                             f"{tuple(l_full.shape)}")
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
        ldl = _rows_operand(prefix, "prefix")
        cap = max(rest + first, j0 + block)
        rows = prefix
    b_rows, ldb = rows, ldl
    if panel_rows is not None:
        ldb = _rows_operand(panel_rows, "panel_rows")
        if panel_rows.shape[0] != block or panel_rows.shape[1] < kdim:
            raise ValueError(f"panel-strip kernel takes panel rows ({block}, >= {kdim}), got "
                             f"{tuple(panel_rows.shape)}")
        b_rows = panel_rows
        if not (0 <= j0 and 1 <= block and 0 <= first and rest >= 1):
            raise ValueError(f"panel [{j0}, {j0 + block}) and rows [{first}, {first + rest}) "
                             f"are not a strip")
    elif not (0 <= j0 and 1 <= block <= rest):
        raise ValueError(f"panel [{j0}, {j0 + block}) does not fit rows [{j0}, {j0 + rest})")
    if (x_tail.ndim != 2 or xj.ndim != 2 or x_tail.shape[0] != rest
            or xj.shape != (block, x_tail.shape[1])):
        raise ValueError(
            f"panel-strip kernel takes x_tail ({rest}, d) and xj ({block}, d), "
            f"got {tuple(x_tail.shape)} and {tuple(xj.shape)}"
        )
    if not (x_tail.is_contiguous() and xj.is_contiguous()):
        raise ValueError("panel-strip kernel takes contiguous inputs")
    if method not in METHODS:
        raise ValueError(f"unknown distance method {method!r}")
    if max(cap, ldl, ldb, x_tail.shape[1]) >= 2**31 or rest > 65535 * 128:
        raise ValueError(f"panel-strip kernel takes capacities up to {65535 * 128}")
    out = torch.empty((rest, block), dtype=dtype, device=x_tail.device)
    prog, needs = program(kernel)
    fn = getattr(library(), _ENTRY[kind])
    stream = torch.cuda.current_stream(x_tail.device).cuda_stream
    pointers = [x_tail.data_ptr(), xj.data_ptr(), rows.data_ptr(), b_rows.data_ptr()]
    if kind == "one_pass":
        # the panel's rows rounded to bfloat16, rows 16-byte aligned
        scratch = torch.empty((block, -(-kdim // 8) * 8) if kdim else (0,), dtype=torch.bfloat16,
                              device=x_tail.device)
        pointers.append(scratch.data_ptr() if kdim else None)
    err = fn(
        *pointers, out.data_ptr(), rest, block, x_tail.shape[1], ldl, ldb, kdim, first, j0, int(n),
        float(noise), METHODS[method], needs, prog, stream,
    )
    check_launch(err, "panel-strip kernel")
    LAUNCHES += 1
    LAUNCHES_BY_VARIANT[kind] += 1
    if panel_rows is not None:
        LAUNCHES_TWO_OPERAND[kind] += 1
    return out
