"""Wrapper of the hand-written CUDA covariance-tile kernel
(``friedrich_tpu_torch/csrc/covariance.cuh``), the port of the Pallas kernel
``friedrich_tpu/ops/pallas/covariance_pallas.py:_cov_pallas``.

The kernel is built and loaded by :mod:`.build`, with the other kernels of
``csrc/``. A kernel that is a single leaf launches the instantiation with
that leaf's map compiled in, its constants passed by value
(:func:`~.build.kernel_map`); a Sum/Prod tree launches the one that
interprets its postfix program (:func:`~.build.encode_program`).

The wrapper takes CUDA tensors only; it raises on anything the kernel does
not take. Its plain PyTorch version, with its signature, is
``ops/covariance.py``'s ``plain_covariance_tile`` (over the ``plain_*``
builders, which the dispatchers there use for CPU tensors).
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch

from .build import (  # noqa: F401
    MAP_PROGRAM, METHODS, OP_ADD, OP_MUL, LeafConstants, Program, check_launch, encode_program,
    kernel_map, library, program,
)

#: Kernel launches made by this wrapper in this process.
LAUNCHES = 0
#: The same launches by ``(m1, m2, train)``.
LAUNCHES_BY_SHAPE: Counter = Counter()


def covariance(kernel, x1: torch.Tensor, x2: torch.Tensor, n: int, noise=0.0,
               train: bool = False, method: str = "gram",
               row0: int = 0) -> torch.Tensor:
    """K(x1, x2) as one launch of the covariance-tile kernel.

    ``train=True``: the padded training covariance — analytic diagonal
    ``k(x,x) + noise^2``, identity outside the live ``n x n`` block — where
    ``x1`` holds rows ``row0 .. row0+m1`` of the matrix whose columns are
    ``x2``. ``train=False``: rows with global index ``row0 + i >= n`` are
    zero.
    """
    global LAUNCHES
    if not (isinstance(x1, torch.Tensor) and isinstance(x2, torch.Tensor)):
        raise TypeError("covariance kernel takes tensors")
    if not (x1.is_cuda and x2.is_cuda) or x1.device != x2.device:
        raise ValueError(
            f"covariance kernel takes CUDA tensors on one device, got "
            f"{x1.device} and {x2.device}"
        )
    if x1.dtype not in (torch.float32, torch.float64) or x2.dtype != x1.dtype:
        raise ValueError(
            f"covariance kernel takes float32 or float64 inputs of one dtype, "
            f"got {x1.dtype} and {x2.dtype}"
        )
    if x1.ndim != 2 or x2.ndim != 2 or x1.shape[1] != x2.shape[1]:
        raise ValueError(
            f"covariance kernel takes (m1, d) and (m2, d) inputs, got "
            f"{tuple(x1.shape)} and {tuple(x2.shape)}"
        )
    if not (x1.is_contiguous() and x2.is_contiguous()):
        raise ValueError("covariance kernel takes contiguous inputs")
    if method not in METHODS:
        raise ValueError(f"unknown distance method {method!r}")
    m1, d = x1.shape
    m2 = x2.shape[0]
    if max(m1, m2, d) >= 2**31:
        raise ValueError("covariance kernel takes sizes below 2**31")
    out = torch.empty((m1, m2), dtype=x1.dtype, device=x1.device)
    if m1 == 0 or m2 == 0:
        return out
    op, consts = kernel_map(kernel)
    prog, needs = program(kernel) if op == MAP_PROGRAM else (Program(), 0)
    lib = library()
    fn = lib.friedrich_cov_f32 if x1.dtype == torch.float32 else lib.friedrich_cov_f64
    stream = torch.cuda.current_stream(x1.device).cuda_stream
    err = fn(
        x1.data_ptr(), x2.data_ptr(), out.data_ptr(), m1, m2, d,
        int(row0), int(n), float(noise), int(bool(train)), METHODS[method],
        needs, op, LeafConstants((ctypes.c_double * 4)(*consts)), prog, stream,
    )
    check_launch(err, "covariance kernel")
    LAUNCHES += 1
    LAUNCHES_BY_SHAPE[(m1, m2, bool(train))] += 1
    return out
