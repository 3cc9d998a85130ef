"""Wrapper of the hand-written CUDA covariance-tile kernel
(``friedrich_tpu_torch/csrc/covariance.cu``), the port of the Pallas kernel
``friedrich_tpu/ops/pallas/covariance_pallas.py:_cov_pallas``.

The source is compiled with ``nvcc`` for ``sm_90a`` into
``friedrich_tpu_torch/_build/`` at first use, keyed by a hash of the
source and flags, and loaded with ``ctypes``. The kernel map travels as a
postfix program (:func:`encode_program`) passed by value in the launch.

The wrapper takes CUDA tensors only; it raises on anything the kernel does
not take. Its plain PyTorch version is ``ops/covariance.py``'s
``plain_*`` builders, which the dispatchers there use for CPU tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from ...kernels import (
    Exponential,
    HyperTan,
    KernelProd,
    KernelSum,
    Linear,
    Matern1,
    Matern2,
    Multiquadric,
    Polynomial,
    RationalQuadratic,
    SquaredExp,
)
from ...ops.distance import DIST, DOT, SQDIST
from ...utils.errors import ConfigError

#: Kernel launches made by this wrapper in this process.
LAUNCHES = 0

MAX_OPS = 16
MAX_PARAMS = 32

#: Opcodes of the leaf kernels and combinators (``enum Op`` in the source).
OPCODES = {
    Linear: 0,
    Polynomial: 1,
    SquaredExp: 2,
    Exponential: 3,
    Matern1: 4,
    Matern2: 5,
    HyperTan: 6,
    Multiquadric: 7,
    RationalQuadratic: 8,
}
OP_ADD = 9
OP_MUL = 10

METHODS = {"gram": 0, "gram_bf16": 1, "direct": 2}
_NEED_BITS = {DOT: 1, SQDIST: 2, DIST: 4}

_PACKAGE = Path(__file__).resolve().parents[2]
SOURCE = _PACKAGE / "csrc" / "covariance.cu"
BUILD_DIR = _PACKAGE / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class _Program(ctypes.Structure):
    """``struct CovProgram`` of the source."""

    _fields_ = [
        ("n_ops", ctypes.c_int),
        ("ops", ctypes.c_int * MAX_OPS),
        ("offs", ctypes.c_int * MAX_OPS),
        ("params", ctypes.c_double * MAX_PARAMS),
    ]


def encode_program(kernel) -> tuple[list[int], list[int], list[float]]:
    """The kernel tree as a postfix program: ``(ops, offs, params)``, where
    ``offs[i]`` is the first parameter of leaf op ``i`` (0 for ADD/MUL) and
    each leaf's parameters are in its ``PARAM_FIELDS`` order."""
    ops: list[int] = []
    offs: list[int] = []
    params: list[float] = []

    def walk(k):
        if isinstance(k, (KernelSum, KernelProd)):
            walk(k.k1)
            walk(k.k2)
            ops.append(OP_ADD if isinstance(k, KernelSum) else OP_MUL)
            offs.append(0)
            return
        op = OPCODES.get(type(k))
        if op is None:
            raise ConfigError(
                f"kernel {type(k).__name__} has no opcode in the CUDA "
                f"covariance kernel"
            )
        ops.append(op)
        offs.append(len(params))
        params.extend(float(getattr(k, f)) for f in k.PARAM_FIELDS)

    walk(kernel)
    if len(ops) > MAX_OPS or len(params) > MAX_PARAMS:
        raise ConfigError(
            f"kernel tree too large for the CUDA covariance kernel: "
            f"{len(ops)} nodes (max {MAX_OPS}), {len(params)} parameters "
            f"(max {MAX_PARAMS})"
        )
    return ops, offs, params


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA covariance kernel cannot be built")


def build() -> tuple[Path, str]:
    """Compile the kernel source if its hash has no library yet. Returns
    the library's path and the compiler's report (``-Xptxas -v``: the
    registers and shared memory of each kernel; empty when the library
    was already built)."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"libcovariance_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, lib)
    return lib, proc.stdout + proc.stderr


_LIB = None


def _library():
    global _LIB
    if _LIB is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        for fn in (lib.friedrich_cov_f32, lib.friedrich_cov_f64):
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_longlong, ctypes.c_longlong, ctypes.c_double,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                _Program, ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
        lib.friedrich_cuda_error_string.argtypes = [ctypes.c_int]
        lib.friedrich_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


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
    if m1 > 65535 * 64:
        raise ValueError(f"covariance kernel takes at most {65535 * 64} rows, got {m1}")
    out = torch.empty((m1, m2), dtype=x1.dtype, device=x1.device)
    if m1 == 0 or m2 == 0:
        return out
    ops, offs, params = encode_program(kernel)
    prog = _Program()
    prog.n_ops = len(ops)
    for i, (op, off) in enumerate(zip(ops, offs)):
        prog.ops[i] = op
        prog.offs[i] = off
    for i, p in enumerate(params):
        prog.params[i] = p
    needs = sum(_NEED_BITS[f] for f in kernel.needs)
    lib = _library()
    fn = lib.friedrich_cov_f32 if x1.dtype == torch.float32 else lib.friedrich_cov_f64
    stream = torch.cuda.current_stream(x1.device).cuda_stream
    err = fn(
        x1.data_ptr(), x2.data_ptr(), out.data_ptr(), m1, m2, d,
        int(row0), int(n), float(noise), int(bool(train)), METHODS[method],
        needs, prog, stream,
    )
    if err != 0:
        msg = lib.friedrich_cuda_error_string(err).decode()
        raise RuntimeError(f"covariance kernel launch failed: CUDA error {err} ({msg})")
    LAUNCHES += 1
    return out
