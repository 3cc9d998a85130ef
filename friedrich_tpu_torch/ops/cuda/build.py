"""Build and load the hand-written CUDA kernels of ``friedrich_tpu_torch/csrc``.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process for ``sm_90a``,
all started together, and the objects are linked into one shared library
in ``friedrich_tpu_torch/_build/``, named by a hash of every source and
header and the flags. The library is built at first use and loaded with
``ctypes``: each kernel has a plain C entry point that returns the launch's
``cudaError_t``.

The kernel map of a covariance function travels to the kernels as a
postfix program (:func:`encode_program`, ``struct CovProgram`` in
``csrc/program.cuh``) passed by value in the launch. The covariance-tile
kernel compiles in the map of a kernel that is a single leaf instead
(:func:`kernel_map`): the wrapper picks that leaf's instantiation and
passes its constants (``struct LeafConsts``, ``csrc/covariance.cuh``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

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

MAX_OPS = 16
MAX_PARAMS = 32

#: Opcodes of the leaf kernels and combinators (``enum Op`` in program.cuh).
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

#: ``map`` of a covariance-kernel launch that interprets the program
#: (``MAP_PROGRAM`` in csrc/covariance.cuh); a leaf's map is its opcode.
MAP_PROGRAM = -1

METHODS = {"gram": 0, "gram_bf16": 1, "direct": 2}
_NEED_BITS = {DOT: 1, SQDIST: 2, DIST: 4}

_PACKAGE = Path(__file__).resolve().parents[2]
SOURCE_DIR = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class Program(ctypes.Structure):
    """``struct CovProgram`` of ``csrc/program.cuh``."""

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
                f"kernel-map interpreter"
            )
        ops.append(op)
        offs.append(len(params))
        params.extend(float(getattr(k, f)) for f in k.PARAM_FIELDS)

    walk(kernel)
    if len(ops) > MAX_OPS or len(params) > MAX_PARAMS:
        raise ConfigError(
            f"kernel tree too large for the CUDA kernel-map interpreter: "
            f"{len(ops)} nodes (max {MAX_OPS}), {len(params)} parameters "
            f"(max {MAX_PARAMS})"
        )
    return ops, offs, params


class LeafConstants(ctypes.Structure):
    """``struct LeafConsts`` of ``csrc/covariance.cuh``."""

    _fields_ = [("c", ctypes.c_double * 4)]


def leaf_constants(op: int, params: list[float]) -> list[float]:
    """The constants of a leaf's compiled-in map (``leaf_map`` in
    ``csrc/program.cuh``), from its parameters in ``PARAM_FIELDS`` order:
    each quotient of parameters computed here, once per launch, in
    float64, with IEEE semantics (a zero lengthscale, which a sampler's
    trajectory can reach by underflow, gives an infinite constant, as the
    division on the card would, not an exception)."""
    params = [np.float64(p) for p in params]
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        if op in (OPCODES[SquaredExp], OPCODES[Exponential]):
            ls, ampl = params
            consts = [abs(ampl), -1.0 / (2.0 * ls * ls)]
        elif op == OPCODES[Matern1]:
            ls, ampl = params
            consts = [abs(ampl), np.sqrt(3.0) / abs(ls)]
        elif op == OPCODES[Matern2]:
            ls, ampl = params
            consts = [abs(ampl), np.sqrt(5.0) / abs(ls), 5.0 / (3.0 * ls * ls)]
        elif op == OPCODES[RationalQuadratic]:
            alpha, ls = params
            consts = [-alpha, 1.0 / (2.0 * alpha * ls * ls)]
        else:
            consts = params
    return [float(c) for c in consts]


def kernel_map(kernel) -> tuple[int, list[float]]:
    """The map a covariance-kernel launch runs: a single leaf's opcode and
    its :func:`leaf_constants`, or ``MAP_PROGRAM`` (no constants) for a
    Sum/Prod tree, which the kernel interprets."""
    op = OPCODES.get(type(kernel))
    if op is None:
        return MAP_PROGRAM, []
    return op, leaf_constants(op, [float(getattr(kernel, f)) for f in kernel.PARAM_FIELDS])


def program(kernel) -> tuple[Program, int]:
    """The launch arguments of a kernel tree: its :class:`Program` and the
    bit mask of the features it needs (``enum Need``)."""
    ops, offs, params = encode_program(kernel)
    prog = Program()
    prog.n_ops = len(ops)
    for i, (op, off) in enumerate(zip(ops, offs)):
        prog.ops[i] = op
        prog.offs[i] = off
    for i, p in enumerate(params):
        prog.params[i] = p
    return prog, sum(_NEED_BITS[f] for f in kernel.needs)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> tuple[Path, str]:
    """Compile and link the kernel sources if their hash has no library
    yet. Returns the library's path and the compilers' report
    (``-Xptxas -v``: the registers, shared memory and spills of each
    kernel; empty when the library was already built)."""
    files = sorted(SOURCE_DIR.glob("*.cu*"))
    digest = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for f in files:
        digest.update(f.name.encode() + b"\0" + f.read_bytes())
    lib = BUILD_DIR / f"libfriedrich_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib, ""
    work = BUILD_DIR / f"{lib.stem}.{os.getpid()}.tmp"
    work.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    sources = [f for f in files if f.suffix == ".cu"]
    objects = [work / f"{src.stem}.o" for src in sources]
    procs = [
        subprocess.Popen(
            [nvcc, *COMPILE_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for src, obj in zip(sources, objects)
    ]
    reports = [proc.communicate()[0] for proc in procs]
    for src, proc, report in zip(sources, procs, reports):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name} ({proc.returncode}):\n{report}")
    tmp = work / lib.name
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objects)],
        capture_output=True, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stdout}\n{link.stderr}")
    os.replace(tmp, lib)
    shutil.rmtree(work)
    return lib, "".join(reports)


_LIB = None


def library():
    """The loaded kernel library, built first if needed."""
    global _LIB
    if _LIB is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        ptr, ll = ctypes.c_void_p, ctypes.c_longlong
        for fn in (lib.friedrich_cov_f32, lib.friedrich_cov_f64):
            fn.argtypes = [
                ptr, ptr, ptr, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ll, ll, ctypes.c_double, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, LeafConstants, Program, ptr,
            ]
            fn.restype = ctypes.c_int
        strip_args = [
            ptr, ptr, ptr, ptr, ptr, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ll, ll, ctypes.c_int, ll, ll, ll, ctypes.c_double,
            ctypes.c_int, ctypes.c_int, Program, ptr,
        ]
        for fn in (lib.friedrich_panel_strip_f32, lib.friedrich_panel_strip_bf16,
                   lib.friedrich_panel_strip_f64):
            fn.argtypes = strip_args
            fn.restype = ctypes.c_int
        # the single pass takes a scratch buffer for its bfloat16 B rows
        lib.friedrich_panel_strip_f32_1pass.argtypes = [*strip_args[:4], ptr, *strip_args[4:]]
        lib.friedrich_panel_strip_f32_1pass.restype = ctypes.c_int
        lib.friedrich_host_register.argtypes = [ptr, ctypes.c_size_t]
        lib.friedrich_host_unregister.argtypes = [ptr]
        lib.friedrich_host_is_locked.argtypes = [ptr]
        lib.friedrich_copy_2d.argtypes = [
            ptr, ctypes.c_size_t, ptr, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_size_t,
            ctypes.c_int, ptr,
        ]
        for fn in (lib.friedrich_host_register, lib.friedrich_host_unregister,
                   lib.friedrich_host_is_locked, lib.friedrich_copy_2d):
            fn.restype = ctypes.c_int
        lib.friedrich_cuda_error_string.argtypes = [ctypes.c_int]
        lib.friedrich_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def check_launch(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = library().friedrich_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")
