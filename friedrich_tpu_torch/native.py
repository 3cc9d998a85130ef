"""ctypes loader for the native C++ CPU library (``native/friedrich_native.cpp``).

Counterpart of ``friedrich_tpu/native.py``: a dense float64 GP on the CPU
with no PyTorch compute in it, used as an independent parity oracle and as
the library the serving daemon (``serving.py``) links against. It runs on
the CPU by design; no path on the card calls it.

The library and the daemon are compiled from the repository's ``native/``
sources by ``g++`` at first use, into ``friedrich_tpu_torch/_build/``, in a
directory named by a hash of both sources and the flags (:func:`build`): a
source change builds anew, and the JAX package's binaries in ``native/``
are never read or written. A failed compile raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .utils.errors import CholeskyError, ConfigError

_REPO_ROOT = Path(__file__).resolve().parent.parent
NATIVE_DIR = _REPO_ROOT / "native"
_LIB_SRC = NATIVE_DIR / "friedrich_native.cpp"
_DAEMON_SRC = NATIVE_DIR / "friedrich_served.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
LIB_NAME = "libfriedrich_native.so"
DAEMON_NAME = "friedrich_served"
_CXX_FLAGS = ("-O3", "-march=native")

KERNEL_IDS = {
    "SquaredExp": 0,
    "Exponential": 1,
    "Matern1": 2,
    "Matern2": 3,
    "RationalQuadratic": 4,
    "Linear": 5,
    "Polynomial": 6,
    "HyperTan": 7,
    "Multiquadric": 8,
}

_lib: Optional[ctypes.CDLL] = None

_f64p = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")


@contextlib.contextmanager
def _build_lock():
    """An exclusive lock on ``_build/native.lock``: processes that build at
    once (parallel test workers) wait for each other."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "native.lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _compile(cmd: list[str]) -> None:
    try:
        done = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"the native build needs g++: {e}") from e
    if done.returncode != 0:
        raise RuntimeError(f"g++ failed ({done.returncode}): {' '.join(cmd)}\n{done.stderr}")


def build() -> Path:
    """The directory holding ``libfriedrich_native.so`` and
    ``friedrich_served`` built from the current sources, compiled first if
    it does not exist: into a temporary directory, then renamed into place,
    under :func:`_build_lock`. The daemon finds the library beside itself
    (rpath ``$ORIGIN``)."""
    digest = hashlib.sha256(" ".join(_CXX_FLAGS).encode())
    for src in (_LIB_SRC, _DAEMON_SRC):
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    out = BUILD_DIR / f"native_{digest.hexdigest()[:16]}"
    if (out / DAEMON_NAME).exists():
        return out
    with _build_lock():
        if (out / DAEMON_NAME).exists():
            return out
        work = BUILD_DIR / f"{out.name}.{os.getpid()}.tmp"
        shutil.rmtree(work, ignore_errors=True)
        work.mkdir(parents=True)
        try:
            _compile(["g++", *_CXX_FLAGS, "-shared", "-fPIC", "-o", str(work / LIB_NAME),
                      str(_LIB_SRC)])
            _compile(["g++", *_CXX_FLAGS, "-pthread", "-o", str(work / DAEMON_NAME),
                      str(_DAEMON_SRC), f"-L{work}", "-lfriedrich_native", "-Wl,-rpath,$ORIGIN"])
            os.replace(work, out)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    return out


def load() -> ctypes.CDLL:
    """Load (building first if needed) the native library."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build() / LIB_NAME))
    i64 = ctypes.c_int64
    lib.cov_matrix.argtypes = [ctypes.c_int, _f64p, _f64p, i64, _f64p, i64, i64, _f64p]
    lib.train_cov.argtypes = [ctypes.c_int, _f64p, _f64p, i64, i64, ctypes.c_double, _f64p]
    lib.cov_matrix2.argtypes = [
        ctypes.c_int, ctypes.c_int, _f64p, ctypes.c_int, _f64p,
        _f64p, i64, _f64p, i64, i64, _f64p,
    ]
    lib.train_cov2.argtypes = [
        ctypes.c_int, ctypes.c_int, _f64p, ctypes.c_int, _f64p,
        _f64p, i64, i64, ctypes.c_double, _f64p,
    ]
    lib.cholesky_factor.argtypes = [_f64p, i64, ctypes.c_double, ctypes.c_int]
    lib.cholesky_factor.restype = ctypes.c_int
    lib.solve_lower.argtypes = [_f64p, _f64p, i64, i64]
    lib.solve_lower_t.argtypes = [_f64p, _f64p, i64, i64]
    lib.gp_predict_mean_var.argtypes = [
        ctypes.c_int, _f64p, _f64p, i64, i64, _f64p, _f64p, _f64p, i64,
        _f64p, _f64p, _f64p,
    ]
    _lib = lib
    return lib


def to_f64(a) -> np.ndarray:
    """A tensor (any device, bfloat16 included) or array as a C-contiguous
    float64 array: each value exactly."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().to(torch.float64).numpy()
    return np.ascontiguousarray(np.asarray(a, dtype=np.float64))


def _kernel_id_and_params(kernel) -> tuple[int, np.ndarray]:
    name = type(kernel).__name__
    if name not in KERNEL_IDS:
        raise ConfigError(
            f"native backend supports simple kernels, not {name!r}"
        )
    return KERNEL_IDS[name], to_f64(kernel.get_params())


def _composite_spec(kernel):
    """(op, kid1, p1, kid2, p2): single kernels and two-kernel Sum/Prod."""
    name = type(kernel).__name__
    if name in ("KernelSum", "KernelProd"):
        op = 1 if name == "KernelSum" else 2
        kid1, p1 = _kernel_id_and_params(kernel.k1)
        kid2, p2 = _kernel_id_and_params(kernel.k2)
        return op, kid1, p1, kid2, p2
    kid, p = _kernel_id_and_params(kernel)
    return 0, kid, p, 0, np.zeros(1)


def _check_2d(name, a):
    if a.ndim != 2:
        raise ConfigError(f"{name} must be 2-D, got shape {a.shape}")


def cov_matrix(kernel, x1, x2) -> np.ndarray:
    lib = load()
    op, kid1, p1, kid2, p2 = _composite_spec(kernel)
    x1, x2 = to_f64(x1), to_f64(x2)
    _check_2d("x1", x1)
    _check_2d("x2", x2)
    if x1.shape[1] != x2.shape[1]:
        raise ConfigError(
            f"feature-dim mismatch: x1 has {x1.shape[1]}, x2 has {x2.shape[1]}"
        )
    out = np.empty((x1.shape[0], x2.shape[0]), dtype=np.float64)
    if op == 0:
        lib.cov_matrix(kid1, p1, x1, x1.shape[0], x2, x2.shape[0], x1.shape[1], out)
    else:
        lib.cov_matrix2(op, kid1, p1, kid2, p2, x1, x1.shape[0], x2,
                        x2.shape[0], x1.shape[1], out)
    return out


def train_cov(kernel, x, noise: float) -> np.ndarray:
    lib = load()
    op, kid1, p1, kid2, p2 = _composite_spec(kernel)
    x = to_f64(x)
    _check_2d("x", x)
    out = np.empty((x.shape[0], x.shape[0]), dtype=np.float64)
    if op == 0:
        lib.train_cov(kid1, p1, x, x.shape[0], x.shape[1], float(noise), out)
    else:
        lib.train_cov2(op, kid1, p1, kid2, p2, x, x.shape[0], x.shape[1],
                       float(noise), out)
    return out


def cholesky(a, eps: Optional[float] = None) -> np.ndarray:
    """Lower Cholesky with nalgebra's per-pivot substitute semantics."""
    lib = load()
    a = np.array(to_f64(a), order="C")  # copy; factored in place
    if a.ndim != 2 or a.shape[0] != a.shape[1]:
        raise ConfigError(f"cholesky needs a square matrix, got {a.shape}")
    rc = lib.cholesky_factor(
        a, a.shape[0], float(eps or 0.0), 1 if eps is not None else 0
    )
    if rc != 0:
        raise CholeskyError()
    return a


def solve_lower(l_mat, b, trans: bool = False) -> np.ndarray:
    lib = load()
    l_mat = to_f64(l_mat)
    b2 = np.array(to_f64(b), order="C")
    flat = b2.ndim == 1
    if flat:
        b2 = b2[:, None]
    if l_mat.ndim != 2 or l_mat.shape[0] != l_mat.shape[1]:
        raise ConfigError(f"L must be square, got {l_mat.shape}")
    if b2.shape[0] != l_mat.shape[0]:
        raise ConfigError(
            f"rhs rows {b2.shape[0]} != L size {l_mat.shape[0]}"
        )
    (lib.solve_lower_t if trans else lib.solve_lower)(
        l_mat, b2, b2.shape[0], b2.shape[1]
    )
    return b2[:, 0] if flat else b2


def _prior_mean_np(prior, x: np.ndarray) -> np.ndarray:
    """A prior's mean in float64 NumPy."""
    name = type(prior).__name__
    if name == "ZeroPrior":
        return np.zeros(x.shape[0])
    if name == "ConstantPrior":
        return np.full(x.shape[0], float(prior.c))
    if name == "LinearPrior":
        return x @ to_f64(prior.weights) + float(prior.intercept)
    raise ConfigError(f"native backend does not support prior {name!r}")


class NativeGP:
    """Minimal CPU GP on the native library: train + predict, the
    reference's core flow (``GaussianProcess::new`` +
    ``predict_mean_variance``) in float64."""

    def __init__(self, kernel, prior, noise: float, x, y,
                 eps: Optional[float] = None):
        self.kernel = kernel
        self.prior = prior
        self.noise = float(noise)
        self.x = to_f64(x)
        _check_2d("x", self.x)
        prior_mean = _prior_mean_np(prior, self.x)
        self.resid = np.ascontiguousarray(to_f64(y) - prior_mean)
        k = train_cov(kernel, self.x, self.noise)
        self.l_mat = cholesky(k, eps)

    def predict_mean_variance(self, xq) -> tuple[np.ndarray, np.ndarray]:
        xq = to_f64(xq)
        _check_2d("xq", xq)
        op, kid, p, _, _ = _composite_spec(self.kernel)
        n, d = self.x.shape
        if xq.shape[1] != d:
            raise ConfigError(
                f"query dim {xq.shape[1]} != training dim {d}"
            )
        m = xq.shape[0]
        if op == 0:
            # fused single-kernel C path
            lib = load()
            work = np.empty((n, m), dtype=np.float64)
            mean = np.empty((m,), dtype=np.float64)
            var = np.empty((m,), dtype=np.float64)
            lib.gp_predict_mean_var(
                kid, p, self.x, n, d, self.l_mat, self.resid, xq, m, work,
                mean, var,
            )
        else:
            # composed path for Sum/Prod kernels
            c = cov_matrix(self.kernel, self.x, xq)
            kl = solve_lower(self.l_mat, c)
            # diagonal k(q, q) per row — O(m), not an (m, m) matrix
            base = np.array(
                [cov_matrix(self.kernel, q[None, :], q[None, :])[0, 0]
                 for q in xq]
            ) if m <= 512 else np.concatenate([
                np.diagonal(cov_matrix(self.kernel, xq[i : i + 512],
                                       xq[i : i + 512])).copy()
                for i in range(0, m, 512)
            ])
            var = base - np.sum(kl * kl, axis=0)
            w = solve_lower(self.l_mat, kl, trans=True)
            mean = w.T @ self.resid
        mean += _prior_mean_np(self.prior, xq)
        return mean, var

    def predict(self, xq) -> np.ndarray:
        return self.predict_mean_variance(xq)[0]

    def predict_variance(self, xq) -> np.ndarray:
        return self.predict_mean_variance(xq)[1]
