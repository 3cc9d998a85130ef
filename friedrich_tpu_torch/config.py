"""Global configuration: defaults, dtype policy, device selection.

Counterpart of ``friedrich_tpu/config.py``. The reference is f64-only
(nalgebra ``DMatrix<f64>``); here the dtype is a knob:

- parity paths enable x64 and run in float64;
- performance paths default to float32.

The port runs on ``torch.device("cuda")`` unless the caller asks for the
CPU, with :func:`set_device` or a ``device=`` argument on the facade and
builder. Without CUDA, a call that did not ask for the CPU raises: the port
never carries on silently on the host.
"""

from __future__ import annotations

import contextlib

import torch

from .utils.errors import ConfigError

#: Default number of ADAM iterations for hyperparameter fitting
#: (reference ``builder.rs:76``).
DEFAULT_MAX_ITER = 100

#: Default convergence fraction for the multiplicative ADAM stop rule
#: (reference ``builder.rs:77``).
DEFAULT_CONVERGENCE_FRACTION = 0.05

#: Default wall-clock limit for fitting, seconds (reference ``builder.rs:78``:
#: one hour).
DEFAULT_MAX_TIME = 3600.0

#: Capacity growth factor for incremental training buffers (reference
#: ``extendable_matrix.rs:38,86``: 1.5x amortized growth).
GROWTH_FACTOR = 1.5

_x64 = False
_device: str | None = None


def enable_x64() -> None:
    """Make float64 the default dtype (needed for 1e-6 parity with the
    reference)."""
    global _x64
    _x64 = True


def default_dtype() -> torch.dtype:
    """float64 under x64, float32 otherwise."""
    return torch.float64 if _x64 else torch.float32


def set_device(device: str | torch.device | None) -> None:
    """Pin the default device (``"cpu"``, ``"cuda"``, ``"cuda:1"``);
    ``None`` restores the default, CUDA."""
    global _device
    _device = None if device is None else str(torch.device(device))


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device a new model lives on: ``device`` when given, else the
    one pinned by :func:`set_device`, else CUDA. Raises
    :class:`ConfigError` when that is a CUDA device and CUDA is absent."""
    dev = torch.device(device if device is not None else (_device or "cuda"))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise ConfigError(
            "friedrich_tpu_torch runs on CUDA by default and no CUDA device "
            "is available; call friedrich_tpu_torch.config.set_device('cpu') "
            "or pass device='cpu' to run on the CPU"
        )
    return dev


#: Share of the card's memory that two (cap, cap) matrices may take: the
#: dense backend's K and L, or an append's old and new factor. Past it,
#: ``backend="auto"`` picks the streamed backend and ``add_samples``
#: appends in place (the JAX package's append rule,
#: ``friedrich_tpu/models/api.py:56-64``).
TWO_MATRIX_FRACTION = 0.85


def device_memory_bytes(device: str | torch.device | None = None) -> int | None:
    """Total memory of a CUDA device in bytes (``device`` defaults to the
    one :func:`resolve_device` gives); None for a CPU device. Counterpart
    of ``friedrich_tpu/config.py:device_hbm_bytes``."""
    dev = torch.device(device) if device is not None else resolve_device()
    if dev.type != "cuda":
        return None
    return torch.cuda.get_device_properties(dev).total_memory


def two_matrices_fit(cap: int, itemsize: int, device) -> bool:
    """Whether two (cap, cap) matrices of ``itemsize``-byte entries fit
    within :data:`TWO_MATRIX_FRACTION` of the device's memory (always true
    on the CPU)."""
    mem = device_memory_bytes(device)
    return mem is None or 2 * cap * cap * itemsize <= TWO_MATRIX_FRACTION * mem


#: The JAX package's matmul precision mode names, mapped to torch's
#: float32 matmul precision (``torch.set_float32_matmul_precision``):
#: "medium" lets float32 matmuls run in bfloat16 and "highest" (torch's
#: default) keeps full float32. "f32x3", the JAX package's compensated
#: three-pass bfloat16 mode, is close to full float32; torch's "high" would
#: be TF32 (10 mantissa bits), less precise, so it maps to "highest".
MATMUL_PRECISION_MODES = {
    "bf16": "medium",
    "f32x3": "highest",
    "f32": "highest",
}


@contextlib.contextmanager
def matmul_precision(mode: str):
    """Context manager pinning the precision of every float32 matmul run
    inside the scope; the previous setting is restored on exit."""
    if mode not in MATMUL_PRECISION_MODES:
        raise ValueError(
            f"mode must be one of {sorted(MATMUL_PRECISION_MODES)}, "
            f"got {mode!r}"
        )
    previous = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(MATMUL_PRECISION_MODES[mode])
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(previous)
