"""Kernels — the model vocabulary (reference ``src/parameters/kernel.rs``).

Nine concrete kernels plus ``+``/``*`` composition, mirroring
``friedrich_tpu/kernels/__init__.py``.
"""

from .base import KernelBase, KernelProd, KernelSum
from .dot import HyperTan, Linear, Polynomial
from .heuristics import fit_amplitude_var, fit_bandwidth_mean
from .stationary import (
    Exponential,
    Gaussian,
    Matern1,
    Matern2,
    Multiquadric,
    RationalQuadratic,
    SquaredExp,
)

#: Registry for specs: class name -> class.
KERNEL_REGISTRY = {
    cls.__name__: cls
    for cls in (
        Linear,
        Polynomial,
        SquaredExp,
        Exponential,
        Matern1,
        Matern2,
        HyperTan,
        Multiquadric,
        RationalQuadratic,
        KernelSum,
        KernelProd,
    )
}
KERNEL_REGISTRY["Gaussian"] = SquaredExp

__all__ = [
    "KernelBase",
    "KernelSum",
    "KernelProd",
    "Linear",
    "Polynomial",
    "SquaredExp",
    "Gaussian",
    "Exponential",
    "Matern1",
    "Matern2",
    "HyperTan",
    "Multiquadric",
    "RationalQuadratic",
    "KERNEL_REGISTRY",
    "fit_bandwidth_mean",
    "fit_amplitude_var",
]
