"""friedrich_tpu_torch: the PyTorch / CUDA port of friedrich-tpu, an exact
Gaussian-process inference engine, for one NVIDIA H100.

The public surface mirrors ``friedrich_tpu`` (and the reference's
re-exports, ``lib.rs:39-45``): kernels, priors, the GP + builder, and the
posterior sampler. Models live on CUDA unless the CPU is asked for
(``config.set_device("cpu")`` or ``device="cpu"``); on the GPU every
covariance matrix is built by the hand-written CUDA kernel in ``csrc/``.
"""

from . import config, kernels, priors
from .config import enable_x64, matmul_precision
from .models import (
    GaussianProcess,
    GaussianProcessBuilder,
    GPState,
    MultivariateNormal,
    OutOfCoreGP,
)
from .utils.errors import CholeskyError, ConfigError, FriedrichError, ShapeError

__version__ = "0.1.0"

__all__ = [
    "config",
    "kernels",
    "priors",
    "GaussianProcess",
    "GaussianProcessBuilder",
    "GPState",
    "MultivariateNormal",
    "OutOfCoreGP",
    "CholeskyError",
    "ConfigError",
    "FriedrichError",
    "ShapeError",
    "enable_x64",
    "matmul_precision",
]
