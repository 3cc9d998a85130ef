"""Polymorphic input/output conversion (L0 adapter).

Counterpart of ``friedrich_tpu/conversion.py`` and of the reference's
``Input`` trait (``conversion/mod.rs:23-52``):

- ``[f, f, ...]`` (flat list/tuple of floats) = ONE sample -> scalar output;
- ``[[...], [...]]`` (nested list) = many samples -> list output;
- 2-D ``numpy.ndarray`` -> 1-D ``numpy.ndarray`` output;
- 2-D ``torch.Tensor`` -> 1-D ``torch.Tensor`` output.

Everything is normalized to a tensor of shape ``(n, d)`` on the model's
device; outputs are converted back with :meth:`OutputAdapter.vector`.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .config import default_dtype, resolve_device
from .utils.errors import ShapeError


@dataclasses.dataclass(frozen=True)
class OutputAdapter:
    """Remembers the input container type so outputs can mirror it.

    ``kind`` is one of ``"scalar"`` (single flat-list sample), ``"list"``,
    ``"numpy"``, ``"torch"``.
    """

    kind: str

    def vector(self, v: torch.Tensor) -> Any:
        """Convert a length-m vector to the caller's preferred type."""
        if self.kind == "scalar":
            return float(v[0])
        if self.kind == "list":
            return [float(x) for x in v.tolist()]
        if self.kind == "numpy":
            return v.detach().cpu().numpy()
        return v

    def pair(self, a: torch.Tensor, b: torch.Tensor) -> tuple[Any, Any]:
        return self.vector(a), self.vector(b)


def as_input_matrix(x: Any, dtype=None, device=None) -> tuple[torch.Tensor, OutputAdapter]:
    """Normalize ``x`` to a ``(n, d)`` tensor + an output adapter."""
    dtype = dtype or default_dtype()
    device = resolve_device(device)
    if isinstance(x, (list, tuple)):
        if len(x) == 0:
            raise ShapeError("empty input")
        if isinstance(x[0], (list, tuple, np.ndarray, torch.Tensor)):
            rows = [r.detach().cpu().numpy() if isinstance(r, torch.Tensor) else r
                    for r in x]
            mat = np.asarray(rows, dtype=np.float64)
            if mat.ndim != 2:
                raise ShapeError(
                    f"nested input must be a list of 1-D rows, got overall "
                    f"shape {mat.shape}"
                )
            return torch.as_tensor(mat, dtype=dtype, device=device), OutputAdapter("list")
        # flat list of floats = a single sample (reference Vec<f64> impl)
        mat = np.asarray(x, dtype=np.float64)[None, :]
        if mat.ndim != 2:
            raise ShapeError(f"flat input must be 1-D, got shape {mat.shape[1:]}")
        return torch.as_tensor(mat, dtype=dtype, device=device), OutputAdapter("scalar")
    if isinstance(x, np.ndarray):
        if x.ndim == 1:
            return torch.as_tensor(x[None, :], dtype=dtype, device=device), OutputAdapter("scalar")
        if x.ndim != 2:
            raise ShapeError(f"expected 1-D or 2-D input, got ndim={x.ndim}")
        return torch.as_tensor(x, dtype=dtype, device=device), OutputAdapter("numpy")
    if isinstance(x, torch.Tensor):
        if x.ndim == 1:
            return x[None, :].to(dtype=dtype, device=device), OutputAdapter("scalar")
        if x.ndim != 2:
            raise ShapeError(f"expected 1-D or 2-D input, got ndim={x.ndim}")
        return x.to(dtype=dtype, device=device), OutputAdapter("torch")
    raise ShapeError(f"unsupported input type: {type(x)!r}")


def as_output_vector(y: Any, dtype=None, device=None) -> torch.Tensor:
    """Normalize training outputs to a 1-D tensor."""
    dtype = dtype or default_dtype()
    device = resolve_device(device)
    if isinstance(y, torch.Tensor):
        arr = y.to(dtype=dtype, device=device)
    else:
        arr = torch.as_tensor(np.asarray(y, dtype=np.float64), dtype=dtype, device=device)
    if arr.ndim == 2 and arr.shape[1] == 1:
        arr = arr[:, 0]
    if arr.ndim != 1:
        raise ShapeError(f"expected 1-D outputs, got shape {tuple(arr.shape)}")
    return arr
