"""Models carried across from the JAX package.

A JAX ``GPState`` exported as numpy arrays (``x``, ``resid``, ``l``, ``n``,
``noise``) plus the kernel and prior spec dicts of
``friedrich_tpu/utils/serialization.py`` (``{"class": ..., "params": ...}``
trees) becomes a port :class:`GPState`, and back. The spec reader is this
package's own copy: the port imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from .config import resolve_device
from .kernels import KERNEL_REGISTRY
from .kernels.base import KernelProd, KernelSum
from .models.gp import GPState
from .priors import PRIOR_REGISTRY
from .utils.errors import ConfigError
from .utils.serialization import factor_from_numpy, factor_to_numpy


def kernel_from_spec(spec: dict):
    """Kernel tree from its spec dict."""
    cls = KERNEL_REGISTRY.get(spec["class"])
    if cls is None:
        raise ConfigError(f"unknown kernel class {spec['class']!r}")
    if spec["class"] in ("KernelSum", "KernelProd"):
        return cls(k1=kernel_from_spec(spec["k1"]), k2=kernel_from_spec(spec["k2"]))
    return cls(**spec["params"])


def kernel_spec(kernel) -> dict:
    """Spec dict of a kernel tree (inverse of :func:`kernel_from_spec`)."""
    name = type(kernel).__name__
    if isinstance(kernel, (KernelSum, KernelProd)):
        return {"class": name, "k1": kernel_spec(kernel.k1), "k2": kernel_spec(kernel.k2)}
    return {
        "class": name,
        "params": {f: float(getattr(kernel, f)) for f in kernel.PARAM_FIELDS},
    }


def prior_from_spec(spec: dict):
    """Prior from its spec dict."""
    cls = PRIOR_REGISTRY.get(spec["class"])
    if cls is None:
        raise ConfigError(f"unknown prior class {spec['class']!r}")
    if spec["class"] == "ConstantPrior":
        return cls(c=spec["c"])
    if spec["class"] == "LinearPrior":
        return cls(
            weights=torch.as_tensor(spec["weights"], dtype=torch.float64),
            intercept=spec["intercept"],
        )
    return cls()


def prior_spec(prior) -> dict:
    """Spec dict of a prior (inverse of :func:`prior_from_spec`)."""
    name = type(prior).__name__
    spec: dict[str, Any] = {"class": name}
    if name == "ConstantPrior":
        spec["c"] = float(prior.c)
    elif name == "LinearPrior":
        spec["intercept"] = float(prior.intercept)
        spec["weights"] = torch.as_tensor(prior.weights).cpu().tolist()
    return spec


def _storage_of(l_np: np.ndarray, storage: Optional[str]) -> Optional[str]:
    # a numpy bfloat16 array (the JAX package's) names its storage itself
    return "bf16" if storage == "bf16" or l_np.dtype.name == "bfloat16" else storage


def state_from_arrays(arrays: dict, kernel_spec: dict, prior_spec: dict,
                      eps: Optional[float] = None, method: str = "gram",
                      device=None, backend: str = "dense", block=None,
                      storage: Optional[str] = None,
                      precision: Optional[str] = None) -> GPState:
    """A port state from the JAX state's arrays (numpy ``x``, ``resid``,
    ``l``, ``n``, ``noise``), its kernel and prior specs, and its static
    fields (``eps``, ``method``, ``backend``, ``block``, ``storage``,
    ``precision``). The dtype is that of ``arrays["x"]``. A bf16-stored
    factor (a numpy bfloat16 array, or its ``uint16`` bits with
    ``storage="bf16"``) is read through a 16-bit view."""
    device = resolve_device(device)
    x = torch.as_tensor(np.asarray(arrays["x"]), device=device)
    dtype = x.dtype

    def t(name):
        return torch.as_tensor(np.asarray(arrays[name]), dtype=dtype, device=device)

    l_np = np.asarray(arrays["l"])
    storage = _storage_of(l_np, storage)
    return GPState(
        x=x, resid=t("resid"), l=factor_from_numpy(l_np, storage, dtype, device),
        n=int(arrays["n"]), noise=t("noise"),
        kernel=kernel_from_spec(kernel_spec).to(dtype, device),
        prior=prior_from_spec(prior_spec).to(dtype, device),
        eps=eps, method=method, backend=backend, block=block, storage=storage,
        precision=precision,
    )


def state_to_arrays(state: GPState) -> tuple[dict, dict, dict, dict]:
    """Inverse of :func:`state_from_arrays`: ``(arrays, kernel_spec,
    prior_spec, static)``, ``static`` the keyword arguments ``eps``,
    ``method``, ``backend``, ``block``, ``storage`` and ``precision``; a
    bf16-stored factor as its ``uint16`` bits."""
    arrays = {
        "x": state.x.cpu().numpy(),
        "resid": state.resid.cpu().numpy(),
        "l": factor_to_numpy(state.l),
        "n": np.asarray(state.n, dtype=np.int32),
        "noise": state.noise.cpu().numpy(),
    }
    static = {"eps": state.eps, "method": state.method, "backend": state.backend,
              "block": state.block, "storage": state.storage, "precision": state.precision}
    return arrays, kernel_spec(state.kernel), prior_spec(state.prior), static


def outofcore_from_arrays(arrays: dict, kernel_spec: dict, prior_spec: dict,
                          eps: Optional[float] = None, block: int = 4096,
                          method: str = "gram", storage: Optional[str] = None,
                          device=None):
    """A port :class:`~.models.outofcore_gp.OutOfCoreGP` carrying a JAX
    ``OutOfCoreGP``'s state without refactoring: numpy ``x`` and ``resid``
    (padded), ``n``, ``noise`` and the host factor ``l_host`` (float32, or
    bfloat16 as a numpy bfloat16 array or its ``uint16`` bits with
    ``storage="bf16"``), its kernel and prior specs and its static fields."""
    from .models.outofcore_gp import OutOfCoreGP
    from .ops.outofcore import host_factor

    device = resolve_device(device)
    l_np = np.asarray(arrays["l_host"])
    storage = _storage_of(l_np, storage)
    l_src = factor_from_numpy(l_np, storage, torch.float32, "cpu")
    # a host factor of the port's own (page-locked for the card), not a view
    # of the caller's arrays, which refactorizations would overwrite
    l_host = host_factor(l_src.shape[0], l_src.dtype, pinned=device.type == "cuda").copy_(l_src)
    return OutOfCoreGP.from_factor(
        kernel_from_spec(kernel_spec), prior_from_spec(prior_spec), float(np.asarray(arrays["noise"])),
        np.asarray(arrays["x"]), np.asarray(arrays["resid"]), int(arrays["n"]), l_host, eps=eps,
        block=block, method=method, storage=storage, device=device,
    )


def large_scale_from_arrays(mesh, arrays: dict, kernel_spec: dict, prior_spec: dict,
                            eps: Optional[float] = None, block: Optional[int] = None,
                            method: str = "gram", storage: Optional[str] = None):
    """This rank's :class:`~.parallel.large_scale.LargeScaleGP` carrying a
    JAX ``LargeScaleGP``'s state without refactoring: numpy ``x`` and
    ``resid`` (padded to a capacity that is a multiple of the mesh's size),
    ``n``, ``noise`` and the gathered factor ``l`` (cap, cap) (float, or
    bfloat16 as a numpy bfloat16 array or its ``uint16`` bits with
    ``storage="bf16"``), of which the rank keeps its row block; its kernel
    and prior specs and its static fields."""
    from .parallel.large_scale import LargeScaleGP

    x = torch.as_tensor(np.asarray(arrays["x"]), device=mesh.device)
    l_np = np.asarray(arrays["l"])
    storage = _storage_of(l_np, storage)
    r0, r1 = mesh.rows(x.shape[0])
    l_local = factor_from_numpy(l_np[r0:r1], storage, x.dtype, mesh.device)
    return LargeScaleGP.from_factor(
        mesh, kernel_from_spec(kernel_spec), prior_from_spec(prior_spec),
        float(np.asarray(arrays["noise"])), x, np.asarray(arrays["resid"]), int(arrays["n"]),
        l_local, eps=eps, block=block, method=method, storage=storage,
    )
