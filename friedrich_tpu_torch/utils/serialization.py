"""Model persistence: save/load of the full trained GP state.

Counterpart of ``friedrich_tpu/utils/serialization.py:74-140`` and of the
reference's serde feature (``Cargo.toml:18-20``). The WHOLE state
round-trips — training inputs, residuals, the Cholesky factor,
hyperparameters, noise, epsilon — so a loaded model gives bit-identical
predictions without refactorizing.

The format is the JAX package's, so that a model saved by either package
loads in the other: one ``.npz`` holding ``header`` (JSON as ``uint8``),
``x``, ``resid``, ``l`` and ``noise``. The header carries ``version``,
``kernel`` and ``prior`` (the spec dicts of :mod:`..interop`), ``eps``,
``method``, ``backend``, ``storage``, ``block``, ``precision``, ``n`` and
``dtype`` (numpy's name, e.g. ``"float32"``). A bf16-stored factor is written
as its raw bits, ``uint16``, since ``.npz`` has no bfloat16.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..config import resolve_device

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def _npz_path(path) -> str:
    # np.savez appends .npz when missing but np.load does not: normalize so
    # that save/load round-trips for extensionless paths
    path = str(path)
    return path if path.endswith(".npz") else f"{path}.npz"


def save_gp(gp, path) -> None:
    """Write ``gp``'s state to ``path`` (``.npz`` added when missing)."""
    from ..interop import kernel_spec, prior_spec

    state = gp.state
    header = {
        "version": 1,
        "kernel": kernel_spec(state.kernel),
        "prior": prior_spec(state.prior),
        "eps": state.eps,
        "method": state.method,
        "backend": state.backend,
        "storage": state.storage,
        "block": list(state.block) if isinstance(state.block, tuple) else state.block,
        "precision": state.precision,
        "n": int(state.n),
        "dtype": str(state.x.dtype).removeprefix("torch."),
    }
    np.savez(
        _npz_path(path),
        header=np.frombuffer(json.dumps(header).encode(), dtype=np.uint8),
        x=state.x.cpu().numpy(),
        resid=state.resid.cpu().numpy(),
        l=factor_to_numpy(state.l),
        noise=state.noise.cpu().numpy(),
    )


def factor_to_numpy(l_mat: torch.Tensor) -> np.ndarray:
    """A factor as numpy: a bfloat16 one as its raw bits, ``uint16``."""
    if l_mat.dtype == torch.bfloat16:
        return l_mat.cpu().view(torch.int16).numpy().view(np.uint16)
    return l_mat.cpu().numpy()


def factor_from_numpy(l_np: np.ndarray, storage, dtype: torch.dtype, device) -> torch.Tensor:
    """Inverse of :func:`factor_to_numpy`: with ``storage="bf16"`` the
    array's 16-bit patterns (``uint16``, or a numpy bfloat16 array, read
    through a view) become a bfloat16 tensor; otherwise ``dtype``."""
    if storage == "bf16":
        bits = np.ascontiguousarray(l_np).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.as_tensor(l_np, dtype=dtype, device=device)


def load_gp(path):
    """A :class:`~..models.api.GaussianProcess` from a file written by
    :func:`save_gp` or by the JAX package, on the default device
    (:func:`~..config.resolve_device`). A tiled/hybrid backend raises: it is
    not ported."""
    from ..interop import kernel_from_spec, prior_from_spec
    from ..models.api import GaussianProcess
    from ..models.gp import GPState, check_backend

    with np.load(_npz_path(path)) as data:
        header = json.loads(bytes(data["header"]).decode())
        backend = header.get("backend", "dense")
        storage = header.get("storage")
        check_backend(backend, storage)
        dtype = _DTYPES[header["dtype"]]
        device = resolve_device()

        def t(name):
            return torch.as_tensor(data[name], dtype=dtype, device=device)

        block = header.get("block")
        state = GPState(
            x=t("x"), resid=t("resid"), l=factor_from_numpy(data["l"], storage, dtype, device),
            n=int(header["n"]), noise=t("noise"),
            kernel=kernel_from_spec(header["kernel"]).to(dtype, device),
            prior=prior_from_spec(header["prior"]).to(dtype, device),
            eps=header["eps"], method=header["method"], backend=backend,
            block=tuple(block) if isinstance(block, list) else block,
            storage=storage, precision=header.get("precision"),
        )
    return GaussianProcess(state)
