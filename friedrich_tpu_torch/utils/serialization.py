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
``dtype`` (numpy's name, e.g. ``"float32"``).
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..config import resolve_device
from ..utils.errors import not_ported

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
        "storage": None,
        "block": list(state.block) if isinstance(state.block, tuple) else state.block,
        "precision": None,
        "n": int(state.n),
        "dtype": str(state.x.dtype).removeprefix("torch."),
    }
    np.savez(
        _npz_path(path),
        header=np.frombuffer(json.dumps(header).encode(), dtype=np.uint8),
        x=state.x.cpu().numpy(),
        resid=state.resid.cpu().numpy(),
        l=state.l.cpu().numpy(),
        noise=state.noise.cpu().numpy(),
    )


def load_gp(path):
    """A :class:`~..models.api.GaussianProcess` from a file written by
    :func:`save_gp` or by the JAX package, on the default device
    (:func:`~..config.resolve_device`). A bf16-stored factor, a factor
    precision or a tiled/hybrid backend raises: none is ported."""
    from ..interop import kernel_from_spec, prior_from_spec
    from ..models.api import GaussianProcess
    from ..models.gp import GPState, check_backend

    with np.load(_npz_path(path)) as data:
        header = json.loads(bytes(data["header"]).decode())
        if header.get("precision") is not None:
            raise not_ported(f"factor precision {header['precision']!r}")
        backend = header.get("backend", "dense")
        check_backend(backend, header.get("storage"))
        dtype = _DTYPES[header["dtype"]]
        device = resolve_device()

        def t(name):
            return torch.as_tensor(data[name], dtype=dtype, device=device)

        block = header.get("block")
        state = GPState(
            x=t("x"), resid=t("resid"), l=t("l"), n=int(header["n"]), noise=t("noise"),
            kernel=kernel_from_spec(header["kernel"]).to(dtype, device),
            prior=prior_from_spec(header["prior"]).to(dtype, device),
            eps=header["eps"], method=header["method"], backend=backend,
            block=tuple(block) if isinstance(block, list) else block,
        )
    return GaussianProcess(state)
