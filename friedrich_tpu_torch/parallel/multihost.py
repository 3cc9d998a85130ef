"""Setting up the process group of the multi-rank layer.

Counterpart of ``friedrich_tpu/parallel/multihost.py``. One process per
device: launched by ``torchrun`` (which sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``) or by hand with
explicit arguments, every process calls :func:`initialize`, then builds its
meshes with ``make_matrix_mesh()`` / ``make_chain_mesh()``.

The backend is NCCL on the card (device ``cuda:LOCAL_RANK``) and gloo when
the caller asks for the CPU; the caller may name gloo for CUDA tensors too
(``backend="gloo"``), which takes broadcast and all-reduce, the only
collectives the layer uses. Nothing switches backend on its own. Where the
environment names no world, :func:`initialize` sets up an explicit world of
one over a TCP store on 127.0.0.1; where it names one and the set-up fails,
it raises (the JAX package warns and carries on in one process).
"""

from __future__ import annotations

import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

from ..config import resolve_device
from ..utils.errors import ConfigError

_DEVICE: Optional[torch.device] = None


def free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_device() -> torch.device:
    """This process's device: the one :func:`initialize` chose."""
    if _DEVICE is None:
        raise ConfigError("call friedrich_tpu_torch.parallel.multihost.initialize() first")
    return _DEVICE


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
) -> dict:
    """Join (or create) the process group; returns the JAX package's summary
    dict (``process_index``, ``process_count``, ``local_devices``,
    ``global_devices``).

    With no arguments the world comes from the environment (``env://``:
    torchrun's variables); where ``WORLD_SIZE`` is unset, a world of one.
    ``coordinator_address`` (``host:port`` or a ``tcp://`` / ``file://``
    URL), ``num_processes`` and ``process_id`` name it explicitly.
    ``device``: this rank's device, by default ``cuda:LOCAL_RANK`` (CUDA
    unless the caller asks for the CPU, ``device="cpu"``); ``backend``:
    ``"nccl"`` for a CUDA device and ``"gloo"`` for the CPU unless named.
    A failed set-up raises. An existing group is kept (its backend and
    world), and this rank's device is set."""
    global _DEVICE
    if device is None:
        device = resolve_device(None)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    device = resolve_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl" and device.type != "cuda":
        raise ConfigError(f"the NCCL backend takes CUDA devices, got {device}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        if coordinator_address is None and num_processes is None:
            if "WORLD_SIZE" in os.environ:
                dist.init_process_group(backend, init_method="env://")
            else:
                # no world named: an explicit world of one
                dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{free_port()}",
                                        world_size=1, rank=0)
        else:
            if coordinator_address is None or num_processes is None or process_id is None:
                raise ConfigError("an explicit world takes coordinator_address, num_processes "
                                  "and process_id")
            url = coordinator_address if "://" in coordinator_address else (
                f"tcp://{coordinator_address}")
            dist.init_process_group(backend, init_method=url, world_size=int(num_processes),
                                    rank=int(process_id))
    _DEVICE = device
    world = dist.get_world_size()
    return {
        "process_index": dist.get_rank(),
        "process_count": world,
        "local_devices": 1,
        "global_devices": world,
        "backend": dist.get_backend(),
        "device": str(device),
    }


def shutdown() -> None:
    """Leave the process group (if any)."""
    global _DEVICE
    if dist.is_initialized():
        dist.destroy_process_group()
    _DEVICE = None
