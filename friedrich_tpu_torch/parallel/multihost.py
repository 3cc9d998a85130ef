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

:func:`joined` makes this process a rank for the length of a ``with``
block, and :func:`spawn` runs a function on a world of CPU ranks it starts
(gloo): the port's counterpart of the JAX package's virtual CPU devices.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import socket
import tempfile
import time
import traceback
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
    ``device``: this rank's device, by default, or where it is ``"cuda"``
    with no index, ``cuda:LOCAL_RANK`` (CUDA unless the caller asks for the
    CPU, ``device="cpu"``); ``backend``:
    ``"nccl"`` for a CUDA device and ``"gloo"`` for the CPU unless named.
    A failed set-up raises. An existing group is kept (its backend and
    world), and this rank's device is set."""
    global _DEVICE
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
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


#: Seconds a world started by :func:`spawn` may take before its ranks are
#: stopped and the call fails.
SPAWN_TIMEOUT_S = 900.0


@contextlib.contextmanager
def joined(device=None):
    """This process as a rank: of the process group that exists, else of
    the world the environment names, else of a world of one on ``device``
    (NCCL on the card, gloo on the CPU). Yields the matrix mesh; leaves a
    group it made on exit."""
    from .mesh import make_matrix_mesh

    made = not dist.is_initialized()
    if made:
        initialize(device=device)
    try:
        yield make_matrix_mesh()
    finally:
        if made:
            shutdown()


def spawn(world: int, fn, timeout: float = SPAWN_TIMEOUT_S, **kwargs) -> list:
    """``fn(mesh, **kwargs)`` on each rank of a world of ``world`` CPU
    processes (gloo, a file store in a temporary directory, one thread a
    rank); returns what each rank's ``fn`` returned, rank order. ``fn`` is
    a module-level function (the ranks import it). Raises ``RuntimeError``
    with the failing rank's traceback, or when the world outlasts
    ``timeout`` (its ranks are then stopped)."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        url = f"file://{tmp}/store"
        procs = [ctx.Process(target=_spawned_rank, args=(r, world, url, fn, kwargs, tmp))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        errors = [open(os.path.join(tmp, f"{r}.err")).read() for r in range(world)
                  if os.path.exists(os.path.join(tmp, f"{r}.err"))]
        if errors:
            raise RuntimeError(f"a rank of the world of {world} failed:\n" + "\n".join(errors))
        if hung:
            raise RuntimeError(f"ranks {hung} of the world of {world} outlasted {timeout} s")
        results = []
        for r, p in enumerate(procs):
            if p.exitcode != 0:
                raise RuntimeError(f"rank {r} of the world of {world} exited with {p.exitcode}")
            with open(os.path.join(tmp, f"{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results


def _spawned_rank(rank: int, world: int, url: str, fn, kwargs: dict, out_dir: str) -> None:
    from .mesh import make_matrix_mesh

    try:
        torch.set_num_threads(1)  # the ranks share the host's cores
        initialize(url, world, rank, device="cpu")
        try:
            result = fn(make_matrix_mesh(world), **kwargs)
        finally:
            shutdown()
        with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    except Exception:  # reported to the caller, then the rank ends
        with open(os.path.join(out_dir, f"{rank}.err"), "w") as f:
            f.write(f"rank {rank}:\n{traceback.format_exc()}")
        os._exit(1)
