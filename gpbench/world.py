"""A cell on W > 1 cards: one process, one rank, per card.

The process that the command started is rank 0. It starts ranks 1 .. W-1
as ``python -m gpbench.world <job>`` from the root of the checkout, rank r
on ``cuda:r``, with torchrun's environment (``RANK``, ``LOCAL_RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``). Every rank creates the
default process group before set-up, as a user's script under torchrun
would (NCCL on the cards, gloo on the CPU), and runs the same job: a
function named by the job, which calls ``harness.execute`` (or a sweep's
windows) on every rank. The program joins that group through its own
``parallel/multihost.initialize()``, which keeps a group that exists, and
leaves it to the benchmark.

Only rank 0 prints a result. The other ranks' standard output goes to
standard error, where their own log lines begin with ``rank <r>:``.

Failure is bounded:

- every collective waits at most :func:`timeout_s`: the window, the mix's
  own timeout and :data:`SLACK_S` for set-up (a first run builds the
  kernels) and the check;
- rank 0 watches the others: one that exits with an error ends the run
  (its traceback is on standard error), and rank 0 stops the rest;
- rank 0 stops every other rank on every exit: those left after the job
  get ``SIGUSR1`` (each then writes every thread's stack to a file of its
  own, which rank 0 prints once all are stopped, so a rank that hangs shows
  where), then ``SIGKILL``, and rank 0 waits for each;
- a rank whose parent (rank 0) is gone ends itself, its stacks on
  standard error.

On NCCL a collective's timeout makes NCCL's watchdog take down every rank
that waits in it, rank 0 among them (exit 134, about a minute after the
timeout, once its debug dump is done); a rank that hangs outside it then
ends itself as above.
"""

from __future__ import annotations

import datetime
import faulthandler
import importlib
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from . import harness

#: Seconds that a collective may wait beyond the window and the mix's own
#: timeout: set-up, where a checkout's first run builds the kernel library
#: (33–78 s in the one-card cells' first runs), a multi-card model's build
#: and the check's sharded reference (n^3 / 3 over the cards: ~10–20 s at
#: n = 200,000 on four).
SLACK_S = 600.0
#: Seconds between two looks at the other ranks, or at the parent.
POLL_S = 0.5
#: Seconds that the other ranks get to end by themselves once the job is
#: done, before they are stopped.
GRACE_S = 30.0
#: Exit code of rank 0 when another rank failed.
RANK_FAILED = 5


def timeout_s(cell: harness.Cell, seconds: float) -> float:
    return float(seconds) + float(cell.traffic.get("timeout_s", 0)) + SLACK_S


def rank_device(device: str, rank: int) -> str:
    return f"cuda:{rank}" if device == "cuda" else device


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def join(rank: int, size: int, device: str, timeout: float) -> None:
    """Create the default process group from torchrun's environment."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method="env://",
                            rank=rank, world_size=size,
                            timeout=datetime.timedelta(seconds=timeout),
                            device_id=dev if dev.type == "cuda" else None)


def leave() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def entry(job: dict):
    module, name = job["entry"].split(":")
    return getattr(importlib.import_module(module), name)


class Ranks:
    """Rank 0's handle on ranks 1 .. size-1, started on ``job``."""

    def __init__(self, job: dict, size: int, log):
        self.log = log
        self.lock = threading.Lock()
        self.done = False
        self.stacks = tempfile.mkdtemp(prefix="gpbench-stacks-")
        job = dict(job, stacks=self.stacks)
        env = dict(os.environ, WORLD_SIZE=str(size))
        self.procs = []
        for rank in range(1, size):
            self.procs.append(subprocess.Popen(
                [sys.executable, "-m", "gpbench.world", json.dumps(job)], cwd=job["root"],
                env=dict(env, RANK=str(rank), LOCAL_RANK=str(rank)), stdin=subprocess.DEVNULL,
                stdout=sys.__stderr__.fileno(), start_new_session=True))
        log(f"gpbench: ranks 1-{size - 1}: pids {' '.join(str(p.pid) for p in self.procs)}")
        threading.Thread(target=self.watch, daemon=True).start()

    def watch(self) -> None:
        """Ends the run where another rank exits with an error."""
        while True:
            with self.lock:
                if self.done:
                    return
                failed = [(r, p.returncode) for r, p in enumerate(self.procs, 1)
                          if p.poll() not in (None, 0)]
                if failed:
                    self.log("gpbench: " + ", ".join(f"rank {r} exited with {code}"
                                                       for r, code in failed))
                    self.stop_locked()
                    sys.stderr.flush()
                    os._exit(RANK_FAILED)
            time.sleep(POLL_S)

    def stop_locked(self) -> None:
        """Each rank still running writes its threads' stacks, then every
        rank is killed with whatever it started, then the stacks printed."""
        alive = [r for r, p in enumerate(self.procs, 1) if p.poll() is None]
        for r in alive:
            send_signal(self.procs[r - 1].pid, signal.SIGUSR1, group=False)
        if alive:
            time.sleep(1.0)
        for p in self.procs:
            send_signal(p.pid, signal.SIGKILL)
        for p in self.procs:
            p.wait()
        for r in alive:
            path = os.path.join(self.stacks, f"{r}.stack")
            if os.path.exists(path) and os.path.getsize(path):
                with open(path) as f:
                    self.log(f"gpbench: rank {r} when stopped:\n{f.read()}")
        shutil.rmtree(self.stacks, ignore_errors=True)
        self.done = True

    def close(self, clean: bool) -> None:
        """After the job: where it ended cleanly the others get ``GRACE_S``
        to end themselves; then every one still running is stopped."""
        with self.lock:
            if self.done:
                return
            deadline = time.monotonic() + (GRACE_S if clean else 0.0)
            while time.monotonic() < deadline and any(p.poll() is None for p in self.procs):
                time.sleep(0.05)
            self.stop_locked()


def send_signal(pid: int, sig: int, group: bool = True) -> None:
    """``sig`` to the rank ``pid`` (with ``group``: and to whatever it
    started), where it is still there."""
    try:
        (os.killpg if group else os.kill)(pid, sig)
    except ProcessLookupError:
        pass


def launch(job: dict, size: int, log):
    """Rank 0 of a world of ``size`` on ``job``: starts the other ranks,
    joins the group and yields what the job's function yields on rank 0.
    The other ranks are stopped on every exit."""
    port = free_port()
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK="0", LOCAL_RANK="0",
                      WORLD_SIZE=str(size))
    ranks = Ranks(job, size, log)
    clean = False
    try:
        device = rank_device(job["device"], 0)
        join(0, size, device, job["timeout_s"])
        yield from entry(job)(job, 0, size, device, log)
        clean = True
    finally:
        if clean:
            leave()
        ranks.close(clean)


def watch_parent(parent: int, rank: int) -> None:
    """Ends this rank, its threads' stacks on standard error, once rank 0
    is gone (on NCCL a collective's timeout aborts the ranks that wait in
    it, rank 0 among them, but not one that hangs outside it)."""
    while os.getppid() == parent:
        time.sleep(POLL_S)
    try:  # standard error may be gone with rank 0
        print(f"rank {rank}: rank 0 is gone; this rank's stacks:", file=sys.stderr, flush=True)
        faulthandler.dump_traceback(all_threads=True)
    finally:
        os._exit(1)


def main(argv=None) -> int:
    """A rank other than 0, started by :func:`launch`."""
    job = json.loads((sys.argv[1:] if argv is None else argv)[0])
    rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    stacks = open(os.path.join(job["stacks"], f"{rank}.stack"), "w")  # noqa: SIM115 — for life
    faulthandler.register(signal.SIGUSR1, file=stacks, all_threads=True)
    threading.Thread(target=watch_parent, args=(os.getppid(), rank), daemon=True).start()

    def log(line: str) -> None:
        print(f"rank {rank}: {line}", file=sys.stderr, flush=True)

    try:
        device = rank_device(job["device"], rank)
        join(rank, size, device, job["timeout_s"])
        for _ in entry(job)(job, rank, size, device, log):
            pass
        leave()
    except BaseException:  # noqa: BLE001 — reported, then the rank ends
        print(f"rank {rank}:\n{traceback.format_exc()}", file=sys.stderr, flush=True)
        os._exit(1)
    return 0


def execute_seeds(job: dict, rank: int, size: int, device: str, log):
    """The job of ``gpbench.run`` and ``gpbench.control``: ``harness.execute``
    on each of the job's seeds; yields ``(seed, result, forbidden)`` on rank
    0, where ``forbidden`` lists each rank's forbidden modules after the
    run. A fault the job names is planted on every rank first."""
    cell = harness.Cell(job["workload"], Path(job["root"]))
    if job.get("fault"):
        from . import faults

        faults.plant(job["fault"], cell, faults.Patch)
    controls = set(job.get("control_seeds", ()))
    started = job.get("started") if rank == 0 else None
    for seed in job["seeds"]:
        result = harness.execute(cell, seed, job["seconds"], job["traced"], device,
                                 started or time.perf_counter(), log,
                                 readings=job.get("readings", False), control=seed in controls,
                                 rank=rank, world=size)
        started = None
        found = harness.gather(harness.forbidden_modules(), rank, size)
        yield seed, result, found


def run_job(cell: harness.Cell, seeds: list, seconds: float, traced: bool, device: str,
            started: float | None = None, **extra) -> dict:
    """The job of :func:`execute_seeds` for ``cell``."""
    return {"entry": "gpbench.world:execute_seeds", "root": str(cell.root),
            "workload": cell.name, "seeds": [int(s) for s in seeds], "seconds": float(seconds),
            "traced": bool(traced), "device": device, "started": started,
            "timeout_s": timeout_s(cell, seconds), **extra}


if __name__ == "__main__":
    sys.exit(main())
