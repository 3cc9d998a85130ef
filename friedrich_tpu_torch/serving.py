"""Serving: bundle export, the native daemon, the device-backed server and
the client.

Counterpart of ``friedrich_tpu/serving.py``, with the same bundle format and
wire protocol, so that the daemon serves a bundle of either package and
either package's client talks to either package's server. A trained model is
exported to a flat binary bundle (training inputs, prior residuals, Cholesky
factor, kernel and prior spec: the state the reference persists with serde,
``gaussian_process/mod.rs:58``), which ``native/friedrich_served`` (C++,
linked against ``libfriedrich_native.so``, both built by ``native.build``
into ``friedrich_tpu_torch/_build/``) serves on the CPU in float64 over a
length-prefixed binary TCP protocol. :class:`AcceleratedGPServer` speaks the
same protocol from a live model on the device it lives on.

Typical use::

    from friedrich_tpu_torch import serving
    serving.export_bundle(gp, "model.frsv")
    with serving.GPServer("model.frsv") as srv:
        client = serving.GPClient(port=srv.port)
        mean, var = client.predict_mean_variance(xq)

    with serving.AcceleratedGPServer(gp) as srv:   # on the model's card
        ...

A :class:`~.parallel.large_scale.LargeScaleGP` spread over the ranks of a
``torch.distributed`` world is served by rank 0, while every other rank
runs :func:`follow`::

    if mesh.rank == 0:
        with serving.AcceleratedGPServer(gp) as srv:
            ...
    else:
        serving.follow(gp)   # returns when rank 0's server closes
"""

from __future__ import annotations

import itertools
import socket
import struct
import subprocess
import threading
import time
from collections import Counter
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from . import native
from .parallel.mesh import broadcast
from .utils.errors import ConfigError, ShapeError
from .utils.profiling import record_span, recording, scope

_BUNDLE_MAGIC = b"FRSERVE1"
_REQ_MAGIC = 0x46525131
_RESP_MAGIC = 0x46525231
_FLAG_VARIANCE = 1

_PRIOR_KINDS = {"ZeroPrior": 0, "ConstantPrior": 1, "LinearPrior": 2}


def _prior_spec(prior) -> tuple[int, np.ndarray]:
    name = type(prior).__name__
    if name not in _PRIOR_KINDS:
        raise ConfigError(f"serving does not support prior {name!r}")
    if name == "ZeroPrior":
        params = np.zeros(0)
    elif name == "ConstantPrior":
        params = np.array([float(prior.c)])
    else:  # LinearPrior: [w_0..w_{d-1}, intercept]
        params = np.concatenate([native.to_f64(prior.weights).ravel(), [float(prior.intercept)]])
    return _PRIOR_KINDS[name], np.ascontiguousarray(params, dtype=np.float64)


def export_bundle(gp, path) -> None:
    """Write a serving bundle for a trained :class:`GaussianProcess` (or a
    state: anything with ``x``, ``resid``, ``l``, ``n``, ``noise``,
    ``kernel`` and ``prior``, tensors or arrays). Arrays are stored in
    float64, each value exactly (a bfloat16 factor too), sliced to the live
    row count."""
    state = getattr(gp, "state", gp)
    n = int(state.n)
    d = int(state.x.shape[1])
    x = native.to_f64(state.x[:n])
    resid = native.to_f64(state.resid[:n])
    l_mat = native.to_f64(state.l[:n, :n])
    op, kid1, p1, kid2, p2 = native._composite_spec(state.kernel)
    prior_kind, prior_params = _prior_spec(state.prior)

    def _i64(v):
        return struct.pack("<q", v)

    with open(path, "wb") as f:
        f.write(_BUNDLE_MAGIC)
        f.write(_i64(op))
        f.write(_i64(kid1) + _i64(len(p1)) + p1.astype("<f8").tobytes())
        f.write(_i64(kid2) + _i64(len(p2)) + p2.astype("<f8").tobytes())
        f.write(_i64(prior_kind) + _i64(len(prior_params)) + prior_params.astype("<f8").tobytes())
        f.write(struct.pack("<d", float(state.noise)))
        f.write(_i64(n) + _i64(d))
        f.write(x.astype("<f8").tobytes())
        f.write(resid.astype("<f8").tobytes())
        f.write(l_mat.astype("<f8").tobytes())


def build_daemon() -> Path:
    """The serving daemon built from ``native/friedrich_served.cpp`` beside
    the native library it links against (``native.build``)."""
    return native.build() / native.DAEMON_NAME


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class GPServer:
    """Runs ``friedrich_served`` on a bundle; context-manager friendly.

    The daemon is stopped by its exact PID on :meth:`close`."""

    def __init__(self, bundle_path, port: Optional[int] = None,
                 startup_timeout: float = 10.0):
        self.bundle_path = str(bundle_path)
        self.port = port or _free_port()
        binary = build_daemon()
        self._proc = subprocess.Popen(
            [str(binary), self.bundle_path, str(self.port)],
            stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL,
        )
        deadline = time.time() + startup_timeout
        while True:
            if self._proc.poll() is not None:
                raise ConfigError(
                    f"friedrich_served exited with {self._proc.returncode} "
                    f"(bad bundle or port {self.port} in use?)"
                )
            try:
                with socket.create_connection(("127.0.0.1", self.port), timeout=0.2):
                    return
            except OSError:
                if time.time() > deadline:
                    self._proc.kill()
                    self._proc.wait()
                    raise ConfigError("friedrich_served did not come up")
                time.sleep(0.05)

    def close(self) -> None:
        if self._proc.poll() is None:
            self._proc.terminate()
            try:
                self._proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                self._proc.wait()

    def __enter__(self) -> "GPServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class AcceleratedGPServer:
    """Serve a live model over the daemon's wire protocol, on the device
    the model lives on.

    Where :class:`GPServer` runs the C++ daemon (CPU, float64), this server
    keeps the trained model resident: on a card each batch is one
    ``predict_mean_variance`` (the covariance-tile kernel in cross mode and
    one triangular solve against the factor). ``model`` is anything with
    ``predict_mean_variance(xq, block=)`` taking a tensor and a ``state.x``
    (or bare ``.x``) feature tensor: :class:`GaussianProcess`,
    :class:`OutOfCoreGP` or :class:`LargeScaleGP` (row-sharded factor).

    A ``LargeScaleGP`` predicts collectively: every rank of its mesh must
    enter each sweep with the same queries. Where the JAX package's single
    controller drives every device from one process, here the server runs
    on rank 0 and every other rank runs :func:`follow`: before each sweep
    rank 0 broadcasts the chunk's row count and solve width, then its rows,
    and the followers take part in the same ``predict_mean_variance(rows,
    block=)``; closing the server broadcasts a count of 0, which ends them.
    Only rank 0's dispatcher thread sends collectives, so they stay in
    order. A request of the wrong width is refused before any broadcast. A
    world of one sends nothing. A failure after a chunk's broadcast (a
    follower that died ends the world's process group; any rank's error
    inside the sweep) is delivered to that chunk's waiters, and since the
    ranks' collectives are then out of step, every later request is
    answered with an error: the server never carries on with rank 0
    alone.

    Thread per connection, like the daemon. Concurrent requests are
    batched continuously: while the device runs one batch, arrivals queue,
    and the dispatcher merges everything queued into the next single sweep
    (a sweep reads the whole factor once, so co-batched requests share that
    read). Each batch is solved ``block`` columns at a time, the last block
    zero-padded (``models/gp.sweep_moments``), so that a reply does not
    depend on the requests it was merged with: it equals the model's
    ``predict_mean_variance(rows, block=block)`` of its own rows. The rows
    themselves are not padded: eager PyTorch compiles nothing per shape.
    A lone request pays a whole ``block``-column solve; a smaller ``block``
    makes small requests cheaper and large batches dearer (PERF.md).
    Batches are chunked above ``max_rows``; a lone request dispatches at
    once. ``dispatches`` counts the sweeps by their rows and
    ``requests_per_dispatch`` the requests each merged.

    While spans are recorded (``utils/profiling.record_spans``), each
    request gives a ``serving/request`` span on its connection's thread,
    from its header to its reply sent, and a ``serving/queue`` span, from
    its enqueue to the start of the sweep that answers it, both with its
    ``request`` id; the dispatcher gives ``serving/wait`` while nothing is
    queued, ``serving/busy`` from then until it finds the queue empty
    again (so that the host's time between two sweeps has a range), and
    inside it one ``serving/dispatch`` per chunk (``rows``, ``requests``,
    ``block`` and the request ``ids``), from taking it to the last waiter
    woken, around ``serving/merge`` (rows merged and copied to the
    device), ``serving/batch`` (the sweep queued) and ``serving/fetch``
    (the answers copied back, where the host waits for the device).
    """

    def __init__(self, model, host: str = "127.0.0.1",
                 port: Optional[int] = None, max_batch: int = 1 << 20,
                 max_rows: int = 4096, block: int = 256):
        self._model = model
        # a LargeScaleGP's ranks sweep together: rank 0 leads, the others follow()
        self._mesh = getattr(model, "mesh", None)
        if self._mesh is not None and self._mesh.rank != 0:
            raise ConfigError(f"the server runs on rank 0; rank {self._mesh.rank} runs "
                              f"serving.follow(model)")
        self._spread = self._mesh is not None and self._mesh.size > 1
        #: The error that left the ranks' collectives out of step, if any.
        self.broken: Optional[BaseException] = None
        # GaussianProcess keeps features on .state.x; OutOfCoreGP and LargeScaleGP on .x
        feats = getattr(model, "state", model).x
        self._d = int(feats.shape[1])
        self._x_dtype = feats.dtype  # the wire is float64; the model may be float32
        self._device = feats.device
        self._max_batch = max_batch
        self._max_rows = max_rows
        self.block = block
        self.dispatches: Counter = Counter()
        self.requests_per_dispatch: Counter = Counter()
        self._request_ids = itertools.count(1)
        # (xq, out_slot, event, request id, enqueue time_ns or 0 unrecorded)
        self._pending: list = []
        self._cond = threading.Condition()
        self._closing = False
        self._dispatcher = threading.Thread(target=self._dispatch_loop, daemon=True)
        self._dispatcher.start()
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((host, port or 0))
        self._lsock.listen(16)
        self.host = host
        self.port = self._lsock.getsockname()[1]
        self._accept_thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._accept_thread.start()

    # -- socket plumbing ---------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._closing:
            try:
                conn, _ = self._lsock.accept()
            except OSError:
                return  # listening socket closed
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=self._serve_conn, args=(conn,), daemon=True).start()

    @staticmethod
    def _recv_exact(conn, nbytes: int) -> Optional[bytes]:
        buf = bytearray()
        while len(buf) < nbytes:
            chunk = conn.recv(nbytes - len(buf))
            if not chunk:
                return None
            buf.extend(chunk)
        return bytes(buf)

    def _serve_conn(self, conn) -> None:
        try:
            while True:
                head = self._recv_exact(conn, 8)
                if head is None:
                    return
                request = next(self._request_ids)
                started = time.time_ns() if recording() else 0
                keep = self._answer(conn, head, request)
                if started:
                    record_span("serving/request", started, time.time_ns(), request=request)
                if not keep:
                    return
        except OSError:
            return
        finally:
            conn.close()

    def _answer(self, conn, head: bytes, request: int) -> bool:
        """Read the rest of the request whose header is ``head`` and send
        its reply; False where the connection is to be closed."""
        magic, flags = struct.unpack("<II", head)
        if magic != _REQ_MAGIC:
            return False
        dims = self._recv_exact(conn, 16)
        if dims is None:
            return False
        nq, d = struct.unpack("<QQ", dims)
        if nq == 0 or nq > self._max_batch or d != self._d:
            # drain the payload so that the connection stays usable for the
            # next request (the daemon closes instead)
            if nq <= self._max_batch:
                self._recv_exact(conn, 8 * nq * d)
            conn.sendall(struct.pack("<IIQ", _RESP_MAGIC, 1, 0))
            return nq <= self._max_batch
        data = self._recv_exact(conn, 8 * nq * d)
        if data is None:
            return False
        xq = np.frombuffer(data, dtype="<f8").reshape(nq, d)
        try:
            mean, var = self._predict(xq, request)
        except Exception:  # noqa: BLE001 — model or device error: the
            # request was well formed; a status-2 reply keeps the
            # connection usable
            conn.sendall(struct.pack("<IIQ", _RESP_MAGIC, 2, 0))
            return True
        conn.sendall(
            struct.pack("<IIQ", _RESP_MAGIC, 0, nq)
            + mean.astype("<f8").tobytes()
            + (var.astype("<f8").tobytes() if flags & _FLAG_VARIANCE else b"")
        )
        return True

    def _predict(self, xq: np.ndarray, request: int = 0) -> tuple[np.ndarray, np.ndarray]:
        """Submit to the continuous-batching dispatcher and wait."""
        out: dict = {}
        ev = threading.Event()
        with self._cond:
            if self._closing:
                # the dispatcher may already have drained and exited; an
                # enqueue now would wait forever
                raise RuntimeError("server is closing")
            self._pending.append((xq, out, ev, request, time.time_ns() if recording() else 0))
            self._cond.notify()
        # bounded waits, so that a dead dispatcher cannot hang the
        # connection's thread: if it exits while the event is unset, the
        # request fails
        while not ev.wait(timeout=1.0):
            if not self._dispatcher.is_alive() and not ev.is_set():
                raise RuntimeError("dispatcher exited before answering")
        if "error" in out:
            raise out["error"]
        return out["mean"], out["var"]

    def _dispatch_loop(self) -> None:
        """Continuous batching: everything queued runs as ONE sweep."""
        while True:
            with self._cond:
                if not self._pending and not self._closing:
                    with scope("serving/wait"):
                        while not self._pending and not self._closing:
                            self._cond.wait(timeout=0.5)
                if self._closing and not self._pending:
                    break
            with scope("serving/busy"):
                self._drain()
        if self._spread and self.broken is None:
            try:
                _send_header(self._mesh, 0, None)  # ends the followers
            except Exception as e:  # noqa: BLE001 — a follower already gone
                self.broken = e

    def _drain(self) -> None:
        """Sweep what is queued until the queue is found empty."""
        while True:
            with self._cond:
                batch, self._pending = self._pending, []
            if not batch:
                return
            # chunk oversized merges, so that one giant batch cannot starve
            # the queue
            rows = [b[0].shape[0] for b in batch]
            while batch:
                take, total = 0, 0
                while take < len(batch) and (take == 0 or total + rows[take] <= self._max_rows):
                    total += rows[take]
                    take += 1
                chunk, batch = batch[:take], batch[take:]
                rows = rows[take:]
                self._run_chunk(chunk, total)

    def _run_chunk(self, chunk, total: int) -> None:
        with scope("serving/dispatch", rows=total, requests=len(chunk), block=self.block,
                   ids=tuple(c[3] for c in chunk)) as span:
            if span is not None:
                for x, _, _, request, queued in chunk:
                    if queued:
                        record_span("serving/queue", queued, span.start_ns, request=request,
                                    rows=x.shape[0])
            self._answer_chunk(chunk, total)

    def _answer_chunk(self, chunk, total: int) -> None:
        # the WHOLE body runs under try: an exception in the merge (not
        # only in the model call) must reach the waiters, not end the
        # dispatcher thread, which would leave every later request waiting
        try:
            if self.broken is not None:
                raise RuntimeError(f"the ranks' sweeps are out of step after {self.broken!r}")
            with scope("serving/merge"):
                rows = np.concatenate([c[0] for c in chunk], axis=0)
                if rows.ndim != 2 or rows.shape[1] != self._d:
                    # refused before any broadcast: the followers never see it
                    raise ShapeError(f"queries of shape {rows.shape}, the model takes width "
                                     f"{self._d}")
                xq = torch.as_tensor(rows, dtype=self._x_dtype, device=self._device)
            try:
                if self._spread:
                    _send_header(self._mesh, total, self.block)
                    broadcast(self._mesh, xq, 0)
                with scope("serving/batch"):
                    mean, var = self._model.predict_mean_variance(xq, block=self.block)
            except Exception as e:
                if self._spread:
                    self.broken = e
                raise
            with scope("serving/fetch"):
                mean = torch.as_tensor(mean).detach().to("cpu", torch.float64).numpy()
                var = torch.as_tensor(var).detach().to("cpu", torch.float64).numpy()
            self.dispatches[total] += 1
            self.requests_per_dispatch[len(chunk)] += 1
            off = 0
            for x, out, ev, _, _ in chunk:
                k = x.shape[0]
                out["mean"] = mean[off:off + k]
                out["var"] = var[off:off + k]
                off += k
                ev.set()
        except Exception as e:  # noqa: BLE001 — delivered to every waiter
            for _, out, ev, _, _ in chunk:
                out["error"] = e
                ev.set()

    def close(self) -> None:
        self._closing = True
        try:
            # a shutdown wakes the accept loop's blocked accept() at once; a
            # close alone leaves it blocked until the join's timeout
            self._lsock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._lsock.close()
        except OSError:
            pass
        self._accept_thread.join(timeout=5)
        with self._cond:
            self._cond.notify()
        # what is queued is answered first; a spread model's followers end
        # with the dispatcher's last broadcast
        self._dispatcher.join()

    def __enter__(self) -> "AcceleratedGPServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _send_header(mesh, rows: int, block: Optional[int]) -> None:
    """Rank 0's announcement of a sweep: its row count (0: the server
    closed) and its solve width (0 for one solve of all the rows)."""
    broadcast(mesh, torch.tensor([rows, block or 0], dtype=torch.int64, device=mesh.device), 0)


def follow(model) -> int:
    """Take part in the sweeps of an :class:`AcceleratedGPServer` that
    serves ``model``, a ``LargeScaleGP``, from rank 0: on every other rank
    of the model's mesh, receive each chunk's rows and run the same
    ``predict_mean_variance(rows, block=)`` (its result is rank 0's to
    send), until the server closes. Returns the number of sweeps taken
    part in. An error inside a sweep propagates: a rank that dies of it
    ends the world's process group, which fails rank 0's sweep in turn."""
    mesh = model.mesh
    if mesh.rank == 0:
        raise ConfigError("rank 0 serves the model (AcceleratedGPServer); follow() runs on the others")
    d = model.x.shape[1]
    sweeps = 0
    while True:
        head = broadcast(mesh, torch.zeros(2, dtype=torch.int64, device=mesh.device), 0)
        rows, block = (int(v) for v in head.tolist())
        if rows == 0:
            return sweeps
        xq = broadcast(mesh, torch.empty((rows, d), dtype=model.x.dtype, device=mesh.device), 0)
        model.predict_mean_variance(xq, block=block or None)
        sweeps += 1


class GPClient:
    """Blocking client of the serving protocol (one persistent connection;
    requests are sent one after another)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 timeout: float = 60.0):
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.host = host
        self.port = port

    def close(self) -> None:
        self._sock.close()

    def __enter__(self) -> "GPClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _recv_exact(self, nbytes: int) -> bytes:
        buf = bytearray()
        while len(buf) < nbytes:
            chunk = self._sock.recv(nbytes - len(buf))
            if not chunk:
                raise ConfigError("serving connection closed mid-response")
            buf.extend(chunk)
        return bytes(buf)

    def _request(self, xq, want_variance: bool):
        xq = native.to_f64(xq)
        if xq.ndim != 2:
            raise ConfigError(f"queries must be 2-D, got shape {xq.shape}")
        m, d = xq.shape
        flags = _FLAG_VARIANCE if want_variance else 0
        self._sock.sendall(struct.pack("<IIQQ", _REQ_MAGIC, flags, m, d) + xq.astype("<f8").tobytes())
        magic, status = struct.unpack("<II", self._recv_exact(8))
        if magic != _RESP_MAGIC:
            raise ConfigError("bad response magic from friedrich_served")
        (count,) = struct.unpack("<Q", self._recv_exact(8))
        if status != 0:
            raise ConfigError(
                f"friedrich_served rejected the request (status {status}: "
                f"{'server-side prediction error' if status == 2 else 'query dim mismatch or oversized batch?'})"
            )
        mean = np.frombuffer(self._recv_exact(8 * count), dtype="<f8").copy()
        if not want_variance:
            return mean, None
        var = np.frombuffer(self._recv_exact(8 * count), dtype="<f8").copy()
        return mean, var

    def predict(self, xq) -> np.ndarray:
        """Posterior mean (``mod.rs:226-244`` semantics)."""
        return self._request(xq, want_variance=False)[0]

    def predict_mean_variance(self, xq) -> tuple[np.ndarray, np.ndarray]:
        """Posterior mean and latent variance (``mod.rs:290-326``;
        observation noise not added back, as in the reference)."""
        return self._request(xq, want_variance=True)
