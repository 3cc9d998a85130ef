"""Out-of-core streamed Cholesky: the factor in host memory, the work on
the card.

Counterpart of ``friedrich_tpu/ops/outofcore.py``. The (cap, cap) factor
lives in host memory (page-locked when the inputs are on the card, so that
copies run asynchronously at the link's rate), and only one panel strip and
two column chunks of the factor are on the card at a time. The panel loop
is the left-looking one of ``ops/streamed.py`` with the prefix streamed from
the host:

    for panel j at j0 (width B):
        chunk 0 = L[j0:, 0:B] up;  S = K(X[j0:], X_j) - chunk0 chunk0[:B]^T
                                        (the panel-strip kernel, its prefix given)
        for each further chunk i < j:   (uploaded on a second stream while
            S -= L[j0:, i] L[j0:j0+B, i]^T   the previous chunk's GEMM runs)
        factor the diagonal block, solve the rows below, round to the
        storage dtype on the card, and download rows j0: into L[j0:, j]

Only rows >= j0 of each chunk go up and only rows >= j0 of each finished
strip come down: about cap^3 / (6 B) factor elements up and cap^2 / 2 down
per factorization, where the JAX package's full-height chunks (one TPU
program for every panel) move cap^3 / (2 B) up. ``storage="bf16"`` keeps
the host factor in bfloat16, which halves both; the chunk GEMMs then
multiply bfloat16 values (exact in TF32) with float32 accumulation.

The solves stream each column panel once per sweep (cap^2 / 2 elements):
the forward sweep fans out (each panel updates every row below it), the
backward sweep fans in. ``TRAFFIC`` counts the bytes each way.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
import weakref
from typing import Optional

import torch

from ..utils.errors import ConfigError
from .cholesky import cholesky, cholesky_with_substitute
from .panel_fused import panel_strip
from .partition import pick_block

#: Host factor dtypes by storage.
HOST_DTYPES = {None: torch.float32, "bf16": torch.bfloat16}

#: Bytes moved over the host link in this process: factor chunks and
#: panels up to the card, finished strips down.
TRAFFIC = {"up": 0, "down": 0}

#: Environment variable: per-panel progress lines on stderr when set to
#: anything but "", "0" or "false".
PROGRESS_ENV = "FRIEDRICH_OOC_PROGRESS"


def progress_enabled(value: Optional[str] = None) -> bool:
    """Whether ``FRIEDRICH_OOC_PROGRESS`` (or ``value``) asks for progress
    lines: "", "0" and "false" (any case, surrounding blanks ignored) and an
    unset variable mean off. The JAX package treats any non-empty value,
    "0" included, as on (``friedrich_tpu/ops/outofcore.py:147``)."""
    if value is None:
        value = os.environ.get(PROGRESS_ENV, "")
    return value.strip().lower() not in ("", "0", "false")


# ---------------------------------------------------------------------------
# Host memory and copies
# ---------------------------------------------------------------------------


def _library():
    from .cuda.build import library

    return library()


def is_page_locked(t: torch.Tensor) -> bool:
    """Whether the host memory of ``t`` is page-locked (needs the card)."""
    return bool(_library().friedrich_host_is_locked(t.data_ptr()))


def page_lock(t: torch.Tensor) -> torch.Tensor:
    """Page-lock the contiguous CPU tensor ``t`` in place
    (``cudaHostRegister``), unless it already is; unlocked when ``t`` is
    collected. A refused registration raises: a host factor on the path to
    the card is never silently pageable."""
    if t.device.type != "cpu" or not t.is_contiguous():
        raise ValueError(f"page-locking takes a contiguous CPU tensor, got {t.device} "
                         f"(contiguous: {t.is_contiguous()})")
    if is_page_locked(t):
        return t
    from .cuda.build import check_launch

    lib = _library()
    ptr = t.data_ptr()
    check_launch(lib.friedrich_host_register(ptr, t.numel() * t.element_size()),
                 "page-locking of the host factor")
    weakref.finalize(t, lib.friedrich_host_unregister, ptr)
    return t


def host_factor(cap: int, dtype: torch.dtype, pinned: bool) -> torch.Tensor:
    """A zeroed (cap, cap) host factor, page-locked (:func:`page_lock`)
    when ``pinned``."""
    l_host = torch.zeros((cap, cap), dtype=dtype)
    return page_lock(l_host) if pinned else l_host


def check_host_factor(l_host: torch.Tensor, cap: int, dtype: torch.dtype,
                      device: torch.device) -> torch.Tensor:
    """``l_host`` as a host factor for inputs on ``device``: a contiguous
    (cap, cap) CPU tensor of ``dtype``, else ValueError; page-locked in
    place when ``device`` is the card."""
    if (l_host.shape != (cap, cap) or l_host.dtype != dtype or l_host.device.type != "cpu"
            or not l_host.is_contiguous()):
        raise ValueError(
            f"host factor must be a contiguous ({cap}, {cap}) {dtype} CPU tensor, got "
            f"{tuple(l_host.shape)} {l_host.dtype} on {l_host.device}"
        )
    return page_lock(l_host) if device.type == "cuda" else l_host


def _copy_2d(dst: torch.Tensor, src: torch.Tensor, stream) -> None:
    """``dst.copy_(src)`` for 2-D blocks with unit column stride, one in
    host memory and one on the card, queued on ``stream`` (a strided DMA
    copy, no staging); on the CPU a plain copy."""
    if dst.device.type == "cpu" and src.device.type == "cpu":
        dst.copy_(src)
        return
    if (dst.shape != src.shape or dst.dtype != src.dtype or dst.ndim != 2
            or dst.stride(1) != 1 or src.stride(1) != 1 or dst.is_cuda == src.is_cuda):
        raise ValueError("a 2-D copy takes one host and one card block of one shape and dtype, "
                         "each with unit column stride")
    if src.shape[0] == 0:
        return
    from .cuda.build import check_launch

    es = src.element_size()
    err = _library().friedrich_copy_2d(
        dst.data_ptr(), dst.stride(0) * es, src.data_ptr(), src.stride(0) * es,
        src.shape[1] * es, src.shape[0], int(dst.is_cuda), stream.cuda_stream,
    )
    check_launch(err, "host-card copy")


class _Uploads:
    """Host blocks streamed to the card through two buffers on a side
    stream: block k+1 goes up while the compute stream works on block k.
    On the CPU the blocks are used where they are."""

    def __init__(self, device: torch.device, rows: int, width: int, dtype: torch.dtype):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.bufs = [torch.empty((rows, width), dtype=dtype, device=device) for _ in range(2)]
            self.stream = torch.cuda.Stream(device)
            self.free = [None, None]  # compute-stream events: the buffer was last read
            self.count = 0

    def start(self, block: torch.Tensor):
        """Queue the upload of a host ``block``; returns a ticket for
        :meth:`take`."""
        TRAFFIC["up"] += block.numel() * block.element_size()
        if not self.cuda:
            return block
        k = self.count % 2
        self.count += 1
        dst = self.bufs[k][:block.shape[0], :block.shape[1]]
        with torch.cuda.stream(self.stream):
            if self.free[k] is not None:
                self.stream.wait_event(self.free[k])
            _copy_2d(dst, block, self.stream)
            done = torch.cuda.Event()
            done.record(self.stream)
        return k, dst, done

    def take(self, ticket) -> torch.Tensor:
        """The uploaded block, once the compute stream may read it."""
        if not self.cuda:
            return ticket
        k, dst, done = ticket
        torch.cuda.current_stream().wait_event(done)
        return dst

    def release(self, ticket) -> None:
        """The compute stream is done queueing reads of this block."""
        if self.cuda:
            k = ticket[0]
            self.free[k] = torch.cuda.Event()
            self.free[k].record(torch.cuda.current_stream())


def _download(l_host_block: torch.Tensor, strip: torch.Tensor, uploads: _Uploads) -> None:
    """Queue the finished ``strip`` into its host block on the uploads'
    stream, after the compute stream's work on it (later uploads of the
    same columns follow it in that stream's order)."""
    TRAFFIC["down"] += strip.numel() * strip.element_size()
    if not uploads.cuda:
        l_host_block.copy_(strip)
        return
    stream = uploads.stream
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        _copy_2d(l_host_block, strip, stream)
    strip.record_stream(stream)


# ---------------------------------------------------------------------------
# Factorization
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _chunk_precision(dtype: torch.dtype):
    """The float32 matmul precision of a chunk's downdate: TF32 for a
    bfloat16 chunk (upcast, its values are exact in TF32: one tensor-core
    product with float32 accumulation, the arithmetic of a bf16 GEMM), the
    ambient one otherwise."""
    previous = torch.get_float32_matmul_precision()
    if dtype == torch.bfloat16:
        torch.set_float32_matmul_precision("high")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(previous)


def _finish_panel(s: torch.Tensor, block: int, eps: Optional[float]) -> torch.Tensor:
    """Factor the strip's diagonal block and solve the rows below it, in
    place: the finished (cap - j0, B) strip of the factor
    (``friedrich_tpu/ops/outofcore.py:_finish_panel``, its rows >= j0)."""
    if eps is None:
        ld, _ = cholesky(s[:block])
    else:
        ld = cholesky_with_substitute(s[:block], eps)
    if s.shape[0] > block:
        s[block:] = torch.linalg.solve_triangular(ld.mT, s[block:], upper=True, left=False)
    s[:block] = ld
    return s


def outofcore_cholesky_factor(kernel, x_pad: torch.Tensor, n: int, noise,
                              eps: Optional[float] = None, block: int = 4096,
                              method: str = "gram", storage: Optional[str] = None,
                              l0: Optional[torch.Tensor] = None,
                              ) -> tuple[torch.Tensor, bool]:
    """Covariance build and Cholesky factorization with the factor in host
    memory. Returns ``(L_host, ok)``: a (cap, cap) CPU tensor, float32 or
    bfloat16 (``storage="bf16"``), page-locked when ``x_pad`` is on the
    card, and whether the whole factor is finite.

    ``x_pad``: the padded float32 inputs, on the device that computes;
    ``block``: the panel width, snapped to a divisor of the capacity
    (``pick_block``). ``l0``: a host factor to write into (its contents are
    lost) instead of a new one, as :func:`check_host_factor` takes it.
    """
    if storage not in HOST_DTYPES:
        raise ConfigError(f"storage must be None or 'bf16', got {storage!r}")
    if x_pad.dtype != torch.float32:
        raise ConfigError(f"out-of-core factorization is float32-compute only, got {x_pad.dtype}")
    cap = x_pad.shape[0]
    b = pick_block(cap, block)
    host_dtype = HOST_DTYPES[storage]
    device = x_pad.device
    if l0 is not None:
        l_host = check_host_factor(l0, cap, host_dtype, device).zero_()
    else:
        l_host = host_factor(cap, host_dtype, pinned=device.type == "cuda")
    noise = torch.as_tensor(noise, dtype=torch.float32, device=device)
    uploads = _Uploads(device, cap, b, host_dtype)
    ok = torch.ones((), dtype=torch.bool, device=device)
    progress = progress_enabled()
    t_start = time.perf_counter()
    num_panels = cap // b
    for j in range(num_panels):
        if progress:
            print(f"[ooc] panel {j + 1}/{num_panels} t={time.perf_counter() - t_start:.0f}s",
                  file=sys.stderr, flush=True)
        j0, j1 = j * b, (j + 1) * b
        tickets = [uploads.start(l_host[j0:, i * b:(i + 1) * b]) for i in range(min(j, 1))]
        if j > 0:
            first = uploads.take(tickets[0])
        else:
            first = torch.empty((cap, 0), dtype=host_dtype, device=device)
        ticket = uploads.start(l_host[j0:, b:2 * b]) if j > 1 else None
        # the kernel strip fused with the first chunk's downdate
        s = panel_strip(kernel, x_pad[j0:], x_pad[j0:j1], None, n, noise, j0, b, method,
                        prefix=first)
        if j > 0:
            uploads.release(tickets[0])
        for i in range(1, j):
            chunk = uploads.take(ticket)
            nxt = uploads.start(l_host[j0:, (i + 1) * b:(i + 2) * b]) if i + 1 < j else None
            c = chunk.to(torch.float32)
            with _chunk_precision(host_dtype):
                s.addmm_(c, c[:b].mT, alpha=-1.0)
            del c
            uploads.release(ticket)
            ticket = nxt
        s = _finish_panel(s, b, eps)
        out = s.to(host_dtype)  # rounded on the card: half the download for bf16
        ok &= torch.isfinite(torch.sum(out, dtype=torch.float32))
        _download(l_host[j0:, j0:j1], out, uploads)
        del s, out
    if uploads.cuda:
        uploads.stream.synchronize()
    return l_host, bool(ok)


# ---------------------------------------------------------------------------
# Solves
# ---------------------------------------------------------------------------


def _stream_solve(l_host: torch.Tensor, c: torch.Tensor, transposed: bool,
                  block: int = 4096) -> torch.Tensor:
    """One sweep over the host factor's column panels (``_fwd_step`` /
    ``_bwd_step`` of the JAX package, rows >= j0 of each panel only); ``c``
    on the device that computes, a matrix or a vector."""
    cap = l_host.shape[0]
    c2 = c if c.ndim == 2 else c[:, None]
    # a fresh float32 buffer: the sweep updates it in place
    y = c2.to(torch.float32, copy=True)
    b = pick_block(cap, block)
    uploads = _Uploads(y.device, cap, b, l_host.dtype)
    order = list(range(cap // b))
    if transposed:
        order.reverse()
    ticket = uploads.start(l_host[order[0] * b:, order[0] * b:(order[0] + 1) * b])
    for k, j in enumerate(order):
        j0, j1 = j * b, (j + 1) * b
        panel = uploads.take(ticket)
        if k + 1 < len(order):
            i = order[k + 1]
            nxt = uploads.start(l_host[i * b:, i * b:(i + 1) * b])
        p = panel.to(torch.float32)
        ld, below = p[:b], p[b:]
        if not transposed:
            # fan-out: solve the diagonal block, then eliminate it from every row below
            y[j0:j1] = torch.linalg.solve_triangular(ld, y[j0:j1], upper=False)
            if j1 < cap:
                y[j1:].addmm_(below, y[j0:j1], alpha=-1.0)
        else:
            # fan-in: gather the rows below, then solve the transposed block
            rhs = y[j0:j1]
            if j1 < cap:
                rhs = rhs - below.mT @ y[j1:]
            y[j0:j1] = torch.linalg.solve_triangular(ld.mT, rhs, upper=True)
        del p, ld, below
        uploads.release(ticket)
        if k + 1 < len(order):
            ticket = nxt
    return y if c.ndim == 2 else y[:, 0]


def outofcore_solve_lower(l_host: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``L^-1 c`` with the factor streamed from host memory, one panel at a
    time (each panel uploaded once)."""
    return _stream_solve(l_host, c, transposed=False)


def outofcore_solve_lower_t(l_host: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``L^-T c`` (the backward sweep, each panel uploaded once)."""
    return _stream_solve(l_host, c, transposed=True)


def outofcore_cho_solve(l_host: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``(L L^T)^-1 c``: the two sweeps."""
    return outofcore_solve_lower_t(l_host, outofcore_solve_lower(l_host, c))
