"""Smoke test of the PyTorch/CUDA port (``friedrich_tpu_torch``) on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each of which fails loudly (non-zero exit, no result line):

1. environment: card name and power limit, torch and CUDA versions, float32
   matmuls in full precision, and the build of the kernels from
   ``friedrich_tpu_torch/csrc/`` with ``nvcc`` (timed), with each
   instantiation's registers and spills (a spilling covariance-kernel or
   warp-specialized panel-strip instantiation fails, and so does one of the
   latter that does not start at 168 registers a thread, the count its
   setmaxnreg split assumes);
2. the covariance kernel against its plain PyTorch version on the card, for
   the nine kernels (each its own compiled-in map) plus Sum, Prod and a
   deeper composition (the interpreter), in train mode (whole matrix and a
   strip across the diagonal) and cross mode, float32 and float64, every
   distance method, at ragged shapes: capacities 1,000 and 1,001 and 333
   queries (rows not 16-byte aligned);
3. parity of the port on the card against the port on the CPU: the demo
   flow and a builder fit at n=512, d=3, float64;
4. the full-width main path: ``bench.py``'s north-star flow on the dense
   backend at n=50,000, d=8, float32 — sub-fit at 8,192, one 50,512-capacity
   build and factor, a 4,096-query ``predict_in_batches``, a 512-point
   ``add_samples`` and ``sample_at`` 64 points — with the kernel's launches
   counted over that run (in all and by shape), then the kernel held against
   the plain version on 4,096-row strips of the 50,512^2 matrix and timed
   at each main-path shape beside its bound and its launches on the flow
   (train 8,192^2 and 50,512^2, cross 50,512 x 4,096), and on the Composite
   tree at 50,512^2;
5. the streamed backend: the panel-strip kernel against its plain version at
   ragged shapes (the nine kernels plus Sum, Prod and a composition, every
   distance method, float32 and float64); the streamed against the dense
   backend at capacity 50,512 with phase 4's data and fitted
   hyperparameters, and a sweep of panel widths; the same north-star flow on
   the streamed backend at n=100,000 (capacity 100,512), with both kernels'
   launches counted over that run and its peak memory held below two
   factors; the covariance kernel timed on its cross 100,512 x 4,096; then
   the panel-strip kernel against its plain version on three
   panels of the final factor, and timed on the middle one beside its bound,
   its plain version and the downdate alone as one ``torch.addmm``; last, a
   panel-width sweep at 100,512 and a ``torch.profiler`` breakdown (device
   time by kernel, idle share) of one streamed build+factor there. Phase 5a
   also runs a capacity that is not a multiple of 4 (the float32 kernel's
   cp.async producer), with NaN right of the prefix, which the kernel must
   never read;
   Phase 5d is a prior-only refit (``fit_parameters(fit_prior=True,
   fit_kernel=False)``) of a freshly built 100,512 streamed model: the
   rebuild writes into the old factor's buffer, its peak memory stays below
   two factors, and its factor equals the build's (K is unchanged);
6. large-n fitting and persistence: (6a) the builder's default flow at
   n=100,000 — phase 5c's chain with the sub-fit left at "auto", so a
   20,000-point sub-fit with the Hutchinson gradient — then predict, append
   and sample, with both kernels' launches counted over that run, its LML
   above the heuristic start's and its peak memory below two factors, and
   the covariance kernel held against its plain version and timed at the
   sub-fit's 20,000^2 shape; (6b) two
   full-n Hutchinson iterations of that 100,512 model, each timed by part
   (solves, dK matvec, rebuild), with one panel-strip launch per panel per
   rebuild, the factor's buffer reused and the peak below two factors;
   (6c) both hyperparameter densities (dense at capacity 1,024, streamed at
   4,096) against the same functions with the plain versions on the card,
   the covariance's forward against its plain version and its backward
   against the analytic gradient, the panel-strip kernel against its plain
   version on three panels of the 20,000-point sub-model's streamed factor,
   ``polish_map`` on that sub-model (its exact LML must not drop) and ``fit_map(num_steps=3)`` on phase 4's
   50,512 model through the streamed density; (6d) save and load of the
   sub-model, whose predictions must come back bit for bit;
7. the hyperparameter samplers on the JAX package's sampler data
   (``scripts/measure.py:474-482``: d=4, SquaredExp, noise 0.2, float32;
   4 chains, 100 warmup and 100 sampled transitions): (7a) NUTS
   (``max_depth=6``) on the streamed density at n=4,096 with 64 Hutchinson
   probes (``num_probes=64`` of ``sample_hyperparameters``, whose default
   is 16; the panel-strip kernel), (7b) NUTS and HMC (16 leapfrogs, 50 + 50
   transitions) on the dense density at n=1,024 (the covariance kernel),
   each run counted as a main path (kernel launches, density
   evaluations), gated (finite draws on the card, at most 5 % divergent,
   split R-hat below 1.1 per parameter) and timed
   (transitions/s and ESS/s over the whole run, seconds per evaluation
   apart, peak memory, the device idle share of 5 more transitions under
   ``torch.profiler``); (7c) ``predictive_mixture`` over 32 of 7a's draws
   on 1,024 queries and ``sample_predictive`` with given indices and
   normals on 64 of them, against the same calls with the plain versions
   on the card (the samples' distance from a float64 run printed beside
   it; the samples again on a float64 copy of the model);
   (7d) the covariance kernel at 1,024^2, 4,096^2 and cross 4,096 x 1,024
   and the panel-strip kernel on the panels of 7a's density factor against
   their plain versions, timed beside their bounds; and NUTS on a 5-D
   anisotropic Gaussian on the card, whose moments must lie within 5
   Monte-Carlo standard errors of the analytic ones;
8. past one float32 factor: (8a) ``scripts/check80k.py``'s flow and data
   (d=8, noise 2.0, a 10,000-point sub-fit) with bf16 factor storage at
   n=150,000, capacity 150,512 — where one float32 factor does not fit the
   card and two bf16 factors do not either — then predict, append (a
   rebuild into the factor's own buffer) and sample, with the launches of
   the bf16-prefix panel-strip instantiation counted (and no other), the
   variances inside [-1e-4, k(x, x)], the training-point correlation
   above check80k.py's 0.1 and the query means' correlation with the
   noise-free function above 0.5, and that instantiation against its plain version on three
   panels, timed on the middle one beside its bound and ``torch.addmm`` on
   the same bf16 operands, its downdate against float64 beside the
   library's; (8b) float32 storage, bf16 storage and float32 with
   precision "bf16" at capacity 100,512 with 8a's hyperparameters, one
   after another: build times, each model's launches of its own
   instantiation only, the bf16 models' predictions within 0.05 of the
   float32 model's, and the single-pass instantiation against its plain
   version on three panels and timed beside ``torch.addmm`` under
   "medium" (their ratio printed); the downdates of both bf16-product
   instantiations at their middle panels within twice the error against
   float64 of their previous design (a 128 x 128 tile per block, no
   producer warp); (8c) ``OutOfCoreGP`` at n=100,000 with a bf16 host factor
   (``scripts/check100k_outofcore.py``'s configuration: 22.7 GB of
   page-locked host memory, panels of 8,192): the host's ``free -b``, the
   link's copy rates, the factor's time, bytes up and down and host and
   card peaks, predictions at 256 queries within 1e-3 of an on-card bf16
   model of the same data; then a float32 host factor at n=50,000 within
   5e-5 of the on-card streamed factor, the copy/kernel overlap of one
   refactorization (``torch.profiler``), and one ``fit_generic``
   iteration. Each host factor's first, middle and last panels hold B2's
   explicit-prefix entry against its plain version.

9. the tiled and hybrid backends at full width and serving: on ``bench.py``'s
   data at n=100,000 (capacity 100,512) with 6a's fitted hyperparameters
   (no fit), first the streamed model's 4,096 predictions as the reference;
   (9a) a ``backend="tiled"`` model through the builder and its 4,096
   predictions under ``torch.profiler`` (device time by named scope and by
   kernel, idle share), both kernels' launches counted (B1 only), the
   means, in one solve and at the server's solve width, no further from the
   model's float64 solution (iterative refinement with the float32 factor,
   float64 residuals from B1's float64 instantiation) than the streamed
   model's means + 1e-3, the variances within 1e-3 of the streamed model's
   and >= -1e-4, and the peak below 1.15 factors; (9c) ``AcceleratedGPServer`` over that
   model: 4 ``GPClient`` threads of 8 requests each (1-1,024 rows, mean
   and variance or mean only), each reply within 1e-5 of the model's
   in-process prediction of its rows at the server's solve width
   (``predict_mean_variance(rows, block=256)``; its distance from the
   one-solve prediction printed), a dimension mismatch answered with
   status 1 on a connection that stays usable, no status 2, latencies and
   the dispatcher's batches printed; then B1 at 9a's 100,512^2 launch, timed
   beside its bound and held against its plain version on 4,096-row strips;
   (9b) the same as 9a with ``backend="hybrid"`` (levels 1), whose leading
   region launches B2 (3xTF32 only), held against its plain version on
   three panels of that region (rows ending at h = 50,256), and B1 on the
   first S22 strip; the downdates of L21's last strip and S22's first, as
   one product and panel by panel, against float64; (9e) a float64 dense
   model of the first 50,000 points (capacity 50,512) as the witness of a
   float64 streamed model of the same points (B2's float64 instantiation),
   whose means and variances must lie within rtol 1e-10, atol 1e-10 of it,
   and of the float32 streamed, tiled and hybrid models, the tiled
   and hybrid models' means and variances no further from it than the
   streamed model's + 1e-3; (9d) the native daemon (``GPServer``, CPU float64) on a
   bundle the port exported from a model of the first 8,192 points, asked
   256 rows over 8 connections, within 5e-4 of the card's predictions; last,
   B2's explicit bf16 prefix at 8c's middle panel and its float64
   instantiation at a 4,096 density factor's middle panel, each against its
   plain version, its bound and ``torch.addmm``; B1 at 9c's merged batch
   (cross 100,512 x 1,024) beside its bound and plain version.
10. the float64 flow: ``bench.py``'s data at n=70,000 (capacity 70,512,
   a 39.8 GB float64 factor, two of which do not fit the card) through the
   builder with ``set_dtype("float64")``, noise 1.0, ``backend="auto"``
   (which must resolve to "streamed") and the "auto" sub-fit (14,000
   points), then predict 4,096 queries, append 512 points in place and
   sample 64; B2's float64 instantiation (``mma.sync`` on the FP64 tensor
   cores) must launch once per panel and no other instantiation; the peak
   below 1.15 factors, the fitted LML above the heuristic start's,
   variances >= -1e-4; B2 against its plain version on three panels of the
   final factor and timed at the middle one beside its bound, its plain
   version and one float64 ``torch.addmm``; B1 at the flow's float64
   shapes; a ``torch.profiler`` breakdown of one float64 build.
11. the multi-rank layer: (11a) B2 with the panel's rows as a separate
   operand against its plain version; (11b) ``LargeScaleGP`` at n=100,000
   on NCCL's world of one (build, predict, ``fit_scaled(max_iter=2)``,
   append); (11c) two gloo ranks on the one card at n=50,000 against a
   world of one, and chain-sharded NUTS; (11d) the distributed density's
   sampler (``--phase11`` runs phase 1 and phase 11 alone).
12. serving across ranks and the example twins: (12a) ``AcceleratedGPServer``
   over 11b's ``LargeScaleGP`` on NCCL's world of one, 9c's clients and
   gates; (12b) 11c's two gloo ranks at n=50,000, each on its row block of
   a world of one's factor (shared on the card), serving from rank 0 while
   rank 1 runs ``serving.follow``, each reply within 1e-5 of the world of
   one's answer and equal to rank 0's in-process answer;
   (12c) each twin of ``examples/`` (``friedrich_tpu_torch/examples/``)
   at its script's defaults (``outofcore_gp`` at n=50,000,
   ``large_scale_fit`` at n=20,000) with its gates and the kernels'
   launches (``--phase12`` runs phase 1 and phase 12 alone).

The last three lines are the card's ``nvidia-smi`` name and power limit, a
JSON line describing each kernel, and ``{"ok": true, "device": ...}``.
``--n``, ``--streamed-n`` and ``--f64-n`` shrink the full-width phases (4
and 5b; 5c, 5d, 6a, 6b, 8b and 9; 10) for a quick check.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

#: Published H100 SXM rates used for the bound (NVIDIA data sheet): float64
#: on the tensor cores and on the CUDA cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
FP64_FLOPS = 67e12
FP64_SIMT_FLOPS = 34e12

#: Tolerances of the kernel against its plain version, held as
#: ``|got - want| <= atol + rtol * |want|``. float64: the two differ only
#: in summation order and fused multiply-adds. float32 (and gram_bf16 in
#: either dtype, whose dot product is accumulated in float32 by
#: definition): the rounding of sqdist's cancellation, scaled by the entry
#: (a product with a Linear factor reaches ~15), so relative as well as
#: absolute, as tests/test_torch_cuda.py holds the same kernel.
ATOL_F64, RTOL_F64 = 1e-12, 0.0
ATOL_F32, RTOL_F32 = 2e-5, 2e-5


def excess(got, want, atol: float, rtol: float) -> float:
    """Largest amount by which ``got`` misses ``want`` beyond the
    tolerance; <= 0 when every entry is within it."""
    return float(((got - want).abs() - (atol + rtol * want.abs())).max())


def log(*parts) -> None:
    print(*parts, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def sync():
    import torch

    torch.cuda.synchronize()
    return time.perf_counter()


def device_ops(prof) -> list:
    """``(name, start_ns, end_ns)`` of every kernel, copy and memset a
    finished ``torch.profiler`` profile saw on the card (not the copies of
    the host's named ranges there)."""
    from torch.autograd import DeviceType

    return [(e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()]


def busy_s(ops) -> float:
    """Seconds in which any of ``ops`` ran: the union of their intervals
    (``gpbench/trace.union_length``), so work overlapping on two streams
    counts once."""
    from gpbench.trace import union_length

    return union_length((start, end) for _, start, end in ops) / 1e9


def cuda_ms(fn, reps: int = 5) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()`` after one warm-up;
    each result is dropped before the next call."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        del out
    return statistics.median(times)


def test_kernels():
    """The covariance functions phase 2 holds the kernel to."""
    from friedrich_tpu_torch import kernels as K

    return {
        "Linear": K.Linear(c=0.4),
        "Polynomial": K.Polynomial(alpha=0.1, c=1.0, d=2.0),
        "SquaredExp": K.SquaredExp(ls=0.9, ampl=1.3),
        "Exponential": K.Exponential(ls=1.1, ampl=0.8),
        "Matern1": K.Matern1(ls=1.2, ampl=0.9),
        "Matern2": K.Matern2(ls=1.1, ampl=0.7),
        "HyperTan": K.HyperTan(alpha=0.3, c=0.1),
        "Multiquadric": K.Multiquadric(c=0.7),
        "RationalQuadratic": K.RationalQuadratic(alpha=1.5, ls=1.2),
        "Sum": K.SquaredExp(ls=0.9, ampl=1.3) + K.Matern2(ls=1.1, ampl=0.7),
        "Prod": K.Linear(c=0.4) * K.SquaredExp(ls=0.9, ampl=1.3),
        "Composite": (K.Matern2(ls=1.1, ampl=0.7) * K.RationalQuadratic(alpha=1.5, ls=1.2)
                      + K.Linear(c=0.4) * K.SquaredExp(ls=0.9, ampl=1.3)),
    }


#: The warp-specialized panel-strip kernels, whose blocks start at 168
#: registers a thread for setmaxnreg to split.
WS_KERNELS = ("panel_strip_ws_kernel", "panel_strip_tf32x3_ws_kernel")


def ptxas_table(report: str) -> dict:
    """Registers, static shared memory, spill stores and ptxas's wgmma
    serialization notes of each kernel instantiation in the ``-Xptxas -v``
    report, by readable name: the covariance kernel by dtype, method and map
    (a leaf, or the program interpreter), the panel-strip kernels by their
    template arguments. ``serialized`` lists the codes of the notes that
    name the instantiation (C7513, C7518, ...: ptxas made its ``wgmma``
    wait one by one), empty where its ``wgmma`` stay asynchronous."""
    from friedrich_tpu_torch.ops.cuda import build

    maps = {str(op): cls.__name__ for cls, op in build.OPCODES.items()}
    maps["n1"] = "program"
    methods = {str(v): k for k, v in build.METHODS.items()}
    dtypes = {"f": "float", "d": "double"}

    def readable(symbol: str):
        m = re.search(r"\d+cov_kernel\w*?I([fd])Li(\d+)ELi(n?\d+)E", symbol)
        if m:
            return f"cov_kernel<{dtypes[m.group(1)]},{methods[m.group(2)]},{maps[m.group(3)]}>"
        m = re.search(r"\d+(panel_strip_f64_kernel|panel_strip_tf32x3_ws_kernel|panel_strip_ws_kernel)"
                      r"I(\w*?)EEv", symbol)
        if m:
            raw = m.group(2)
            parts = [dtypes[raw[0]]] if raw[0] in dtypes else []
            ints = re.findall(r"Li(\d+)E", raw)
            if m.group(1) == "panel_strip_ws_kernel":  # feed, method, TMA, serialized loop
                parts += [("bf16", "f32")[int(ints[0])], methods[ints[1]]]
            else:
                parts += [methods[v] for v in ints]
            flags = re.findall(r"Lb([01])E", raw)
            if flags:
                parts.append("tma" if flags[0] == "1" else "no_tma")
            if flags[1:] == ["1"] and m.group(1) == "panel_strip_ws_kernel":
                parts.append("serial")
            return f"{m.group(1)}<{','.join(parts)}>"
        return "bf16_rows_kernel" if "bf16_rows_kernel" in symbol else None

    table: dict = {}
    entry, spill = None, 0
    for line in report.splitlines():  # each entry function, its spills, its "Used N registers"
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry, spill = readable(m.group(1)), 0
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and entry:
            spill = max(spill, int(m.group(1)))
        m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", line)
        if m and entry:
            table[entry] = {"registers": int(m.group(1)), "static_smem_bytes": int(m.group(2)),
                            "spill_stores": spill, "serialized": []}
            entry = None
    for line in report.splitlines():  # "(C7513) Potential Performance Loss: ... '<function>'"
        code = re.search(r"\((C\d+)\)", line)
        for symbol in re.findall(r"'(\w+)'", line) if code else ():
            name = readable(symbol)
            if name in table and code.group(1) not in table[name]["serialized"]:
                table[name]["serialized"].append(code.group(1))
    return table


def phase_environment() -> None:
    import torch

    from friedrich_tpu_torch.ops.cuda import build

    log("== phase 1: environment")
    log("nvidia-smi:", smi_line())
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    if torch.backends.cuda.matmul.allow_tf32:
        fail("torch.backends.cuda.matmul.allow_tf32 is True: float32 matmuls would run in TF32")
    log(f"torch.backends.cuda.matmul.allow_tf32 = {torch.backends.cuda.matmul.allow_tf32} "
        f"(float32 matmul precision {torch.get_float32_matmul_precision()!r})")
    t0 = time.perf_counter()
    path, report = build.build()
    build_s = time.perf_counter() - t0
    per_kernel = ptxas_table(report)
    spills = sorted({int(s) for s in re.findall(r"(\d+) bytes spill stores", report)})
    log(f"kernel build (every csrc/*.cu, one nvcc each, in parallel): {build_s} s -> {path.name}; "
        f"spill stores (bytes) {spills}")
    log(json.dumps({"ptxas": per_kernel}))
    spilled = [k for k, v in per_kernel.items()
               if k.startswith(("cov_kernel", "panel_strip_")) and v["spill_stores"]]
    if spilled:
        fail(f"kernel instantiations spill: {spilled}")
    # the warp-specialized kernels' setmaxnreg split (2 x 128 x 232 + 128 x
    # 40, or 224 and 56) takes the 384 x 168 registers a block starts with;
    # with fewer, setmaxnreg.inc would wait forever
    unsplit = {k: v["registers"] for k, v in per_kernel.items()
               if k.startswith(WS_KERNELS) and v["registers"] != 168}
    if unsplit:
        fail(f"warp-specialized panel-strip instantiations do not start at 168 registers: {unsplit}")
    log(json.dumps({"wgmma_serialized": {k: v["serialized"] for k, v in per_kernel.items()
                                         if k.startswith(WS_KERNELS)}}))
    for line in report.splitlines():  # ptxas's own warnings, e.g. a serialized wgmma
        if "warning" in line.lower() or "performance loss" in line.lower():
            log("ptxas:", line.strip())


def phase_kernel_vs_plain() -> None:
    import torch

    from friedrich_tpu_torch.ops import covariance as cov
    from friedrich_tpu_torch.ops.cuda import covariance_cuda

    log("== phase 2: covariance kernel against its plain version")
    rng = np.random.default_rng(7)
    # capacity 1,001: rows not 16-byte aligned (m2 % 4 != 0), the masked
    # scalar stores; 333 queries likewise in cross mode
    caps, n, mq, noise = (1000, 1001), 937, 333, 0.3
    worst, launches = {}, {}
    for d, m1 in itertools.product((1, 8), caps):
        x_np = rng.normal(size=(m1, d))
        q_np = rng.normal(size=(mq, d))
        for dtype in (torch.float32, torch.float64):
            x = torch.as_tensor(x_np, dtype=dtype, device="cuda")
            q = torch.as_tensor(q_np, dtype=dtype, device="cuda")
            for name, kern in test_kernels().items():
                kern = kern.to(dtype, x.device)
                before = covariance_cuda.LAUNCHES
                for method in ("gram", "gram_bf16", "direct"):
                    f32_like = dtype == torch.float32 or method == "gram_bf16"
                    atol, rtol = (ATOL_F32, RTOL_F32) if f32_like else (ATOL_F64, RTOL_F64)
                    cases = {
                        "train": (
                            covariance_cuda.covariance(kern, x, x, n, noise, train=True, method=method),
                            cov.plain_train_covariance_padded(kern, x, n, noise, method=method),
                        ),
                        "train_strip": (
                            covariance_cuda.covariance(kern, x[300:700], x, n, noise, train=True,
                                                       method=method, row0=300),
                            cov.plain_train_covariance_padded(kern, x, n, noise, method=method,
                                                              rows=(300, 700)),
                        ),
                        "cross": (
                            covariance_cuda.covariance(kern, x, q, n, method=method),
                            cov.plain_cross_covariance_train_padded(kern, x, n, q, method=method),
                        ),
                        "cross_full": (
                            covariance_cuda.covariance(kern, q, x, mq, method=method),
                            cov.plain_cross_covariance(kern, q, x, method=method),
                        ),
                    }
                    torch.cuda.synchronize()
                    for mode, (got, want) in cases.items():
                        what = f"{name} {mode} {method} d={d} m1={m1} {dtype}"
                        if got.shape != want.shape or not bool(torch.isfinite(got).all()):
                            fail(f"{what}: shape or non-finite")
                        err = float((got - want).abs().max())
                        if not excess(got, want, atol, rtol) <= 0:
                            fail(f"{what}: max error {err} beyond atol {atol} + rtol {rtol}")
                        key = (name, "f32" if dtype == torch.float32 else "f64")
                        worst[key] = max(worst.get(key, 0.0), err)
                launches[name] = launches.get(name, 0) + covariance_cuda.LAUNCHES - before
    table = [
        {"kernel": name, "launches": launches[name],
         "max_err_f32": worst[(name, "f32")], "max_err_f64": worst[(name, "f64")]}
        for name in test_kernels()
    ]
    log(json.dumps({"parity": table,
                    "shapes": f"{caps} rows, live n {n}, {mq} queries, d in (1, 8)"}))


_NUM = re.compile(r"-?\d+\.\d+(?:e-?\d+)?")


def phase_parity() -> None:
    import torch

    from friedrich_tpu_torch import GaussianProcessBuilder, demo

    log("== phase 3: the port on the card against the port on the CPU (float64)")
    lines = {}
    for device in ("cuda", "cpu"):
        out = []
        demo.main(device=device, out=out.append)
        lines[device] = out
    for a, b in zip(lines["cuda"], lines["cpu"]):
        va = [float(v) for v in _NUM.findall(a)]
        vb = [float(v) for v in _NUM.findall(b)]
        if len(va) != len(vb) or not np.allclose(va, vb, rtol=1e-9, atol=0):
            fail(f"demo differs between cuda and cpu: {a!r} vs {b!r}")
    log("demo: cuda and cpu agree at rtol 1e-9:", lines["cuda"][0])

    rng = np.random.default_rng(3)
    x = rng.normal(size=(512, 3))
    y = np.sin(x[:, 0]) + 0.5 * np.cos(2.0 * x[:, 1]) + 0.1 * rng.normal(size=512)
    xq = rng.normal(size=(64, 3))
    fits = {}
    for device in ("cuda", "cpu"):
        builder = GaussianProcessBuilder(x, y, device=device).fit_kernel().fit_prior()
        gp = builder.train()
        mean, var = gp.predict_mean_variance(xq)
        fits[device] = (
            np.concatenate([gp.kernel.get_params().cpu().numpy(), [gp.noise]]),
            np.asarray(mean), np.asarray(var), builder.timings["fit_iterations"],
        )
    (pa, ma, va, ia), (pb, mb, vb, ib) = fits["cuda"], fits["cpu"]
    if ia != ib or not np.allclose(pa, pb, rtol=1e-7, atol=0):
        fail(f"builder fit differs: params {pa} vs {pb}, iterations {ia} vs {ib}")
    if not (np.allclose(ma, mb, rtol=1e-9, atol=1e-12) and np.allclose(va, vb, rtol=1e-9, atol=1e-12)):
        fail(f"builder predictions differ: {np.abs(ma - mb).max()} {np.abs(va - vb).max()}")
    log(f"builder fit n=512 d=3: {ia} iterations, params {pa.tolist()}, max |dparam/param| "
        f"{float(np.max(np.abs(pa - pb) / np.abs(pb)))}, max |dmean| {float(np.abs(ma - mb).max())}")
    torch.cuda.empty_cache()


#: Operations per entry of the maps timed at full width besides the dot
#: product (exp, pow and sqrt counted as one): the squared-exponential's
#: distance and map, and the Composite tree's distance, sqrt, four leaves
#: and three combinators.
MAP_OPS = {"SquaredExp": 9, "Composite": 22}


def bound_ms(m1: int, m2: int, d: int, itemsize: int, flops_per_s: float,
             map_ops: int = MAP_OPS["SquaredExp"]) -> tuple[float, str]:
    """Least time for one launch: inputs read once and output written
    once over HBM bandwidth, against 2d + ``map_ops`` operations per entry
    plus 2d per row norm, over the peak rate for the dtype."""
    nbytes = ((m1 + m2) * d + m1 * m2) * itemsize
    ops = m1 * m2 * (2 * d + map_ops) + 2 * d * (m1 + m2)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


D, M_QUERIES, K_ADD, M_SAMPLE = 8, 4096, 512, 64


def bench_data(n: int):
    """``bench.py``'s data (bench.py:99-107) at ``n`` points, float32:
    ``(x, y, queries, appended x, appended y, sample points)``."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, D)).astype(np.float32)
    y = (np.sin(2.5 * x[:, 0]) + 0.5 * np.cos(2.0 * x[:, 1]) + rng.normal(size=n)).astype(np.float32)
    xq = rng.normal(size=(M_QUERIES, D)).astype(np.float32)
    x_add = rng.normal(size=(K_ADD, D)).astype(np.float32)
    y_add = (np.sin(2.5 * x_add[:, 0]) + 0.5 * np.cos(2.0 * x_add[:, 1])).astype(np.float32)
    x_sample = rng.normal(size=(M_SAMPLE, D)).astype(np.float32)
    return x, y, xq, x_add, y_add, x_sample


def launch_ms(fn, reps: int = 10) -> float:
    """Device time of one call of ``fn``: CUDA events around ``reps``
    calls issued back to back after a warm-up, over ``reps``; the median
    of three such runs. ``fn`` must not wait for the device."""
    import torch

    fn()
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def shape_time(label: str, kernel, x1, x2, n: int, train: bool, noise, by_shape) -> dict:
    """B1 at one main-path shape: its device time per launch, its bound and
    its launches at that shape on the flow (``by_shape``, the wrapper's
    ``LAUNCHES_BY_SHAPE`` over the flow). The kernel's parameters are
    copied to the host first: read from the card, each launch would wait
    for their copy."""
    import torch

    from friedrich_tpu_torch.ops.cuda import covariance_cuda

    m1, m2 = x1.shape[0], x2.shape[0]
    kernel, noise = kernel.to(x1.dtype, "cpu"), float(noise) if train else 0.0
    ms = launch_ms(lambda: covariance_cuda.covariance(kernel, x1, x2, n, noise, train=train))
    torch.cuda.empty_cache()
    map_ops = MAP_OPS["Composite" if label.startswith("Composite") else "SquaredExp"]
    rate = FP64_SIMT_FLOPS if x1.dtype == torch.float64 else FP32_FLOPS
    bound, by = bound_ms(m1, m2, x1.shape[1], x1.element_size(), rate, map_ops)
    return {"shape": label, "ms": ms, "bound_ms": bound, "bound_by": by, "ms_over_bound": ms / bound,
            "launches_on_flow": 0 if label.startswith("Composite") else by_shape.get((m1, m2, train), 0)}


def phase_full_width(n: int) -> tuple[dict, tuple]:
    import torch

    import friedrich_tpu_torch as ft
    from friedrich_tpu_torch.ops import covariance as cov
    from friedrich_tpu_torch.ops.cuda import covariance_cuda

    log(f"== phase 4: full width, n={n}, d=8, float32, dense backend")
    d, m, k_add, m_sample = D, M_QUERIES, K_ADD, M_SAMPLE
    cap = n + k_add
    x, y, xq, x_add, y_add, x_sample = bench_data(n)

    # reference point: the LML of the full-data model at the heuristic start
    xt = torch.as_tensor(x, device="cuda")
    yt = torch.as_tensor(y, device="cuda")
    heur = ft.kernels.Gaussian().heuristic_fit(xt, yt)
    gp0 = ft.GaussianProcess.new(
        ft.priors.ConstantPrior().fit(xt, yt), heur, 1.0, None, x, y,
        dtype="float32", capacity=cap, device="cuda",
    )
    lml0 = gp0.log_marginal_likelihood()
    log(f"heuristic start: ls={float(heur.ls)} ampl={float(heur.ampl)} LML={lml0}")
    del gp0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # ---- the main path; the kernel's launches are counted over this run only
    covariance_cuda.LAUNCHES = 0
    covariance_cuda.LAUNCHES_BY_SHAPE.clear()
    t_start = sync()
    builder = (
        ft.GaussianProcessBuilder(x, y, device="cuda")
        .set_noise(1.0).set_dtype("float32").set_capacity(cap)
        .set_fit_subsample(min(8192, n // 2)).set_fit_parameters(100, 0.05)
        .fit_kernel().fit_prior()
    )
    gp = builder.train()
    lml = gp.log_marginal_likelihood()
    state = gp.state
    t0 = sync()
    mean, var = gp.predict_in_batches(xq, 4096)
    t_predict = sync() - t0
    t0 = sync()
    gp.add_samples(x_add, y_add)
    t_add = sync() - t0
    t0 = sync()
    draw = gp.sample_at(torch.as_tensor(x_sample, device="cuda")).sample(
        torch.Generator(device="cuda").manual_seed(0))
    t_sample = sync() - t0
    t_total = sync() - t_start
    launches = covariance_cuda.LAUNCHES
    by_shape = dict(covariance_cuda.LAUNCHES_BY_SHAPE)
    # ---- end of the main path

    if launches <= 0:
        fail("the main path never launched the covariance kernel")
    if mean.shape != (m,) or var.shape != (m,) or draw.shape != (m_sample,):
        fail(f"unexpected shapes {tuple(mean.shape)} {tuple(var.shape)} {tuple(draw.shape)}")
    if not (bool(torch.isfinite(mean).all()) and bool(torch.isfinite(var).all())
            and bool(torch.isfinite(draw).all())):
        fail("non-finite predictions or draws")
    if float(var.min()) < -1e-4:
        fail(f"negative predictive variance {float(var.min())}")
    if not lml > lml0:
        fail(f"LML after the fit {lml} does not exceed the heuristic start's {lml0}")
    if gp.num_samples != cap:
        fail(f"add_samples left {gp.num_samples} samples, expected {cap}")
    t = builder.timings
    steps = {
        "heuristic_s": t["heuristic"], "subfit_s": t["subfit"],
        "subfit_iterations": t["subfit_iterations"], "build_factor_s": t["build"],
        "predict_in_batches_s": t_predict, "add_samples_s": t_add,
        "sample_at_s": t_sample, "total_s": t_total,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches": launches, "launches_by_shape": {f"{k[0]}x{k[1]}{' train' if k[2] else ''}": v
                                                    for k, v in by_shape.items()},
        "lml_start": lml0, "lml_fitted": lml,
        "ls": float(gp.kernel.ls), "ampl": float(gp.kernel.ampl), "noise": gp.noise,
        "var_min": float(var.min()), "mean_abs_max": float(mean.abs().max()),
    }
    log(json.dumps({"full_width_steps": steps}))
    fitted = (gp.prior, gp.kernel, gp.noise)
    kernel, noise, n_live, x_pad = state.kernel, state.noise, state.n, state.x
    del gp, state, mean, var, draw, builder
    torch.cuda.empty_cache()

    # ---- the kernel against the plain version on strips of the main-path K
    max_err, worst_excess = 0.0, float("-inf")
    strip = min(4096, cap // 3)
    for r0 in (0, cap // 2, cap - strip):  # the last strip crosses into the dead block
        got = covariance_cuda.covariance(kernel, x_pad[r0:r0 + strip], x_pad, n_live, noise,
                                         train=True, row0=r0)
        want = cov.plain_train_covariance_padded(kernel, x_pad, n_live, noise, rows=(r0, r0 + strip))
        err = float((got - want).abs().max())
        log(f"train strip rows [{r0}, {r0 + strip}): max error {err}")
        max_err = max(max_err, err)
        worst_excess = max(worst_excess, excess(got, want, ATOL_F32, RTOL_F32))
        del got, want
    xq_t = torch.as_tensor(xq, device="cuda")
    got = covariance_cuda.covariance(kernel, x_pad, xq_t, n_live)
    want = cov.plain_cross_covariance_train_padded(kernel, x_pad, n_live, xq_t)
    err = float((got - want).abs().max())
    log(f"cross {cap} x {m}: max error {err}")
    max_err = max(max_err, err)
    worst_excess = max(worst_excess, excess(got, want, ATOL_F32, RTOL_F32))
    del got, want
    if not worst_excess <= 0:
        fail(f"kernel differs from the plain version at full width: max error {max_err} "
             f"beyond atol {ATOL_F32} + rtol {RTOL_F32}")

    # ---- times at the main-path shapes, each beside its bound and its
    # launches on the flow; the Composite tree (the interpreter) for reference
    sub = min(8192, n // 2)
    composite = test_kernels()["Composite"].to(torch.float32, x_pad.device)
    cases = {
        f"train {sub}^2": (kernel, x_pad[:sub], x_pad[:sub], sub, True),
        f"train {cap}^2": (kernel, x_pad, x_pad, n_live, True),
        f"cross {cap} x {m}": (kernel, x_pad, xq_t, n_live, False),
        f"Composite train {cap}^2": (composite, x_pad, x_pad, n_live, True),
    }
    shapes = [shape_time(label, *case, noise, by_shape) for label, case in cases.items()]
    shapes[0]["plain_ms"] = cuda_ms(lambda: cov.plain_train_covariance_padded(kernel, x_pad[:sub], sub, noise))
    shapes[2]["plain_ms"] = cuda_ms(lambda: cov.plain_cross_covariance_train_padded(kernel, x_pad, n_live, xq_t))
    torch.cuda.empty_cache()
    shapes[1]["plain_ms"] = cuda_ms(lambda: cov.plain_train_covariance_padded(kernel, x_pad, n_live, noise),
                                    reps=3)
    torch.cuda.empty_cache()
    # the Composite's plain version holds too many (cap, cap) temporaries to
    # run whole: its time is the sum over 8 row strips
    rows = -(-cap // 8)
    shapes[3]["plain_ms"] = sum(
        cuda_ms(lambda r0=r0: cov.plain_train_covariance_padded(composite, x_pad, n_live, noise,
                                                                rows=(r0, min(r0 + rows, cap))), reps=1)
        for r0 in range(0, cap, rows))
    shapes[3]["plain_note"] = "sum over 8 row strips"
    torch.cuda.empty_cache()
    for entry in shapes:
        entry["flow"] = f"dense, n={n}"
    log(json.dumps({"covariance_tile_times": shapes}))
    main = shapes[1]
    return {
        "name": "covariance_tile",
        "route": "cuda",
        "source": "friedrich_tpu_torch/csrc/covariance.cuh",
        "replaces": "friedrich_tpu/ops/pallas/covariance_pallas.py:105",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": None,
        "shape": f"{main['shape']} d={d} float32, SquaredExp (compiled-in map)",
        "shapes": shapes,
    }, fitted


#: Unit roundoffs: the downdate's forward-error bound is j0 * u * (|L_tail| |L_rows|^T).
UNIT_ROUNDOFF = {"float32": 2.0**-24, "float64": 2.0**-53}


def chunked_product(a, b, dtype, chunk: int = 4096, absolute: bool = False, operand=None):
    """``a @ b^T`` (``|a| @ |b|^T`` with ``absolute``) accumulated in
    ``dtype`` over column chunks, each chunk passed through ``operand`` (if
    given) and cast on its own, so that no copy of a whole (strided) factor
    block is made."""
    import torch

    out = torch.zeros((a.shape[0], b.shape[0]), dtype=dtype, device=a.device)
    for k0 in range(0, a.shape[1], chunk):
        ac, bc = a[:, k0:k0 + chunk], b[:, k0:k0 + chunk]
        if operand is not None:
            ac, bc = operand(ac), operand(bc)
        ac, bc = ac.to(dtype), bc.to(dtype)
        if absolute:
            ac, bc = ac.abs(), bc.abs()
        out.addmm_(ac, bc.mT)
    return out


def abs_product(a, b, chunk: int = 4096):
    """``|a| @ |b|^T`` in float32 (float64 for a float64 factor)."""
    import torch

    dtype = torch.float64 if a.dtype == torch.float64 else torch.float32
    return chunked_product(a, b, dtype, chunk, absolute=True)


def plain_strip_chunked(kernel, x_tail, xj, l_full, n_live: int, noise, j0: int, block: int,
                        precision=None):
    """``ops/panel_fused.plain_panel_strip`` (same arguments) with its
    downdate chunked (:func:`chunked_product`): at full width a bfloat16
    prefix upcast whole would not fit beside the factor. Operands as
    ``ops/panel_fused.downdate_operand`` gives them."""
    import torch

    from friedrich_tpu_torch.ops.covariance import plain_train_covariance_block
    from friedrich_tpu_torch.ops.panel_fused import downdate_operand

    strip = plain_train_covariance_block(kernel, x_tail, xj, n_live, noise, row0=j0, col0=j0)
    if j0 > 0:
        p = l_full[j0:j0 + x_tail.shape[0], :j0]
        strip -= chunked_product(p, p[:block], torch.float32,
                                 operand=lambda t: downdate_operand(t, torch.float32, precision))
    return strip


def strip_excess(got, want, prefix, block: int, atol: float, rtol: float, unit: float,
                 split: float, panel_rows=None) -> float:
    """Largest amount by which a panel strip misses its plain version beyond
    atol + rtol |want| + (C u + split) (|P| |Q|^T), ``P`` the strip's
    (rows, C) prefix (``L[j0:, :j0]`` in the factor) and ``Q`` the panel's
    rows of it, ``P[:block]`` or ``panel_rows``; <= 0 when within.
    ``split``: the float32 kernel's 3xTF32 term
    (``panel_strip_cuda.SPLIT_ERROR``), 0 in float64."""
    kdim = prefix.shape[1]
    if kdim == 0:
        return excess(got, want, atol, rtol)
    rows = prefix[:block] if panel_rows is None else panel_rows[:, :kdim]
    bound = abs_product(prefix, rows).mul_(kdim * unit + split)
    bound.add_(want.abs(), alpha=rtol).add_(atol)
    return float(((got - want).abs() - bound).max())


def check_panels(kernel, x_pad, n_live: int, noise, l_full, widths, where: str,
                 precision=None, end=None) -> float:
    """B2 against its plain version on the first, middle and last panels
    of the factor ``l_full`` (panel widths ``widths``; float32, bfloat16
    for the bf16-prefix instantiation, or float64; ``precision="bf16"`` for
    the single pass), each within :func:`strip_excess`'s tolerance; returns
    the largest error. ``end``: the strips' rows end there (the hybrid
    factorization's leading region, whose panels ``widths`` cover)."""
    import torch

    from friedrich_tpu_torch.ops.cuda import panel_strip_cuda
    from friedrich_tpu_torch.ops.panel_fused import plain_panel_strip

    kind = panel_strip_cuda.variant(x_pad.dtype, l_full.dtype, precision)
    split = panel_strip_cuda.SPLIT_ERROR if kind == "tf32x3" else 0.0
    f64 = kind == "f64"
    atol, rtol, unit = (ATOL_F64, RTOL_F64, UNIT_ROUNDOFF["float64"]) if f64 else (
        ATOL_F32, RTOL_F32, UNIT_ROUNDOFF["float32"])
    starts = np.cumsum((0,) + tuple(widths[:-1]))
    max_err = 0.0
    for p in (0, len(widths) // 2, len(widths) - 1):
        j0, block = int(starts[p]), widths[p]
        args = (kernel, x_pad[j0:end], x_pad[j0:j0 + block], l_full, n_live, noise, j0, block)
        got = panel_strip_cuda.panel_strip(*args, precision=precision, end=end)
        if kind in ("tf32x3", "f64"):
            want = plain_panel_strip(*args, end=end)
        else:
            want = plain_strip_chunked(*args, precision=precision)
        err = float((got - want).abs().max())
        over = strip_excess(got, want, l_full[j0:end, :j0], block, atol, rtol, unit, split)
        log(f"{where}, panel {p} [{j0}, {j0 + block}): max error {err}, excess over its tolerance {over}")
        max_err = max(max_err, err)
        if not over <= 0:
            fail(f"panel-strip kernel differs from the plain version on panel {p} at {where}: "
                 f"max error {err}")
        del got, want
        torch.cuda.empty_cache()
    return max_err


def strip_bound_ms(rest: int, block: int, j0: int, d: int, itemsize: int,
                   downdate_flops: float, prefix_itemsize: int | None = None) -> tuple[float, str]:
    """Least time for one panel strip: the downdate's 2 rest B j0 operations
    at ``downdate_flops`` and (2d + 9) per entry for the map at the CUDA
    cores' rate for the dtype, against the prefix blocks
    (``prefix_itemsize`` bytes an entry, default ``itemsize``), the inputs
    and the strip moved once over HBM. The float32 kernel's downdate is
    three TF32 products: pass TF32_FLOPS / 3 for its tensor-core bound,
    FP32_FLOPS for the SIMT one; the single pass and the bfloat16 prefix
    BF16_FLOPS (one product of bfloat16 operands, exact in float32: the
    least time for the same products); float64 FP64_FLOPS (the tensor
    cores)."""
    map_flops = FP64_SIMT_FLOPS if itemsize == 8 else FP32_FLOPS
    t_ops = (2 * rest * block * j0 / downdate_flops + (2 * d + 9) * rest * block / map_flops) * 1e3
    pitem = itemsize if prefix_itemsize is None else prefix_itemsize
    nbytes = (rest * j0 + block * j0) * pitem + (rest * block + (rest + block) * d) * itemsize
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def profile_factor(kernel, x_pad, n: int, noise, **factor_kw) -> dict:
    """Device time by kernel over one streamed build+factor at the default
    panel width (``torch.profiler``; ``factor_kw`` to
    ``streamed_cholesky_factor``), against its wall-clock time: the
    breakdown of the build, the device's idle share, and each panel-strip
    launch's device milliseconds in launch order."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from friedrich_tpu_torch.ops.streamed import streamed_cholesky_factor

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities):  # the tracer's own start-up, outside the timed run
        torch.zeros(1, device="cuda").add_(1.0)
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        l_mat, ok = streamed_cholesky_factor(kernel, x_pad, n, noise, **factor_kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if not bool(ok):
        fail("the profiled streamed factorization failed")
    del l_mat
    kernels = sorted(
        ((e.key, e.self_device_time_total / 1e6, e.count) for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
        key=lambda r: -r[1],
    )
    busy = busy_s(device_ops(prof))
    if busy <= 0:
        return {"wall_s": wall, "device_time": "not measured (the profiler recorded no device time)"}
    b2 = [r for r in kernels if "panel_strip" in r[0]]
    return {
        "wall_s": wall, "device_busy_s": busy, "idle_share": 1.0 - busy / wall,
        "panel_strip_device_s": sum(r[1] for r in b2), "panel_strip_count": sum(r[2] for r in b2),
        "panel_strip_launch_ms": [e.time_range.elapsed_us() / 1e3 for e in sorted(
            (e for e in prof.events() if e.device_type == DeviceType.CUDA and "panel_strip" in e.name
             and "bf16_rows" not in e.name), key=lambda e: e.time_range.start)],
        "kernels": [{"name": k[:80], "s": t, "share_of_wall": t / wall, "count": c}
                    for k, t, c in kernels[:8]],
    }


def phase_panel_strip_vs_plain() -> None:
    import torch

    from friedrich_tpu_torch.ops.cuda import panel_strip_cuda
    from friedrich_tpu_torch.ops.panel_fused import plain_panel_strip

    log("== phase 5a: panel-strip kernel against its plain version (ragged shapes)")
    rng = np.random.default_rng(8)
    n, noise, d = 937, 0.3, 8
    # capacity 1,000: width 384 at j0 0 and 300, the schedule (300, 500, 200)
    # at 0, 300, 800; capacity 1,001 (not a multiple of 4: the float32
    # kernel's cp.async producer) with the schedule (301, 500, 200) and more
    cases = {1000: ((0, 384), (300, 384), (0, 300), (300, 500), (800, 200)),
             1001: ((0, 384), (301, 500), (801, 200), (500, 501))}
    worst, bound_worst = {}, {}
    for cap, panels in cases.items():
        x_np = rng.normal(size=(cap, d))
        l_np = np.tril(rng.normal(size=(cap, cap)) * 0.1)
        for dtype, (atol, rtol) in ((torch.float32, (ATOL_F32, RTOL_F32)),
                                    (torch.float64, (ATOL_F64, RTOL_F64))):
            tname = str(dtype).split(".")[-1]
            split = panel_strip_cuda.SPLIT_ERROR if dtype == torch.float32 else 0.0
            x = torch.as_tensor(x_np, dtype=dtype, device="cuda")
            for j0, block in panels:
                l_full = torch.as_tensor(l_np, dtype=dtype, device="cuda")
                # right of the factored prefix: NaN, which the kernel must never read
                l_full[:, j0:] = float("nan")
                for name, kern in test_kernels().items():
                    kern = kern.to(dtype, x.device)
                    for method in ("gram", "gram_bf16", "direct"):
                        a, r = (ATOL_F32, RTOL_F32) if method == "gram_bf16" else (atol, rtol)
                        got = panel_strip_cuda.panel_strip(kern, x[j0:], x[j0:j0 + block], l_full, n,
                                                           noise, j0, block, method)
                        want = plain_panel_strip(kern, x[j0:], x[j0:j0 + block], l_full, n, noise, j0,
                                                 block, method)
                        torch.cuda.synchronize()
                        what = f"panel strip {name} {method} {tname} cap={cap} j0={j0} B={block}"
                        if got.shape != want.shape or not bool(torch.isfinite(got).all()):
                            fail(f"{what}: shape or non-finite")
                        over = strip_excess(got, want, l_full[j0:, :j0], block, a, r,
                                            UNIT_ROUNDOFF[tname], split)
                        err = float((got - want).abs().max())
                        if not over <= 0:
                            fail(f"{what}: max error {err} beyond its tolerance by {over}")
                        key = f"{tname} cap {cap}"
                        worst[key] = max(worst.get(key, 0.0), err)
                        bound_worst[key] = max(bound_worst.get(key, float("-inf")), over)
    log(json.dumps({"panel_strip_parity": {
        "max_abs_err": worst, "max_excess_over_tolerance": bound_worst,
        "tolerance": "atol + rtol |plain| + (j0 u + split) (|L_tail| |L_rows|^T); f32 2e-5/2e-5, "
                     f"split {panel_strip_cuda.SPLIT_ERROR}; f64 1e-12/0, split 0",
        "shapes": f"live n {n}, d {d}, (cap, j0, B) in "
                  f"{[(c, j0, b) for c, ps in cases.items() for j0, b in ps]}, NaN right of j0",
        "kernels": list(test_kernels()), "methods": ["gram", "gram_bf16", "direct"]}}))


def phase_streamed_vs_dense(fitted, n: int) -> dict:
    import torch

    import friedrich_tpu_torch as ft
    from friedrich_tpu_torch.ops.partition import DEFAULT_PANEL_TARGET, panel_widths, pick_block
    from friedrich_tpu_torch.ops.streamed import streamed_cholesky_factor

    cap = n + K_ADD
    log(f"== phase 5b: streamed against dense at capacity {cap}, float32, phase 4's fitted model")
    prior, kernel, noise = fitted
    x, y, xq, *_ = bench_data(n)
    out = {}
    for backend in ("dense", "streamed"):
        t0 = sync()
        gp = ft.GaussianProcess.new(prior, kernel, noise, None, x, y, dtype="float32", capacity=cap,
                                    backend=backend, device="cuda")
        out[f"{backend}_build_factor_s"] = sync() - t0
        lml = gp.log_marginal_likelihood()
        mean, var = gp.predict_in_batches(xq, 4096)
        out[backend] = (lml, mean, var)
        state = gp.state
        del gp
        torch.cuda.empty_cache()
    (lml_d, mean_d, var_d), (lml_s, mean_s, var_s) = out.pop("dense"), out.pop("streamed")
    out.update({
        "lml_dense": lml_d, "lml_streamed": lml_s, "lml_rel_diff": abs(lml_s - lml_d) / abs(lml_d),
        "mean_max_abs_diff": float((mean_s - mean_d).abs().max()),
        "var_max_abs_diff": float((var_s - var_d).abs().max()),
        "default_panels": list(panel_widths(cap)), "default_target": DEFAULT_PANEL_TARGET,
    })
    if not out["lml_rel_diff"] <= 1e-4:
        fail(f"streamed LML {lml_s} differs from dense {lml_d} by more than 1e-4 relative")
    if not (out["mean_max_abs_diff"] <= 1e-3 and out["var_max_abs_diff"] <= 1e-3):
        fail(f"streamed predictions differ from dense: mean {out['mean_max_abs_diff']}, "
             f"variance {out['var_max_abs_diff']} (limit 1e-3)")
    sweep = {}
    for target in (1024, 2048, 4096, 8192):
        width = pick_block(cap, target)
        t0 = sync()
        l_mat, ok = streamed_cholesky_factor(state.kernel, state.x, state.n, state.noise, block=width)
        sweep[f"{target}->{width}"] = sync() - t0
        if not bool(ok):
            fail(f"streamed factorization at panel width {width} failed")
        del l_mat
        torch.cuda.empty_cache()
    out["panel_sweep_s"] = sweep
    log(json.dumps({"streamed_vs_dense": out}))
    return out


def phase_streamed_full_width(n: int) -> tuple[dict, tuple, dict, dict]:
    import torch

    import friedrich_tpu_torch as ft
    from friedrich_tpu_torch.models.gp import resolve_backend
    from friedrich_tpu_torch.ops.cuda import covariance_cuda, panel_strip_cuda
    from friedrich_tpu_torch.ops.panel_fused import plain_panel_strip
    from friedrich_tpu_torch.ops.covariance import (
        plain_cross_covariance_train_padded,
        plain_train_covariance_block,
    )
    from friedrich_tpu_torch.ops.partition import panel_widths, pick_block
    from friedrich_tpu_torch.ops.streamed import streamed_cholesky_factor

    cap = n + K_ADD
    log(f"== phase 5c: full width on the streamed backend, n={n}, capacity {cap}, d=8, float32")
    x, y, xq, x_add, y_add, x_sample = bench_data(n)
    f32 = torch.float32
    resolved = {c: resolve_backend("auto", c, f32, torch.device("cuda")) for c in (50_512, 100_512)}
    log(f"backend='auto' resolves to {resolved} (card memory {torch.cuda.get_device_properties(0).total_memory} B)")
    if resolved != {50_512: "dense", 100_512: "streamed"}:
        fail(f"backend='auto' resolves to {resolved}, expected dense at 50,512 and streamed at 100,512")

    xt = torch.as_tensor(x, device="cuda")
    yt = torch.as_tensor(y, device="cuda")
    heur = ft.kernels.Gaussian().heuristic_fit(xt, yt)
    t0 = sync()
    gp0 = ft.GaussianProcess.new(ft.priors.ConstantPrior().fit(xt, yt), heur, 1.0, None, x, y,
                                 dtype="float32", capacity=cap, backend="streamed", device="cuda")
    t_heur_build = sync() - t0
    lml0 = gp0.log_marginal_likelihood()
    log(f"heuristic start: ls={float(heur.ls)} ampl={float(heur.ampl)} LML={lml0} "
        f"(streamed build+factor {t_heur_build} s)")
    del gp0, xt, yt
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # ---- the main path; both kernels' launches are counted over this run only
    covariance_cuda.LAUNCHES = 0
    covariance_cuda.LAUNCHES_BY_SHAPE.clear()
    panel_strip_cuda.LAUNCHES = 0
    t_start = sync()
    builder = (
        ft.GaussianProcessBuilder(x, y, device="cuda")
        .set_noise(1.0).set_dtype("float32").set_capacity(cap).set_backend("streamed")
        .set_fit_subsample(8192).set_fit_parameters(100, 0.05)
        .fit_kernel().fit_prior()
    )
    gp = builder.train()
    lml = gp.log_marginal_likelihood()
    t0 = sync()
    mean, var = gp.predict_in_batches(xq, 4096)
    t_predict = sync() - t0
    t0 = sync()
    gp.add_samples(x_add, y_add)
    t_add = sync() - t0
    t0 = sync()
    draw = gp.sample_at(torch.as_tensor(x_sample, device="cuda")).sample(
        torch.Generator(device="cuda").manual_seed(0))
    t_sample = sync() - t0
    t_total = sync() - t_start
    b1_launches = covariance_cuda.LAUNCHES
    b1_by_shape = dict(covariance_cuda.LAUNCHES_BY_SHAPE)
    b2_launches = panel_strip_cuda.LAUNCHES
    # ---- end of the main path

    peak = torch.cuda.max_memory_allocated()
    two_factors = 2 * cap * cap * 4
    widths = panel_widths(cap, gp.state.block)
    if gp.state.backend != "streamed":
        fail(f"the model's backend is {gp.state.backend!r}, expected 'streamed'")
    if b2_launches != len(widths):
        fail(f"the panel-strip kernel launched {b2_launches} times, expected one per panel ({len(widths)})")
    if b1_launches <= 0:
        fail("the streamed main path never launched the covariance kernel")
    if mean.shape != (M_QUERIES,) or var.shape != (M_QUERIES,) or draw.shape != (M_SAMPLE,):
        fail(f"unexpected shapes {tuple(mean.shape)} {tuple(var.shape)} {tuple(draw.shape)}")
    if not (bool(torch.isfinite(mean).all()) and bool(torch.isfinite(var).all())
            and bool(torch.isfinite(draw).all())):
        fail("non-finite predictions or draws")
    if float(var.min()) < -1e-4:
        fail(f"negative predictive variance {float(var.min())}")
    if not lml > lml0:
        fail(f"LML after the fit {lml} does not exceed the heuristic start's {lml0}")
    if gp.num_samples != cap:
        fail(f"add_samples left {gp.num_samples} samples, expected {cap}")
    if not peak < two_factors:
        fail(f"peak device memory {peak} B is not below two factors ({two_factors} B)")
    t = builder.timings
    steps = {
        "heuristic_s": t["heuristic"], "subfit_s": t["subfit"],
        "subfit_iterations": t["subfit_iterations"], "build_factor_s": t["build"],
        "predict_in_batches_s": t_predict, "add_samples_s": t_add,
        "sample_at_s": t_sample, "total_s": t_total,
        "peak_bytes": peak, "peak_gib": peak / 2**30, "two_factors_bytes": two_factors,
        "panels": list(widths), "panel_strip_launches": b2_launches,
        "covariance_tile_launches": b1_launches, "lml_start": lml0, "lml_fitted": lml,
        "ls": float(gp.kernel.ls), "ampl": float(gp.kernel.ampl), "noise": gp.noise,
        "var_min": float(var.min()), "mean_abs_max": float(mean.abs().max()),
    }
    log(json.dumps({"streamed_full_width_steps": steps}))

    # ---- the kernel against the plain version on three panels of the final
    # factor (the build's prefix, with the appended rows below it)
    fitted = (gp.prior, gp.kernel, gp.noise)
    state = gp.state
    kernel, noise, n_live, x_pad, l_full = state.kernel, state.noise, state.n, state.x, state.l
    del gp, state, mean, var, draw, builder
    torch.cuda.empty_cache()
    b1_cross = shape_time(f"cross {cap} x {M_QUERIES}", kernel, x_pad, torch.as_tensor(xq, device="cuda"),
                          n_live, False, noise, b1_by_shape)
    b1_cross["flow"] = f"streamed, n={n}"
    xq_t = torch.as_tensor(xq, device="cuda")
    b1_cross["plain_ms"] = cuda_ms(lambda: plain_cross_covariance_train_padded(kernel, x_pad, n_live, xq_t))
    del xq_t
    torch.cuda.empty_cache()
    log(json.dumps({"covariance_tile_times": [b1_cross]}))
    max_err = check_panels(kernel, x_pad, n_live, noise, l_full, widths, f"capacity {cap}")
    starts = np.cumsum((0,) + widths[:-1])

    # ---- the middle panel (the widest mid-factor one): the downdate of the
    # kernel and of cuBLAS in float32 against float64, then times
    p = len(widths) // 2
    j0, block = int(starts[p]), widths[p]
    rest = cap - j0
    args = (kernel, x_pad[j0:], x_pad[j0:j0 + block], l_full, n_live, noise, j0, block)
    k_strip = plain_train_covariance_block(kernel, x_pad[j0:], x_pad[j0:j0 + block], n_live, noise,
                                           row0=j0, col0=j0)
    l_tail, l_rows = l_full[j0:, :j0], l_full[j0:j0 + block, :j0]
    ref = l_tail.double() @ l_rows.double().mT
    accuracy = {
        "max_abs_downdate_f64": float(ref.abs().max()),
        "kernel_downdate_err": float((k_strip.double() - panel_strip_cuda.panel_strip(*args).double()
                                      - ref).abs().max()),
        "cublas_f32_downdate_err": float(((l_tail @ l_rows.mT).double() - ref).abs().max()),
    }
    del ref
    torch.cuda.empty_cache()
    log(json.dumps({"middle_panel_downdate_vs_float64": accuracy}))
    # kernel and yardstick in turns: kernel, addmm, kernel, addmm
    times = {"kernel": [], "addmm": []}
    for _ in range(2):
        times["kernel"].append(cuda_ms(lambda: panel_strip_cuda.panel_strip(*args), reps=3))
        times["addmm"].append(cuda_ms(lambda: torch.addmm(k_strip, l_tail, l_rows.mT, alpha=-1), reps=3))
    ms, library_ms = min(times["kernel"]), min(times["addmm"])
    plain_ms = cuda_ms(lambda: plain_panel_strip(*args), reps=3)
    torch.set_float32_matmul_precision("high")  # TF32: one product, less precise; for information
    try:
        library_tf32_ms = cuda_ms(lambda: torch.addmm(k_strip, l_tail, l_rows.mT, alpha=-1), reps=3)
    finally:
        torch.set_float32_matmul_precision("highest")
    del k_strip, l_tail, l_rows, args
    bound, bound_by = strip_bound_ms(rest, block, j0, D, 4, TF32_FLOPS / 3)
    simt_bound, _ = strip_bound_ms(rest, block, j0, D, 4, FP32_FLOPS)
    downdate_ops = 2 * rest * block * j0
    if not ms < library_ms:
        fail(f"the panel-strip kernel ({ms} ms) is not faster than torch.addmm on the downdate alone "
             f"({library_ms} ms)")
    log(f"panel strip [{j0}, {j0 + block}) of {cap}, f32: {ms} ms (runs {times['kernel']}; plain "
        f"{plain_ms} ms; downdate alone as torch.addmm {library_ms} ms (runs {times['addmm']}), in "
        f"TF32 {library_tf32_ms} ms (less precise); tensor-core bound {bound} ms by {bound_by} "
        f"({bound / ms:.3f} of it), SIMT bound {simt_bound} ms; "
        f"{downdate_ops / ms / 1e9} TFLOP/s of downdate)")

    # ---- the panel-width sweep at full width (one factor on the card at a time)
    del l_full
    torch.cuda.empty_cache()
    sweep = {}
    for target in (1024, 2048, 4096, 8192):
        width = pick_block(cap, target)
        t0 = sync()
        l_mat, ok = streamed_cholesky_factor(kernel, x_pad, n_live, noise, block=width)
        sweep[f"{target}->{width}"] = sync() - t0
        if not bool(ok):
            fail(f"streamed factorization at panel width {width} failed")
        del l_mat
        torch.cuda.empty_cache()
    log(json.dumps({"full_width_panel_sweep_s": sweep, "capacity": cap, "n": n_live}))
    profile = profile_factor(kernel, x_pad, n_live, noise)
    log(json.dumps({"full_width_factor_profile": profile}))
    return {
        "name": "panel_strip",
        "route": "cuda",
        "source": "friedrich_tpu_torch/csrc/panel_strip.cu",
        "replaces": "friedrich_tpu/ops/pallas/panel_fused.py:102",
        "launches": b2_launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": library_ms,
        "library_call": "torch.addmm(k_strip, L[j0:, :j0], L[j0:j0+B, :j0].T, alpha=-1) under "
                        "float32 matmul precision 'highest': the downdate alone, without the kernel map",
        "bound": "tensor cores: three TF32 products (3xTF32) at 495 TFLOP/s",
        "simt_bound_ms": simt_bound,
        "library_tf32_ms": library_tf32_ms,
        "build_device_s": profile.get("panel_strip_device_s"),
        "shape": f"panel j0={j0} B={block} of capacity {cap}, rest {rest}, d={D}, float32",
    }, fitted, b1_cross, steps


def phase_refit(fitted, n: int) -> dict:
    import torch

    import friedrich_tpu_torch as ft
    from friedrich_tpu_torch.ops.cuda import panel_strip_cuda
    from friedrich_tpu_torch.ops.partition import panel_widths

    cap = n + K_ADD
    log(f"== phase 5d: prior-only refit of a streamed model at capacity {cap}, float32")
    prior, kernel, noise = fitted
    x, y, *_ = bench_data(n)
    t0 = sync()
    gp = ft.GaussianProcess.new(prior, kernel, noise, None, x, y, dtype="float32", capacity=cap,
                                backend="streamed", device="cuda")
    t_build = sync() - t0
    built = torch.empty((cap, cap), dtype=torch.float32)  # the build's factor, on the host
    chunk = 8192
    for r0 in range(0, cap, chunk):
        built[r0:r0 + chunk].copy_(gp.state.l[r0:r0 + chunk])
    ptr = gp.state.l.data_ptr()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    panel_strip_cuda.LAUNCHES = 0
    t0 = sync()
    gp.fit_parameters(fit_prior=True, fit_kernel=False)
    t_refit = sync() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = panel_strip_cuda.LAUNCHES
    l_new = gp.state.l
    max_diff = max(float((l_new[r0:r0 + chunk] - built[r0:r0 + chunk].cuda()).abs().max())
                   for r0 in range(0, cap, chunk))
    two_factors = 2 * cap * cap * 4
    out = {
        "build_s": t_build, "refit_s": t_refit, "peak_bytes": peak, "peak_gib": peak / 2**30,
        "two_factors_bytes": two_factors, "same_buffer": l_new.data_ptr() == ptr,
        "panel_strip_launches": launches, "max_abs_diff_vs_build": max_diff,
        "lml": gp.log_marginal_likelihood(),
    }
    log(json.dumps({"prior_only_refit": out}))
    if not out["same_buffer"]:
        fail("the prior-only refit did not write into the old factor's buffer")
    if launches != len(panel_widths(cap, gp.state.block)):
        fail(f"the refit launched the panel-strip kernel {launches} times, expected one per panel")
    if not peak < two_factors:
        fail(f"the refit's peak device memory {peak} B is not below two factors ({two_factors} B)")
    if not max_diff == 0.0:
        fail(f"the refit's factor differs from the build's by {max_diff} (K is unchanged)")
    del gp, l_new, built
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def plain_versions():
    """Inside the scope every covariance build and panel strip on the card
    runs its plain PyTorch version instead of its kernel (whose launch
    counts then stay still): the same function with the plain versions, to
    hold a path through the kernels against."""
    import torch

    from friedrich_tpu_torch.ops.covariance import plain_covariance_tile
    from friedrich_tpu_torch.ops.cuda import covariance_cuda, panel_strip_cuda
    from friedrich_tpu_torch.ops.panel_fused import plain_panel_strip

    saved = covariance_cuda.covariance, panel_strip_cuda.panel_strip
    covariance_cuda.covariance, panel_strip_cuda.panel_strip = plain_covariance_tile, plain_panel_strip
    try:
        yield
    finally:
        covariance_cuda.covariance, panel_strip_cuda.panel_strip = saved


def reset_launches() -> None:
    from friedrich_tpu_torch.ops.cuda import covariance_cuda, panel_strip_cuda

    covariance_cuda.LAUNCHES = 0
    covariance_cuda.LAUNCHES_BY_SHAPE.clear()
    panel_strip_cuda.LAUNCHES = 0
    for kind in panel_strip_cuda.LAUNCHES_BY_VARIANT:
        panel_strip_cuda.LAUNCHES_BY_VARIANT[kind] = 0
        panel_strip_cuda.LAUNCHES_TWO_OPERAND[kind] = 0


def read_launches() -> tuple[int, dict, int]:
    from friedrich_tpu_torch.ops.cuda import covariance_cuda, panel_strip_cuda

    return (covariance_cuda.LAUNCHES, dict(covariance_cuda.LAUNCHES_BY_SHAPE),
            panel_strip_cuda.LAUNCHES)


def phase_default_flow(n: int, lml_start: float, lml_5c: float) -> tuple[dict, object, object, dict]:
    """6a: the builder's default flow — phase 5c's chain without a pinned
    sub-fit size, so the sub-fit is ``"auto"`` (max(8192, n // 5) points,
    the Hutchinson gradient above capacity 8,192) — then predict, append and
    sample. Returns its numbers, the model, the sub-fit's model (its
    subset at the fitted hyperparameters) and B1's time at the sub-fit's
    train shape."""
    import torch

    import friedrich_tpu_torch as ft
    from friedrich_tpu_torch.models.optimizer import LARGE_FIT_THRESHOLD, auto_subsample, subset_indices
    from friedrich_tpu_torch.ops.covariance import plain_train_covariance_padded
    from friedrich_tpu_torch.ops.cuda import covariance_cuda
    from friedrich_tpu_torch.ops.partition import panel_widths

    cap = n + K_ADD
    sub = auto_subsample(n)
    log(f"== phase 6a: the builder's default flow, n={n}, capacity {cap}, sub-fit 'auto' "
        f"({sub} points), d=8, float32")
    x, y, xq, x_add, y_add, x_sample = bench_data(n)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # ---- the main path; both kernels' launches are counted over this run only
    reset_launches()
    t_start = sync()
    builder = (
        ft.GaussianProcessBuilder(x, y, device="cuda")
        .set_noise(1.0).set_dtype("float32").set_capacity(cap).set_backend("streamed")
        .set_fit_parameters(100, 0.05).fit_kernel().fit_prior()
    )
    gp = builder.train()
    lml = gp.log_marginal_likelihood()
    t0 = sync()
    mean, var = gp.predict_in_batches(xq, 4096)
    t_predict = sync() - t0
    t0 = sync()
    gp.add_samples(x_add, y_add)
    t_add = sync() - t0
    t0 = sync()
    draw = gp.sample_at(torch.as_tensor(x_sample, device="cuda")).sample(
        torch.Generator(device="cuda").manual_seed(0))
    t_sample = sync() - t0
    t_total = sync() - t_start
    b1_launches, b1_by_shape, b2_launches = read_launches()
    # ---- end of the main path

    peak = torch.cuda.max_memory_allocated()
    two_factors = 2 * cap * cap * 4
    widths = panel_widths(cap, gp.state.block)
    t = builder.timings
    iterations = t.get("subfit_iterations", t.get("fit_iterations"))
    fit_s = t.get("subfit", t.get("fit"))
    steps = {
        "timings": t, "subfit_points": sub,
        "subfit_gradient": "hutchinson" if (sub or cap) > LARGE_FIT_THRESHOLD else "exact",
        "subfit_iterations": iterations, "subfit_s_per_iteration": fit_s / max(iterations, 1),
        "predict_in_batches_s": t_predict, "add_samples_s": t_add, "sample_at_s": t_sample,
        "total_s": t_total, "peak_bytes": peak, "peak_gib": peak / 2**30,
        "two_factors_bytes": two_factors, "panel_strip_launches": b2_launches,
        "covariance_tile_launches": b1_launches,
        "covariance_tile_launches_by_shape": {f"{k[0]}x{k[1]}{' train' if k[2] else ''}": v
                                              for k, v in b1_by_shape.items()},
        "lml_start": lml_start, "lml_fitted": lml, "lml_5c_subfit_8192": lml_5c,
        "ls": float(gp.kernel.ls), "ampl": float(gp.kernel.ampl), "noise": gp.noise,
        "var_min": float(var.min()), "mean_abs_max": float(mean.abs().max()),
    }
    log(json.dumps({"default_flow_steps": steps}))
    if gp.state.backend != "streamed":
        fail(f"the model's backend is {gp.state.backend!r}, expected 'streamed'")
    if b1_launches <= 0 or b2_launches <= 0:
        fail(f"the default flow launched the covariance kernel {b1_launches} times and the "
             f"panel-strip kernel {b2_launches} times; each must run")
    if b2_launches != len(widths):
        fail(f"the panel-strip kernel launched {b2_launches} times, expected one per panel "
             f"of the full-n build ({len(widths)})")
    if mean.shape != (M_QUERIES,) or var.shape != (M_QUERIES,) or draw.shape != (M_SAMPLE,):
        fail(f"unexpected shapes {tuple(mean.shape)} {tuple(var.shape)} {tuple(draw.shape)}")
    if not (bool(torch.isfinite(mean).all()) and bool(torch.isfinite(var).all())
            and bool(torch.isfinite(draw).all())):
        fail("non-finite predictions or draws")
    if float(var.min()) < -1e-4:
        fail(f"negative predictive variance {float(var.min())}")
    if not lml > lml_start:
        fail(f"LML after the default flow's fit {lml} does not exceed the heuristic start's "
             f"{lml_start}")
    if gp.num_samples != cap:
        fail(f"add_samples left {gp.num_samples} samples, expected {cap}")
    if not peak < two_factors:
        fail(f"peak device memory {peak} B is not below two factors ({two_factors} B)")
    del mean, var, draw, builder
    torch.cuda.empty_cache()
    # B1 at the sub-fit's train shape, beside its bound and its launches on the flow
    size = sub or min(n, 8192)
    idx = subset_indices(n, size, 0, "cpu").numpy()
    x_sub = torch.as_tensor(x[idx], device="cuda")
    b1_sub = shape_time(f"train {size}^2", gp.kernel, x_sub, x_sub, size, True, gp.noise, b1_by_shape)
    b1_sub["flow"] = f"default (sub-fit auto), n={n}"
    # ... and against its plain version there
    got = covariance_cuda.covariance(gp.kernel, x_sub, x_sub, size, gp.noise, train=True)
    want = plain_train_covariance_padded(gp.kernel, x_sub, size, gp.noise)
    b1_sub["max_abs_err"] = float((got - want).abs().max())
    over = excess(got, want, ATOL_F32, RTOL_F32)
    del got, want
    log(f"train {size}^2: max error {b1_sub['max_abs_err']}, excess over its tolerance {over}")
    if not over <= 0:
        fail(f"kernel differs from the plain version at the sub-fit's train {size}^2: max error "
             f"{b1_sub['max_abs_err']} beyond atol {ATOL_F32} + rtol {RTOL_F32}")
    b1_sub["plain_ms"] = cuda_ms(lambda: plain_train_covariance_padded(gp.kernel, x_sub, size, gp.noise))
    del x_sub
    torch.cuda.empty_cache()
    log(json.dumps({"covariance_tile_times": [b1_sub]}))
    # the sub-fit's model at its fitted hyperparameters (the builder drops
    # its own), for phases 6c and 6d
    sub_gp = ft.GaussianProcess.new(gp.prior, gp.kernel, gp.noise, None, x[idx], y[idx],
                                    dtype="float32", backend="auto", device="cuda")
    return steps, gp, sub_gp, b1_sub


def phase_full_n_refit(gp) -> dict:
    """6b: two full-n Hutchinson iterations of 6a's model (every rebuild
    writes into the factor's buffer), each timed by part."""
    import torch

    from friedrich_tpu_torch.models import large_fit
    from friedrich_tpu_torch.ops.partition import panel_widths

    cap = gp.state.capacity
    log(f"== phase 6b: full-n Hutchinson refit at capacity {cap}, float32, max_iter=2")
    parts: list[dict] = []

    def timed(name, fn):
        def wrapped(*args, **kwargs):
            t0 = sync()
            out = fn(*args, **kwargs)
            dt = sync() - t0
            if name == "solves":
                parts.append({})
            parts[-1][f"{name}_s"] = dt
            return out
        return wrapped

    saved = large_fit._cho_solve, large_fit.streamed_grad_matvec, large_fit.rebuild_cholesky
    large_fit._cho_solve = timed("solves", saved[0])
    large_fit.streamed_grad_matvec = timed("grad_matvec", saved[1])
    large_fit.rebuild_cholesky = timed("rebuild", saved[2])
    ptr = gp.state.l.data_ptr()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    try:
        t0 = sync()
        gp.fit_parameters(fit_prior=False, fit_kernel=True, max_iter=2)
        total = sync() - t0
    finally:
        large_fit._cho_solve, large_fit.streamed_grad_matvec, large_fit.rebuild_cholesky = saved
    _, _, b2_launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    two_factors = 2 * cap * cap * 4
    rebuilds = sum("rebuild_s" in p for p in parts)
    panels = len(panel_widths(cap, gp.state.block))
    for p in parts:
        p["iteration_s"] = sum(p.values())
    out = {
        "iterations": gp.fit_iterations, "per_iteration": parts, "total_s": total,
        "rebuilds": rebuilds, "panel_strip_launches": b2_launches,
        "panel_strip_launches_per_rebuild": b2_launches / max(rebuilds, 1),
        "same_buffer": gp.state.l.data_ptr() == ptr, "peak_bytes": peak, "peak_gib": peak / 2**30,
        "two_factors_bytes": two_factors, "lml": gp.log_marginal_likelihood(),
        "ls": float(gp.kernel.ls), "ampl": float(gp.kernel.ampl), "noise": gp.noise,
    }
    log(json.dumps({"full_n_refit": out}))
    if gp.fit_iterations != 2 or rebuilds < 1:
        fail(f"the refit ran {gp.fit_iterations} iterations with {rebuilds} rebuilds, expected two "
             f"iterations and at least one rebuild")
    if b2_launches != rebuilds * panels:
        fail(f"the refit launched the panel-strip kernel {b2_launches} times, expected {panels} per "
             f"rebuild")
    if not out["same_buffer"]:
        fail("the refit's rebuilds did not write into the factor's buffer")
    if not peak < two_factors:
        fail(f"the refit's peak device memory {peak} B is not below two factors ({two_factors} B)")
    if not np.isfinite(out["lml"]):
        fail(f"the refit's LML is {out['lml']}")
    return out


#: Densities with the kernels against the same densities with the plain
#: versions, both on the card: float64 at rtol 1e-9 (the kernels differ from
#: their plain versions by rounding only); float32 at rtol 1e-4 on the value
#: and 1e-3 of the largest gradient entry (B2's 3xTF32 products and the
#: float32 factors and solves).
DENSITY_TOL = {"float64": (1e-9, 1e-9), "float32": (1e-4, 1e-3)}


def phase_densities_and_map_fit(sub_gp, fitted_50k, n_50k: int) -> dict:
    """6c: both densities on the card against their plain versions; the
    covariance's forward against its plain version and its backward
    against the analytic gradient; B2 against its plain version on the
    sub-model's streamed factor, then polish_map on 6a's sub-model; fit_map
    on phase 4's model through the streamed density."""
    import torch

    import friedrich_tpu_torch as ft
    from friedrich_tpu_torch.mcmc.logprob import initial_signs, initial_theta, make_hyperparam_logprob
    from friedrich_tpu_torch.models.map_fit import fit_map, polish_map
    from friedrich_tpu_torch.ops import covariance as cov
    from friedrich_tpu_torch.ops.partition import panel_widths
    from friedrich_tpu_torch.ops.streamed import streamed_cholesky_factor

    log("== phase 6c: densities, the covariance's backward and the MAP fits on the card")
    out: dict = {"densities": [], "backward": []}
    rng = np.random.default_rng(11)
    for dtype, backend in itertools.product((torch.float64, torch.float32), ("dense", "streamed")):
        cap = 1024 if backend == "dense" else 4096
        x = rng.normal(size=(cap - 24, D))
        y = np.sin(2.5 * x[:, 0]) + 0.5 * np.cos(2.0 * x[:, 1]) + rng.normal(size=cap - 24)
        gp = ft.GaussianProcess.new(ft.priors.ConstantPrior(c=0.0), ft.kernels.SquaredExp(ls=1.1, ampl=0.9),
                                    1.0, None, x, y, dtype=dtype, capacity=cap, device="cuda")
        theta = initial_theta(gp.state) + 0.05
        logp = make_hyperparam_logprob(gp.state, signs=initial_signs(gp.state), backend=backend)

        def value_and_grad():
            th = theta.clone().requires_grad_(True)
            val = logp(th)
            val.backward()
            return float(val.detach()), th.grad

        reset_launches()
        val, grad = value_and_grad()
        b1, _, b2 = read_launches()
        reset_launches()
        with plain_versions():
            pval, pgrad = value_and_grad()
        if read_launches() != (0, {}, 0):
            fail("a kernel launched inside plain_versions()")
        name = str(dtype).removeprefix("torch.")
        rtol_v, rtol_g = DENSITY_TOL[name]
        entry = {"density": backend, "capacity": cap, "dtype": name, "value": val, "plain_value": pval,
                 "grad": grad.tolist(), "plain_grad": pgrad.tolist(),
                 "value_rel_err": abs(val - pval) / abs(pval),
                 "grad_err_over_max": float((grad - pgrad).abs().max() / pgrad.abs().max()),
                 "covariance_tile_launches": b1, "panel_strip_launches": b2}
        out["densities"].append(entry)
        if (b1 if backend == "dense" else b2) <= 0:
            fail(f"the {backend} density at capacity {cap} did not launch its kernel")
        if not (entry["value_rel_err"] <= rtol_v and entry["grad_err_over_max"] <= rtol_g):
            fail(f"the {backend} density ({name}, capacity {cap}) differs from its plain version: "
                 f"value {val} vs {pval}, gradient {grad.tolist()} vs {pgrad.tolist()}")
        del gp, logp
    # TrainCovarianceFn: its forward (B1) against the plain builder, its
    # backward (autograd through the plain builder) against the analytic
    # gradient; float64 at 1e-10 of the largest entry, float32 at rtol 1e-4
    for dtype, points in itertools.product((torch.float64, torch.float32), (1000, 1001)):
        x = torch.as_tensor(rng.normal(size=(points, D)), dtype=dtype, device="cuda")
        g = torch.as_tensor(rng.normal(size=(points, points)), dtype=dtype, device="cuda")
        n_live = points - 37
        kernel = ft.kernels.SquaredExp(ls=1.1, ampl=0.9).to(dtype, "cuda")
        p = kernel.get_params().clone().requires_grad_(True)
        nz = torch.tensor(0.7, dtype=dtype, device="cuda", requires_grad=True)
        reset_launches()
        k = cov.TrainCovarianceFn.apply(p, nz, kernel, x, n_live, "gram")
        b1, _, _ = read_launches()
        got = torch.cat([gv.reshape(-1) for gv in torch.autograd.grad(torch.sum(g * k), (p, nz))])
        want_p, want_n = cov.analytic_train_covariance_grads(kernel, x, n_live, 0.7, g)
        want = torch.cat([want_p, want_n.reshape(1)])
        name = str(dtype).removeprefix("torch.")
        atol, rtol = (ATOL_F64, RTOL_F64) if dtype == torch.float64 else (ATOL_F32, RTOL_F32)
        forward_over = excess(k.detach(), cov.plain_train_covariance_padded(kernel, x, n_live, 0.7),
                              atol, rtol)
        err = float((got - want).abs().max())
        ok = (err <= 1e-10 * max(1.0, float(want.abs().max())) if dtype == torch.float64
              else bool(torch.allclose(got, want, rtol=1e-4, atol=0)))
        out["backward"].append({"dtype": name, "points": points, "grad": got.tolist(),
                                "analytic_grad": want.tolist(), "max_abs_err": err,
                                "forward_excess": forward_over, "covariance_tile_launches": b1})
        if b1 != 1 or not forward_over <= 0:
            fail(f"TrainCovarianceFn's forward ({name}, {points} points) launched the covariance "
                 f"kernel {b1} times, excess over the plain builder {forward_over}")
        if not ok:
            fail(f"TrainCovarianceFn's backward ({name}, {points} points) differs from the analytic "
                 f"gradient: {got.tolist()} vs {want.tolist()}")
        del x, g, k
    log(json.dumps({"densities_vs_plain": out["densities"], "backward_vs_analytic": out["backward"]}))

    # B2 against its plain version on the panels polish_map factors: the
    # streamed factor of 6a's sub-model
    state = sub_gp.state
    widths = panel_widths(state.capacity)
    l_sub, ok = streamed_cholesky_factor(state.kernel, state.x, state.n, state.noise, block=widths)
    if not bool(ok):
        fail(f"the streamed factorization of the {state.capacity} sub-model failed")
    out["panel_max_abs_err"] = check_panels(state.kernel, state.x, state.n, state.noise, l_sub, widths,
                                            f"the {state.capacity} sub-model's streamed factor")
    del l_sub
    torch.cuda.empty_cache()

    # polish_map on 6a's sub-model (the streamed density above capacity 2,048)
    lml_before = sub_gp.log_marginal_likelihood()
    panels = len(widths)
    reset_launches()
    t0 = sync()
    polished = ft.GaussianProcess(polish_map(state))
    t_polish = sync() - t0
    _, _, b2 = read_launches()
    lml_after = polished.log_marginal_likelihood()
    out["polish"] = {"capacity": state.capacity, "steps": b2 / panels, "seconds": t_polish,
                     "panel_strip_launches": b2, "lml_before": lml_before, "lml_after": lml_after,
                     "kernel_before": [float(v) for v in state.kernel.get_params()],
                     "noise_before": float(state.noise),
                     "kernel_after": [float(v) for v in polished.kernel.get_params()],
                     "noise_after": polished.noise}
    log(json.dumps({"polish_map": out["polish"]}))
    if b2 <= 0:
        fail("polish_map did not launch the panel-strip kernel")
    if not lml_after >= lml_before - 1e-4 * abs(lml_before):
        fail(f"polish_map lowered the sub-model's exact LML from {lml_before} to {lml_after}")
    del polished
    torch.cuda.empty_cache()

    # fit_map on phase 4's model (dense backend, capacity n + 512) through the
    # streamed density: two factors of this size fit the card
    prior, kernel, noise = fitted_50k
    x, y, *_ = bench_data(n_50k)
    gp = ft.GaussianProcess.new(prior, kernel, noise, None, x, y, dtype="float32",
                                capacity=n_50k + K_ADD, device="cuda")
    lml_before = gp.log_marginal_likelihood()
    panels = len(panel_widths(gp.state.capacity))
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = sync()
    gp.fit_map(num_steps=3)
    t_map = sync() - t0
    _, _, b2 = read_launches()
    out["fit_map"] = {"capacity": gp.state.capacity, "steps": b2 / panels, "seconds": t_map,
                      "panel_strip_launches": b2, "lml_before": lml_before,
                      "lml_after": gp.log_marginal_likelihood(),
                      "kernel_after": [float(v) for v in gp.kernel.get_params()], "noise_after": gp.noise,
                      "peak_bytes": torch.cuda.max_memory_allocated()}
    log(json.dumps({"fit_map": out["fit_map"]}))
    if b2 != 3 * panels:
        fail(f"fit_map(num_steps=3) launched the panel-strip kernel {b2} times, expected {3 * panels}")
    if not np.isfinite(out["fit_map"]["lml_after"]):
        fail(f"fit_map ended at a non-finite LML {out['fit_map']['lml_after']}")
    del gp
    torch.cuda.empty_cache()
    return out


def phase_save_load(sub_gp) -> dict:
    """6d: save and load 6a's sub-model; the loaded model's predictions must
    equal the saved one's bit for bit."""
    import tempfile

    import torch

    import friedrich_tpu_torch as ft

    log(f"== phase 6d: save and load of a {sub_gp.state.capacity}-point model on the card")
    xq = torch.as_tensor(bench_data(1)[2], device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/model"
        t0 = sync()
        sub_gp.save(path)
        t_save = sync() - t0
        size = os.path.getsize(f"{path}.npz")
        t0 = sync()
        loaded = ft.GaussianProcess.load(path)
        t_load = sync() - t0
    want = sub_gp.predict_mean_variance(xq)
    got = loaded.predict_mean_variance(xq)
    out = {"bytes": size, "save_s": t_save, "load_s": t_load, "queries": xq.shape[0],
           "device": str(loaded.state.x.device),
           "identical": all(torch.equal(a, b) for a, b in zip(got, want))}
    log(json.dumps({"save_load": out}))
    if loaded.state.x.device.type != "cuda" or not out["identical"]:
        fail("the loaded model's predictions differ from the saved model's")
    return out


# ---------------------------------------------------------------------------
# Phase 7: the hyperparameter samplers on the card
# ---------------------------------------------------------------------------

#: The sampler's data and settings (``scripts/measure.py:474-482``, where
#: the JAX package measured it): d = 4, SquaredExp(ls=1, ampl=1), noise 0.2,
#: zero prior, float32, NUTS ``max_depth=6``, 4 chains.
SAMPLER_D, SAMPLER_CHAINS, SAMPLER_MAX_DEPTH = 4, 4, 6
SAMPLER_WARMUP, SAMPLER_SAMPLES, HMC_LEAPFROG = 100, 100, 16
#: HMC's run is cut to 50 + 50 to hold phase 7 near its time budget: at
#: 100 + 100 it took 74 s (16 evaluations per transition) and its ESS was at
#: the estimator's cap.
HMC_WARMUP, HMC_SAMPLES = 50, 50
#: Hutchinson probes of 7a's streamed density (``num_probes`` of
#: ``sample_hyperparameters``), not the entry point's default of 16 (the JAX
#: package's): with 16 the gradient's trace error at n = 4,096 holds the
#: adapted step at 0.045, the trees at depth 5.1 and split R-hat at 1.14
#: over 100 + 100 transitions; 64 probes cost 6 % more per evaluation and
#: give step 0.37, depth 2.3 and R-hat 1.05 in a third of the time
#: (PERF.md, phase 7).
SAMPLER_PROBES = 64
#: Gates of every sampler run: at most 5 % divergent transitions, split
#: R-hat below 1.1 for each parameter.
MAX_DIVERGENCE_RATE, MAX_RHAT = 0.05, 1.1
#: The predictive on the card against its plain version:
#: ``|got - want| <= atol + rtol |want|``, the mixture and the samples in
#: float32: the kernels' rounding (2e-5 relative at most) passes through a
#: float32 factorization of a 4,096^2 K whose condition number is ~1e4
#: (noise^2 = 0.04 against eigenvalues up to ~n ampl / 4), so 1e-3. The
#: samples also pass through the Cholesky factor of a posterior covariance
#: that is numerically singular in float32 (variances down to ~2e-5; its
#: 1e-10 jitter is below float32's rounding), whose factor is fixed only to
#: ~sqrt(eps) in its null directions: the phase prints each draw's distance
#: from a float64 plain run of the same draws, the card's and the plain
#: version's, to show how far float32 itself is off there.
PREDICTIVE_ATOL, PREDICTIVE_RTOL = 1e-3, 1e-3
#: An extra check in float64, at queries spread by 1.5 so that the
#: posterior covariance factors: float64 rounding (1e-16) amplified by
#: ~1e6 stays within 1e-8.
SAMPLES_ATOL, SAMPLES_RTOL = 1e-8, 1e-8


class CountingDensity:
    """A density that counts its evaluations (each one also gives the
    gradient: the samplers differentiate every evaluation)."""

    def __init__(self, logp):
        self.logp, self.calls = logp, 0

    def __call__(self, theta):
        self.calls += 1
        return self.logp(theta)


def sampler_model(n: int, dtype: str = "float32"):
    """The sampler's GP at ``n`` points (``scripts/measure.py:474-482``):
    x ~ N(0, 1) in 4 dimensions and y = sin(x0) + 0.1 N(0, 1) from
    ``default_rng(0)``, float32 (or ``dtype``), capacity n, on the card."""
    import friedrich_tpu_torch as ft

    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, SAMPLER_D)).astype(np.float32)
    y = np.sin(x[:, 0]) + 0.1 * rng.normal(size=(n,)).astype(np.float32)
    return ft.GaussianProcess.new(ft.priors.ZeroPrior(), ft.kernels.SquaredExp(ls=1.0, ampl=1.0), 0.2,
                                  None, x, y, dtype=dtype, device="cuda")


def eval_seconds(logp, theta, reps: int = 5) -> float:
    """Median wall-clock of one density+gradient evaluation at ``theta``,
    after one warm-up, each ending in a synchronize."""
    from friedrich_tpu_torch.mcmc._adapt import value_and_grad

    val_grad = value_and_grad(logp)
    val_grad(theta)
    times = []
    for _ in range(reps):
        t0 = sync()
        val_grad(theta)
        times.append(sync() - t0)
    return statistics.median(times)


def profile_sampler(sample, logp, res) -> dict:
    """Device time against wall-clock over 5 more transitions per chain of
    a finished run (its adaptation, from its last draws) under
    ``torch.profiler``: the sampler's device idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities):  # the tracer's own start-up, outside the window
        torch.zeros(1, device="cuda").add_(1.0)
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        sample(logp, res.samples[-1], 1, num_samples=5, num_chains=SAMPLER_CHAINS,
               step_size=res.step_size, inv_mass=res.inv_mass)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = busy_s(device_ops(prof))
    if busy <= 0:
        return {"wall_s": wall, "idle_share": "not measured (the profiler recorded no device time)"}
    return {"wall_s": wall, "device_busy_s": busy, "idle_share": 1.0 - busy / wall}


def run_sampler(name: str, sample, logp, theta0, launch_kernel: str, num_warmup: int = SAMPLER_WARMUP,
                num_samples: int = SAMPLER_SAMPLES, settings: dict | None = None,
                **kwargs) -> tuple[dict, object, dict]:
    """One sampler run as the phase's main path: every kernel count set to
    0 just before it and read just after; its gates, then its numbers:
    transitions/s and ESS/s over the whole run (warmup included), depth,
    density evaluations, peak memory and the launches of ``launch_kernel``
    (``"covariance_tile"`` or ``"panel_strip"``). ``settings`` labels the
    run's density. Returns the numbers, the result and the covariance
    kernel's launches by shape."""
    import torch

    from friedrich_tpu_torch.mcmc import ess, rhat

    counted = CountingDensity(logp)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # ---- the main path; the kernels' launches are counted over this run only
    reset_launches()
    t0 = sync()
    res = sample(counted, theta0, 0, num_warmup=num_warmup, num_samples=num_samples,
                 num_chains=SAMPLER_CHAINS, **kwargs)
    wall = sync() - t0
    b1, b1_by_shape, b2 = read_launches()
    # ---- end of the main path
    samples = res.samples.double()
    ess_v, rhat_v = ess(samples), rhat(samples)
    transitions = SAMPLER_CHAINS * (num_warmup + num_samples)
    divergent = getattr(res, "divergent", None)
    depth = getattr(res, "tree_depth", None)
    out = {
        "run": name, **(settings or {}),
        "wall_s": wall, "transitions": transitions, "transitions_per_s": transitions / wall,
        "ess": ess_v.tolist(), "ess_min": float(ess_v.min()), "ess_min_per_s": float(ess_v.min()) / wall,
        "rhat": rhat_v.tolist(), "step_size": float(res.step_size), "inv_mass": res.inv_mass.tolist(),
        "mean_accept": float(res.accept_prob.double().mean()),
        "divergence_rate": None if divergent is None else float(divergent.double().mean()),
        "mean_tree_depth": None if depth is None else float(depth.double().mean()),
        "density_evaluations": counted.calls, "evaluations_per_transition": counted.calls / transitions,
        "posterior_mean": samples.reshape(-1, samples.shape[-1]).mean(0).tolist(),
        "posterior_sd": samples.reshape(-1, samples.shape[-1]).std(0).tolist(),
        "peak_bytes": torch.cuda.max_memory_allocated(),
        "covariance_tile_launches": b1, "panel_strip_launches": b2,
        "covariance_tile_launches_by_shape": {f"{k[0]}x{k[1]}{' train' if k[2] else ''}": v
                                              for k, v in b1_by_shape.items()},
    }
    launches = b1 if launch_kernel == "covariance_tile" else b2
    out[f"{launch_kernel}_launches_per_evaluation"] = launches / counted.calls
    log(json.dumps({"sampler_run": out}))
    if res.samples.device.type != "cuda":
        fail(f"{name}: the draws are on {res.samples.device}, not on the card")
    if not bool(torch.isfinite(res.samples).all()):
        fail(f"{name}: non-finite draws")
    if launches <= 0:
        fail(f"{name}: the {launch_kernel} kernel never launched")
    if divergent is not None and not out["divergence_rate"] <= MAX_DIVERGENCE_RATE:
        fail(f"{name}: divergence rate {out['divergence_rate']} above {MAX_DIVERGENCE_RATE}")
    if not bool((rhat_v < MAX_RHAT).all()):
        fail(f"{name}: split R-hat {rhat_v.tolist()} not below {MAX_RHAT}")
    return out, res, b1_by_shape


def phase_sampler_streamed() -> tuple[dict, object, object]:
    """7a: NUTS on the streamed density (the panel-strip kernel) at
    n = 4,096, capacity 4,096."""
    import inspect

    from friedrich_tpu_torch.mcmc import (
        initial_signs,
        initial_theta,
        make_hyperparam_logprob,
        sample_hyperparameters,
        sample_nuts,
    )
    from friedrich_tpu_torch.mcmc.logprob import STREAMED_LOGPROB_THRESHOLD

    n = 4096
    log(f"== phase 7a: NUTS on the streamed density ({SAMPLER_PROBES} probes), n={n}, capacity {n}, "
        f"d={SAMPLER_D}, float32, {SAMPLER_CHAINS} chains, max_depth {SAMPLER_MAX_DEPTH}, "
        f"{SAMPLER_WARMUP}+{SAMPLER_SAMPLES}")
    gp = sampler_model(n)
    state = gp.state
    if not state.capacity > STREAMED_LOGPROB_THRESHOLD:
        fail(f"capacity {state.capacity} would not take the streamed density")
    # the density of sample_hyperparameters(gp, ..., num_probes=SAMPLER_PROBES)
    logp = make_hyperparam_logprob(state, signs=initial_signs(state), num_probes=SAMPLER_PROBES)
    default = inspect.signature(sample_hyperparameters).parameters["num_probes"].default
    theta0 = initial_theta(state)
    out, res, _ = run_sampler(f"7a NUTS, streamed density, num_probes={SAMPLER_PROBES}", sample_nuts, logp,
                              theta0, "panel_strip", max_depth=SAMPLER_MAX_DEPTH,
                              settings={"num_probes": SAMPLER_PROBES, "num_probes_of_the_entry_point": default})
    out["seconds_per_evaluation"] = eval_seconds(logp, res.samples[-1, 0])
    out["profile"] = profile_sampler(sample_nuts, logp, res)
    log(json.dumps({"sampler_streamed": {k: out[k] for k in ("seconds_per_evaluation", "profile")}}))
    return out, gp, res


def phase_sampler_dense() -> tuple[dict, dict, object, dict]:
    """7b: NUTS, then HMC, on the dense density (the covariance-tile
    kernel) at n = 1,024. Returns both runs' numbers, the model and the
    covariance kernel's launches by shape over both runs."""
    from friedrich_tpu_torch.mcmc import (
        initial_signs,
        initial_theta,
        make_hyperparam_logprob,
        sample_hmc,
        sample_nuts,
    )

    n = 1024
    log(f"== phase 7b: NUTS ({SAMPLER_WARMUP}+{SAMPLER_SAMPLES}) and HMC ({HMC_WARMUP}+{HMC_SAMPLES}) on "
        f"the dense density, n={n}, d={SAMPLER_D}, float32, {SAMPLER_CHAINS} chains")
    gp = sampler_model(n)
    state = gp.state
    logp = make_hyperparam_logprob(state, signs=initial_signs(state))
    theta0 = initial_theta(state)
    nuts, res, by_shape = run_sampler("7b NUTS, dense density", sample_nuts, logp, theta0,
                                      "covariance_tile", max_depth=SAMPLER_MAX_DEPTH)
    nuts["seconds_per_evaluation"] = eval_seconds(logp, res.samples[-1, 0])
    nuts["profile"] = profile_sampler(sample_nuts, logp, res)
    log(json.dumps({"sampler_dense_nuts": {k: nuts[k] for k in ("seconds_per_evaluation", "profile")}}))
    hmc, _, hmc_by_shape = run_sampler("7b HMC, dense density", sample_hmc, logp, theta0,
                                       "covariance_tile", num_warmup=HMC_WARMUP,
                                       num_samples=HMC_SAMPLES, num_leapfrog=HMC_LEAPFROG)
    if not hmc["mean_accept"] > 0.5:
        fail(f"7b HMC: mean acceptance {hmc['mean_accept']} not above 0.5")
    return nuts, hmc, gp, {k: by_shape.get(k, 0) + hmc_by_shape.get(k, 0)
                           for k in {*by_shape, *hmc_by_shape}}


def phase_predictive(gp, res) -> tuple[dict, dict]:
    """7c: ``predictive_mixture`` over 32 of 7a's draws on 1,024 queries and
    ``sample_predictive`` with given indices and normals on 64 of them, both
    on 7a's float32 model, each against the same call with the plain
    versions on the card, and the float32 samples' distance from a float64
    plain run of the same draws. Then ``sample_predictive`` on a float64 copy of the
    model at spread queries against its plain version. Returns the numbers
    and the covariance kernel's launches by shape."""
    import torch

    from friedrich_tpu_torch.mcmc import predictive_mixture, sample_predictive

    log("== phase 7c: the predictive mixture over 32 of 7a's draws, 1,024 queries, and 16 predictive "
        "samples on 64 of them, float32; the same samples in float64 at spread queries")
    rng = np.random.default_rng(1)
    xq = torch.as_tensor(rng.normal(size=(1024, SAMPLER_D)), dtype=torch.float32, device="cuda")
    xq_s = xq[:64]
    xq_far = xq_s.double() * 1.5  # spread out: a posterior covariance that factors in float64
    indices, z = rng.integers(0, res.samples.shape[0] * SAMPLER_CHAINS, size=16), rng.normal(size=(16, 64))
    state, state_f64 = gp.state, sampler_model(gp.state.n, "float64").state

    def run():
        mean, var = predictive_mixture(state, res.samples, xq, max_draws=32, chunk_size=4)
        return (mean, var, sample_predictive(state, res.samples, xq_s, indices=indices, z=z),
                sample_predictive(state_f64, res.samples, xq_far, indices=indices, z=z))

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # ---- the main path; the kernels' launches are counted over this run only
    reset_launches()
    t0 = sync()
    got = run()
    wall = sync() - t0
    b1, b1_by_shape, b2 = read_launches()
    # ---- end of the main path
    peak = torch.cuda.max_memory_allocated()
    reset_launches()
    with plain_versions():
        t0 = sync()
        want = run()
        plain_wall = sync() - t0
        # the float32 samples' draws, plain, in float64
        exact = sample_predictive(state_f64, res.samples, xq_s.double(), indices=indices, z=z)
    if read_launches() != (0, {}, 0):
        fail("a kernel launched inside plain_versions()")
    mean, var, draws, draws_f64 = got
    errors = [float((g - w).abs().max()) for g, w in zip(got, want)]
    from_f64 = (draws.double() - exact).abs().amax(1), (want[2].double() - exact).abs().amax(1)
    excesses = [excess(got[0], want[0], PREDICTIVE_ATOL, PREDICTIVE_RTOL),
                excess(got[1], want[1], PREDICTIVE_ATOL, PREDICTIVE_RTOL),
                excess(got[2], want[2], PREDICTIVE_ATOL, PREDICTIVE_RTOL),
                excess(got[3], want[3], SAMPLES_ATOL, SAMPLES_RTOL)]
    out = {
        "wall_s": wall, "plain_wall_s": plain_wall, "draws": 32, "queries": xq.shape[0],
        "peak_bytes": peak, "covariance_tile_launches": b1, "panel_strip_launches": b2,
        "covariance_tile_launches_by_shape": {f"{k[0]}x{k[1]}{' train' if k[2] else ''}": v
                                              for k, v in b1_by_shape.items()},
        "max_abs_err_vs_plain": {"mean": errors[0], "variance": errors[1], "samples_f32": errors[2],
                                 "samples_f64": errors[3]},
        "samples_f32_vs_float64_per_draw": {"card": from_f64[0].tolist(), "plain": from_f64[1].tolist()},
        "var_min": float(var.min()), "mean_abs_max": float(mean.abs().max()),
        "tolerance": f"mixture and samples (float32) atol {PREDICTIVE_ATOL} + rtol {PREDICTIVE_RTOL}; "
                     f"samples (float64) atol {SAMPLES_ATOL} + rtol {SAMPLES_RTOL}",
    }
    log(json.dumps({"predictive": out}))
    if b1 <= 0:
        fail("the predictive never launched the covariance kernel")
    if mean.shape != (1024,) or draws.shape != (16, 64) or draws_f64.shape != (16, 64):
        fail(f"unexpected shapes {tuple(mean.shape)} {tuple(draws.shape)} {tuple(draws_f64.shape)}")
    if not all(bool(torch.isfinite(t).all()) for t in got):
        fail("non-finite predictive mean, variance or samples")
    if float(var.min()) < -1e-4:
        fail(f"negative predictive variance {float(var.min())}")
    if not max(excesses) <= 0:
        fail(f"the predictive differs from its plain version: max errors {errors}")
    return out, b1_by_shape


def phase_sampler_kernels(gp_7a, res_7a, gp_7b, by_shape: dict, entries) -> None:
    """7d: both kernels at the samplers' shapes against their plain
    versions, with times and bounds: B1 in train mode at 1,024^2 and
    4,096^2 and in cross mode at 4,096 x 1,024 (``by_shape``: the
    launches of phases 7b and 7c by shape); B2 on the panels of 7a's
    density factor at its posterior-mean hyperparameters. Adds the shapes
    to the kernels' entries."""
    import torch

    from friedrich_tpu_torch.mcmc.logprob import initial_signs
    from friedrich_tpu_torch.ops import covariance as cov
    from friedrich_tpu_torch.ops.cuda import covariance_cuda, panel_strip_cuda
    from friedrich_tpu_torch.ops.panel_fused import plain_panel_strip
    from friedrich_tpu_torch.ops.partition import panel_widths
    from friedrich_tpu_torch.ops.streamed import streamed_cholesky_factor

    log("== phase 7d: the kernels at the samplers' shapes against their plain versions")
    entry, streamed_entry = entries
    state = gp_7a.state
    theta = res_7a.samples.reshape(-1, res_7a.samples.shape[-1]).mean(0)
    raw = initial_signs(state) * torch.exp(theta)
    kernel = state.kernel.with_params(raw[:-1]).to(torch.float32, "cpu")
    noise = float(torch.abs(raw[-1]))
    xq = torch.as_tensor(np.random.default_rng(1).normal(size=(1024, SAMPLER_D)), dtype=torch.float32,
                         device="cuda")
    x_7b = gp_7b.state.x
    cases = {
        "train 1024^2": (x_7b, x_7b, gp_7b.state.n, True, "7b"),
        "train 4096^2": (state.x, state.x, state.n, True, "7c"),
        "cross 4096 x 1024": (state.x, xq, state.n, False, "7c"),
    }
    rows = []
    for label, (x1, x2, n, train, flow) in cases.items():
        got = covariance_cuda.covariance(kernel, x1, x2, n, noise if train else 0.0, train=train)
        want = cov.plain_covariance_tile(kernel, x1, x2, n, noise if train else 0.0, train=train)
        over = excess(got, want, ATOL_F32, RTOL_F32)
        err = float((got - want).abs().max())
        del got, want
        if not over <= 0:
            fail(f"the covariance kernel differs from its plain version at {label}: max error {err}")
        row = shape_time(label, kernel, x1, x2, n, train, noise, by_shape[flow])
        row["plain_ms"] = cuda_ms(lambda: cov.plain_covariance_tile(
            kernel, x1, x2, n, noise if train else 0.0, train=train))
        row.update({"max_abs_err": err, "flow": f"sampler phase {flow}"})
        rows.append(row)
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
    log(json.dumps({"covariance_tile_times": rows}))
    entry["shapes"].extend(rows)

    # B2 on the panels of the density's factor at 7a's posterior mean
    widths = panel_widths(state.capacity)
    kernel_dev = kernel.to(torch.float32, "cuda")
    l_full, ok = streamed_cholesky_factor(kernel_dev, state.x, state.n, torch.tensor(noise, device="cuda"))
    if not bool(ok):
        fail("the streamed factorization at 7a's posterior mean failed")
    err = check_panels(kernel_dev, state.x, state.n, noise, l_full, widths,
                       f"7a's density factor (capacity {state.capacity})")
    streamed_entry["max_abs_err"] = max(streamed_entry["max_abs_err"], err)
    j0, block = widths[0], widths[-1]
    rest = state.capacity - j0
    args = (kernel, state.x[j0:], state.x[j0:j0 + block], l_full, state.n, noise, j0, block)
    k_strip = cov.plain_train_covariance_block(kernel, state.x[j0:], state.x[j0:j0 + block], state.n,
                                               noise, row0=j0, col0=j0)
    l_tail, l_rows = l_full[j0:, :j0], l_full[j0:j0 + block, :j0]
    bound, bound_by = strip_bound_ms(rest, block, j0, SAMPLER_D, 4, TF32_FLOPS / 3)
    row = {"shape": f"last panel j0={j0} B={block} of capacity {state.capacity}, d={SAMPLER_D}",
           "ms": cuda_ms(lambda: panel_strip_cuda.panel_strip(*args), reps=10),
           "plain_ms": cuda_ms(lambda: plain_panel_strip(*args), reps=10),
           "library_ms": cuda_ms(lambda: torch.addmm(k_strip, l_tail, l_rows.mT, alpha=-1), reps=10),
           "bound_ms": bound, "bound_by": bound_by, "max_abs_err": err, "flow": "sampler phase 7a",
           "launches_per_evaluation": len(widths)}
    log(json.dumps({"panel_strip_times": [row]}))
    streamed_entry.setdefault("shapes", []).append(row)
    del l_full, k_strip, l_tail, l_rows, args
    torch.cuda.empty_cache()


def phase_sampler_sanity() -> dict:
    """NUTS on a 5-D anisotropic Gaussian (scales 0.01 to 10) on the card,
    no GP: each mean and variance within 5 Monte-Carlo standard errors of
    the analytic one, which separates a sampler fault on the card from a
    density fault."""
    import torch

    from friedrich_tpu_torch.mcmc import ess, sample_nuts

    log("== phase 7 sanity: NUTS on a 5-D anisotropic Gaussian on the card")
    scales = torch.tensor([0.01, 0.1, 1.0, 3.0, 10.0], device="cuda")
    t0 = sync()
    res = sample_nuts(lambda x: -0.5 * torch.sum((x / scales) ** 2), torch.zeros(5, device="cuda"), 3,
                      num_warmup=200, num_samples=300, num_chains=2, max_depth=6)
    wall = sync() - t0
    x = res.samples.double()
    worst = 0.0
    for f, truth in ((x, torch.zeros(5, dtype=torch.float64, device="cuda")),
                     (x * x, (scales.double() ** 2))):
        mcse = f.reshape(-1, 5).std(0) / torch.sqrt(ess(f))
        worst = max(worst, float(((f.reshape(-1, 5).mean(0) - truth).abs() / mcse).max()))
    out = {"wall_s": wall, "worst_error_in_mcse": worst, "step_size": float(res.step_size),
           "mean_tree_depth": float(res.tree_depth.double().mean()), "ess": ess(x).tolist()}
    log(json.dumps({"sampler_sanity": out}))
    if not worst <= 5.0:
        fail(f"NUTS on the anisotropic Gaussian misses an analytic moment by {worst} standard errors")
    return out


# ---------------------------------------------------------------------------
# Phase 8: bf16 factor storage, the factor precision, out-of-core
# ---------------------------------------------------------------------------

#: scripts/check80k.py's configuration (check80k.py:49-57, 62-79): noise
#: 2.0, a 10,000-point sub-fit, 100 iterations at 0.05.
BF16_N, BF16_NOISE, BF16_SUBFIT = 150_000, 2.0, 10_000
#: Tolerance of the bf16 models' predictions against the float32 model's
#: (phase 8b; the JAX package's ladder, tests/test_bf16_storage.py:36-66).
BF16_PREDICT_ATOL = 0.05
#: scripts/check100k_outofcore.py's configuration: SquaredExp(0.5, 1),
#: noise 2.5, panels of 8,192.
OOC_N, OOC_BLOCK, OOC_NOISE, OOC_QUERIES, OOC_F32_N = 100_000, 8192, 2.5, 256, 50_000
#: 8c's out-of-core models against the on-card ones, which differ from them
#: in summation order only. bf16 predictions: the JAX package holds float32
#: out-of-core against in-memory predictions at 2e-4
#: (tests/test_outofcore_gp.py:39-46); a bf16 write-back can turn a
#: summation-order difference into one ulp (2^-8 relative), so 5x that. The
#: float32 factor: the JAX package's own bound (tests/test_outofcore.py:130).
OOC_BF16_ATOL, OOC_F32_ATOL = 1e-3, 5e-5


def bf16_data(n: int):
    """``scripts/check80k.py``'s data at ``n`` points (d=8, seed 0,
    y = sin(2.5 x0) + 0.5 cos(2 x1) + 2 N(0, 1), float32), then 512
    appended points and 64 sample points from the same generator:
    ``(x, y, queries, appended x, appended y, sample points)``."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, D)).astype(np.float32)
    y = (np.sin(2.5 * x[:, 0]) + 0.5 * np.cos(2.0 * x[:, 1])
         + BF16_NOISE * rng.normal(size=n)).astype(np.float32)
    xq = rng.normal(size=(M_QUERIES, D)).astype(np.float32)
    x_add = rng.normal(size=(K_ADD, D)).astype(np.float32)
    y_add = (np.sin(2.5 * x_add[:, 0]) + 0.5 * np.cos(2.0 * x_add[:, 1])
             + BF16_NOISE * rng.normal(size=K_ADD)).astype(np.float32)
    x_sample = rng.normal(size=(M_SAMPLE, D)).astype(np.float32)
    return x, y, xq, x_add, y_add, x_sample


def variant_launches() -> dict:
    from friedrich_tpu_torch.ops.cuda import panel_strip_cuda

    return dict(panel_strip_cuda.LAUNCHES_BY_VARIANT)


def only_variant(launches: dict, kind: str, count: int, what: str) -> None:
    """Fail unless ``count`` launches of instantiation ``kind`` and none of
    any other."""
    want = {k: (count if k == kind else 0) for k in launches}
    if launches != want:
        fail(f"{what}: panel-strip launches {launches}, expected {want}")


def middle_panel_times(kernel, x_pad, n_live, noise, l_full, widths, precision, library_call,
                       flops: float) -> dict:
    """The middle panel: the kernel against its bound, its (chunked) plain
    version and one torch call of the downdate alone (``library_call``:
    ``(k_strip, l_tail, l_rows) -> fn``), in turns; and the downdates'
    errors against float64."""
    import torch

    from friedrich_tpu_torch.ops.covariance import plain_train_covariance_block
    from friedrich_tpu_torch.ops.cuda import panel_strip_cuda
    from friedrich_tpu_torch.ops.panel_fused import downdate_operand

    starts = np.cumsum((0,) + tuple(widths[:-1]))
    p = len(widths) // 2
    j0, block = int(starts[p]), widths[p]
    rest = x_pad.shape[0] - j0
    args = (kernel, x_pad[j0:], x_pad[j0:j0 + block], l_full, n_live, noise, j0, block)
    k_strip = plain_train_covariance_block(kernel, x_pad[j0:], x_pad[j0:j0 + block], n_live, noise,
                                           row0=j0, col0=j0)
    l_tail, l_rows = l_full[j0:, :j0], l_full[j0:j0 + block, :j0]
    op = (lambda t: downdate_operand(t, torch.float32, precision))
    ref = chunked_product(l_tail, l_rows, torch.float64, operand=op)
    fn, library_name = library_call(k_strip, l_tail, l_rows)
    kernel_dd = k_strip.double() - panel_strip_cuda.panel_strip(*args, precision=precision).double()
    accuracy = {"max_abs_downdate_f64": float(ref.abs().max()),
                "kernel_downdate_err": float((kernel_dd - ref).abs().max()),
                "library_downdate_err": float((k_strip.double() - fn().double() - ref).abs().max())}
    del kernel_dd, ref
    torch.cuda.empty_cache()
    times = {"kernel": [], "library": []}
    for _ in range(2):
        times["kernel"].append(cuda_ms(lambda: panel_strip_cuda.panel_strip(*args, precision=precision),
                                       reps=3))
        times["library"].append(cuda_ms(fn, reps=3))
    plain_ms = cuda_ms(lambda: plain_strip_chunked(*args, precision=precision), reps=1)
    pitem = l_full.element_size()
    bound, by = strip_bound_ms(rest, block, j0, x_pad.shape[1], 4, flops, prefix_itemsize=pitem)
    del k_strip, l_tail, l_rows, fn
    torch.cuda.empty_cache()
    return {"shape": f"panel j0={j0} B={block} of capacity {x_pad.shape[0]}, rest {rest}, "
                     f"prefix {l_full.dtype}, precision {precision}",
            "ms": min(times["kernel"]), "kernel_runs_ms": times["kernel"], "plain_ms": plain_ms,
            "library_ms": min(times["library"]), "library_runs_ms": times["library"],
            "library_call": library_name, "bound_ms": bound, "bound_by": by,
            "downdate_tflops": 2 * rest * block * j0 / min(times["kernel"]) / 1e9, **accuracy}


#: Downdate errors against float64 at the middle panels of 8a and 8b that
#: the bf16-product instantiations may not exceed: twice those of their
#: previous design, measured by this script on an NVIDIA H100 80GB HBM3
#: (1.2764e-06 for the bf16 prefix, 1.9955e-06 for the single pass; PERF.md).
DOWNDATE_ERR_LIMIT = {"bf16 prefix": 2 * 1.2764e-06, "single pass": 2 * 1.9955e-06}


def downdate_gate(row: dict, what: str) -> None:
    """Fail if a middle panel's downdate error against float64 exceeds
    ``DOWNDATE_ERR_LIMIT``."""
    limit = DOWNDATE_ERR_LIMIT[what]
    if not row["kernel_downdate_err"] <= limit:
        fail(f"{what}: downdate error against float64 {row['kernel_downdate_err']} above {limit}")


def bf16_library_call(k_strip, l_tail, l_rows):
    """torch's one call of the downdate on the bf16 operands: float32 out
    where this torch has ``out_dtype``, else bf16 out."""
    import torch

    try:
        torch.addmm(k_strip[:8], l_tail[:8], l_rows[:8].mT, alpha=-1, out_dtype=torch.float32)
        return (lambda: torch.addmm(k_strip, l_tail, l_rows.mT, alpha=-1, out_dtype=torch.float32),
                "torch.addmm(k_strip, L[j0:, :j0], L[j0:j0+B, :j0].T, alpha=-1, "
                "out_dtype=torch.float32), bf16 operands")
    except (TypeError, RuntimeError):
        k16 = k_strip.to(torch.bfloat16)
        return (lambda: torch.addmm(k16, l_tail, l_rows.mT, alpha=-1),
                "torch.addmm on bf16 operands and a bf16 strip (this torch has no out_dtype)")


def medium_library_call(k_strip, l_tail, l_rows):
    """torch's one call of the downdate on the float32 operands under the
    float32 matmul precision "medium" (the JAX package's "bf16" mode)."""
    import torch

    def fn():
        torch.set_float32_matmul_precision("medium")
        try:
            return torch.addmm(k_strip, l_tail, l_rows.mT, alpha=-1)
        finally:
            torch.set_float32_matmul_precision("highest")

    return fn, "torch.addmm(k_strip, L[j0:, :j0], L[j0:j0+B, :j0].T, alpha=-1) under 'medium'"


def phase_bf16_storage(n: int) -> tuple[dict, tuple, dict]:
    """8a: the builder's flow with bf16 factor storage at n = 150,000."""
    import torch

    import friedrich_tpu_torch as ft
    from friedrich_tpu_torch.ops.covariance import kernel_diag
    from friedrich_tpu_torch.ops.partition import panel_widths

    cap = n + K_ADD
    card = torch.cuda.get_device_properties(0).total_memory
    log(f"== phase 8a: bf16 factor storage at n={n}, capacity {cap}, d=8, float32 compute "
        f"(scripts/check80k.py's data and flow); a float32 factor {cap * cap * 4} B, two bf16 "
        f"factors {2 * cap * cap * 2} B, card {card} B")
    x, y, xq, x_add, y_add, x_sample = bf16_data(n)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # ---- the main path; the kernels' launches are counted over this run only
    reset_launches()
    t_start = sync()
    builder = (
        ft.GaussianProcessBuilder(x, y, device="cuda")
        .set_noise(BF16_NOISE).set_dtype("float32").set_backend("streamed").set_capacity(cap)
        .set_factor_storage("bf16").set_fit_subsample(BF16_SUBFIT).set_fit_parameters(100, 0.05)
        .fit_kernel().fit_prior()
    )
    gp = builder.train()
    t0 = sync()
    mean, var = gp.predict_in_batches(xq, M_QUERIES)
    t_predict = sync() - t0
    mean_train = np.asarray(gp.predict(x[:512]))
    t0 = sync()
    gp.add_samples(x_add, y_add)
    t_add = sync() - t0
    t0 = sync()
    draw = gp.sample_at(torch.as_tensor(x_sample, device="cuda")).sample(
        torch.Generator(device="cuda").manual_seed(0))
    t_sample = sync() - t0
    t_total = sync() - t_start
    b1_launches, _, _ = read_launches()
    launches = variant_launches()
    # ---- end of the main path
    peak = torch.cuda.max_memory_allocated()
    state = gp.state
    widths = panel_widths(cap, state.block)
    if state.l.dtype != torch.bfloat16 or state.storage != "bf16":
        fail(f"the model's factor is {state.l.dtype}, storage {state.storage!r}")
    kdiag = kernel_diag(gp.kernel, torch.as_tensor(xq, device="cuda"))
    corr = float(np.corrcoef(mean_train, y[:512])[0, 1])
    ampl = float(gp.kernel.ampl)
    f_q = np.sin(2.5 * xq[:, 0]) + 0.5 * np.cos(2.0 * xq[:, 1])
    corr_truth = float(np.corrcoef(mean.cpu().numpy(), f_q)[0, 1])
    t = builder.timings
    steps = {
        "heuristic_s": t["heuristic"], "subfit_s": t["subfit"], "subfit_iterations": t["subfit_iterations"],
        "build_factor_s": t["build"], "predict_in_batches_s": t_predict, "add_samples_s": t_add,
        "sample_at_s": t_sample, "total_s": t_total, "peak_bytes": peak, "peak_gib": peak / 2**30,
        "factor_bytes": cap * cap * 2, "panels": len(widths), "panel_width": widths[0],
        "panel_strip_launches": launches, "covariance_tile_launches": b1_launches,
        "ls": float(gp.kernel.ls), "ampl": ampl, "noise": gp.noise,
        "envelope_n_2^-15_ampl^2": n * 2.0**-15 * ampl * ampl, "noise^2": gp.noise**2,
        "train_corr": corr, "var_min": float(var.min()), "var_max": float(var.max()),
        "rmse_vs_truth": float(np.sqrt(np.mean((mean.cpu().numpy() - f_q) ** 2))),
        "query_mean_truth_corr": corr_truth,
        "lml": gp.log_marginal_likelihood(),
    }
    log(json.dumps({"bf16_storage_steps": steps}))
    # the build and the append's rebuild, each one launch a panel, bf16 only
    only_variant(launches, "bf16", 2 * len(widths), "phase 8a")
    if b1_launches <= 0:
        fail("phase 8a never launched the covariance kernel")
    if not (bool(torch.isfinite(mean).all()) and bool(torch.isfinite(var).all())
            and bool(torch.isfinite(draw).all())):
        fail("phase 8a: non-finite predictions or draws")
    if not (float(var.min()) >= -1e-4 and bool((var <= kdiag + 1e-4).all())):
        fail(f"phase 8a: variances outside [-1e-4, k(x, x)]: [{float(var.min())}, {float(var.max())}]")
    # a calibrated model cannot reach a training-point correlation near
    # check80k's 0.82 here: corr(f, y) = std f / std y = 0.79 / 2.15 = 0.37
    # (PERF.md §6); check80k.py's own gate is 0.1, and the model must
    # have learned f itself
    if not (corr > 0.1 and corr_truth > 0.5):
        fail(f"phase 8a: training-point mean/target correlation {corr} (limit 0.1), query "
             f"mean/noise-free truth correlation {corr_truth} (limit 0.5)")
    if gp.num_samples != cap:
        fail(f"phase 8a: add_samples left {gp.num_samples} samples, expected {cap}")
    fitted = (gp.prior, gp.kernel, gp.noise)
    kernel, noise, n_live, x_pad, l_full = state.kernel, state.noise, state.n, state.x, state.l
    del gp, state, mean, var, draw, builder
    torch.cuda.empty_cache()
    max_err = check_panels(kernel, x_pad, n_live, noise, l_full, widths, f"bf16 factor, capacity {cap}")
    row = middle_panel_times(kernel, x_pad, n_live, noise, l_full, widths, None, bf16_library_call,
                             BF16_FLOPS)
    row["max_abs_err"] = max_err
    log(json.dumps({"panel_strip_bf16_middle_panel": row}))
    downdate_gate(row, "bf16 prefix")
    del l_full
    torch.cuda.empty_cache()
    return {
        "name": "panel_strip_bf16", "route": "cuda",
        "source": "friedrich_tpu_torch/csrc/panel_strip_bf16.cu",
        "replaces": "friedrich_tpu/ops/pallas/panel_fused.py:102",
        "launches": launches["bf16"], "max_abs_err": max_err, "ms": row["ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": row["library_ms"], "library_call": row["library_call"],
        "bound": "tensor cores: one bf16 product at 989 TFLOP/s", "shape": row["shape"],
    }, fitted, steps


def phase_bf16_vs_f32(fitted, n: int) -> dict:
    """8b: float32 storage, bf16 storage and float32 with precision "bf16"
    at capacity n + 512, one after another, with 8a's hyperparameters."""
    import torch

    import friedrich_tpu_torch as ft
    from friedrich_tpu_torch.ops.partition import panel_widths

    cap = n + K_ADD
    log(f"== phase 8b: float32 against bf16 storage and precision 'bf16' at capacity {cap} "
        f"(8a's data and hyperparameters)")
    prior, kernel, noise = fitted
    x, y, xq, *_ = bf16_data(BF16_N)
    x, y = x[:n], y[:n]
    widths = panel_widths(cap)
    out, preds = {}, {}
    entry = None
    for name, kw, kind in (("f32", {}, "tf32x3"), ("bf16_storage", {"storage": "bf16"}, "bf16"),
                           ("f32_precision_bf16", {"precision": "bf16"}, "one_pass")):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = sync()
        gp = ft.GaussianProcess.new(prior, kernel, noise, None, x, y, dtype="float32", capacity=cap,
                                    backend="streamed", device="cuda", **kw)
        build_s = sync() - t0
        launches = variant_launches()
        only_variant(launches, kind, len(widths), f"phase 8b, {name}")
        mean, var = gp.predict_in_batches(xq, M_QUERIES)
        preds[name] = (mean.cpu(), var.cpu())
        out[name] = {"build_factor_s": build_s, "peak_bytes": torch.cuda.max_memory_allocated(),
                     "lml": gp.log_marginal_likelihood(), "launches": launches[kind]}
        if kind == "one_pass":
            st = gp.state
            err = check_panels(st.kernel, st.x, st.n, st.noise, st.l, widths,
                               f"precision 'bf16' factor, capacity {cap}", precision="bf16")
            row = middle_panel_times(st.kernel, st.x, st.n, st.noise, st.l, widths, "bf16",
                                     medium_library_call, BF16_FLOPS)
            row["max_abs_err"] = err
            # printed, not gated: a hand-written kernel slower than the
            # library call stays, with its numbers
            row["ms_over_medium_addmm"] = row["ms"] / row["library_ms"]
            log(json.dumps({"panel_strip_1pass_middle_panel": row}))
            downdate_gate(row, "single pass")
            entry = {
                "name": "panel_strip_1pass", "route": "cuda",
                "source": "friedrich_tpu_torch/csrc/panel_strip_1pass.cu",
                "replaces": "friedrich_tpu/ops/pallas/panel_fused.py:102",
                "launches": launches[kind], "max_abs_err": err, "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": row["library_ms"], "library_call": row["library_call"],
                "bound": "tensor cores: one bf16 product at 989 TFLOP/s", "shape": row["shape"],
            }
            del st
        del gp, mean, var
        torch.cuda.empty_cache()
    m32, v32 = preds["f32"]
    for name in ("bf16_storage", "f32_precision_bf16"):
        m, v = preds[name]
        out[name]["mean_max_abs_diff_vs_f32"] = float((m - m32).abs().max())
        out[name]["var_max_abs_diff_vs_f32"] = float((v - v32).abs().max())
    out["tolerance"] = BF16_PREDICT_ATOL
    log(json.dumps({"bf16_vs_f32": out}))
    for name in ("bf16_storage", "f32_precision_bf16"):
        worst = max(out[name]["mean_max_abs_diff_vs_f32"], out[name]["var_max_abs_diff_vs_f32"])
        if not worst <= BF16_PREDICT_ATOL:
            fail(f"phase 8b: {name} predictions differ from float32 storage by {worst} "
                 f"(limit {BF16_PREDICT_ATOL})")
    return {"entry": entry, "launches_bf16": out["bf16_storage"]["launches"],
            "launches_tf32x3": out["f32"]["launches"]}


def rss_bytes() -> int:
    """This process's resident host memory (page-locked buffers included)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    return -1


def link_rates() -> dict:
    """Host-to-card copy rates of 1 GiB from pageable and from page-locked
    host memory, and the time of page-locking 1 GiB in place
    (``ops/outofcore.host_factor``) beside torch's own ``pin_memory``."""
    import torch

    from friedrich_tpu_torch.ops import outofcore

    nbytes = 1 << 30
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    pageable = torch.ones(nbytes, dtype=torch.uint8)
    t0 = time.perf_counter()
    pinned = outofcore.host_factor(1 << 15, torch.uint8, pinned=True)  # 1 GiB
    pin_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    torch_pinned = torch.zeros(nbytes, dtype=torch.uint8, pin_memory=True)
    torch_pin_s = time.perf_counter() - t0
    del torch_pinned
    out = {"register_1GiB_s": pin_s, "torch_pin_memory_1GiB_s": torch_pin_s}
    for name, src in (("pageable", pageable), ("pinned", pinned.view(-1))):
        dev.copy_(src, non_blocking=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            dev.copy_(src, non_blocking=True)
        torch.cuda.synchronize()
        out[f"h2d_{name}_GBps"] = 3 * nbytes / (time.perf_counter() - t0) / 1e9
    del dev, pageable, pinned
    return out


def ooc_profile(fn) -> dict:
    """Device activity during ``fn()`` (``torch.profiler``): the busy time
    of the copies and of the kernels, how much of the two overlapped, and
    the device's idle share of the wall-clock."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ops = [op for op in device_ops(prof) if op[2] > op[1]]
    copies = [op for op in ops if "memcpy" in op[0].lower()]
    kernels = [op for op in ops if "memcpy" not in op[0].lower()]
    if not ops:
        return {"wall_s": wall, "device_time": "not measured (the profiler recorded no device time)"}
    c, k, both = busy_s(copies), busy_s(kernels), busy_s(ops)
    return {"wall_s": wall, "copy_busy_s": c, "kernel_busy_s": k, "overlap_s": c + k - both,
            "overlap_share_of_copies": (c + k - both) / c if c else None,
            "idle_share": 1.0 - both / wall, "copies": len(copies), "kernels": len(kernels)}


def check_prefix_panels(kernel, x_pad, n_live: int, noise, l_host, block: int, where: str) -> float:
    """B2's explicit-prefix entry, the out-of-core strip, against its plain
    version on the first, middle and last panels of the host factor
    ``l_host`` (panels of ``block``): the prefix is the panel's first chunk
    as the out-of-core loop uploads it, rows j0: of ``L[:, :block]`` (no
    columns for the first panel), each strip within :func:`strip_excess`'s
    tolerance; returns the largest error."""
    import torch

    from friedrich_tpu_torch.ops.cuda import panel_strip_cuda
    from friedrich_tpu_torch.ops.panel_fused import plain_panel_strip

    panels = x_pad.shape[0] // block
    kind = panel_strip_cuda.variant(x_pad.dtype, l_host.dtype)
    split = panel_strip_cuda.SPLIT_ERROR if kind == "tf32x3" else 0.0
    max_err = 0.0
    for p in (0, panels // 2, panels - 1):
        j0 = p * block
        prefix = l_host[j0:, :block if p else 0].contiguous().to("cuda")
        args = (kernel, x_pad[j0:], x_pad[j0:j0 + block], None, n_live, noise, j0, block)
        got = panel_strip_cuda.panel_strip(*args, prefix=prefix)
        want = plain_panel_strip(*args, prefix=prefix)
        err = float((got - want).abs().max())
        over = strip_excess(got, want, prefix, block, ATOL_F32, RTOL_F32, UNIT_ROUNDOFF["float32"], split)
        log(f"{where}, panel {p} [{j0}, {j0 + block}), prefix {tuple(prefix.shape)}: max error {err}, "
            f"excess over its tolerance {over}")
        max_err = max(max_err, err)
        if not over <= 0:
            fail(f"explicit-prefix panel strip differs from the plain version on panel {p} at {where}: "
                 f"max error {err}")
        del got, want, prefix
        torch.cuda.empty_cache()
    return max_err


def phase_outofcore() -> dict:
    """8c: OutOfCoreGP at n = 100,000 with a bf16 host factor, against an
    on-card bf16 model; then a float32 host factor at n = 50,000 against
    the on-card streamed factor, and one fit_generic iteration."""
    import torch

    import friedrich_tpu_torch as ft
    from friedrich_tpu_torch.ops import outofcore
    from friedrich_tpu_torch.ops.partition import pick_block
    from friedrich_tpu_torch.ops.streamed import streamed_cholesky_factor

    log("== phase 8c: OutOfCoreGP (host factor) at n=100,000, bf16, and n=50,000, float32 "
        "(scripts/check100k_outofcore.py's configuration)")
    free = subprocess.run(["free", "-b"], capture_output=True, text=True, timeout=60).stdout
    log("free -b:\n" + free.strip())
    rates = link_rates()
    log(json.dumps({"host_link": rates}))
    n, block = OOC_N, OOC_BLOCK
    cap = -(-n // block) * block
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, D)).astype(np.float32)
    y = (np.sin(x[:, 0]) + OOC_NOISE * rng.normal(size=n)).astype(np.float32)
    xq = rng.normal(size=(OOC_QUERIES, D)).astype(np.float32)
    kern = ft.kernels.SquaredExp(ls=0.5, ampl=1.0)
    prior = ft.priors.ZeroPrior()
    out = {}
    # ---- the main path: the model, its factor and its predictions
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    up0, down0, rss0 = outofcore.TRAFFIC["up"], outofcore.TRAFFIC["down"], rss_bytes()
    t0 = sync()
    gp = ft.OutOfCoreGP(kern, prior, OOC_NOISE, x, y, block=block, capacity=cap, storage="bf16",
                        device="cuda")
    factor_s = sync() - t0
    up, down = outofcore.TRAFFIC["up"] - up0, outofcore.TRAFFIC["down"] - down0
    rss1 = rss_bytes()
    up_predict = outofcore.TRAFFIC["up"]
    t0 = sync()
    mean, var = gp.predict_mean_variance(xq)
    predict_s = sync() - t0
    up_predict = outofcore.TRAFFIC["up"] - up_predict
    launches = variant_launches()
    # ---- end of the main path
    only_variant(launches, "bf16", cap // block, "phase 8c, bf16 host factor")
    # the factor alone: a refactor into the page-locked buffer the model holds
    up1 = outofcore.TRAFFIC["up"]
    t0 = sync()
    gp.set_hyperparameters(noise=OOC_NOISE)
    refactor_s = sync() - t0
    refactor_up = outofcore.TRAFFIC["up"] - up1
    out["bf16_n100k"] = {
        "capacity": cap, "host_factor_bytes": cap * cap * 2, "construct_s": factor_s,
        "refactor_s": refactor_s, "bytes_up": up, "bytes_down": down,
        "link_GBps_refactor": (refactor_up + down) / refactor_s / 1e9,
        "host_alloc_and_pin_s_estimate": factor_s - refactor_s,
        "host_rss_before": rss0, "host_rss_after": rss1, "device_peak_bytes": torch.cuda.max_memory_allocated(),
        "predict_256_s": predict_s, "bytes_up_predict": up_predict,
        "var_min": float(var.min()), "var_max": float(var.max()),
        "lml": gp.log_marginal_likelihood(), "panel_strip_launches": launches["bf16"],
    }
    log(json.dumps({"outofcore_bf16": out["bf16_n100k"]}))
    if not (bool(torch.isfinite(mean).all()) and bool(torch.isfinite(var).all())):
        fail("phase 8c: non-finite out-of-core predictions")
    if not (float(var.min()) >= -1e-2 and float(var.max()) <= 1.0 + 1e-2):
        fail(f"phase 8c: variances outside [-1e-2, 1.01]: [{float(var.min())}, {float(var.max())}]")
    ooc_lml = out["bf16_n100k"]["lml"]
    out["bf16_n100k"]["prefix_max_abs_err"] = check_prefix_panels(
        gp.kernel, gp.x, gp.n, gp.noise, gp.l_host, pick_block(cap, block),
        f"explicit bf16 prefix, out-of-core capacity {cap}")
    del gp
    # the same model on the card (bf16 storage, the streamed backend)
    t0 = sync()
    ref = ft.GaussianProcess.new(prior, kern, OOC_NOISE, None, x, y, dtype="float32", capacity=cap,
                                 backend="streamed", storage="bf16", device="cuda")
    ref_s = sync() - t0
    rmean, rvar = ref.predict_mean_variance(torch.as_tensor(xq, device="cuda"))
    cmp = {"on_card_build_s": ref_s, "mean_max_abs_diff": float((mean - rmean).abs().max()),
           "var_max_abs_diff": float((var - rvar).abs().max()), "tolerance": OOC_BF16_ATOL,
           "lml_on_card": ref.log_marginal_likelihood(), "lml_out_of_core": ooc_lml}
    log(json.dumps({"outofcore_vs_on_card_bf16": cmp}))
    del ref, rmean, rvar, mean, var
    torch.cuda.empty_cache()
    if not max(cmp["mean_max_abs_diff"], cmp["var_max_abs_diff"]) <= OOC_BF16_ATOL:
        fail(f"phase 8c: out-of-core predictions differ from the on-card model's: {cmp}")
    # ---- float32 host factor at n = 50,000
    n2 = OOC_F32_N
    cap2 = n2 + K_ADD
    reset_launches()
    t0 = sync()
    gp2 = ft.OutOfCoreGP(kern, prior, OOC_NOISE, x[:n2], y[:n2], block=block, capacity=cap2,
                         device="cuda")
    factor2_s = sync() - t0
    f32_launches = variant_launches()
    prefix_err = check_prefix_panels(gp2.kernel, gp2.x, gp2.n, gp2.noise, gp2.l_host,
                                     pick_block(cap2, block),
                                     f"explicit float32 prefix, out-of-core capacity {cap2}")
    kern_dev = kern.to(torch.float32, "cuda")
    noise_dev = torch.tensor(OOC_NOISE, device="cuda")
    l_dev, ok = streamed_cholesky_factor(kern_dev, gp2.x, n2, noise_dev)
    if not bool(ok):
        fail("phase 8c: the on-card streamed factor at 50,512 failed")
    worst = 0.0
    for r0 in range(0, cap2, 4096):
        worst = max(worst, float((gp2.l_host[r0:r0 + 4096].to("cuda") - l_dev[r0:r0 + 4096]).abs().max()))
    del l_dev
    torch.cuda.empty_cache()
    profile = ooc_profile(lambda: gp2.set_hyperparameters(noise=OOC_NOISE))
    t0 = sync()
    gp2.fit_generic(max_iter=1, num_probes=8)
    fit_s = sync() - t0
    out["f32_n50k"] = {"capacity": cap2, "factor_s": factor2_s, "max_abs_diff_vs_on_card": worst,
                       "prefix_max_abs_err": prefix_err,
                       "tolerance": OOC_F32_ATOL, "launches": f32_launches, "refactor_profile": profile,
                       "fit_generic_1_iteration_s": fit_s, "noise_after": float(gp2.noise)}
    log(json.dumps({"outofcore_f32": out["f32_n50k"]}))
    del gp2
    if not worst <= OOC_F32_ATOL:
        fail(f"phase 8c: the float32 host factor differs from the on-card one by {worst} "
             f"(limit {OOC_F32_ATOL})")
    return out


#: 8a's fitted SquaredExp and noise (phase 8a's flow on an NVIDIA H100 80GB
#: HBM3), to build 8a's and 8b's factors without running the flow.
FIT_8A = {"ls": 1.1968789100646973, "ampl": 0.5815813541412354, "noise": 1.9908756017684937}
#: Contraction lengths of the explicit-prefix sweep of ``panel_times``, on
#: 8c's middle panel's rows (capacity 106,496 less j0 = 49,152).
SWEEP_KDIMS, SWEEP_ROWS = (512, 1024, 2048, 4096, 8192, 16384, 32768), 57_344
#: Capacities of ``panel_times``'s in-place middle panels beside 8a's and 8b's.
SWEEP_CAPACITIES = (120_512, 130_512, 140_512, 160_512)


def panel_times(errors: bool) -> dict:
    """B2's times on the card, for comparing the ``friedrich_tpu_torch`` this
    script imports (the one beside it) with another checkout's: copy this
    script into the other checkout's root and run both with
    ``--panel-times`` in turns. On prefixes of N(0, 0.01) entries (seed 0)
    and SquaredExp(1, 1) on N(0, 1) inputs (d = 8), median CUDA-event times
    (``cuda_ms``) of: each reduced-precision instantiation's middle panel
    on the main path (the bf16 prefix at j0 = 75,256, B = 1,636 of capacity
    150,512; the single pass and 3xTF32 at j0 = 50,256, B = 1,396 of
    100,512) beside one ``torch.addmm`` of the same downdate, and 8c's
    middle panel (an explicit bf16 prefix 8,192 wide); float64's middle
    panels at 4,096 (j0 = B = 2,048) and 70,512 (j0 = 34,352, B = 1,808)
    beside one float64 ``torch.addmm``, and one float64 streamed build at
    70,512 (phase 10's data) under ``torch.profiler``; every panel of a bf16
    factor at 100,512 (8b's bf16 storage: the kernel alone, panel by
    panel), and of one at 150,512 (8a's); the middle panels of bf16 factors
    at ``SWEEP_CAPACITIES``; the explicit bf16 prefix at ``SWEEP_KDIMS`` on ``SWEEP_ROWS``
    rows, 1,396 and 8,192 columns; and the B2 launches of 8b's real
    bf16-storage build (``bf16_data`` under ``FIT_8A``) under
    ``torch.profiler``, in panel order, beside the build's other kernels.
    With ``errors``, the middle panels' downdate errors against float64 on
    8a's and 8b's real factors, as phase 8 logs them."""
    import torch

    import friedrich_tpu_torch as ft
    from friedrich_tpu_torch.ops.covariance import plain_train_covariance_block
    from friedrich_tpu_torch.ops.cuda import build
    from friedrich_tpu_torch.ops.cuda import panel_strip_cuda as pc
    from friedrich_tpu_torch.ops.panel_fused import downdate_operand
    from friedrich_tpu_torch.ops.partition import panel_widths
    from friedrich_tpu_torch.ops.streamed import streamed_cholesky_factor

    _, report = build.build()
    out = {"package": os.path.dirname(ft.__file__), "card": smi_line(),
           "ptxas_notes": sorted({line.strip() for line in report.splitlines()
                                  if "performance loss" in line.lower()}),
           "ms": {}, "panels_100512_bf16_ms": [], "panels_150512_bf16_ms": [], "explicit_sweep_ms": {}}
    kern = ft.kernels.SquaredExp(ls=1.0, ampl=1.0)
    g = torch.Generator(device="cuda").manual_seed(0)

    def strip(x, lmat, cap, j0, b, **kw):
        return lambda: pc.panel_strip(kern, x[j0:], x[j0:j0 + b], lmat, cap - K_ADD, 1.0, j0, b, **kw)

    for cap, j0, b, dtype, kinds in ((150_512, 75_256, 1636, torch.bfloat16, ("bf16",)),
                                     (100_512, 50_256, 1396, torch.float32, ("one_pass", "tf32x3"))):
        x = torch.randn((cap, D), device="cuda", generator=g)
        lmat = torch.empty((cap, cap), dtype=dtype, device="cuda")
        lmat[j0:, :j0].normal_(0, 0.01, generator=g)
        k_strip = plain_train_covariance_block(kern, x[j0:], x[j0:j0 + b], cap - K_ADD, 1.0,
                                               row0=j0, col0=j0)
        parts = (k_strip, lmat[j0:, :j0], lmat[j0:j0 + b, :j0])
        for kind in kinds:
            precision = "bf16" if kind == "one_pass" else None
            out["ms"][f"{kind}_middle_{cap}"] = cuda_ms(strip(x, lmat, cap, j0, b, precision=precision))
            if kind == "bf16":
                lib, _ = bf16_library_call(*parts)
            elif kind == "one_pass":
                lib, _ = medium_library_call(*parts)
            else:
                lib = (lambda: torch.addmm(parts[0], parts[1], parts[2].mT, alpha=-1))  # noqa: E731
            out["ms"][f"{kind}_middle_{cap}_torch_addmm"] = cuda_ms(lib)
            del lib
        del parts, k_strip, lmat
        torch.cuda.empty_cache()
        del x
        torch.cuda.empty_cache()
    # float64: the middle panels at 4,096 (6c's density factor) and 70,512
    # (phase 10) beside one float64 torch.addmm, then one float64 streamed
    # build at 70,512 on bench.py's data (SquaredExp(1, 1), noise 1)
    kern64 = kern.to(torch.float64, "cpu")
    for cap in (4096, F64_N + K_ADD):
        widths = panel_widths(cap)
        j0, b = int(np.sum(widths[:len(widths) // 2])), widths[len(widths) // 2]
        x = torch.randn((cap, D), device="cuda", generator=g, dtype=torch.float64)
        lmat = torch.empty((cap, cap), dtype=torch.float64, device="cuda")
        lmat[j0:, :j0].normal_(0, 0.01, generator=g)
        k_strip = plain_train_covariance_block(kern64.to(torch.float64, "cuda"), x[j0:], x[j0:j0 + b],
                                               cap - K_ADD, 1.0, row0=j0, col0=j0)
        l_tail, l_rows = lmat[j0:, :j0], lmat[j0:j0 + b, :j0]
        out["ms"][f"f64_middle_{cap}_j0_{j0}_B_{b}"] = cuda_ms(
            lambda: pc.panel_strip(kern64, x[j0:], x[j0:j0 + b], lmat, cap - K_ADD, 1.0, j0, b))
        out["ms"][f"f64_middle_{cap}_torch_addmm"] = cuda_ms(
            lambda: torch.addmm(k_strip, l_tail, l_rows.mT, alpha=-1))
        del k_strip, l_tail, l_rows, lmat, x
        torch.cuda.empty_cache()
    cap = F64_N + K_ADD
    x_pad = torch.zeros((cap, D), dtype=torch.float64, device="cuda")
    x_pad[:F64_N] = torch.as_tensor(bench_data(F64_N)[0], dtype=torch.float64, device="cuda")
    out["build_f64_70512"] = profile_factor(kern64.to(torch.float64, "cuda"), x_pad, F64_N, 1.0)
    del x_pad
    torch.cuda.empty_cache()
    # every panel of a bf16 factor in place at 8b's and 8a's capacities
    for cap in (100_512, 150_512):
        x = torch.randn((cap, D), device="cuda", generator=g)
        lmat = torch.empty((cap, cap), dtype=torch.bfloat16, device="cuda")
        lmat.normal_(0, 0.01, generator=g)
        starts = np.cumsum((0,) + tuple(panel_widths(cap)[:-1]))
        for j0, b in zip(starts.tolist(), panel_widths(cap)):
            out[f"panels_{cap}_bf16_ms"].append([j0, b, cuda_ms(strip(x, lmat, cap, j0, b), reps=3)])
        del lmat, x
        torch.cuda.empty_cache()
    # the middle panel of a bf16 factor in place at other capacities
    for cap in SWEEP_CAPACITIES:
        widths = panel_widths(cap)
        j0, b = int(np.sum(widths[:len(widths) // 2])), widths[len(widths) // 2]
        x = torch.randn((cap, D), device="cuda", generator=g)
        lmat = torch.empty((cap, cap), dtype=torch.bfloat16, device="cuda")
        lmat[j0:, :j0].normal_(0, 0.01, generator=g)
        out["ms"][f"bf16_middle_{cap}_j0_{j0}_B_{b}"] = cuda_ms(strip(x, lmat, cap, j0, b))
        del lmat, x
        torch.cuda.empty_cache()
    # explicit bfloat16 prefixes: 8c's middle panel, then the sweep
    cap, block = 106_496, OOC_BLOCK
    j0 = cap - SWEEP_ROWS
    x = torch.randn((cap, D), device="cuda", generator=g)
    for width, cols in [(block, block)] + [(k, c) for c in (1396, block) for k in SWEEP_KDIMS]:
        prefix = (torch.randn((SWEEP_ROWS, width), device="cuda", generator=g) * 0.01).to(torch.bfloat16)
        ms = cuda_ms(strip(x, None, cap, j0, cols, prefix=prefix))
        out["explicit_sweep_ms"][f"rows{SWEEP_ROWS}_cols{cols}_k{width}"] = ms
        del prefix
    del x
    torch.cuda.empty_cache()
    # 8b's bf16-storage build, kernel by kernel
    cap = 100_000 + K_ADD
    fit = ft.kernels.SquaredExp(ls=FIT_8A["ls"], ampl=FIT_8A["ampl"]).to(torch.float32, "cuda")
    x_pad = torch.zeros((cap, D), device="cuda")
    x_pad[:100_000] = torch.as_tensor(bf16_data(100_000)[0], device="cuda")
    out["build_8b_bf16"] = profile_factor(fit, x_pad, 100_000, FIT_8A["noise"], storage="bf16")
    del x_pad
    torch.cuda.empty_cache()
    log(json.dumps(out))
    if not errors:
        return out
    # the middle panels' downdate errors against float64 on 8a's and 8b's factors
    x_np = bf16_data(BF16_N)[0]
    for cap, n, kw in ((BF16_N + K_ADD, BF16_N, {"storage": "bf16"}),
                       (100_000 + K_ADD, 100_000, {"precision": "bf16"})):
        x_pad = torch.zeros((cap, D), device="cuda")
        x_pad[:n] = torch.as_tensor(x_np[:n], device="cuda")
        l_full, ok = streamed_cholesky_factor(fit, x_pad, n, FIT_8A["noise"], **kw)
        if not bool(ok):
            fail(f"--panel-times: the factor at {cap} failed")
        widths = panel_widths(cap)
        p = len(widths) // 2
        j0, b = int(np.sum(widths[:p])), widths[p]
        precision = kw.get("precision")
        k_strip = plain_train_covariance_block(fit, x_pad[j0:], x_pad[j0:j0 + b], n, FIT_8A["noise"],
                                               row0=j0, col0=j0).double()
        op = (lambda t: downdate_operand(t, torch.float32, precision))  # noqa: E731
        ref = chunked_product(l_full[j0:, :j0], l_full[j0:j0 + b, :j0], torch.float64, operand=op)
        got = pc.panel_strip(fit, x_pad[j0:], x_pad[j0:j0 + b], l_full, n, FIT_8A["noise"], j0, b,
                             precision=precision)
        kind = pc.variant(torch.float32, l_full.dtype, precision)
        out[f"downdate_err_{kind}_{cap}"] = float((k_strip - got.double() - ref).abs().max())
        out[f"max_abs_downdate_{kind}_{cap}"] = float(ref.abs().max())
        del l_full, ref, k_strip, got, x_pad
        torch.cuda.empty_cache()
    log(json.dumps({k: v for k, v in out.items() if k.startswith(("downdate_err", "max_abs_downdate"))}))
    return out


# ---------------------------------------------------------------------------
# Phase 9: the tiled and hybrid backends at n = 100,000, and serving
# ---------------------------------------------------------------------------

#: Peak device memory of a tiled or hybrid build at full width, in factors
#: (a float32 factor at capacity 100,512 is 40.4 GB): K becomes L in place.
PEAK_FACTORS_9 = 1.15
#: 9c: client threads, requests each, the most rows a request has.
SERVE_CLIENTS, SERVE_REQUESTS, SERVE_MAX_ROWS = 4, 8, 1024
#: 9c: the server's solve width (``AcceleratedGPServer``'s default).
SERVE_BLOCK = 256
#: 9c: each reply against the in-process prediction of its rows at the
#: server's solve width (tests/test_serving.py:134-135); 9d: the daemon's float64 against the
#: card's float32 (tests/test_serving.py:54-55).
SERVE_ATOL, DAEMON_ATOL = 1e-5, 5e-4
#: 9d: the daemon's model (the first 8,192 points, a 537 MB bundle), its
#: queries, and the connections they are sent on at once: the daemon runs a
#: thread per connection, and one request's two triangular solves (2 x
#: 8,192^2 x rows operations) run on one core.
DAEMON_N, DAEMON_QUERIES, DAEMON_CONNECTIONS = 8192, 256, 8
#: The float64 mean witness of 9a and 9b: rows of K in float64 per strip
#: (3.2 GB at capacity 100,512), refinement steps at most, and the largest
#: change of the mean in its last step that counts as converged.
WITNESS_STRIP, WITNESS_STEPS, WITNESS_CHANGE = 4096, 10, 1e-6
#: 9e: points of the float64 dense witness (a float64 factor at 50,512 is 20.4 GB).
WITNESS_N = 50_000
#: Prefixes of the named scopes (``utils/profiling.scope``) phase 9 splits the device time by.
SCOPE_PREFIXES = ("gp/", "tiled/", "hybrid/", "fit/", "serving/")


def profiled(fn):
    """``fn()`` under a ``torch.profiler`` trace (``utils/profiling``'s
    ``start_trace`` and ``stop_trace``, written to a temporary directory):
    its result and its wall-clock seconds, the device time of each named
    scope (``device_s``: its range on the device's timeline) and of each
    kernel, and the device's idle share."""
    import shutil
    import tempfile

    import torch
    from torch.autograd import DeviceType

    from friedrich_tpu_torch.utils import profiling

    tmp = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    try:
        profiling.start_trace(tmp)  # the tracer's own start-up, outside the timed run
        torch.zeros(1, device="cuda").add_(1.0)
        profiling.stop_trace()
        profiling.start_trace(tmp)
        t0 = sync()
        out = fn()
        wall = sync() - t0
        prof = profiling.stop_trace()
        trace_bytes = os.path.getsize(os.path.join(tmp, "trace.json"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    scopes: dict = {}
    kernels = []
    for e in prof.key_averages():
        if e.key.startswith(SCOPE_PREFIXES):
            # the range on the device's timeline (the host-side range's
            # device total counts a kernel once per enclosing operator)
            if e.device_type == DeviceType.CUDA:
                scopes[e.key] = {"device_s": e.self_device_time_total / 1e6, "count": e.count}
        elif e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            kernels.append((e.key, e.self_device_time_total / 1e6, e.count))
    kernels.sort(key=lambda r: -r[1])
    busy = busy_s(device_ops(prof))
    breakdown = {"wall_s": wall, "trace_bytes": trace_bytes, "scopes": scopes,
                 "kernels": [{"name": k[:80], "s": t, "share_of_wall": t / wall, "count": c}
                             for k, t, c in kernels[:10]]}
    if busy > 0:
        breakdown.update(device_busy_s=busy, idle_share=1.0 - busy / wall)
    else:
        breakdown["device_time"] = "not measured (the profiler recorded no device time)"
    return out, breakdown


def phase9_build(backend: str, fitted, x, y, cap: int, dtype: str = "float32"):
    """The builder at 6a's fitted hyperparameters on ``backend``: one build
    and factor, no fit."""
    import friedrich_tpu_torch as ft

    prior, kernel, noise = fitted
    return (ft.GaussianProcessBuilder(x, y, device="cuda").set_dtype(dtype).set_capacity(cap)
            .set_kernel(kernel).set_prior(prior).set_noise(float(noise)).set_backend(backend).train())


def phase9_reference(fitted, n: int) -> tuple:
    """The streamed model's predictions at 9's 4,096 queries and 6a's fitted
    hyperparameters, in one solve and, third, the means at the server's
    solve width: what the tiled and hybrid models are held to."""
    import torch

    x, y, xq = bench_data(n)[:3]
    log(f"== phase 9: the streamed model at capacity {n + K_ADD} (the tiled and hybrid models' reference)")
    t0 = sync()
    gp = phase9_build("streamed", fitted, x, y, n + K_ADD)
    build_s = sync() - t0
    mean, var = gp.predict_mean_variance(xq)
    mean_block = gp.predict_mean_variance(xq, block=SERVE_BLOCK)[0]
    del gp
    torch.cuda.empty_cache()
    log(json.dumps({"phase_9_streamed_reference": {"build_s": build_s}}))
    return mean, var, mean_block


def float64_mean_witness(state, y, n: int, xq) -> tuple[np.ndarray, dict]:
    """The posterior mean at ``xq`` of the model ``state`` holds, solved in
    float64: ``K alpha = y - prior(x)`` by iterative refinement, each
    correction solved with the model's own float32 factor and each residual
    computed in float64 by the covariance kernel's float64 instantiation in
    row strips of K (K in float64 does not fit the card at capacity
    100,512: 80.8 GB). Returns the mean and, for each step, the relative
    residual and the largest change of the mean."""
    import torch

    from friedrich_tpu_torch.ops.cholesky import cho_solve
    from friedrich_tpu_torch.ops.covariance import covariance_tile, cross_covariance_train_padded

    cap, dev = state.capacity, state.x.device
    kern = state.kernel.to(torch.float64, "cpu")
    x, noise = state.x.double(), float(state.noise)
    y64 = torch.zeros(cap, dtype=torch.float64, device=dev)
    y64[:n] = torch.as_tensor(y[:n], dtype=torch.float64, device=dev)
    r = torch.where(torch.arange(cap, device=dev) < n, y64 - state.prior.mean(x), 0.0)

    def residual(alpha):
        out = r.clone()
        for r0 in range(0, cap, WITNESS_STRIP):
            strip = covariance_tile(kern, x[r0:r0 + WITNESS_STRIP], x, n, noise, train=True,
                                    method=state.method, row0=r0)
            out[r0:r0 + WITNESS_STRIP] -= strip @ alpha
            del strip
        return out

    xq64 = torch.as_tensor(xq, dtype=torch.float64, device=dev)
    cross = cross_covariance_train_padded(kern, x, n, xq64, method=state.method)
    prior_q = state.prior.mean(xq64)
    alpha = cho_solve(state.l, r.float()).double()
    mean = prior_q + cross.mT @ alpha
    history = {"relative_residual": [], "mean_change": []}
    for _ in range(WITNESS_STEPS):
        res = residual(alpha)
        history["relative_residual"].append(float(res.norm() / r.norm()))
        alpha += cho_solve(state.l, res.float()).double()
        new = prior_q + cross.mT @ alpha
        history["mean_change"].append(float((new - mean).abs().max()))
        mean = new
        if history["mean_change"][-1] < 1e-12:
            break
    del cross, alpha, r
    torch.cuda.empty_cache()
    return mean.cpu().numpy(), history


def phase_tiled_hybrid(backend: str, fitted, n: int, ref, witness=None) -> tuple[dict, object]:
    """9a (``"tiled"``) and 9b (``"hybrid"``, levels 1): build and factor
    at capacity n + 512 through the builder, then 4,096 predictions, under
    ``torch.profiler``, with both kernels' launches counted over that run;
    gated against the float64 mean of the same model (:func:`float64_mean_witness`
    with 9a's factor; ``witness``: 9a's, passed to 9b), the streamed
    model's variances and the peak. 9b then
    holds B2 against its plain version on three panels of the leading
    region (rows ending at h) and B1 on the first S22 strip."""
    import torch

    from friedrich_tpu_torch.ops.covariance import plain_train_covariance_block
    from friedrich_tpu_torch.ops.cuda import covariance_cuda
    from friedrich_tpu_torch.ops.partition import pick_block

    label = {"tiled": "9a", "hybrid": "9b"}[backend]
    cap = n + K_ADD
    log(f"== phase {label}: backend={backend!r}, n={n}, capacity {cap}, float32, 6a's fitted "
        f"hyperparameters; 4,096 predictions")
    x, y, xq = bench_data(n)[:3]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    def main_path():
        t0 = sync()
        gp = phase9_build(backend, fitted, x, y, cap)
        build_s = sync() - t0
        t0 = sync()
        mean, var = gp.predict_mean_variance(xq)
        return gp, mean, var, build_s, sync() - t0

    # ---- the main path; both kernels' launches are counted over this run only
    reset_launches()
    (gp, mean, var, build_s, predict_s), profile = profiled(main_path)
    b1, b1_by_shape, b2 = read_launches()
    by_variant = variant_launches()
    # ---- end of the main path
    peak = torch.cuda.max_memory_allocated()
    factor_bytes = cap * cap * 4
    ref_mean, ref_var, ref_mean_block = ref
    if witness is None:
        t0 = sync()
        w_mean, history = float64_mean_witness(gp.state, y, n, xq)
        witness = {"mean": w_mean, "history": history, "seconds": sync() - t0,
                   "streamed_mean_err": float(np.abs(ref_mean - w_mean).max()),
                   "streamed_block_mean_err": float(np.abs(ref_mean_block - w_mean).max())}
        log(json.dumps({"phase_9_float64_mean_witness": {k: v for k, v in witness.items() if k != "mean"}}))
        if not witness["history"]["mean_change"][-1] < WITNESS_CHANGE:
            fail(f"phase {label}: the float64 witness did not converge: {history}")
    mean_block = gp.predict_mean_variance(xq, block=SERVE_BLOCK)[0]
    steps = {
        "witness": witness, "mean_max_abs_err_vs_float64": float(np.abs(mean - witness["mean"]).max()),
        "streamed_mean_max_abs_err_vs_float64": witness["streamed_mean_err"],
        "block_mean_max_abs_err_vs_float64": float(np.abs(mean_block - witness["mean"]).max()),
        "streamed_block_mean_max_abs_err_vs_float64": witness["streamed_block_mean_err"],
        "backend": gp.state.backend, "capacity": cap, "build_s": build_s, "predict_4096_s": predict_s,
        "profile": profile, "covariance_tile_launches": b1,
        "covariance_tile_launches_by_shape": {f"{k[0]}x{k[1]}{' train' if k[2] else ''}": v
                                              for k, v in b1_by_shape.items()},
        "panel_strip_launches": b2, "panel_strip_launches_by_variant": by_variant,
        "b1_by_shape": b1_by_shape,
        "peak_bytes": peak, "peak_factors": peak / factor_bytes,
        "mean_max_abs_diff_vs_streamed": float(np.abs(mean - ref_mean).max()),
        "var_max_abs_diff_vs_streamed": float(np.abs(var - ref_var).max()),
        "var_min": float(var.min()),
    }
    log(json.dumps({f"phase_{label}": {k: v for k, v in steps.items() if k not in ("b1_by_shape", "witness")}}))
    if gp.state.backend != backend:
        fail(f"phase {label}: the model's backend is {gp.state.backend!r}")
    if mean.shape != (M_QUERIES,) or not (np.isfinite(mean).all() and np.isfinite(var).all()):
        fail(f"phase {label}: predictions of shape {mean.shape} or not finite")
    if steps["var_min"] < -1e-4:
        fail(f"phase {label}: negative predictive variance {steps['var_min']}")
    for kind in ("", "block_"):
        err, streamed_err = steps[f"{kind}mean_max_abs_err_vs_float64"], steps[
            f"streamed_{kind}mean_max_abs_err_vs_float64"]
        if not err <= streamed_err + 1e-3:
            fail(f"phase {label}: the {kind or 'one-solve '}mean is {err} from the float64 witness, the streamed "
                 f"model's {streamed_err} (limit: the streamed model's + 1e-3)")
    if not steps["var_max_abs_diff_vs_streamed"] <= 1e-3:
        fail(f"phase {label}: variances differ from the streamed model's by "
             f"{steps['var_max_abs_diff_vs_streamed']} (limit 1e-3)")
    if not peak < PEAK_FACTORS_9 * factor_bytes:
        fail(f"phase {label}: peak device memory {peak} B is not below {PEAK_FACTORS_9} factors")
    if b1 <= 0:
        fail(f"phase {label}: the covariance kernel did not launch")
    if backend == "tiled":
        if b2 != 0:
            fail(f"phase 9a: the tiled build launched the panel-strip kernel {b2} times")
        return steps, gp
    b = pick_block(cap // 2, 2048)
    h = cap // 2
    if b2 <= 0:
        fail("phase 9b: the hybrid build did not launch the panel-strip kernel")
    only_variant(by_variant, "tf32x3", b2, "phase 9b, the hybrid leaf")
    state = gp.state
    steps["leaf_panel_max_abs_err"] = check_panels(state.kernel, state.x, n, state.noise, state.l,
                                                   (b,) * (h // b), "phase 9b leaf", end=h)
    # B1 on the first S22 strip: train mode shifted to the strip's diagonal
    xs, xc = state.x[h:], state.x[h:h + b]
    got = covariance_cuda.covariance(state.kernel, xs, xc, max(n - h, 0), state.noise, train=True)
    want = plain_train_covariance_block(state.kernel, xs, xc, n, state.noise, row0=h, col0=h)
    err, over = float((got - want).abs().max()), excess(got, want, ATOL_F32, RTOL_F32)
    del got, want
    log(f"phase 9b, first S22 strip {cap - h} x {b}: max error {err}, excess over its tolerance {over}")
    if not over <= 0:
        fail(f"phase 9b: the covariance kernel differs from its plain version on the S22 strip: {err}")
    s22 = shape_time(f"train S22 strip {cap - h} x {b} (9b)", state.kernel, xs, xc, max(n - h, 0), True,
                     state.noise, b1_by_shape)
    s22["plain_ms"] = cuda_ms(lambda: plain_train_covariance_block(state.kernel, xs, xc, n, state.noise,
                                                                   row0=h, col0=h))
    s22["max_abs_err"] = err
    steps["b1_s22"] = s22
    log(json.dumps({"covariance_tile_times": [s22]}))
    steps["downdate_forms"] = downdate_forms(state, n, h, b)
    return steps, gp


def downdate_forms(state, n: int, h: int, b: int) -> dict:
    """Hybrid's two downdates at their deepest strips, L21's last
    (``K21[:, j] - L21[:, :j0] L11[j, :j0]^T``, j0 = h - b) and S22's first
    (``K22[:, :b] - L21 L21[:b]^T``), from the finished factor's own rows,
    in float32 as one product and as one product per panel of L (as
    ``ops/hybrid`` does), each against the same downdate in float64: the
    largest error of each form, beside the largest entry."""
    import torch

    from friedrich_tpu_torch.ops.covariance import covariance_tile

    l_full, x_pad, cap = state.l, state.x, state.capacity
    j0 = h - b
    k21 = covariance_tile(state.kernel, x_pad[h:], x_pad[j0:h], n, method=state.method, row0=h)
    k22 = covariance_tile(state.kernel, x_pad[h:], x_pad[h:h + b], max(n - h, 0), state.noise, train=True,
                          method=state.method)
    out = {}
    for name, k, a, r in (("l21_last", k21, l_full[h:cap, :j0], l_full[j0:h, :j0]),
                          ("s22_first", k22, l_full[h:cap, :h], l_full[h:h + b, :h])):
        exact = k.double() - chunked_product(a, r, torch.float64)
        one = torch.addmm(k, a, r.mT, alpha=-1)
        panels = k.clone()
        for k0 in range(0, a.shape[1], b):
            panels.addmm_(a[:, k0:k0 + b], r[:, k0:k0 + b].mT, alpha=-1)
        out[name] = {"rows": a.shape[0], "depth": a.shape[1], "columns": b,
                     "one_product_err": float((one.double() - exact).abs().max()),
                     "panel_by_panel_err": float((panels.double() - exact).abs().max()),
                     "max_abs": float(exact.abs().max())}
        del exact, one, panels
    del k21, k22
    torch.cuda.empty_cache()
    log(json.dumps({"phase_9b_downdate_forms_vs_float64": out}))
    return out


def phase_float64_witness(fitted, n: int) -> dict:
    """9e: the float64 witness of the float32 backends. The first ``n``
    points of phase 9's data (capacity n + 512) at 6a's fitted
    hyperparameters: a float64 dense model (cuSOLVER's factor of the whole
    matrix), then a float64 streamed model (B2's float64 instantiation),
    whose means and variances at 9's 4,096 queries must lie within
    F64_WITNESS_RTOL and F64_WITNESS_ATOL of the dense model's, and
    float32 streamed, tiled and hybrid models, each asked the queries in
    one solve and at the server's solve width; each float32 model's
    largest distance from the witness, the tiled and hybrid models' gated
    at the streamed model's + 1e-3."""
    import torch

    from friedrich_tpu_torch.ops.partition import panel_widths

    x, y, xq = bench_data(2 * n)[:3]
    x, y = x[:n], y[:n]
    cap = n + K_ADD
    log(f"== phase 9e: float64 dense witness of the float32 backends, n={n}, capacity {cap}")
    t0 = sync()
    gp = phase9_build("dense", fitted, x, y, cap, dtype="float64")
    witness_s = sync() - t0
    w_mean, w_var = gp.predict_mean_variance(xq.astype(np.float64))
    del gp
    torch.cuda.empty_cache()
    out = {"capacity": cap, "witness_build_s": witness_s, "solve_width": SERVE_BLOCK,
           "tolerance": "the streamed model's error + 1e-3"}
    # a float64 streamed model of the same points (B2's float64 instantiation)
    reset_launches()
    t0 = sync()
    gp = phase9_build("streamed", fitted, x, y, cap, dtype="float64")
    build_s = sync() - t0
    s_mean, s_var = gp.predict_mean_variance(xq.astype(np.float64))
    del gp
    torch.cuda.empty_cache()
    out["float64_streamed"] = {
        "build_s": build_s, "panel_strip_launches_by_variant": variant_launches(),
        "mean_max_abs_diff": float(np.abs(s_mean - w_mean).max()),
        "var_max_abs_diff": float(np.abs(s_var - w_var).max()),
        "tolerance": f"rtol {F64_WITNESS_RTOL}, atol {F64_WITNESS_ATOL}"}
    log(json.dumps({"phase_9e_float64_streamed": out["float64_streamed"]}))
    if not (np.allclose(s_mean, w_mean, rtol=F64_WITNESS_RTOL, atol=F64_WITNESS_ATOL)
            and np.allclose(s_var, w_var, rtol=F64_WITNESS_RTOL, atol=F64_WITNESS_ATOL)):
        fail(f"phase 9e: the float64 streamed model is not within rtol {F64_WITNESS_RTOL}, atol "
             f"{F64_WITNESS_ATOL} of the float64 dense witness: {out['float64_streamed']}")
    only_variant(out["float64_streamed"]["panel_strip_launches_by_variant"], "f64",
                 len(panel_widths(cap)), "phase 9e's float64 streamed model (one launch per panel)")
    for backend in ("streamed", "tiled", "hybrid"):
        t0 = sync()
        gp = phase9_build(backend, fitted, x, y, cap)
        build_s = sync() - t0
        row = {"build_s": build_s}
        for label, kw in (("one_solve", {}), ("block", {"block": SERVE_BLOCK})):
            mean, var = gp.predict_mean_variance(xq, **kw)
            row[f"{label}_mean_err"] = float(np.abs(mean - w_mean).max())
            row[f"{label}_var_err"] = float(np.abs(var - w_var).max())
        out[backend] = row
        del gp
        torch.cuda.empty_cache()
    log(json.dumps({"phase_9e": out}))
    for backend in ("tiled", "hybrid"):
        for key, err in out[backend].items():
            if key.endswith("_err") and not err <= out["streamed"][key] + 1e-3:
                fail(f"phase 9e: the float32 {backend} model's {key} is {err} from the float64 witness, the "
                     f"streamed model's {out['streamed'][key]} (limit: the streamed model's + 1e-3)")
    return out


def phase_tiled_b1(fitted, n: int, by_shape: dict, served_launches: int) -> tuple[dict, dict]:
    """B1 at 9a's shape, the whole training covariance at capacity n + 512
    in one launch, beside its bound, its launches on 9a and its plain
    version on 4,096-row strips of the same matrix (the plain version of
    the whole would not fit beside it); and at 9c's, the cross covariance
    of a merged batch (timed at SERVE_MAX_ROWS rows, seed 9), beside its
    bound, its plain version and 9c's launches (``served_launches``)."""
    import torch

    from friedrich_tpu_torch.ops.covariance import plain_covariance_tile, plain_cross_covariance_train_padded
    from friedrich_tpu_torch.ops.cuda import covariance_cuda

    prior, kernel, noise = fitted
    cap = n + K_ADD
    x_pad = torch.zeros((cap, D), device="cuda")
    x_pad[:n] = torch.as_tensor(bench_data(n)[0], device="cuda")
    kernel = kernel.to(torch.float32, "cuda")
    row = shape_time(f"train {cap}^2 (9a)", kernel, x_pad, x_pad, n, True, noise, by_shape)
    worst = 0.0
    for r0 in (0, n // 2, cap - 4096):
        got = covariance_cuda.covariance(kernel, x_pad[r0:r0 + 4096], x_pad, n, noise, train=True, row0=r0)
        want = plain_covariance_tile(kernel, x_pad[r0:r0 + 4096], x_pad, n, noise, train=True, row0=r0)
        worst = max(worst, float((got - want).abs().max()))
        if not excess(got, want, ATOL_F32, RTOL_F32) <= 0:
            fail(f"phase 9a: the covariance kernel differs from its plain version on rows {r0}..")
        del got, want
    row["max_abs_err"] = worst
    row["plain_ms"] = cuda_ms(lambda: plain_covariance_tile(kernel, x_pad[:4096], x_pad, n, noise,
                                                            train=True))
    row["plain_ms_is_of"] = "one 4,096-row strip"
    q = torch.as_tensor(np.random.default_rng(9).normal(size=(SERVE_MAX_ROWS, D)), dtype=torch.float32,
                        device="cuda")
    merged = shape_time(f"cross {cap} x {SERVE_MAX_ROWS} (9c: one merged batch)", kernel, x_pad, q, n,
                        False, 0.0, {})
    merged["launches_on_flow"] = served_launches
    got = covariance_cuda.covariance(kernel, x_pad, q, n)
    want = plain_cross_covariance_train_padded(kernel, x_pad, n, q)
    merged["max_abs_err"] = float((got - want).abs().max())
    if not excess(got, want, ATOL_F32, RTOL_F32) <= 0:
        fail(f"phase 9c: the covariance kernel differs from its plain version at {merged['shape']}")
    merged["plain_ms"] = cuda_ms(lambda: plain_cross_covariance_train_padded(kernel, x_pad, n, q))
    del x_pad, q, got, want
    torch.cuda.empty_cache()
    log(json.dumps({"covariance_tile_times": [row, merged]}))
    return row, merged


def phase_serving(gp, label: str = "9c", what: str = "9a's model") -> dict:
    """9c (12a: ``label``): ``AcceleratedGPServer`` over ``what``: 4 ``GPClient`` threads
    send 8 requests each of 1-1,024 rows (seed 9), alternately mean and
    variance and mean only; each reply within SERVE_ATOL of the model's
    in-process prediction of its rows at the server's solve width
    (``block``), a dimension mismatch answered with status 1 on a
    connection that stays usable, no status 2; each reply's distance from
    the one-solve prediction of its rows printed beside it."""
    import threading

    import torch

    from friedrich_tpu_torch import ConfigError, serving

    log(f"== phase {label}: AcceleratedGPServer over {what}, {SERVE_CLIENTS} clients x "
        f"{SERVE_REQUESTS} requests of 1-{SERVE_MAX_ROWS} rows")
    rng = np.random.default_rng(9)
    d = getattr(gp, "state", gp).x.shape[1]
    plan = [[(rng.normal(size=(int(rng.integers(1, SERVE_MAX_ROWS + 1)), d)), k % 2 == 0)
             for k in range(SERVE_REQUESTS)] for _ in range(SERVE_CLIENTS)]
    replies = [[None] * SERVE_REQUESTS for _ in range(SERVE_CLIENTS)]
    latencies, errors = [], []
    # ---- the main path: the server's batches; B1's launches are counted over it
    reset_launches()
    t_start = sync()
    with serving.AcceleratedGPServer(gp, block=SERVE_BLOCK) as srv:
        with serving.GPClient(port=srv.port, timeout=600.0) as c:
            try:
                c.predict(rng.normal(size=(3, d + 1)))
                fail(f"phase {label}: a request of the wrong dimension was answered")
            except ConfigError as e:
                if "status 1" not in str(e):
                    fail(f"phase {label}: a dimension mismatch was answered with {e}")
            c.predict(plan[0][0][0][:2])  # the same connection, still usable
        barrier = threading.Barrier(SERVE_CLIENTS)

        def client(i):
            try:
                with serving.GPClient(port=srv.port, timeout=600.0) as c:
                    barrier.wait()
                    for k, (xq, both) in enumerate(plan[i]):
                        t0 = time.perf_counter()
                        replies[i][k] = c.predict_mean_variance(xq) if both else (c.predict(xq), None)
                        latencies.append(time.perf_counter() - t0)
            except Exception as e:  # noqa: BLE001 — a status 2 among them fails the phase
                errors.append(repr(e))

        threads = [threading.Thread(target=client, args=(i,)) for i in range(SERVE_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        dispatches, per_dispatch = dict(srv.dispatches), dict(srv.requests_per_dispatch)
    serve_s = sync() - t_start
    b1 = read_launches()[0]
    # ---- end of the main path
    if errors:
        fail(f"phase {label}: requests failed: {errors}")
    worst, one_solve = 0.0, 0.0
    for i in range(SERVE_CLIENTS):
        for k, (xq, both) in enumerate(plan[i]):
            mean, var = replies[i][k]
            for which, kw in (("block", {"block": srv.block}), ("one_solve", {})):
                want_mean, want_var = (np.asarray(torch.as_tensor(t).cpu())
                                       for t in gp.predict_mean_variance(xq, **kw))
                diff = float(np.abs(mean - want_mean).max())
                if both:
                    diff = max(diff, float(np.abs(var - want_var).max()))
                if which == "block":
                    worst = max(worst, diff)
                else:
                    one_solve = max(one_solve, diff)
    lat = sorted(latencies)
    rows = [xq.shape[0] for p in plan for xq, _ in p]
    out = {"requests": len(rows), "rows": sum(rows), "serve_s": serve_s,
           "latency_p50_s": lat[len(lat) // 2], "latency_p99_s": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
           "latency_max_s": lat[-1], "solve_width": srv.block, "dispatches_by_rows": dispatches,
           "requests_per_dispatch": per_dispatch, "covariance_tile_launches": b1,
           "max_abs_diff_vs_in_process": worst, "tolerance": SERVE_ATOL,
           "max_abs_diff_vs_one_solve": one_solve}
    log(json.dumps({f"phase_{label}": out}))
    if len(latencies) != SERVE_CLIENTS * SERVE_REQUESTS:
        fail(f"phase {label}: {len(latencies)} replies, expected {SERVE_CLIENTS * SERVE_REQUESTS}")
    if b1 <= 0:
        fail(f"phase {label}: serving did not launch the covariance kernel")
    if not worst <= SERVE_ATOL:
        fail(f"phase {label}: replies differ from the in-process predictions by {worst} (limit {SERVE_ATOL})")
    torch.cuda.empty_cache()
    return out


def phase_daemon(fitted, n: int) -> dict:
    """9d: the native daemon (``GPServer``, CPU float64) on a bundle the
    port exported from a model of the first 8,192 points on the card, asked
    256 rows; within DAEMON_ATOL of the card's predictions."""
    import shutil
    import tempfile
    import threading

    import torch

    import friedrich_tpu_torch as ft
    from friedrich_tpu_torch import serving

    log(f"== phase 9d: the native daemon on a bundle the port exported ({DAEMON_N} points)")
    prior, kernel, noise = fitted
    x, y = bench_data(n)[:2]
    xq = np.random.default_rng(10).normal(size=(DAEMON_QUERIES, D))
    gp = ft.GaussianProcess.new(prior, kernel, float(noise), None, x[:DAEMON_N], y[:DAEMON_N],
                                dtype="float32", device="cuda")
    mean, var = gp.predict_mean_variance(xq)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_bundle_")
    try:
        path = os.path.join(tmp, "model.frsv")
        t0 = time.perf_counter()
        serving.export_bundle(gp, path)
        export_s = time.perf_counter() - t0
        nbytes = os.path.getsize(path)
        t0 = time.perf_counter()
        try:
            serving.build_daemon()
        except Exception as e:  # noqa: BLE001 — a missing or failing g++ fails the phase
            fail(f"phase 9d: the daemon did not build: {e}")
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        with serving.GPServer(path, startup_timeout=300.0) as srv:
            up_s = time.perf_counter() - t0
            parts = np.array_split(xq, DAEMON_CONNECTIONS)
            replies: list = [None] * len(parts)

            def ask(i):
                with serving.GPClient(port=srv.port, timeout=900.0) as c:
                    replies[i] = c.predict_mean_variance(parts[i])

            threads = [threading.Thread(target=ask, args=(i,)) for i in range(len(parts))]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            query_s = time.perf_counter() - t0
            if any(r is None for r in replies):
                fail("phase 9d: a connection to the daemon got no reply")
            d_mean = np.concatenate([r[0] for r in replies])
            d_var = np.concatenate([r[1] for r in replies])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del gp
    torch.cuda.empty_cache()
    out = {"points": DAEMON_N, "bundle_bytes": nbytes, "export_s": export_s, "daemon_build_s": build_s,
           "daemon_startup_s": up_s, "daemon_query_256_s": query_s, "connections": DAEMON_CONNECTIONS,
           "mean_max_abs_diff": float(np.abs(d_mean - mean).max()),
           "var_max_abs_diff": float(np.abs(d_var - var).max()), "tolerance": DAEMON_ATOL}
    log(json.dumps({"phase_9d": out}))
    if not max(out["mean_max_abs_diff"], out["var_max_abs_diff"]) <= DAEMON_ATOL:
        fail(f"phase 9d: the daemon's predictions differ from the card's: {out}")
    return out


def phase_b2_other_rows(explicit_launches: int, f64_launches: int) -> tuple[dict, dict]:
    """B2's explicit bf16 prefix at 8c's middle panel (57,344 rows, 8,192
    columns, a prefix chunk 8,192 deep; N(0, 0.01) entries, seed 0) and its
    float64 instantiation at the middle panel of a float64 streamed factor
    at capacity 4,096 (6c's streamed density): each against its plain
    version and timed beside one ``torch.addmm`` of the downdate and its
    bound; ``*_launches``: their launches on 8c's and 6c's runs."""
    import torch

    import friedrich_tpu_torch as ft
    from friedrich_tpu_torch.ops.covariance import plain_train_covariance_block
    from friedrich_tpu_torch.ops.cuda import panel_strip_cuda as pc
    from friedrich_tpu_torch.ops.panel_fused import plain_panel_strip
    from friedrich_tpu_torch.ops.partition import panel_widths
    from friedrich_tpu_torch.ops.streamed import streamed_cholesky_factor

    log("== phase 9: B2's explicit bf16 prefix (8c's middle panel) and float64 (6c's density factor)")
    g = torch.Generator(device="cuda").manual_seed(0)
    kern = ft.kernels.SquaredExp(ls=0.5, ampl=1.0).to(torch.float32, "cuda")
    cap, block = -(-OOC_N // OOC_BLOCK) * OOC_BLOCK, OOC_BLOCK
    j0 = cap - SWEEP_ROWS
    x = torch.randn((cap, D), device="cuda", generator=g)
    prefix = (torch.randn((SWEEP_ROWS, block), device="cuda", generator=g) * 0.01).to(torch.bfloat16)
    args = (kern, x[j0:], x[j0:j0 + block], None, OOC_N, OOC_NOISE, j0, block)
    got = pc.panel_strip(*args, prefix=prefix)
    want = plain_panel_strip(*args, prefix=prefix)
    err = float((got - want).abs().max())
    if not strip_excess(got, want, prefix, block, ATOL_F32, RTOL_F32, UNIT_ROUNDOFF["float32"], 0.0) <= 0:
        fail(f"explicit bf16 prefix differs from its plain version at 8c's middle panel: {err}")
    del got, want
    k_strip = plain_train_covariance_block(kern, x[j0:], x[j0:j0 + block], OOC_N, OOC_NOISE, row0=j0,
                                           col0=j0)
    lib, lib_name = bf16_library_call(k_strip, prefix, prefix[:block])
    bound, by = strip_bound_ms(SWEEP_ROWS, block, block, D, 4, BF16_FLOPS, prefix_itemsize=2)
    explicit = {
        "name": "panel_strip_bf16_explicit_prefix", "route": "cuda",
        "source": "friedrich_tpu_torch/csrc/panel_strip_bf16.cu",
        "replaces": "friedrich_tpu/ops/pallas/panel_fused.py:102", "launches": explicit_launches,
        "max_abs_err": err, "ms": cuda_ms(lambda: pc.panel_strip(*args, prefix=prefix)),
        "plain_ms": cuda_ms(lambda: plain_panel_strip(*args, prefix=prefix), reps=3),
        "bound_ms": bound, "bound_by": by, "library_ms": cuda_ms(lib), "library_call": lib_name,
        "bound": "tensor cores: one bf16 product at 989 TFLOP/s",
        "shape": f"8c's middle panel: rows {SWEEP_ROWS}, B={block}, an explicit bf16 prefix {block} deep",
    }
    del lib, k_strip, prefix, x
    torch.cuda.empty_cache()
    cap64 = 4096
    x64 = torch.as_tensor(np.random.default_rng(11).normal(size=(cap64, D)), device="cuda")
    kern64 = ft.kernels.SquaredExp(ls=1.1, ampl=0.9).to(torch.float64, "cuda")
    l_full, ok = streamed_cholesky_factor(kern64, x64, cap64 - 24, 1.0)
    if not bool(ok):
        fail("the float64 streamed factor at capacity 4,096 failed")
    widths = panel_widths(cap64)
    j0, block = int(np.sum(widths[:len(widths) // 2])), widths[len(widths) // 2]
    rest = cap64 - j0
    args = (kern64, x64[j0:], x64[j0:j0 + block], l_full, cap64 - 24, 1.0, j0, block)
    got, want = pc.panel_strip(*args), plain_panel_strip(*args)
    err = float((got - want).abs().max())
    if not strip_excess(got, want, l_full[j0:, :j0], block, ATOL_F64, RTOL_F64, UNIT_ROUNDOFF["float64"],
                        0.0) <= 0:
        fail(f"float64 panel strip differs from its plain version: {err}")
    k_strip = plain_train_covariance_block(kern64, x64[j0:], x64[j0:j0 + block], cap64 - 24, 1.0,
                                           row0=j0, col0=j0)
    l_tail, l_rows = l_full[j0:], l_full[j0:j0 + block]
    l_tail, l_rows = l_tail[:, :j0], l_rows[:, :j0]
    bound, by = strip_bound_ms(rest, block, j0, D, 8, FP64_FLOPS)
    f64 = {
        "name": "panel_strip_f64", "route": "cuda", "source": "friedrich_tpu_torch/csrc/panel_strip.cu",
        "replaces": "friedrich_tpu/ops/pallas/panel_fused.py:102", "launches": f64_launches,
        "max_abs_err": err, "ms": cuda_ms(lambda: pc.panel_strip(*args)),
        "plain_ms": cuda_ms(lambda: plain_panel_strip(*args)), "bound_ms": bound, "bound_by": by,
        "library_ms": cuda_ms(lambda: torch.addmm(k_strip, l_tail, l_rows.mT, alpha=-1)),
        "library_call": "torch.addmm(k_strip, L[j0:, :j0], L[j0:j0+B, :j0].T, alpha=-1), float64",
        "bound": "float64 tensor cores at 67 TFLOP/s",
        "shape": f"panel j0={j0} B={block} of a float64 streamed factor at capacity {cap64}",
    }
    del l_full, k_strip, got, want
    torch.cuda.empty_cache()
    log(json.dumps({"panel_strip_other_rows": [explicit, f64]}))
    return explicit, f64


# ---------------------------------------------------------------------------
# Phase 10: the float64 flow at n = 70,000
# ---------------------------------------------------------------------------

#: Training points of phase 10 (capacity 70,512): a float64 factor of
#: 39,775,537,152 B, two of which pass 0.85 of an 80 GB card, so that
#: ``backend="auto"`` resolves to "streamed" and B2's float64 instantiation
#: runs every panel.
F64_N = 70_000
#: Peak device memory of phase 10's flow, in factors (PERF_FACTORS_9's limit).
PEAK_FACTORS_10 = 1.15
#: The float64 streamed model of 9e's points against 9e's float64 dense
#: witness: the tolerance tests/test_torch_streamed.py holds float64 factors to.
F64_WITNESS_RTOL, F64_WITNESS_ATOL = 1e-10, 1e-10


def phase_float64_flow(n: int) -> dict:
    """10: the builder's flow in float64 on ``bench.py``'s data at ``n``
    points (capacity n + 512): ``set_dtype("float64")``, noise 1.0,
    ``backend="auto"`` (which must resolve to "streamed"), the "auto"
    sub-fit, then a 4,096-query ``predict_in_batches``, a 512-point
    ``add_samples`` (in place) and ``sample_at`` 64 points; both kernels'
    launches counted over that run, B2's float64 instantiation only and one
    launch per panel of the build. Gates: the peak below PEAK_FACTORS_10
    factors, the fitted LML above the heuristic start's, variances >= -1e-4,
    B2 against its plain version on three panels of the final factor. Then
    B2 at the middle panel beside its bound, its plain version and one
    float64 ``torch.addmm`` of the downdate; B1 at the flow's float64
    shapes; a ``torch.profiler`` breakdown of one float64 build."""
    import torch

    import friedrich_tpu_torch as ft
    from friedrich_tpu_torch.models.gp import resolve_backend
    from friedrich_tpu_torch.models.optimizer import auto_subsample, subset_indices
    from friedrich_tpu_torch.ops.covariance import (
        plain_cross_covariance_train_padded,
        plain_train_covariance_block,
        plain_train_covariance_padded,
    )
    from friedrich_tpu_torch.ops.cuda import covariance_cuda, panel_strip_cuda
    from friedrich_tpu_torch.ops.panel_fused import plain_panel_strip
    from friedrich_tpu_torch.ops.partition import panel_widths

    cap = n + K_ADD
    sub = auto_subsample(n)
    f64 = torch.float64
    log(f"== phase 10: the float64 flow, n={n}, capacity {cap}, backend 'auto', sub-fit 'auto' "
        f"({sub} points), d=8")
    resolved = resolve_backend("auto", cap, f64, torch.device("cuda"))
    if resolved != "streamed":
        fail(f"phase 10: backend='auto' resolves to {resolved!r} at capacity {cap} in float64")
    x, y, xq, x_add, y_add, x_sample = (a.astype(np.float64) for a in bench_data(n))
    xt, yt = torch.as_tensor(x, device="cuda"), torch.as_tensor(y, device="cuda")
    heur = ft.kernels.Gaussian().heuristic_fit(xt, yt)
    gp0 = ft.GaussianProcess.new(ft.priors.ConstantPrior().fit(xt, yt), heur, 1.0, None, x, y,
                                 dtype="float64", capacity=cap, backend="streamed", device="cuda")
    lml0 = gp0.log_marginal_likelihood()
    del gp0, xt, yt
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # ---- the main path; both kernels' launches are counted over this run only
    reset_launches()
    t_start = sync()
    builder = (
        ft.GaussianProcessBuilder(x, y, device="cuda")
        .set_noise(1.0).set_dtype("float64").set_capacity(cap).set_backend("auto")
        .set_fit_parameters(100, 0.05).fit_kernel().fit_prior()
    )
    gp = builder.train()
    lml = gp.log_marginal_likelihood()
    t0 = sync()
    mean, var = gp.predict_in_batches(xq, M_QUERIES)
    t_predict = sync() - t0
    t0 = sync()
    gp.add_samples(x_add, y_add)
    t_add = sync() - t0
    t0 = sync()
    draw = gp.sample_at(torch.as_tensor(x_sample, device="cuda")).sample(
        torch.Generator(device="cuda").manual_seed(0))
    t_sample = sync() - t0
    t_total = sync() - t_start
    b1_launches, b1_by_shape, b2_launches = read_launches()
    by_variant = variant_launches()
    # ---- end of the main path

    peak = torch.cuda.max_memory_allocated()
    factor_bytes = cap * cap * 8
    widths = panel_widths(cap, gp.state.block)
    t = builder.timings
    steps = {
        "timings": t, "subfit_points": sub, "predict_in_batches_s": t_predict, "add_samples_s": t_add,
        "sample_at_s": t_sample, "total_s": t_total, "peak_bytes": peak,
        "peak_factors": peak / factor_bytes, "factor_bytes": factor_bytes, "panels": len(widths),
        "panel_strip_launches_by_variant": by_variant, "covariance_tile_launches": b1_launches,
        "covariance_tile_launches_by_shape": {f"{k[0]}x{k[1]}{' train' if k[2] else ''}": v
                                              for k, v in b1_by_shape.items()},
        "lml_start": lml0, "lml_fitted": lml, "ls": float(gp.kernel.ls), "ampl": float(gp.kernel.ampl),
        "noise": gp.noise, "var_min": float(var.min()), "mean_abs_max": float(mean.abs().max()),
    }
    log(json.dumps({"phase_10_steps": steps}))
    if gp.state.backend != "auto" or mean.dtype != f64:
        fail(f"phase 10: the model's backend is {gp.state.backend!r} and its dtype {mean.dtype}")
    only_variant(by_variant, "f64", len(widths), "phase 10 (one float64 launch per panel of the build)")
    if b1_launches <= 0:
        fail("phase 10 never launched the covariance kernel")
    if mean.shape != (M_QUERIES,) or var.shape != (M_QUERIES,) or draw.shape != (M_SAMPLE,):
        fail(f"phase 10: unexpected shapes {tuple(mean.shape)} {tuple(var.shape)} {tuple(draw.shape)}")
    if not (bool(torch.isfinite(mean).all()) and bool(torch.isfinite(var).all())
            and bool(torch.isfinite(draw).all())):
        fail("phase 10: non-finite predictions or draws")
    if float(var.min()) < -1e-4:
        fail(f"phase 10: negative predictive variance {float(var.min())}")
    if not lml > lml0:
        fail(f"phase 10: the fitted LML {lml} does not exceed the heuristic start's {lml0}")
    if gp.num_samples != cap:
        fail(f"phase 10: add_samples left {gp.num_samples} samples, expected {cap}")
    if not peak < PEAK_FACTORS_10 * factor_bytes:
        fail(f"phase 10: peak device memory {peak} B is not below {PEAK_FACTORS_10} factors "
             f"({factor_bytes} B each)")

    # ---- B2 against its plain version on three panels of the final factor,
    # then timed at the middle one
    state = gp.state
    kernel, noise, n_live, x_pad, l_full = state.kernel, state.noise, state.n, state.x, state.l
    fitted = (gp.prior, kernel.to(f64, "cpu"), noise)
    del gp, state, mean, var, draw, builder
    torch.cuda.empty_cache()
    max_err = check_panels(kernel, x_pad, n_live, noise, l_full, widths, f"phase 10, capacity {cap}")
    starts = np.cumsum((0,) + tuple(widths[:-1]))
    p = len(widths) // 2
    j0, block = int(starts[p]), widths[p]
    rest = cap - j0
    args = (kernel.to(f64, "cpu"), x_pad[j0:], x_pad[j0:j0 + block], l_full, n_live, noise, j0, block)
    k_strip = plain_train_covariance_block(kernel, x_pad[j0:], x_pad[j0:j0 + block], n_live, noise,
                                           row0=j0, col0=j0)
    l_tail, l_rows = l_full[j0:, :j0], l_full[j0:j0 + block, :j0]
    times = {"kernel": [], "addmm": []}
    for _ in range(2):  # kernel and yardstick in turns
        times["kernel"].append(cuda_ms(lambda: panel_strip_cuda.panel_strip(*args), reps=3))
        times["addmm"].append(cuda_ms(lambda: torch.addmm(k_strip, l_tail, l_rows.mT, alpha=-1), reps=3))
    ms, library_ms = min(times["kernel"]), min(times["addmm"])
    plain_ms = cuda_ms(lambda: plain_panel_strip(*args), reps=3)
    bound, bound_by = strip_bound_ms(rest, block, j0, D, 8, FP64_FLOPS)
    middle = {"shape": f"panel j0={j0} B={block} of capacity {cap}, rest {rest}, d={D}, float64",
              "ms": ms, "kernel_runs_ms": times["kernel"], "plain_ms": plain_ms, "library_ms": library_ms,
              "library_runs_ms": times["addmm"], "bound_ms": bound, "bound_by": bound_by,
              "share_of_bound": bound / ms, "over_addmm": ms / library_ms,
              "downdate_tflops": 2 * rest * block * j0 / ms / 1e9}
    log(json.dumps({"phase_10_middle_panel": middle}))
    del k_strip, l_tail, l_rows, args, l_full
    torch.cuda.empty_cache()

    # ---- B1 at the flow's float64 shapes, beside its bound and plain version
    xq_t = torch.as_tensor(xq, device="cuda")
    b1_cross = shape_time(f"cross {cap} x {M_QUERIES}, float64", kernel, x_pad, xq_t, n_live, False,
                          noise, b1_by_shape)
    b1_cross["plain_ms"] = cuda_ms(lambda: plain_cross_covariance_train_padded(kernel, x_pad, n_live,
                                                                               xq_t))
    got = covariance_cuda.covariance(kernel, x_pad, xq_t, n_live)
    want = plain_cross_covariance_train_padded(kernel, x_pad, n_live, xq_t)
    b1_cross["max_abs_err"] = float((got - want).abs().max())
    if not excess(got, want, ATOL_F64, RTOL_F64) <= 0:
        fail(f"phase 10: the covariance kernel differs from its plain version at {b1_cross['shape']}: "
             f"max error {b1_cross['max_abs_err']}")
    del got, want
    size = sub or n  # the sub-fit's points ("auto": all of them below 24,576)
    idx = subset_indices(n, size, 0, "cpu").numpy()
    x_sub = torch.as_tensor(x[idx], device="cuda")
    b1_sub = shape_time(f"train {size}^2, float64", kernel, x_sub, x_sub, size, True, noise,
                        b1_by_shape)
    b1_sub["plain_ms"] = cuda_ms(lambda: plain_train_covariance_padded(kernel, x_sub, size, noise))
    del xq_t, x_sub
    torch.cuda.empty_cache()
    log(json.dumps({"covariance_tile_times": [b1_sub, b1_cross]}))

    # ---- one float64 build at the fitted hyperparameters under torch.profiler
    x_build = torch.zeros((cap, D), dtype=f64, device="cuda")
    x_build[:n] = torch.as_tensor(x, device="cuda")
    del x_pad
    torch.cuda.empty_cache()
    profile = profile_factor(kernel, x_build, n, noise)
    if "panel_strip_device_s" in profile:
        profile["panel_strip_share_of_device"] = profile["panel_strip_device_s"] / profile["device_busy_s"]
    log(json.dumps({"phase_10_build_profile": profile}))
    del x_build
    torch.cuda.empty_cache()
    return {"steps": steps, "fitted": fitted, "middle": middle, "max_abs_err": max_err,
            "launches": by_variant["f64"], "b1": [b1_sub, b1_cross]}


# ---------------------------------------------------------------------------
# Phase 11: the multi-rank layer (parallel/, mcmc/sharded.py,
# mcmc/distributed_logprob.py)
# ---------------------------------------------------------------------------

#: 11a's ragged two-operand strips: (rows of the rank's strip, B, prefix
#: depth j0, global row of the strip's first row, the prefix's row stride,
#: the panel rows' row stride). Row strides 1,001 and 81 are not multiples
#: of 4 (the cp.async and plain-load paths); j0 = 0; an odd depth with
#: B < 8; fewer rows than B; every strip below its panel (row0 > j0 + B).
TWO_OPERAND_CASES = ((333, 128, 256, 1000, 1001, 264), (500, 96, 0, 700, 1000, 8),
                     (257, 5, 77, 600, 1000, 81), (640, 200, 384, 1000, 1000, 384),
                     (64, 200, 300, 900, 1000, 301))
TWO_OPERAND_N = 1200
#: 11a's timed strip: what rank 1 of a two-rank factor at capacity 100,512
#: sees on the middle panel: its 50,256 rows, B = 1,396 (the default panel
#: of a 50,256-row block), a prefix 25,128 deep read in place from its
#: (50,256, 100,512) row block, the panel's rows broadcast by rank 0.
TWO_RANK_CAP, TWO_RANK_ROWS, TWO_RANK_B, TWO_RANK_J0 = 100_512, 50_256, 1396, 18 * 1396


def phase_two_operand() -> dict:
    """11a: B2 with the panel's rows as a separate operand against its plain
    version in all four instantiations at :data:`TWO_OPERAND_CASES` (NaN
    right of the prefix in both operands, which the kernel must never read),
    then one launch at :data:`TWO_RANK_ROWS`'s shape timed beside its bound,
    its plain version and one ``torch.addmm`` of the downdate. Returns the
    kernel line's row for the two-operand launch."""
    import torch

    from friedrich_tpu_torch import kernels as K
    from friedrich_tpu_torch.ops.covariance import plain_train_covariance_block
    from friedrich_tpu_torch.ops.cuda import panel_strip_cuda as pc
    from friedrich_tpu_torch.ops.panel_fused import plain_panel_strip

    log("== phase 11a: B2 with a separate panel-row operand against its plain version")
    rng = np.random.default_rng(11)
    kernels = {"SquaredExp": K.SquaredExp(ls=0.9, ampl=1.3),
               "Composite": test_kernels()["Composite"]}
    kinds = (("tf32x3", torch.float32, torch.float32, None),
             ("one_pass", torch.float32, torch.float32, "bf16"),
             ("bf16", torch.float32, torch.bfloat16, None),
             ("f64", torch.float64, torch.float64, None))
    before = dict(pc.LAUNCHES_TWO_OPERAND)
    worst = {}
    for rows, block, j0, row0, ldl, ldb in TWO_OPERAND_CASES:
        x_np = rng.normal(size=(rows, D))
        xj_np = rng.normal(size=(block, D))
        a_np = np.full((rows, ldl), np.nan)
        a_np[:, :j0] = rng.normal(size=(rows, j0)) * 0.1
        b_np = np.full((block, ldb), np.nan)
        b_np[:, :j0] = rng.normal(size=(block, j0)) * 0.1
        for kind, dtype, pdtype, precision in kinds:
            f64 = dtype == torch.float64
            atol, rtol, unit = (ATOL_F64, RTOL_F64, UNIT_ROUNDOFF["float64"]) if f64 else (
                ATOL_F32, RTOL_F32, UNIT_ROUNDOFF["float32"])
            split = pc.SPLIT_ERROR if kind == "tf32x3" else 0.0
            x = torch.as_tensor(x_np, dtype=dtype, device="cuda")
            xj = torch.as_tensor(xj_np, dtype=dtype, device="cuda")
            prefix = torch.as_tensor(a_np, dtype=pdtype, device="cuda")[:, :j0]
            panel_rows = torch.as_tensor(b_np, dtype=pdtype, device="cuda")[:, :max(j0, 1)]
            if pc.variant(dtype, pdtype, precision) != kind:
                fail(f"11a: {kind} is not the instantiation of {dtype}, {pdtype}, {precision}")
            for name, kern in kernels.items():
                kern = kern.to(dtype, "cuda")
                for method in ("gram", "gram_bf16", "direct"):
                    a, r = (ATOL_F32, RTOL_F32) if method == "gram_bf16" else (atol, rtol)
                    args = (kern, x, xj, None, TWO_OPERAND_N, 0.3, j0, block, method, precision)
                    got = pc.panel_strip(*args, prefix=prefix, panel_rows=panel_rows, row0=row0)
                    want = plain_panel_strip(*args, prefix=prefix, panel_rows=panel_rows, row0=row0)
                    torch.cuda.synchronize()
                    what = (f"11a {kind} {name} {method} rows={rows} B={block} j0={j0} row0={row0} "
                            f"ldl={ldl} ldb={ldb}")
                    if got.shape != (rows, block) or not bool(torch.isfinite(got).all()):
                        fail(f"{what}: shape {tuple(got.shape)} or non-finite")
                    # the plain version rounds bfloat16 operands as the kernel reads them
                    p32 = prefix.to(dtype) if kind != "one_pass" else prefix.to(torch.bfloat16).to(dtype)
                    q32 = panel_rows.to(dtype) if kind != "one_pass" else panel_rows.to(
                        torch.bfloat16).to(dtype)
                    over = strip_excess(got, want, p32, block, a, r, unit, split, panel_rows=q32)
                    err = float((got - want).abs().max())
                    if not over <= 0:
                        fail(f"{what}: max error {err} beyond its tolerance by {over}")
                    worst[kind] = max(worst.get(kind, 0.0), err)
    launched = {k: pc.LAUNCHES_TWO_OPERAND[k] - before[k] for k in before}
    if any(v <= 0 for v in launched.values()):
        fail(f"11a: an instantiation made no two-operand launch: {launched}")
    log(json.dumps({"two_operand_parity": {
        "max_abs_err": worst, "launches": launched, "live_n": TWO_OPERAND_N,
        "cases": [dict(zip(("rows", "B", "j0", "row0", "ldl", "ldb"), c)) for c in TWO_OPERAND_CASES],
        "tolerance": "as phase 5a, with |P| |Q|^T of the strip's prefix P and the panel rows Q"}}))

    # ---- one launch at rank 1's middle panel of a two-rank 100,512 factor
    g = torch.Generator(device="cuda").manual_seed(0)
    rows, block, j0 = TWO_RANK_ROWS, TWO_RANK_B, TWO_RANK_J0
    kern = K.SquaredExp(ls=0.5, ampl=1.0).to(torch.float32, "cuda")
    l_local = torch.full((rows, TWO_RANK_CAP), float("nan"), device="cuda")
    l_local[:, :j0] = torch.randn((rows, j0), device="cuda", generator=g) * 0.1
    panel_rows = torch.randn((block, j0), device="cuda", generator=g) * 0.1
    x = torch.randn((rows, D), device="cuda", generator=g)
    xj = torch.randn((block, D), device="cuda", generator=g)
    prefix = l_local[:, :j0]
    row0 = TWO_RANK_CAP - rows
    n_live = TWO_RANK_CAP - K_ADD
    args = (kern, x, xj, None, n_live, 1.0, j0, block)
    kw = {"prefix": prefix, "panel_rows": panel_rows, "row0": row0}
    got = pc.panel_strip(*args, **kw)
    want = plain_panel_strip(*args, **kw)
    err = float((got - want).abs().max())
    over = strip_excess(got, want, prefix, block, ATOL_F32, RTOL_F32, UNIT_ROUNDOFF["float32"],
                        pc.SPLIT_ERROR, panel_rows=panel_rows)
    if not over <= 0:
        fail(f"11a: the two-operand strip at rank 1's middle panel differs from its plain version: {err}")
    del got, want
    k_strip = plain_train_covariance_block(kern, x, xj, n_live, 1.0, row0=row0, col0=j0)
    times = {"kernel": [], "addmm": []}
    for _ in range(2):  # kernel and yardstick in turns
        times["kernel"].append(cuda_ms(lambda: pc.panel_strip(*args, **kw), reps=3))
        times["addmm"].append(cuda_ms(lambda: torch.addmm(k_strip, prefix, panel_rows.mT, alpha=-1),
                                      reps=3))
    ms, library_ms = min(times["kernel"]), min(times["addmm"])
    plain_ms = cuda_ms(lambda: plain_panel_strip(*args, **kw), reps=3)
    bound, bound_by = strip_bound_ms(rows, block, j0, D, 4, TF32_FLOPS / 3)
    row = {
        "name": "panel_strip_tf32x3_two_operand", "route": "cuda",
        "source": "friedrich_tpu_torch/csrc/panel_strip.cu",
        "replaces": "friedrich_tpu/ops/pallas/panel_fused.py:102", "launches": 0,
        "max_abs_err": max(err, worst["tf32x3"]), "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
        "bound_by": bound_by, "library_ms": library_ms,
        "library_call": "torch.addmm(k_strip, L_rank[:, :j0], panel_rows.T, alpha=-1), float32",
        "bound": "tensor cores: three TF32 products at 495 TFLOP/s",
        "shape": f"rank 1 of 2 at capacity {TWO_RANK_CAP}: rows {rows} from row {row0}, B={block}, "
                 f"j0={j0}, prefix row stride {TWO_RANK_CAP}, d={D}",
        "kernel_runs_ms": times["kernel"], "library_runs_ms": times["addmm"],
        "share_of_bound": bound / ms, "over_addmm": ms / library_ms,
        "max_abs_err_by_instantiation": worst,
    }
    log(json.dumps({"phase_11a_two_operand": row}))
    del l_local, prefix, panel_rows, k_strip, x, xj
    torch.cuda.empty_cache()
    return row


#: 11b's peak device memory, in factors.
PEAK_FACTORS_11 = 1.15
#: 11c: the two ranks' model (9e's size: 5.1 GB of factor a rank) and
#: their sampler run: 7b's dense density at 1,024 points, 2 chains a rank,
#: warmup and sampled transitions.
RANKS_11C, N_11C = 2, 50_000
CHAINS_11C, WARMUP_11C, SAMPLES_11C, DENSITY_N_11C = 2, 20, 20, 1024
#: 11c's gates against the world-of-one model of the same points: the
#: streamed-against-dense gates of phase 5b (LML relative, means and
#: variances absolute).
LML_RTOL_11C, MOMENT_ATOL_11C = 1e-4, 1e-3
#: 11d: the distributed density's sampler at world 1 (7a's data and probes).
N_11D, WARMUP_11D, SAMPLES_11D = 4096, 10, 10
#: Seconds 11c's ranks may take before they are stopped and the phase fails.
RANK_TIMEOUT_S = 600


def world_of_one(backend: str = "nccl") -> None:
    """Set up this process as a world of one rank on the card: a TCP store
    on 127.0.0.1, the named backend, no fallback."""
    import torch.distributed as dist

    from friedrich_tpu_torch.parallel import multihost

    info = multihost.initialize(f"tcp://127.0.0.1:{multihost.free_port()}", 1, 0, backend=backend,
                                device="cuda:0")
    if dist.get_backend() != backend or info["process_count"] != 1:
        fail(f"the world of one runs {dist.get_backend()} with {info['process_count']} ranks")


def phase11_reference(n: int) -> tuple:
    """For phase 11 alone (``--phase11``): 6a's fitted hyperparameters from
    the builder's default flow at ``n`` points, the streamed model's 4,096
    predictions at them (:func:`phase9_reference`) and the float64 witness
    of its means (:func:`float64_mean_witness`), as phases 6a and 9 give
    them in the full run."""
    import torch

    x, y, xq = bench_data(n)[:3]
    fitted = fitted_6a_alone(n)
    gp = phase9_build("streamed", fitted, x, y, n + K_ADD)
    mean, var = gp.predict_mean_variance(xq)
    w_mean, history = float64_mean_witness(gp.state, y, n, xq)
    del gp
    torch.cuda.empty_cache()
    witness = {"mean": w_mean, "history": history,
               "streamed_mean_err": float(np.abs(mean - w_mean).max())}
    return fitted, (mean, var, None), witness


def large_scale_moments(gp, xq) -> dict:
    """A ``LargeScaleGP``'s 4,096 predictions and LML, on the host."""
    mean, var = gp.predict_mean_variance(xq)
    return {"mean": mean.cpu().numpy(), "var": var.cpu().numpy(),
            "lml": gp.log_marginal_likelihood()}


def phase_large_scale_one(fitted, n: int, ref, witness) -> dict:
    """11b: ``LargeScaleGP`` on a world of one through NCCL at ``n`` points
    (capacity n + 512), float32, ``bench.py``'s data and 6a's fitted
    hyperparameters: the build (one B2 launch per panel, 3xTF32 only), the
    4,096 predictions held to 9a/9b's gates against the streamed model and
    the float64 witness, ``fit_scaled(max_iter=2)`` (each refactor in the
    factor's own buffer) and a 512-point ``add_samples`` up to the
    capacity; the peak below :data:`PEAK_FACTORS_11` factors."""
    import torch

    from friedrich_tpu_torch.ops.partition import pick_block
    from friedrich_tpu_torch.parallel import LargeScaleGP, make_matrix_mesh, multihost

    cap = n + K_ADD
    log(f"== phase 11b: LargeScaleGP on a world of one through NCCL, n={n}, capacity {cap}, float32, "
        f"6a's fitted hyperparameters")
    world_of_one("nccl")
    mesh = make_matrix_mesh(1)
    prior, kernel, noise = fitted
    x, y, xq, x_add, y_add = bench_data(n)[:5]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    steps = {}

    # ---- the main path; both kernels' launches are counted over this run only
    reset_launches()
    t0 = sync()
    gp = LargeScaleGP(mesh, kernel, prior, float(noise), x, y, capacity=cap)
    steps["build_s"] = sync() - t0
    build_b2 = variant_launches()
    t0 = sync()
    moments = large_scale_moments(gp, torch.as_tensor(xq, device="cuda"))
    steps["predict_4096_s"] = sync() - t0
    t0 = sync()
    gp.fit_scaled(max_iter=2)
    steps["fit_scaled_2_s"] = sync() - t0
    steps["lml_fitted"] = gp.log_marginal_likelihood()
    t0 = sync()
    gp.add_samples(x_add, y_add)
    steps["add_samples_s"] = sync() - t0
    b1, _, b2 = read_launches()
    by_variant = variant_launches()
    # ---- end of the main path
    peak = torch.cuda.max_memory_allocated()
    factor_bytes = cap * cap * 4
    panels = cap // pick_block(cap, 2048)
    w_mean = witness["mean"]
    steps.update({
        "capacity": cap, "panels": panels, "build_panel_strip_launches": build_b2,
        "panel_strip_launches_by_variant": by_variant, "covariance_tile_launches": b1,
        "peak_bytes": peak, "peak_factors": peak / factor_bytes, "lml": moments["lml"],
        "mean_max_abs_err_vs_float64": float(np.abs(moments["mean"] - w_mean).max()),
        "streamed_mean_max_abs_err_vs_float64": witness["streamed_mean_err"],
        "var_max_abs_diff_vs_streamed": float(np.abs(moments["var"] - ref[1]).max()),
        "var_min": float(moments["var"].min()), "n_after_append": gp.n,
        "noise": float(gp.noise), "kernel_params": gp.kernel.get_params().tolist(),
    })
    log(json.dumps({"phase_11b": steps}))
    del gp
    torch.cuda.empty_cache()
    multihost.shutdown()
    only_variant(build_b2, "tf32x3", panels, "phase 11b's build (one launch per panel)")
    only_variant(by_variant, "tf32x3", b2, "phase 11b")
    if b1 <= 0:
        fail("phase 11b never launched the covariance kernel")
    if not (np.isfinite(moments["mean"]).all() and np.isfinite(moments["var"]).all()):
        fail("phase 11b: non-finite predictions")
    if steps["var_min"] < -1e-4:
        fail(f"phase 11b: negative predictive variance {steps['var_min']}")
    if not steps["mean_max_abs_err_vs_float64"] <= witness["streamed_mean_err"] + 1e-3:
        fail(f"phase 11b: the mean is {steps['mean_max_abs_err_vs_float64']} from the float64 witness, "
             f"the streamed model's {witness['streamed_mean_err']} (limit: the streamed model's + 1e-3)")
    if not steps["var_max_abs_diff_vs_streamed"] <= 1e-3:
        fail(f"phase 11b: variances differ from the streamed model's by "
             f"{steps['var_max_abs_diff_vs_streamed']} (limit 1e-3)")
    if not np.isfinite(steps["lml_fitted"]):
        fail("phase 11b: the fitted LML is not finite")
    if steps["n_after_append"] != cap:
        fail(f"phase 11b: add_samples left {steps['n_after_append']} samples, expected {cap}")
    if not peak < PEAK_FACTORS_11 * factor_bytes:
        fail(f"phase 11b: peak device memory {peak} B is not below {PEAK_FACTORS_11} factors")
    return steps


def factor_collectives(ranks: int, cap: int, b: int, d: int, store: str = "float32") -> dict:
    """What the distributed factorization must send
    (``tests/test_torch_parallel.py``'s contract): per panel whose owner is
    not the last rank, the owner's X_j (B, d), its panel rows (B,
    round_up(j0, 8)) and its (B, B) diagonal block; one flag."""
    from friedrich_tpu_torch.parallel.distributed_cholesky import ROW_PAD

    rows = cap // ranks
    want = {"all_reduce (1,) int32": 1}
    for j0 in range(0, cap, b):
        if j0 // rows == ranks - 1:
            continue
        for shape, dtype in (((b, d), "float32"), ((b, b), "float32"),
                             ((b, min(-(-j0 // ROW_PAD) * ROW_PAD, cap)), store)):
            if shape[1]:
                key = f"broadcast {shape} {dtype}"
                want[key] = want.get(key, 0) + 1
    return want


def _rank_11c(rank: int, url: str, out_dir: str, n: int, fitted_np: dict, theta_seed: int) -> None:
    """One rank of 11c, on the one card through gloo: the LargeScaleGP
    build and predict (launches and collectives of the build counted), then
    chain-sharded NUTS on 7b's dense density. Writes its results to
    ``out_dir``; any exception fails the rank (and the phase)."""
    import traceback

    try:
        import torch

        from friedrich_tpu_torch.interop import kernel_from_spec, prior_from_spec
        from friedrich_tpu_torch.mcmc import initial_signs, initial_theta, make_hyperparam_logprob
        from friedrich_tpu_torch.mcmc.sharded import sample_nuts_sharded
        from friedrich_tpu_torch.ops.cuda import panel_strip_cuda
        from friedrich_tpu_torch.parallel import (
            LargeScaleGP,
            make_chain_mesh,
            make_matrix_mesh,
            multihost,
        )
        from friedrich_tpu_torch.parallel.mesh import COLLECTIVES

        multihost.initialize(url, RANKS_11C, rank, backend="gloo", device="cuda:0")
        mesh = make_matrix_mesh(RANKS_11C)
        x, y, xq = bench_data(n)[:3]
        kernel = kernel_from_spec(fitted_np["kernel"])
        prior = prior_from_spec(fitted_np["prior"])
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        COLLECTIVES.clear()
        t0 = sync()
        gp = LargeScaleGP(mesh, kernel, prior, fitted_np["noise"], x, y, capacity=n + K_ADD)
        build_s = sync() - t0
        collectives = {f"{kind} {shape} {dtype}": v for (kind, shape, dtype), v in COLLECTIVES.items()}
        two_operand = dict(panel_strip_cuda.LAUNCHES_TWO_OPERAND)
        t0 = sync()
        moments = large_scale_moments(gp, torch.as_tensor(xq, device="cuda"))
        predict_s = sync() - t0
        b1, _, b2 = read_launches()
        peak = torch.cuda.max_memory_allocated()
        rows = gp.l_local.shape[0]
        del gp
        torch.cuda.empty_cache()
        # chain-sharded NUTS on 7b's dense density
        state = sampler_model(DENSITY_N_11C).state
        logp = make_hyperparam_logprob(state, signs=initial_signs(state))
        t0 = sync()
        res = sample_nuts_sharded(make_chain_mesh(RANKS_11C), logp, initial_theta(state), theta_seed,
                                  num_chains=CHAINS_11C * RANKS_11C, num_warmup=WARMUP_11C,
                                  num_samples=SAMPLES_11C, max_depth=SAMPLER_MAX_DEPTH)
        nuts_s = sync() - t0
        np.savez(os.path.join(out_dir, f"{rank}.npz"), mean=moments["mean"], var=moments["var"],
                 samples=res.samples.cpu().numpy())
        with open(os.path.join(out_dir, f"{rank}.json"), "w") as f:
            json.dump({"rank": rank, "lml": moments["lml"], "build_s": build_s, "predict_4096_s": predict_s,
                       "collectives": collectives, "two_operand_launches": two_operand,
                       "panel_strip_launches": b2, "covariance_tile_launches": b1, "peak_bytes": peak,
                       "rows": rows, "nuts_s": nuts_s, "step_size": float(res.step_size),
                       "inv_mass": res.inv_mass.tolist(),
                       "divergent": int(res.divergent.sum())}, f)
        multihost.shutdown()
    except Exception:  # written for the parent, then the rank fails
        with open(os.path.join(out_dir, f"{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)


def phase_two_ranks(fitted) -> dict:
    """11c: two ranks on the one card through gloo, spawned after the
    kernels are built: ``LargeScaleGP`` at n = 50,000 (capacity 50,512)
    built and predicting, held against a world-of-one model of the same
    points (LML within 1e-4 relative, means and variances within 1e-3);
    rank 1's two-operand B2 launches (more than 0); the build's collectives
    against the contract; chain-sharded NUTS on 7b's dense density, whose
    pooled step size must be the same on both ranks."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    from friedrich_tpu_torch.ops.partition import pick_block
    from friedrich_tpu_torch.parallel import LargeScaleGP, make_matrix_mesh, multihost

    n, cap = N_11C, N_11C + K_ADD
    log(f"== phase 11c: {RANKS_11C} ranks on the one card through gloo, LargeScaleGP at n={n}, "
        f"capacity {cap}; chain-sharded NUTS on 7b's dense density")
    from friedrich_tpu_torch.interop import kernel_spec, prior_spec

    prior, kernel, noise = fitted
    fitted_np = {"kernel": kernel_spec(kernel), "prior": prior_spec(prior), "noise": float(noise)}
    x, y, xq = bench_data(n)[:3]
    # the world-of-one model of the same points
    world_of_one("nccl")
    t0 = sync()
    gp = LargeScaleGP(make_matrix_mesh(1), kernel, prior, float(noise), x, y, capacity=cap)
    one_build_s = sync() - t0
    one = large_scale_moments(gp, torch.as_tensor(xq, device="cuda"))
    del gp
    torch.cuda.empty_cache()
    multihost.shutdown()

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_11c_")
    url = f"tcp://127.0.0.1:{multihost.free_port()}"
    ctx = mp.get_context("spawn")
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_rank_11c, args=(r, url, out_dir, n, fitted_np, 7))
             for r in range(RANKS_11C)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + RANK_TIMEOUT_S
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    wall = time.perf_counter() - t0
    errors = [open(os.path.join(out_dir, f"{r}.err")).read() for r in range(RANKS_11C)
              if os.path.exists(os.path.join(out_dir, f"{r}.err"))]
    if errors or any(p.exitcode != 0 for p in procs):
        fail(f"phase 11c: a rank failed (exit codes {[p.exitcode for p in procs]}):\n" + "\n".join(errors))
    ranks = []
    for r in range(RANKS_11C):
        with open(os.path.join(out_dir, f"{r}.json")) as f:
            info = json.load(f)
        arrays = np.load(os.path.join(out_dir, f"{r}.npz"))
        info.update({k: arrays[k] for k in arrays.files})
        ranks.append(info)
    b = pick_block(cap // RANKS_11C, 2048)
    want = factor_collectives(RANKS_11C, cap, b, D)
    r0 = ranks[0]
    steps = {
        "ranks": RANKS_11C, "capacity": cap, "panel": b, "wall_s": wall,
        "world_of_one_build_s": one_build_s, "lml": r0["lml"], "lml_world_of_one": one["lml"],
        "lml_rel_diff": abs(r0["lml"] - one["lml"]) / abs(one["lml"]),
        "mean_max_abs_diff": float(np.abs(r0["mean"] - one["mean"]).max()),
        "var_max_abs_diff": float(np.abs(r0["var"] - one["var"]).max()),
        "per_rank": [{k: v for k, v in info.items() if k not in ("mean", "var", "samples")}
                     for info in ranks],
        "collectives_expected": want,
    }
    log(json.dumps({"phase_11c": steps}))
    for info in ranks:
        if info["collectives"] != want:
            fail(f"phase 11c: rank {info['rank']}'s build sent {info['collectives']}, the contract {want}")
        if not np.array_equal(info["mean"], r0["mean"]) or not np.array_equal(info["var"], r0["var"]):
            fail(f"phase 11c: rank {info['rank']}'s predictions differ from rank 0's")
        if info["step_size"] != r0["step_size"] or info["inv_mass"] != r0["inv_mass"]:
            fail(f"phase 11c: rank {info['rank']}'s pooled step size {info['step_size']} or mass differs "
                 f"from rank 0's {r0['step_size']}")
        if not np.isfinite(info["samples"]).all():
            fail(f"phase 11c: rank {info['rank']} drew non-finite samples")
    per_rank = cap // RANKS_11C // b
    for info in ranks:
        # every strip of the rank's rows at or below a panel is one B2 launch,
        # its rows of the predict's cross-covariance one B1 launch
        if info["panel_strip_launches"] != (info["rank"] + 1) * per_rank:
            fail(f"phase 11c: rank {info['rank']} made {info['panel_strip_launches']} B2 launches, "
                 f"expected {(info['rank'] + 1) * per_rank}")
        if not info["covariance_tile_launches"] > 0:
            fail(f"phase 11c: rank {info['rank']} never launched the covariance kernel")
    below = ranks[1]["two_operand_launches"]
    if not below["tf32x3"] > 0 or sum(below.values()) != below["tf32x3"]:
        fail(f"phase 11c: rank 1 made two-operand B2 launches {below}; some 3xTF32 and no other")
    if ranks[0]["two_operand_launches"]["tf32x3"] != 0:
        fail("phase 11c: rank 0 (above every panel of rank 1) made two-operand launches")
    if not steps["lml_rel_diff"] <= LML_RTOL_11C:
        fail(f"phase 11c: LML {r0['lml']} differs from the world of one's {one['lml']} by more than "
             f"{LML_RTOL_11C} relative")
    if not (steps["mean_max_abs_diff"] <= MOMENT_ATOL_11C and steps["var_max_abs_diff"] <= MOMENT_ATOL_11C):
        fail(f"phase 11c: means differ from the world of one's by {steps['mean_max_abs_diff']}, variances "
             f"by {steps['var_max_abs_diff']} (limit {MOMENT_ATOL_11C})")
    return {"steps": steps, "launches": sum(info["panel_strip_launches"] for info in ranks),
            "two_operand_launches": below["tf32x3"],
            "covariance_tile_launches": sum(info["covariance_tile_launches"] for info in ranks)}


def phase_distributed_sampler() -> dict:
    """11d: ``sample_hyperparameters_distributed`` on a world of one (NCCL)
    at 7a's n = 4,096: one chain, 10 + 10 transitions, 64 probes, the
    distributed density's factorization B2 (3xTF32); every draw finite."""
    import torch

    from friedrich_tpu_torch.mcmc.distributed_logprob import sample_hyperparameters_distributed
    from friedrich_tpu_torch.parallel import make_matrix_mesh, multihost

    log(f"== phase 11d: sample_hyperparameters_distributed, world of one, n={N_11D}, 1 chain, "
        f"{WARMUP_11D}+{SAMPLES_11D} transitions, {SAMPLER_PROBES} probes")
    world_of_one("nccl")
    state = sampler_model(N_11D).state
    reset_launches()
    t0 = sync()
    res = sample_hyperparameters_distributed(make_matrix_mesh(1), state, 0, num_warmup=WARMUP_11D,
                                             num_samples=SAMPLES_11D, num_chains=1,
                                             max_depth=SAMPLER_MAX_DEPTH, num_probes=SAMPLER_PROBES)
    seconds = sync() - t0
    by_variant = variant_launches()
    multihost.shutdown()
    steps = {"seconds": seconds, "transitions_per_s": (WARMUP_11D + SAMPLES_11D) / seconds,
             "step_size": res.step_size.tolist(), "divergent": int(res.divergent.sum()),
             "mean_tree_depth": float(res.tree_depth.float().mean()),
             "panel_strip_launches_by_variant": by_variant,
             "samples_mean": res.samples.mean(dim=(0, 1)).tolist()}
    log(json.dumps({"phase_11d": steps}))
    if res.samples.shape != (SAMPLES_11D, 1, 3) or not bool(torch.isfinite(res.samples).all()):
        fail(f"phase 11d: draws of shape {tuple(res.samples.shape)} or not finite")
    if not by_variant["tf32x3"] > 0 or sum(by_variant.values()) != by_variant["tf32x3"]:
        fail(f"phase 11d: the distributed density's launches {by_variant}; some 3xTF32 and no other")
    return {"steps": steps, "launches": by_variant["tf32x3"]}


def phase_eleven(fitted, n: int, ref, witness, entry: dict, streamed_entry: dict) -> dict:
    """Phase 11 in order; the kernel line's entries gain its launches.
    Returns 11a's two-operand row."""
    t11 = time.perf_counter()
    row = phase_two_operand()
    one = phase_large_scale_one(fitted, n, ref, witness)
    two = phase_two_ranks(fitted)
    sampled = phase_distributed_sampler()
    streamed_entry["launches_11b_world_of_one"] = one["panel_strip_launches_by_variant"]["tf32x3"]
    streamed_entry["launches_11c_two_ranks"] = two["launches"]
    streamed_entry["launches_11d_distributed_density"] = sampled["launches"]
    entry["launches_11b_world_of_one"] = one["covariance_tile_launches"]
    entry["launches_11c_two_ranks"] = two["covariance_tile_launches"]
    row["launches"] = two["two_operand_launches"]
    log(f"phase 11 took {time.perf_counter() - t11} s")
    return row


# ---------------------------------------------------------------------------
# phase 12: serving a LargeScaleGP across ranks, and the example twins
# ---------------------------------------------------------------------------

#: 12b: the two ranks' model (11c's size), their client threads and
#: requests each (1-512 rows, seed 12).
RANKS_12B, N_12B = 2, 50_000
CLIENTS_12B, REQUESTS_12B, MAX_ROWS_12B = 2, 3, 512
#: The twins' sizes on the card: the JAX scripts' defaults, but for these.
TWIN_SIZES = {"outofcore_gp": 50_000, "large_scale_fit": 20_000}
#: 12c: a twin's predictions within this of float32's (PERF.md section 2's
#: bf16 gate) and the daemon's float64 within 9d's gate of the card's.
TWIN_BF16_ATOL = 0.05


def fitted_6a_alone(n: int):
    """6a's fitted hyperparameters from the builder's default flow at ``n``
    points (``--phase11``, ``--phase12``)."""
    import torch

    import friedrich_tpu_torch as ft

    x, y = bench_data(n)[:2]
    log(f"== the builder's default flow at n={n} for 6a's fitted hyperparameters")
    gp = (ft.GaussianProcessBuilder(x, y, device="cuda")
          .set_noise(1.0).set_dtype("float32").set_capacity(n + K_ADD).set_backend("streamed")
          .set_fit_parameters(100, 0.05).fit_kernel().fit_prior().train())  # phase 6a's chain
    fitted = (gp.prior, gp.kernel.to(torch.float32, "cpu"), gp.noise)
    del gp
    torch.cuda.empty_cache()
    return fitted


def phase_serve_large_scale(fitted, n: int) -> dict:
    """12a: ``AcceleratedGPServer`` over a ``LargeScaleGP`` at ``n`` points
    (capacity n + 512, 6a's fitted hyperparameters, 11b's model) on NCCL's
    world of one: 9c's 4 clients x 8 requests, each reply within
    SERVE_ATOL of ``predict_mean_variance(rows, block=256)``, p50 and p99,
    B1's launches; a world of one sends no collective."""
    import torch

    from friedrich_tpu_torch.parallel import LargeScaleGP, make_matrix_mesh, multihost
    from friedrich_tpu_torch.parallel.mesh import COLLECTIVES

    world_of_one("nccl")
    prior, kernel, noise = fitted
    x, y = bench_data(n)[:2]
    t0 = sync()
    gp = LargeScaleGP(make_matrix_mesh(1), kernel, prior, float(noise), x, y, capacity=n + K_ADD)
    build_s = sync() - t0
    COLLECTIVES.clear()
    out = phase_serving(gp, "12a", f"a LargeScaleGP of {n} points on NCCL's world of one")
    out["build_s"] = build_s
    out["collectives"] = {f"{k}": v for k, v in COLLECTIVES.items()}
    del gp
    torch.cuda.empty_cache()
    multihost.shutdown()
    if out["collectives"]:
        fail(f"phase 12a: a world of one sent collectives {out['collectives']}")
    return out


def _rank_12b(rank: int, url: str, out_dir: str, model: dict, l_full, block: int, plan) -> None:
    """One rank of 12b on the one card through gloo: a LargeScaleGP on its
    row block of the world of one's factor ``l_full`` (shared from the
    parent's memory on the card), every request answered in process at the
    server's width; then rank 0 serves the plan to its client threads
    while rank 1 follows. Writes its results to ``out_dir``; any exception
    fails the rank."""
    import threading
    import traceback

    try:
        import torch

        from friedrich_tpu_torch import serving
        from friedrich_tpu_torch.interop import kernel_from_spec, prior_from_spec
        from friedrich_tpu_torch.parallel import LargeScaleGP, make_matrix_mesh, multihost
        from friedrich_tpu_torch.parallel.mesh import COLLECTIVES

        multihost.initialize(url, RANKS_12B, rank, backend="gloo", device="cuda:0")
        mesh = make_matrix_mesh(RANKS_12B)
        r0, r1 = mesh.rows(l_full.shape[0])
        gp = LargeScaleGP.from_factor(mesh, kernel_from_spec(model["kernel"]), prior_from_spec(model["prior"]),
                                      model["noise"], model["x"], model["resid"], model["n"],
                                      l_full[r0:r1], block=block)
        flat = [xq for reqs in plan for xq in reqs]
        in_process = [[t.cpu().numpy() for t in gp.predict_mean_variance(xq, block=SERVE_BLOCK)]
                      for xq in flat]
        reset_launches()
        COLLECTIVES.clear()
        info = {"rank": rank}
        arrays = {}
        t0 = sync()
        if rank == 0:
            replies = [[None] * len(reqs) for reqs in plan]
            latencies, errors = [], []
            with serving.AcceleratedGPServer(gp, block=SERVE_BLOCK) as srv:
                def client(i):
                    try:
                        with serving.GPClient(port=srv.port, timeout=600.0) as c:
                            for k, xq in enumerate(plan[i]):
                                t1 = time.perf_counter()
                                replies[i][k] = c.predict_mean_variance(xq)
                                latencies.append(time.perf_counter() - t1)
                    except Exception as e:  # noqa: BLE001 — reported below
                        errors.append(repr(e))

                threads = [threading.Thread(target=client, args=(i,)) for i in range(len(plan))]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
            info.update({"errors": errors, "latencies_s": sorted(latencies),
                         "sweeps": sum(srv.dispatches.values()),
                         "broken": repr(srv.broken) if srv.broken is not None else None})
            served = [r for reqs in replies for r in reqs]
            for k, r in enumerate(served):
                if r is not None:
                    arrays[f"mean_{k}"], arrays[f"var_{k}"] = r
        else:
            info["sweeps"] = serving.follow(gp)
        info["serve_s"] = sync() - t0
        b1, _, b2 = read_launches()
        info.update({"covariance_tile_launches": b1, "panel_strip_launches": b2,
                     "collectives": {f"{kind} {shape} {dtype}": v
                                     for (kind, shape, dtype), v in COLLECTIVES.items()}})
        for k, (mean, var) in enumerate(in_process):
            arrays[f"in_process_mean_{k}"], arrays[f"in_process_var_{k}"] = mean, var
        np.savez(os.path.join(out_dir, f"{rank}.npz"), **arrays)
        with open(os.path.join(out_dir, f"{rank}.json"), "w") as f:
            json.dump(info, f)
        multihost.shutdown()
    except Exception:  # written for the parent, then the rank fails
        with open(os.path.join(out_dir, f"{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)


def phase_serve_two_ranks(fitted) -> dict:
    """12b: 11c's two gloo ranks on the one card at n = 50,000 (capacity
    50,512), rank 0 serving 2 client threads of 3 requests each and rank 1
    following, each on its row block of a world of one's factor (11c holds
    two factorizations at different row splits to each other); each reply
    within SERVE_ATOL of that world of one's ``predict_mean_variance(rows,
    block=256)`` and equal to rank 0's in-process answer; both ranks take
    part in the same sweeps."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    from friedrich_tpu_torch.interop import kernel_spec, prior_spec
    from friedrich_tpu_torch.ops.partition import pick_block
    from friedrich_tpu_torch.parallel import LargeScaleGP, make_matrix_mesh, multihost

    n, cap = N_12B, N_12B + K_ADD
    b = pick_block(cap // RANKS_12B, 2048)
    log(f"== phase 12b: {RANKS_12B} gloo ranks on the one card serve a LargeScaleGP of {n} points "
        f"(panel {b}), {CLIENTS_12B} clients x {REQUESTS_12B} requests, against a world of one")
    prior, kernel, noise = fitted
    rng = np.random.default_rng(12)
    plan = [[rng.normal(size=(int(rng.integers(1, MAX_ROWS_12B + 1)), D)) for _ in range(REQUESTS_12B)]
            for _ in range(CLIENTS_12B)]
    flat = [xq for reqs in plan for xq in reqs]
    x, y = bench_data(n)[:2]
    world_of_one("nccl")
    gp = LargeScaleGP(make_matrix_mesh(1), kernel, prior, float(noise), x, y, capacity=cap, block=b)
    one = [[t.cpu().numpy() for t in gp.predict_mean_variance(xq, block=SERVE_BLOCK)] for xq in flat]
    model = {"kernel": kernel_spec(gp.kernel), "prior": prior_spec(gp.prior), "noise": float(gp.noise),
             "x": gp.x.cpu().numpy(), "resid": gp.resid.cpu().numpy(), "n": gp.n}
    l_full = gp.l_local  # kept alive until the ranks end: they read it in place
    del gp
    multihost.shutdown()

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_12b_")
    url = f"tcp://127.0.0.1:{multihost.free_port()}"
    ctx = mp.get_context("spawn")
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_rank_12b, args=(r, url, out_dir, model, l_full, b, plan))
             for r in range(RANKS_12B)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + RANK_TIMEOUT_S
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    wall = time.perf_counter() - t0
    del l_full
    torch.cuda.empty_cache()
    errors = [open(os.path.join(out_dir, f"{r}.err")).read() for r in range(RANKS_12B)
              if os.path.exists(os.path.join(out_dir, f"{r}.err"))]
    if errors or any(p.exitcode != 0 for p in procs):
        fail(f"phase 12b: a rank failed (exit codes {[p.exitcode for p in procs]}):\n" + "\n".join(errors))
    ranks = []
    for r in range(RANKS_12B):
        with open(os.path.join(out_dir, f"{r}.json")) as f:
            info = json.load(f)
        info["arrays"] = dict(np.load(os.path.join(out_dir, f"{r}.npz")))
        ranks.append(info)
    lead = ranks[0]
    vs_one, vs_in_process, in_process_vs_one = 0.0, 0.0, 0.0
    for k, (want_mean, want_var) in enumerate(one):
        a = lead["arrays"]
        if f"mean_{k}" not in a:
            fail(f"phase 12b: request {k} was not answered ({lead['errors']})")
        mean, var = a[f"mean_{k}"], a[f"var_{k}"]
        vs_one = max(vs_one, float(np.abs(mean - want_mean).max()), float(np.abs(var - want_var).max()))
        vs_in_process = max(vs_in_process, float(np.abs(mean - a[f"in_process_mean_{k}"]).max()),
                            float(np.abs(var - a[f"in_process_var_{k}"]).max()))
        in_process_vs_one = max(in_process_vs_one,
                                float(np.abs(a[f"in_process_mean_{k}"] - want_mean).max()))
    lat = lead["latencies_s"]
    steps = {"ranks": RANKS_12B, "capacity": cap, "panel": b, "wall_s": wall,
             "requests": len(flat), "rows": sum(q.shape[0] for q in flat),
             "latency_p50_s": lat[len(lat) // 2] if lat else None, "latency_max_s": lat[-1] if lat else None,
             "max_abs_diff_vs_world_of_one": vs_one, "max_abs_diff_vs_rank0_in_process": vs_in_process,
             "in_process_mean_max_abs_diff_vs_world_of_one": in_process_vs_one, "tolerance": SERVE_ATOL,
             "per_rank": [{k: v for k, v in info.items() if k != "arrays"} for info in ranks]}
    log(json.dumps({"phase_12b": steps}))
    if lead["errors"] or lead["broken"]:
        fail(f"phase 12b: requests failed: {lead['errors']} (server broken: {lead['broken']})")
    if any(info["sweeps"] != lead["sweeps"] for info in ranks):
        fail(f"phase 12b: the ranks took part in {[info['sweeps'] for info in ranks]} sweeps")
    if any(info["covariance_tile_launches"] <= 0 for info in ranks):
        fail("phase 12b: a rank's sweeps never launched the covariance kernel")
    if not vs_in_process == 0.0:
        fail(f"phase 12b: replies differ from rank 0's in-process answers by {vs_in_process}")
    if not vs_one <= SERVE_ATOL:
        fail(f"phase 12b: replies differ from the world of one's by {vs_one} (limit {SERVE_ATOL})")
    return {"steps": steps, "covariance_tile_launches": sum(i["covariance_tile_launches"] for i in ranks)}


def _finite(*arrays) -> bool:
    return all(np.isfinite(np.asarray(a, dtype=np.float64)).all() for a in arrays)


def phase_twins() -> dict:
    """12c: each example twin's ``main`` on the card at its JAX script's
    defaults (``TWIN_SIZES`` larger), with the kernels' launches of each;
    gates: finite numbers, variances >= -1e-4, fitted LMLs above the
    start's, the sampler's R-hat below 1.1, the daemon within 9d's gate of
    the card, bf16 predictions within 0.05 of float32's, and each precision
    mode on its own B2 instantiation."""
    import torch

    from friedrich_tpu_torch import config, mcmc
    from friedrich_tpu_torch.examples import (
        bayesian_hyperparameters,
        bayesian_optimization,
        distributed_gp,
        large_scale_fit,
        outofcore_gp,
        precision_modes,
        serving_deployment,
    )

    runs = [
        ("bayesian_optimization", lambda: bayesian_optimization.main(device="cuda")),
        ("serving_deployment", lambda: serving_deployment.main(device="cuda")),
        ("distributed_gp", lambda: distributed_gp.main(device="cuda")),
        ("bayesian_hyperparameters", lambda: bayesian_hyperparameters.main(device="cuda")),
        ("large_scale_fit", lambda: large_scale_fit.main(n=TWIN_SIZES["large_scale_fit"], device="cuda")),
        ("outofcore_gp", lambda: outofcore_gp.main(n=TWIN_SIZES["outofcore_gp"], device="cuda")),
        ("precision_modes", lambda: precision_modes.main(device="cuda")),
    ]
    # the twins run at their scripts' ambient default dtype, float32: the
    # demo of phase 3 made float64 this process's default
    x64, config._x64 = config._x64, False
    rows, results = {}, {}
    try:
        for name, run in runs:
            log(f"== phase 12c: examples/{name}.py's twin on the card")
            reset_launches()
            t0 = sync()
            results[name] = run()
            seconds = sync() - t0
            b1, _, b2 = read_launches()
            rows[name] = {"seconds": seconds, "covariance_tile_launches": b1, "panel_strip_launches": b2,
                          "panel_strip_launches_by_variant": variant_launches()}
            sys.stdout.flush()
            log(json.dumps({"phase_12c": {name: rows[name]}}))
            torch.cuda.empty_cache()
    finally:
        config._x64 = x64

    def gate(ok: bool, name: str, what: str) -> None:
        if not ok:
            fail(f"phase 12c: {name}: {what}")

    best = results["bayesian_optimization"]
    gate(np.isfinite(best) and best > 0.9, "bayesian_optimization", f"best found {best} (at most 0.9)")
    mean, mean2 = results["serving_deployment"]
    gate(_finite(mean, mean2), "serving_deployment", "served answers not finite")
    gate(float(np.abs(mean - mean2).max()) <= DAEMON_ATOL, "serving_deployment",
         f"the daemon and the card differ by {float(np.abs(mean - mean2).max())}")
    gp = results["distributed_gp"]
    mean_d, var_d = gp.predict_mean_variance(bench_data(64)[2][:256, :4])
    gate(np.isfinite(gp.log_marginal_likelihood()) and _finite(mean_d.cpu(), var_d.cpu()),
         "distributed_gp", "LML or predictions not finite")
    gate(float(var_d.min()) >= -1e-4, "distributed_gp", f"variance {float(var_d.min())}")
    del gp
    res = results["bayesian_hyperparameters"]
    r_hat = mcmc.rhat(res.samples.cpu())
    gate(_finite(res.samples.cpu()) and bool((r_hat < 1.1).all()), "bayesian_hyperparameters",
         f"R-hat {r_hat.tolist()}")
    fit = results["large_scale_fit"]
    gate(_finite(fit["lml_initial"], fit["predictions"], *(fit[k]["lml"] for k in ("subsampled", "hutchinson", "auto"))),
         "large_scale_fit", "not finite")
    for key in ("subsampled", "hutchinson"):
        gate(fit[key]["lml"] > fit["lml_initial"], "large_scale_fit",
             f"the {key} fit's LML {fit[key]['lml']} is not above the start's {fit['lml_initial']}")
    ooc = results["outofcore_gp"]
    gate(_finite(ooc["mean"], ooc["var"], ooc["lml"]), "outofcore_gp", "not finite")
    gate(float(ooc["var"].min()) >= -1e-4, "outofcore_gp", f"variance {float(ooc['var'].min())}")
    gate(ooc["n"] == TWIN_SIZES["outofcore_gp"] + 64, "outofcore_gp", f"n after the append {ooc['n']}")
    gate(rows["outofcore_gp"]["panel_strip_launches_by_variant"]["tf32x3"] > 0, "outofcore_gp",
         "the explicit-prefix entry never launched")
    modes = results["precision_modes"]
    gate(_finite(*modes.values()), "precision_modes", "not finite")
    for label in ("bf16", "default+bf16store"):
        spread = float(np.abs(modes[label] - modes["f32"]).max())
        gate(spread <= TWIN_BF16_ATOL, "precision_modes", f"{label} is {spread} from f32")
    by_variant = rows["precision_modes"]["panel_strip_launches_by_variant"]
    for kind in ("one_pass", "tf32x3", "bf16"):
        gate(by_variant[kind] > 0, "precision_modes", f"the {kind} instantiation never launched")
    for name, row in rows.items():
        gate(row["covariance_tile_launches"] > 0, name, "the covariance kernel never launched")
    return rows


def phase_twelve(fitted, n: int) -> dict:
    """Phase 12 in order; returns the launches it adds to the kernel line."""
    t12 = time.perf_counter()
    served = phase_serve_large_scale(fitted, n)
    two = phase_serve_two_ranks(fitted)
    twins = phase_twins()
    log(f"phase 12 took {time.perf_counter() - t12} s")
    by_variant = {kind: sum(row["panel_strip_launches_by_variant"][kind] for row in twins.values())
                  for kind in ("tf32x3", "one_pass", "bf16", "f64")}
    return {"covariance_tile": {"launches_12a_serving": served["covariance_tile_launches"],
                                "launches_12b_two_ranks": two["covariance_tile_launches"],
                                "launches_12c_twins": sum(r["covariance_tile_launches"] for r in twins.values())},
            "panel_strip_12c_twins": by_variant}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--n", type=int, default=50_000,
                        help="training points of the dense full-width phase (default 50,000)")
    parser.add_argument("--streamed-n", type=int, default=100_000,
                        help="training points of the streamed full-width phase and of 8b (default 100,000)")
    parser.add_argument("--f64-n", type=int, default=F64_N,
                        help="training points of the float64 flow, phase 10 (default 70,000)")
    parser.add_argument("--panel-times", action="store_true",
                        help="only time B2 at the main path's panels (panel_times) and exit")
    parser.add_argument("--errors", action="store_true",
                        help="with --panel-times, also the downdate errors against float64")
    parser.add_argument("--phase11", action="store_true",
                        help="only phase 1 and phase 11 (the multi-rank layer; its reference "
                             "model fitted here) and exit")
    parser.add_argument("--phase12", action="store_true",
                        help="only phase 1 and phase 12 (serving a LargeScaleGP across ranks, the "
                             "example twins; 6a's hyperparameters fitted here) and exit")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: FAILED: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    import friedrich_tpu_torch  # noqa: F401  (fails outside the repository)

    if args.panel_times:
        panel_times(args.errors)
        return 0
    phase_environment()
    if args.phase11:
        fitted, ref, witness = phase11_reference(args.streamed_n)
        b1_counts: dict = {}
        b2_counts: dict = {}
        row = phase_eleven(fitted, args.streamed_n, ref, witness, b1_counts, b2_counts)
        log(json.dumps({"phase_11_launches": {"covariance_tile": b1_counts, "panel_strip": b2_counts},
                        "two_operand": row}))
        return 0
    if args.phase12:
        log(json.dumps({"phase_12_launches": phase_twelve(fitted_6a_alone(args.streamed_n),
                                                          args.streamed_n)}))
        return 0
    phase_kernel_vs_plain()
    phase_parity()
    entry, fitted = phase_full_width(args.n)
    torch.cuda.empty_cache()
    phase_panel_strip_vs_plain()
    phase_streamed_vs_dense(fitted, args.n)
    fitted_50k = fitted
    torch.cuda.empty_cache()
    streamed_entry, fitted, b1_cross, flow_5c = phase_streamed_full_width(args.streamed_n)
    entry["shapes"].append(b1_cross)
    torch.cuda.empty_cache()
    phase_refit(fitted, args.streamed_n)
    del fitted
    torch.cuda.empty_cache()
    t6 = time.perf_counter()
    default, gp, sub_gp, b1_sub = phase_default_flow(args.streamed_n, flow_5c["lml_start"],
                                                     flow_5c["lml_fitted"])
    entry["shapes"].append(b1_sub)
    entry["max_abs_err"] = max(entry["max_abs_err"], b1_sub["max_abs_err"])
    entry["launches_default_flow"] = default["covariance_tile_launches"]
    streamed_entry["launches_default_flow"] = default["panel_strip_launches"]
    fitted_6a = (gp.prior, gp.kernel.to(torch.float32, "cpu"), gp.noise)
    refit = phase_full_n_refit(gp)
    streamed_entry["launches_full_n_refit"] = refit["panel_strip_launches"]
    del gp
    torch.cuda.empty_cache()
    map_fits = phase_densities_and_map_fit(sub_gp, fitted_50k, args.n)
    streamed_entry["max_abs_err"] = max(streamed_entry["max_abs_err"], map_fits["panel_max_abs_err"])
    phase_save_load(sub_gp)
    del sub_gp
    torch.cuda.empty_cache()
    log(f"phase 6 took {time.perf_counter() - t6} s")
    t7 = time.perf_counter()
    sampled_7a, gp_7a, res_7a = phase_sampler_streamed()
    streamed_entry["launches_sampler_7a"] = sampled_7a["panel_strip_launches"]
    nuts_7b, hmc_7b, gp_7b, by_shape_7b = phase_sampler_dense()
    entry["launches_sampler_7b_nuts"] = nuts_7b["covariance_tile_launches"]
    entry["launches_sampler_7b_hmc"] = hmc_7b["covariance_tile_launches"]
    predictive, by_shape_7c = phase_predictive(gp_7a, res_7a)
    entry["launches_predictive_7c"] = predictive["covariance_tile_launches"]
    phase_sampler_kernels(gp_7a, res_7a, gp_7b, {"7b": by_shape_7b, "7c": by_shape_7c},
                          (entry, streamed_entry))
    del gp_7a, gp_7b, res_7a
    phase_sampler_sanity()
    log(f"phase 7 took {time.perf_counter() - t7} s")
    t8 = time.perf_counter()
    bf16_entry, fitted_bf16, _ = phase_bf16_storage(BF16_N)
    torch.cuda.empty_cache()
    compared = phase_bf16_vs_f32(fitted_bf16, args.streamed_n)
    one_pass_entry = compared["entry"]
    bf16_entry["launches_8b"] = compared["launches_bf16"]
    streamed_entry["launches_8b"] = compared["launches_tf32x3"]
    torch.cuda.empty_cache()
    ooc = phase_outofcore()
    bf16_entry["launches_8c_outofcore"] = ooc["bf16_n100k"]["panel_strip_launches"]
    streamed_entry["launches_8c_outofcore"] = ooc["f32_n50k"]["launches"]["tf32x3"]
    bf16_entry["max_abs_err"] = max(bf16_entry["max_abs_err"], ooc["bf16_n100k"]["prefix_max_abs_err"])
    streamed_entry["max_abs_err"] = max(streamed_entry["max_abs_err"], ooc["f32_n50k"]["prefix_max_abs_err"])
    log(f"phase 8 took {time.perf_counter() - t8} s")
    t9 = time.perf_counter()
    ref = phase9_reference(fitted_6a, args.streamed_n)
    # 9c serves 9a's model before 9b: two factors at 100,512 do not fit the card
    tiled, gp = phase_tiled_hybrid("tiled", fitted_6a, args.streamed_n, ref)
    served = phase_serving(gp)
    del gp
    torch.cuda.empty_cache()
    b1_tiled, b1_served = phase_tiled_b1(fitted_6a, args.streamed_n, tiled["b1_by_shape"],
                                         served["covariance_tile_launches"])
    hybrid, gp = phase_tiled_hybrid("hybrid", fitted_6a, args.streamed_n, ref, tiled["witness"])
    del gp
    torch.cuda.empty_cache()
    phase_float64_witness(fitted_6a, WITNESS_N)
    phase_daemon(fitted_6a, args.streamed_n)
    f64_launches = sum(d["panel_strip_launches"] for d in map_fits["densities"]
                       if d["dtype"] == "float64" and d["density"] == "streamed")
    explicit_entry, f64_density = phase_b2_other_rows(ooc["bf16_n100k"]["panel_strip_launches"],
                                                      f64_launches)
    entry["shapes"] += [b1_tiled, b1_served, hybrid["b1_s22"]]
    entry["max_abs_err"] = max(entry["max_abs_err"], b1_tiled["max_abs_err"], b1_served["max_abs_err"],
                               hybrid["b1_s22"]["max_abs_err"])
    entry["launches_9a_tiled"] = tiled["covariance_tile_launches"]
    entry["launches_9b_hybrid"] = hybrid["covariance_tile_launches"]
    entry["launches_9c_serving"] = served["covariance_tile_launches"]
    streamed_entry["launches_9b_hybrid"] = hybrid["panel_strip_launches"]
    streamed_entry["max_abs_err"] = max(streamed_entry["max_abs_err"], hybrid["leaf_panel_max_abs_err"])
    log(f"phase 9 took {time.perf_counter() - t9} s")
    t10 = time.perf_counter()
    flow_10 = phase_float64_flow(args.f64_n)
    middle = flow_10["middle"]
    f64_entry = {
        "name": "panel_strip_f64", "route": "cuda", "source": "friedrich_tpu_torch/csrc/panel_strip.cu",
        "replaces": "friedrich_tpu/ops/pallas/panel_fused.py:102", "launches": flow_10["launches"],
        "max_abs_err": max(flow_10["max_abs_err"], f64_density["max_abs_err"]), "ms": middle["ms"],
        "plain_ms": middle["plain_ms"], "bound_ms": middle["bound_ms"], "bound_by": middle["bound_by"],
        "library_ms": middle["library_ms"],
        "library_call": "torch.addmm(k_strip, L[j0:, :j0], L[j0:j0+B, :j0].T, alpha=-1), float64",
        "bound": "float64 tensor cores at 67 TFLOP/s", "shape": middle["shape"],
        "launches_6c": f64_density["launches"], "density_4096": f64_density,
    }
    entry["shapes"] += flow_10["b1"]
    entry["max_abs_err"] = max(entry["max_abs_err"], flow_10["b1"][1]["max_abs_err"])
    entry["launches_10_float64"] = flow_10["steps"]["covariance_tile_launches"]
    log(f"phase 10 took {time.perf_counter() - t10} s")
    torch.cuda.empty_cache()
    two_operand_entry = phase_eleven(fitted_6a, args.streamed_n, ref, tiled["witness"], entry,
                                     streamed_entry)
    torch.cuda.empty_cache()
    twelve = phase_twelve(fitted_6a, args.streamed_n)
    entry.update(twelve["covariance_tile"])
    for row, kind in ((streamed_entry, "tf32x3"), (one_pass_entry, "one_pass"), (bf16_entry, "bf16"),
                      (f64_entry, "f64")):
        row["launches_12c_twins"] = twelve["panel_strip_12c_twins"][kind]
    log(smi_line())
    log(json.dumps({"kernels": [entry, streamed_entry, bf16_entry, one_pass_entry, explicit_entry,
                                f64_entry, two_operand_entry]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
