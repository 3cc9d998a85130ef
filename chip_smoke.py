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

The last three lines are the card's ``nvidia-smi`` name and power limit, a
JSON line describing each kernel, and ``{"ok": true, "device": ...}``.
``--n`` and ``--streamed-n`` shrink the full-width phases (4 and 5b; 5c,
5d, 6a, 6b and 8b) for a quick check.
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

#: Published H100 SXM rates used for the bound (NVIDIA data sheet).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12

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


def ptxas_table(report: str) -> dict:
    """Registers, static shared memory and spill stores of each kernel
    instantiation in the ``-Xptxas -v`` report, by readable name: the
    covariance kernel by dtype, method and map (a leaf, or the program
    interpreter), the panel-strip kernels by their template arguments."""
    from friedrich_tpu_torch.ops.cuda import build

    maps = {str(op): cls.__name__ for cls, op in build.OPCODES.items()}
    maps["n1"] = "program"
    methods = {str(v): k for k, v in build.METHODS.items()}
    dtypes = {"f": "float", "d": "double"}
    table: dict = {}
    entry, spill = None, 0
    for line in report.splitlines():  # each entry function, its spills, its "Used N registers"
        m = re.search(r"Compiling entry function '\w*?\d+cov_kernel\w*?I([fd])Li(\d+)ELi(n?\d+)E", line)
        if m:
            entry = f"cov_kernel<{dtypes[m.group(1)]},{methods[m.group(2)]},{maps[m.group(3)]}>"
            spill = 0
            continue
        m = re.search(r"Compiling entry function '\w*?\d+(panel_strip_kernel|panel_strip_tf32x3_kernel|"
                      r"panel_strip_ws_kernel)I(\w*?)EEv", line)
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
            entry = f"{m.group(1)}<{','.join(parts)}>"
            spill = 0
            continue
        if re.search(r"Compiling entry function '\w*?bf16_rows_kernel", line):
            entry, spill = "bf16_rows_kernel", 0
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and entry:
            spill = max(spill, int(m.group(1)))
        m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", line)
        if m and entry:
            table[entry] = {"registers": int(m.group(1)), "static_smem_bytes": int(m.group(2)),
                            "spill_stores": spill}
            entry = None
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
               if k.startswith(("cov_kernel", "panel_strip_ws_kernel")) and v["spill_stores"]]
    if spilled:
        fail(f"kernel instantiations spill: {spilled}")
    # the ws kernel's setmaxnreg split (2 x 128 x 232 + 128 x 40, or 224 and
    # 56 with plain loads) takes the 384 x 168 registers a block starts
    # with; with fewer, setmaxnreg.inc would wait forever
    unsplit = {k: v["registers"] for k, v in per_kernel.items()
               if k.startswith("panel_strip_ws_kernel") and v["registers"] != 168}
    if unsplit:
        fail(f"warp-specialized panel-strip instantiations do not start at 168 registers: {unsplit}")
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
    bound, by = bound_ms(m1, m2, x1.shape[1], x1.element_size(), FP32_FLOPS, map_ops)
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
        p = l_full[j0:, :j0]
        strip -= chunked_product(p, p[:block], torch.float32,
                                 operand=lambda t: downdate_operand(t, torch.float32, precision))
    return strip


def strip_excess(got, want, prefix, block: int, atol: float, rtol: float, unit: float,
                 split: float) -> float:
    """Largest amount by which a panel strip misses its plain version beyond
    atol + rtol |want| + (C u + split) (|P| |P[:block]|^T), ``P`` the strip's
    (rows, C) prefix (``L[j0:, :j0]`` in the factor); <= 0 when within.
    ``split``: the float32 kernel's 3xTF32 term
    (``panel_strip_cuda.SPLIT_ERROR``), 0 in float64."""
    kdim = prefix.shape[1]
    if kdim == 0:
        return excess(got, want, atol, rtol)
    bound = abs_product(prefix, prefix[:block]).mul_(kdim * unit + split)
    bound.add_(want.abs(), alpha=rtol).add_(atol)
    return float(((got - want).abs() - bound).max())


def check_panels(kernel, x_pad, n_live: int, noise, l_full, widths, where: str,
                 precision=None) -> float:
    """B2 against its plain version on the first, middle and last panels
    of the factor ``l_full`` (panel widths ``widths``; float32, or bfloat16
    for the bf16-prefix instantiation; ``precision="bf16"`` for the single
    pass), each within :func:`strip_excess`'s tolerance; returns the
    largest error."""
    import torch

    from friedrich_tpu_torch.ops.cuda import panel_strip_cuda
    from friedrich_tpu_torch.ops.panel_fused import plain_panel_strip

    kind = panel_strip_cuda.variant(x_pad.dtype, l_full.dtype, precision)
    split = panel_strip_cuda.SPLIT_ERROR if kind == "tf32x3" else 0.0
    starts = np.cumsum((0,) + tuple(widths[:-1]))
    max_err = 0.0
    for p in (0, len(widths) // 2, len(widths) - 1):
        j0, block = int(starts[p]), widths[p]
        args = (kernel, x_pad[j0:], x_pad[j0:j0 + block], l_full, n_live, noise, j0, block)
        got = panel_strip_cuda.panel_strip(*args, precision=precision)
        if kind == "tf32x3":
            want = plain_panel_strip(*args)
        else:
            want = plain_strip_chunked(*args, precision=precision)
        err = float((got - want).abs().max())
        over = strip_excess(got, want, l_full[j0:, :j0], block, ATOL_F32, RTOL_F32,
                            UNIT_ROUNDOFF["float32"], split)
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
    at ``downdate_flops`` and (2d + 9) per entry for the map at the float32
    rate, against the prefix blocks (``prefix_itemsize`` bytes an entry,
    default ``itemsize``), the inputs and the strip moved once over HBM. The
    float32 kernel's downdate is three TF32 products: pass TF32_FLOPS / 3
    for its tensor-core bound, FP32_FLOPS for the SIMT one; the single pass
    and the bfloat16 prefix BF16_FLOPS (one product of bfloat16 operands,
    exact in float32: the least time for the same products)."""
    t_ops = (2 * rest * block * j0 / downdate_flops + (2 * d + 9) * rest * block / FP32_FLOPS) * 1e3
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
    busy = sum(r[1] for r in kernels)
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
    from torch.autograd import DeviceType
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
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e6
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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def union(iv):
        total, end = 0.0, -1.0
        for a, b in sorted(iv):
            if b <= end:
                continue
            total += b - max(a, end)
            end = b
        return total

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    copies, kernels = [], []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.time_range.end > e.time_range.start:
            iv = (e.time_range.start / 1e6, e.time_range.end / 1e6)
            (copies if "memcpy" in e.name.lower() else kernels).append(iv)
    if not copies and not kernels:
        return {"wall_s": wall, "device_time": "not measured (the profiler recorded no device time)"}
    c, k, both = union(copies), union(kernels), union(copies + kernels)
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
    middle panel (an explicit bf16 prefix 8,192 wide); every panel of a bf16
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--n", type=int, default=50_000,
                        help="training points of the dense full-width phase (default 50,000)")
    parser.add_argument("--streamed-n", type=int, default=100_000,
                        help="training points of the streamed full-width phase and of 8b (default 100,000)")
    parser.add_argument("--panel-times", action="store_true",
                        help="only time B2 at the main path's panels (panel_times) and exit")
    parser.add_argument("--errors", action="store_true",
                        help="with --panel-times, also the downdate errors against float64")
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
    log(smi_line())
    log(json.dumps({"kernels": [entry, streamed_entry, bf16_entry, one_pass_entry]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
