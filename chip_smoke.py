"""Smoke test of the PyTorch/CUDA port (``friedrich_tpu_torch``) on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each of which fails loudly (non-zero exit, no result line):

1. environment: card name and power limit, torch and CUDA versions, float32
   matmuls in full precision, and the build of the covariance-tile kernel
   from ``friedrich_tpu_torch/csrc/`` with ``nvcc`` (timed);
2. the kernel against its plain PyTorch version on the card, for the nine
   kernels plus Sum, Prod and a deeper composition, in train and cross
   mode, float32 and float64, every distance method, at ragged shapes;
3. parity of the port on the card against the port on the CPU: the demo
   flow and a builder fit at n=512, d=3, float64;
4. the full-width main path: ``bench.py``'s north-star flow on the dense
   backend at n=50,000, d=8, float32 — sub-fit at 8,192, one 50,512-capacity
   build and factor, a 4,096-query ``predict_in_batches``, a 512-point
   ``add_samples`` and ``sample_at`` 64 points — with the kernel's launches
   counted over that run, then the kernel held against the plain version on
   4,096-row strips of the 50,512^2 matrix and timed at the main-path shapes.

The last three lines are the card's ``nvidia-smi`` name and power limit, a
JSON line describing each kernel, and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np

#: Published H100 SXM rates used for the bound (NVIDIA data sheet).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

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


def phase_environment() -> None:
    import torch

    from friedrich_tpu_torch.ops.cuda import covariance_cuda

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
    path, report = covariance_cuda.build()
    build_s = time.perf_counter() - t0
    registers = re.findall(r"Used (\d+) registers", report)
    spills = sorted({int(s) for s in re.findall(r"(\d+) bytes spill stores", report)})
    log(f"kernel build: {build_s} s -> {path.name}; ptxas registers per instantiation "
        f"{registers}, spill stores (bytes) {spills}")


def phase_kernel_vs_plain() -> None:
    import torch

    from friedrich_tpu_torch.ops import covariance as cov
    from friedrich_tpu_torch.ops.cuda import covariance_cuda

    log("== phase 2: covariance kernel against its plain version")
    rng = np.random.default_rng(7)
    m1, n, mq, noise = 1000, 937, 333, 0.3
    worst, launches = {}, {}
    for d in (1, 8):
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
                        if got.shape != want.shape or not bool(torch.isfinite(got).all()):
                            fail(f"{name} {mode} {method} d={d} {dtype}: shape or non-finite")
                        err = float((got - want).abs().max())
                        if not excess(got, want, atol, rtol) <= 0:
                            fail(f"{name} {mode} {method} d={d} {dtype}: max error {err} "
                                 f"beyond atol {atol} + rtol {rtol}")
                        key = (name, "f32" if dtype == torch.float32 else "f64")
                        worst[key] = max(worst.get(key, 0.0), err)
                launches[name] = launches.get(name, 0) + covariance_cuda.LAUNCHES - before
    table = [
        {"kernel": name, "launches": launches[name],
         "max_err_f32": worst[(name, "f32")], "max_err_f64": worst[(name, "f64")]}
        for name in test_kernels()
    ]
    log(json.dumps({"parity": table,
                    "shapes": f"{m1} rows, live n {n}, {mq} queries, d in (1, 8)"}))


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


def bound_ms(m1: int, m2: int, d: int, itemsize: int, flops_per_s: float) -> tuple[float, str]:
    """Least time for one launch: inputs read once and output written
    once over HBM bandwidth, against 2d + 9 operations per entry (dot
    product, distance, squared-exponential map with exp counted as one)
    plus 2d per row norm, over the peak rate for the dtype."""
    nbytes = ((m1 + m2) * d + m1 * m2) * itemsize
    ops = m1 * m2 * (2 * d + 9) + 2 * d * (m1 + m2)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_full_width(n: int) -> dict:
    import torch

    import friedrich_tpu_torch as ft
    from friedrich_tpu_torch.ops import covariance as cov
    from friedrich_tpu_torch.ops.cuda import covariance_cuda

    log(f"== phase 4: full width, n={n}, d=8, float32, dense backend")
    d, m, k_add, m_sample = 8, 4096, 512, 64
    cap = n + k_add
    rng = np.random.default_rng(0)  # bench.py's data (bench.py:99-107)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (np.sin(2.5 * x[:, 0]) + 0.5 * np.cos(2.0 * x[:, 1]) + rng.normal(size=n)).astype(np.float32)
    xq = rng.normal(size=(m, d)).astype(np.float32)
    x_add = rng.normal(size=(k_add, d)).astype(np.float32)
    y_add = (np.sin(2.5 * x_add[:, 0]) + 0.5 * np.cos(2.0 * x_add[:, 1])).astype(np.float32)
    x_sample = rng.normal(size=(m_sample, d)).astype(np.float32)

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
        "launches": launches, "lml_start": lml0, "lml_fitted": lml,
        "ls": float(gp.kernel.ls), "ampl": float(gp.kernel.ampl), "noise": gp.noise,
        "var_min": float(var.min()), "mean_abs_max": float(mean.abs().max()),
    }
    log(json.dumps({"full_width_steps": steps}))
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

    # ---- times at the main-path shapes
    train_ms = cuda_ms(lambda: covariance_cuda.covariance(kernel, x_pad, x_pad, n_live, noise, train=True))
    cross_ms = cuda_ms(lambda: covariance_cuda.covariance(kernel, x_pad, xq_t, n_live))
    cross_plain_ms = cuda_ms(lambda: cov.plain_cross_covariance_train_padded(kernel, x_pad, n_live, xq_t))
    torch.cuda.empty_cache()
    train_plain_ms = cuda_ms(lambda: cov.plain_train_covariance_padded(kernel, x_pad, n_live, noise), reps=3)
    train_bound, train_by = bound_ms(cap, cap, d, 4, FP32_FLOPS)
    cross_bound, _ = bound_ms(cap, m, d, 4, FP32_FLOPS)
    log(f"covariance kernel train {cap}^2 f32: {train_ms} ms (plain {train_plain_ms} ms, "
        f"bound {train_bound} ms by {train_by}); cross {cap} x {m}: {cross_ms} ms "
        f"(plain {cross_plain_ms} ms, bound {cross_bound} ms)")
    return {
        "name": "covariance_tile",
        "route": "cuda",
        "source": "friedrich_tpu_torch/csrc/covariance.cu",
        "replaces": "friedrich_tpu/ops/pallas/covariance_pallas.py:105",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": train_ms,
        "plain_ms": train_plain_ms,
        "bound_ms": train_bound,
        "bound_by": train_by,
        "library_ms": None,
        "shape": f"train {cap}x{cap} d={d} float32",
        "cross_shape": f"cross {cap}x{m} d={d} float32",
        "cross_ms": cross_ms,
        "cross_plain_ms": cross_plain_ms,
        "cross_bound_ms": cross_bound,
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--n", type=int, default=50_000,
                        help="training points of the full-width phase (default 50,000)")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: FAILED: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    import friedrich_tpu_torch  # noqa: F401  (fails outside the repository)

    phase_environment()
    phase_kernel_vs_plain()
    phase_parity()
    entry = phase_full_width(args.n)
    log(smi_line())
    log(json.dumps({"kernels": [entry]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
