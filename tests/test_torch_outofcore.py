"""The out-of-core factorization and solves of the PyTorch port
(``ops/outofcore.py``) against the JAX package's
(``friedrich_tpu/ops/outofcore.py``; the cases of
``tests/test_outofcore.py``), against dense float64 factors and the
port's own in-memory streamed factor, plus the bytes it moves and the
``FRIEDRICH_OOC_PROGRESS`` parse. float32 on the CPU, where the host factor
and the computing device are the same memory.

Tolerances are the JAX tests': 5e-5 against a float64 factor, 2e-4 for the
solves, 3e-2 between bf16 and f32 storage; the two packages' bf16 factors
agree within two bfloat16 ulps of each entry (summation order only, but a
write-back can round one ulp apart).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import friedrich_tpu.kernels as jk
import friedrich_tpu_torch.kernels as tk
from friedrich_tpu.ops import outofcore as jooc
from friedrich_tpu_torch import ConfigError, config
from friedrich_tpu_torch.ops import outofcore as tooc
from friedrich_tpu_torch.ops.covariance import train_covariance_padded
from friedrich_tpu_torch.ops.streamed import streamed_cholesky_factor

RNG = np.random.default_rng(5)
F32 = torch.float32


@pytest.fixture(autouse=True)
def _port_on_cpu():
    config.set_device("cpu")
    yield


def _problem(cap=256, n=200, d=4):
    x = np.zeros((cap, d), np.float32)
    x[:n] = RNG.normal(size=(n, d))
    return x, n, dict(ls=1.0, ampl=1.2), 0.4


def _port(kern_p, x):
    return tk.SquaredExp(**kern_p).to(F32, "cpu"), torch.as_tensor(x)


def _dense_factor(kern, xt, n, noise):
    k64 = train_covariance_padded(kern.to(torch.float64, "cpu"), xt.double(), n,
                                  torch.tensor(noise, dtype=torch.float64))
    return torch.linalg.cholesky(k64)


def assert_bf16_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    bound = 2.0**-6 * np.abs(want) + 2.0**-12 * np.abs(want).max()
    assert np.all(np.abs(got - want) <= bound)


def test_outofcore_factor_matches_dense_and_jax():
    x, n, p, noise = _problem()
    kern, xt = _port(p, x)
    l_host, ok = tooc.outofcore_cholesky_factor(kern, xt, n, noise, block=32)
    assert ok and l_host.device.type == "cpu" and l_host.dtype == F32
    np.testing.assert_allclose(l_host.double().numpy(), _dense_factor(kern, xt, n, noise).numpy(),
                               atol=5e-5)
    jl, jok = jooc.outofcore_cholesky_factor(jk.SquaredExp(ls=jnp.float32(1.0), ampl=jnp.float32(1.2)),
                                             jnp.asarray(x), n, jnp.float32(noise), block=32)
    assert jok
    np.testing.assert_allclose(l_host.numpy(), jl, rtol=0, atol=5e-6)


def test_outofcore_factor_eps_substitution():
    kern = tk.SquaredExp(ls=1.0, ampl=1.0).to(F32, "cpu")
    # duplicate points, zero noise: a rank-deficient live block
    x = torch.zeros((64, 1), dtype=F32)
    x[:20] = 1.0
    l_host, ok = tooc.outofcore_cholesky_factor(kern, x, 20, 0.0, eps=1e-6, block=16)
    assert ok and bool(torch.isfinite(l_host).all())
    d = torch.diagonal(l_host)[:20].numpy()
    assert np.sum(np.isclose(d, np.sqrt(1e-6))) >= 1
    jl, jok = jooc.outofcore_cholesky_factor(jk.SquaredExp(ls=jnp.float32(1.0), ampl=jnp.float32(1.0)),
                                             jnp.asarray(x.numpy()), 20, jnp.float32(0.0), eps=1e-6,
                                             block=16)
    assert jok
    np.testing.assert_allclose(l_host.numpy(), jl, rtol=0, atol=1e-5)


def test_outofcore_factor_detects_failure():
    kern = tk.SquaredExp(ls=1.0, ampl=1.0).to(F32, "cpu")
    x = torch.zeros((32, 1), dtype=F32)
    x[:8] = 2.0
    _, ok = tooc.outofcore_cholesky_factor(kern, x, 8, 0.0, block=8)
    assert not ok  # duplicate points, no noise, no eps: a NaN factor


def test_outofcore_solves_match_torch_linalg_and_jax():
    x, n, p, noise = _problem()
    kern, xt = _port(p, x)
    l_host, ok = tooc.outofcore_cholesky_factor(kern, xt, n, noise, block=32)
    assert ok
    c = RNG.normal(size=(256, 3)).astype(np.float32)
    ct = torch.as_tensor(c)
    l64, c64 = l_host.double(), ct.double()
    y = tooc.outofcore_solve_lower(l_host, ct)
    np.testing.assert_allclose(y.double().numpy(),
                               torch.linalg.solve_triangular(l64, c64, upper=False).numpy(), atol=2e-4)
    xt_ = tooc.outofcore_solve_lower_t(l_host, ct)
    np.testing.assert_allclose(xt_.double().numpy(),
                               torch.linalg.solve_triangular(l64.mT, c64, upper=True).numpy(), atol=2e-4)
    w = tooc.outofcore_cho_solve(l_host, ct)
    np.testing.assert_allclose(w.double().numpy(), torch.cholesky_solve(c64, l64).numpy(), atol=5e-3)
    # the JAX package's sweeps over the same factor
    lj = l_host.numpy()
    for got, fn in ((y, jooc.outofcore_solve_lower), (xt_, jooc.outofcore_solve_lower_t),
                    (w, jooc.outofcore_cho_solve)):
        np.testing.assert_allclose(got.numpy(), np.asarray(fn(lj, jnp.asarray(c))), rtol=0,
                                   atol=2e-4)
    # a 1-D right-hand side keeps its shape; the caller's vector is not changed
    v0 = ct[:, 0].clone()
    v = tooc.outofcore_solve_lower(l_host, ct[:, 0])
    assert v.shape == (256,) and torch.equal(ct[:, 0], v0)


def test_outofcore_bf16_host_storage():
    x, n, p, noise = _problem()
    kern, xt = _port(p, x)
    l32, _ = tooc.outofcore_cholesky_factor(kern, xt, n, noise, block=32)
    lbf, ok = tooc.outofcore_cholesky_factor(kern, xt, n, noise, block=32, storage="bf16")
    assert ok and lbf.dtype == torch.bfloat16
    assert float((l32.double() - lbf.double()).abs().max()) < 3e-2
    jbf, jok = jooc.outofcore_cholesky_factor(jk.SquaredExp(ls=jnp.float32(1.0), ampl=jnp.float32(1.2)),
                                              jnp.asarray(x), n, jnp.float32(noise), block=32,
                                              storage="bf16")
    assert jok
    assert_bf16_close(lbf.double().numpy(), np.asarray(jbf, np.float64))
    # the sweeps read the bf16 host factor, in float32
    c = torch.as_tensor(RNG.normal(size=(256, 2)), dtype=F32)
    y = tooc.outofcore_solve_lower(lbf, c)
    assert y.dtype == F32
    ref = torch.linalg.solve_triangular(lbf.double(), c.double(), upper=False)
    np.testing.assert_allclose(y.double().numpy(), ref.numpy(), atol=5e-3)


def test_outofcore_matches_in_memory_streamed():
    """Not bit for bit (other GEMM shapes), but factors of the same
    covariance to float32 accuracy."""
    x, n, p, noise = _problem(cap=128, n=100)
    kern, xt = _port(p, x)
    l_mem, ok1 = streamed_cholesky_factor(kern, xt, n, noise, block=32)
    l_ooc, ok2 = tooc.outofcore_cholesky_factor(kern, xt, n, noise, block=32)
    assert bool(ok1) and ok2
    np.testing.assert_allclose(l_ooc.double().numpy(), l_mem.double().numpy(), atol=5e-5)


def test_outofcore_validation_and_reuse():
    x, n, p, noise = _problem(cap=64, n=50)
    kern, xt = _port(p, x)
    with pytest.raises(ConfigError, match="storage"):
        tooc.outofcore_cholesky_factor(kern, xt, n, noise, storage="f8")
    with pytest.raises(ConfigError, match="float32"):
        tooc.outofcore_cholesky_factor(kern, xt.double(), n, noise, block=16)
    # a host factor of the right shape and dtype is written in place
    first, _ = tooc.outofcore_cholesky_factor(kern, xt, n, noise, block=16)
    buf = torch.full_like(first, float("nan"))
    again, ok = tooc.outofcore_cholesky_factor(kern, xt, n, noise, block=16, l0=buf)
    assert ok and again.data_ptr() == buf.data_ptr() and torch.equal(again, first)


@pytest.mark.parametrize("case", ("shape", "dtype", "layout"))
def test_outofcore_refuses_a_mismatched_host_factor(case):
    x, n, p, noise = _problem(cap=64, n=50)
    kern, xt = _port(p, x)
    l0 = {"shape": torch.zeros((48, 48)), "dtype": torch.zeros((64, 64), dtype=torch.bfloat16),
          "layout": torch.zeros((64, 64)).mT}[case]
    with pytest.raises(ValueError, match="host factor"):
        tooc.outofcore_cholesky_factor(kern, xt, n, noise, block=16, l0=l0)


def test_outofcore_moves_rows_below_each_panel_only():
    x, n, p, noise = _problem(cap=128, n=100)
    kern, xt = _port(p, x)
    for storage, es in ((None, 4), ("bf16", 2)):
        up, down = tooc.TRAFFIC["up"], tooc.TRAFFIC["down"]
        tooc.outofcore_cholesky_factor(kern, xt, n, noise, block=32, storage=storage)
        panels = 128 // 32
        want_up = sum((128 - j * 32) * 32 * j for j in range(panels)) * es
        want_down = sum((128 - j * 32) * 32 for j in range(panels)) * es
        assert (tooc.TRAFFIC["up"] - up, tooc.TRAFFIC["down"] - down) == (want_up, want_down)


@pytest.mark.parametrize("value,on", [
    (None, False), ("", False), ("0", False), ("false", False), (" False ", False),
    ("1", True), ("true", True), ("yes", True),
])
def test_progress_variable_parse(monkeypatch, capsys, value, on):
    """``FRIEDRICH_OOC_PROGRESS``: "", "0" and "false" mean off (the JAX
    package takes any non-empty value, "0" included, as on)."""
    if value is None:
        monkeypatch.delenv(tooc.PROGRESS_ENV, raising=False)
    else:
        monkeypatch.setenv(tooc.PROGRESS_ENV, value)
    assert tooc.progress_enabled() is on
    x, n, p, noise = _problem(cap=32, n=30)
    kern, xt = _port(p, x)
    tooc.outofcore_cholesky_factor(kern, xt, n, noise, block=16)
    lines = [ln for ln in capsys.readouterr().err.splitlines() if ln.startswith("[ooc] panel")]
    assert len(lines) == (2 if on else 0)


KERNEL_SWEEP = {
    "Matern2": lambda m: m.Matern2(ls=1.1, ampl=0.8),
    "KernelSum": lambda m: m.SquaredExp(ls=0.7, ampl=1.0) + m.Linear(c=0.2),
    "RationalQuadratic": lambda m: m.RationalQuadratic(alpha=1.2, ls=0.9),
}


@pytest.mark.parametrize("name", KERNEL_SWEEP)
def test_outofcore_factor_kernel_sweep(name):
    """Across kernel families (a composition included): the dense float64
    factor, and the JAX package's out-of-core factor."""
    rng = np.random.default_rng(9)
    n, cap = 100, 128
    x = np.zeros((cap, 3), np.float32)
    x[:n] = rng.normal(size=(n, 3))
    kern = KERNEL_SWEEP[name](tk).to(F32, "cpu")
    xt = torch.as_tensor(x)
    l_host, ok = tooc.outofcore_cholesky_factor(kern, xt, n, 0.35, block=16)
    assert ok
    np.testing.assert_allclose(l_host.double().numpy(), _dense_factor(kern, xt, n, 0.35).numpy(),
                               atol=5e-5)
    jl, jok = jooc.outofcore_cholesky_factor(KERNEL_SWEEP[name](jk), jnp.asarray(x), n,
                                             jnp.float32(0.35), block=16)
    assert jok
    np.testing.assert_allclose(l_host.numpy(), jl, rtol=0, atol=1e-5)
