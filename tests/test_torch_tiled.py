"""The tiled and hybrid backends of the PyTorch port against the JAX
package: the factors (float64 at the tolerances of
``tests/test_streamed_distributed.py``, float32 against a float64 factor as
in ``tests/test_f32_backends.py``), the per-pivot substitute, the panel
strip with an end row, models through the builder and ``GaussianProcess.new``,
a fit and ``add_samples`` on each backend, states carried across and
save/load of models the JAX package saved.

The port runs on the CPU here, where the covariance tiles and panel strips
are their plain versions; the kernels are held against those on the card by
``chip_smoke.py`` phase 9 and ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import friedrich_tpu as jft
import friedrich_tpu.kernels as jk
import friedrich_tpu.priors as jp
import friedrich_tpu_torch as tft
import friedrich_tpu_torch.kernels as tk
import friedrich_tpu_torch.priors as tp
from friedrich_tpu.ops.covariance import train_covariance_padded as j_train_cov
from friedrich_tpu.ops.hybrid import hybrid_cholesky_factor as j_hybrid
from friedrich_tpu.ops.tiled import tiled_cholesky_factor as j_tiled
from friedrich_tpu.utils.serialization import _kernel_spec, _prior_spec
from friedrich_tpu_torch import config, interop
from friedrich_tpu_torch.ops.covariance import train_covariance_padded
from friedrich_tpu_torch.ops.hybrid import hybrid_cholesky_factor
from friedrich_tpu_torch.ops.panel_fused import panel_strip
from friedrich_tpu_torch.ops.tiled import region_cholesky_inplace, tiled_cholesky_factor

# tests/test_streamed_distributed.py:73-165
RTOL, ATOL = 1e-9, 1e-12


@pytest.fixture(autouse=True)
def _port_on_cpu_in_f64():
    config.enable_x64()
    config.set_device("cpu")
    yield


def _problem(cap=96, n=70, d=3, seed=21):
    x = np.zeros((cap, d))
    x[:n] = np.random.default_rng(seed).normal(size=(n, d))
    return x, n


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("block", [16, 48])
def test_tiled_factor_matches_jax(block):
    x, n = _problem()
    want, ok_w = j_tiled(jk.SquaredExp(ls=0.9, ampl=1.4), jnp.asarray(x), n, 0.3, block=block)
    got, ok = tiled_cholesky_factor(tk.SquaredExp(ls=0.9, ampl=1.4), torch.as_tensor(x), n, 0.3,
                                    block=block)
    assert bool(ok) and bool(ok_w)
    _close(got, want)
    assert torch.equal(got, torch.tril(got))


@pytest.mark.parametrize("n", [70, 40, 96])
def test_hybrid_factor_matches_jax(n):
    x, _ = _problem(n=n)
    want, _ = j_hybrid(jk.Matern1(ls=0.9, ampl=1.2), jnp.asarray(x), n, 0.3, block=16)
    got, ok = hybrid_cholesky_factor(tk.Matern1(ls=0.9, ampl=1.2), torch.as_tensor(x), n, 0.3,
                                     block=16)
    assert bool(ok)
    _close(got, want)
    assert torch.equal(got, torch.tril(got))  # no final mask: every write is lower


@pytest.mark.parametrize("levels,cap,n", [(1, 128, 100), (2, 128, 100), (2, 256, 200)])
def test_hybrid_levels_match_jax(levels, cap, n):
    x, _ = _problem(cap=cap, n=n)
    want, _ = j_hybrid(jk.SquaredExp(ls=0.9, ampl=1.4), jnp.asarray(x), n, 0.3, block=16,
                       levels=levels)
    got, ok = hybrid_cholesky_factor(tk.SquaredExp(ls=0.9, ampl=1.4), torch.as_tensor(x), n, 0.3,
                                     block=16, levels=levels)
    assert bool(ok)
    _close(got, want)


@pytest.mark.parametrize("split", [0.33, 0.66])
def test_hybrid_split_matches_jax(split):
    x, n = _problem(cap=128, n=110)
    kern = (jk.SquaredExp(ls=0.7, ampl=1.0) + jk.Linear(c=0.2),
            tk.SquaredExp(ls=0.7, ampl=1.0) + tk.Linear(c=0.2))
    want, _ = j_hybrid(kern[0], jnp.asarray(x), n, 0.3, block=16, split=split)
    got, ok = hybrid_cholesky_factor(kern[1], torch.as_tensor(x), n, 0.3, block=16, split=split)
    assert bool(ok)
    _close(got, want)


def test_hybrid_needs_even_capacity():
    x, n = _problem(cap=95, n=70)
    with pytest.raises(ValueError, match="even capacity"):
        hybrid_cholesky_factor(tk.SquaredExp(), torch.as_tensor(x), n, 0.3, block=16)


@pytest.mark.parametrize("backend", ["tiled", "hybrid"])
def test_eps_substitution_matches_jax(backend):
    # 40 duplicate points, zero noise: a rank-1 live block
    x = np.zeros((64, 1))
    x[:40] = 1.0
    jfn, tfn = (j_tiled, tiled_cholesky_factor) if backend == "tiled" else (j_hybrid,
                                                                             hybrid_cholesky_factor)
    want, _ = jfn(jk.SquaredExp(ls=1.0, ampl=1.0), jnp.asarray(x), 40, 0.0, eps=1e-8, block=16)
    got, ok = tfn(tk.SquaredExp(ls=1.0, ampl=1.0), torch.as_tensor(x), 40, 0.0, eps=1e-8, block=16)
    assert bool(ok) and bool(torch.isfinite(got).all())
    _close(got, want)
    assert int(np.sum(np.isclose(np.diagonal(got.numpy())[:40], np.sqrt(1e-8)))) >= 1
    # without eps the factorization fails, as the JAX package's does
    _, ok = tfn(tk.SquaredExp(ls=1.0, ampl=1.0), torch.as_tensor(x), 40, 0.0, block=16)
    assert not bool(ok)


@pytest.mark.parametrize("name", ["tiled", "hybrid", "hybrid-l2"])
def test_float32_factor_matches_float64(name):
    """tests/test_f32_backends.py:48-52: the float32 factor within 5e-6 of a
    float64 dense factor. The port solves each panel by TRSM where the JAX
    package multiplies by an inverse (a TPU workaround); both hold it."""
    n = 256
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    k64 = np.asarray(j_train_cov(jk.SquaredExp(ls=1.0, ampl=1.0), jnp.asarray(x, jnp.float64), n,
                                 0.5), np.float64)
    want = np.linalg.cholesky(k64)
    kern = tk.SquaredExp(ls=1.0, ampl=1.0).to(torch.float32, "cpu")
    xt = torch.as_tensor(x)
    if name == "tiled":
        got, ok = tiled_cholesky_factor(kern, xt, n, 0.5, block=32)
    else:
        got, ok = hybrid_cholesky_factor(kern, xt, n, 0.5, block=32,
                                         levels=2 if name == "hybrid-l2" else 1)
    assert got.dtype == torch.float32 and bool(ok)
    assert float(np.max(np.abs(got.double().numpy() - want))) < 5e-6


def test_region_factorization_reads_the_lower_triangle_only():
    """The JAX package mirrors each diagonal tile (``mirror_diag``) because
    XLA's Cholesky symmetrizes its input; the port's reads the lower
    triangle, so garbage above the diagonal changes nothing."""
    x, n = _problem(cap=64, n=64)
    k = train_covariance_padded(tk.SquaredExp(ls=0.9, ampl=1.4), torch.as_tensor(x), n, 0.3)
    want = torch.linalg.cholesky(k)
    for eps in (None, 1e-8):
        m = torch.tril(k) + torch.triu(torch.full_like(k, 7.0), 1)
        region_cholesky_inplace(m, 0, 4, 16, eps)
        _close(torch.tril(m), want)


def test_panel_strip_with_an_end_row():
    """The hybrid leaf's strip, rows j0..h of the factor, is the top of the
    whole strip: the plain version (the kernel's reference) with ``end``."""
    x, n = _problem(cap=96, n=80)
    xt = torch.as_tensor(x)
    kern = tk.Matern2(ls=1.1, ampl=0.8)
    l_full = torch.as_tensor(np.random.default_rng(2).normal(size=(96, 96)))
    for j0, block, end in ((0, 16, 48), (16, 16, 48), (32, 16, 48), (40, 7, 61)):
        got = panel_strip(kern, xt[j0:end], xt[j0:j0 + block], l_full, n, 0.3, j0, block, end=end)
        whole = panel_strip(kern, xt[j0:], xt[j0:j0 + block], l_full, n, 0.3, j0, block)
        assert got.shape == (end - j0, block)
        _close(got, whole[:end - j0], rtol=1e-14, atol=1e-14)


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

def _data(n=64, d=2, seed=7):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    return x, np.sin(x[:, 0]) + 0.1 * rng.normal(size=n), rng.normal(size=(5, d))


@pytest.mark.parametrize("backend", ["tiled", "hybrid"])
def test_builder_models_match_jax(backend):
    x, y, xq = _data()
    jgp = jft.GaussianProcess.builder(x, y).set_backend(backend).set_noise(0.2).train()
    tgp = tft.GaussianProcessBuilder(x, y).set_backend(backend).set_noise(0.2).train()
    assert tgp.state.backend == backend
    _close(tgp.state.l, jgp.state.l)
    for got, want in zip(tgp.predict_mean_variance(xq), jgp.predict_mean_variance(xq)):
        _close(got, want)
    # and the dense backend's predictions (tests/test_streamed_distributed.py)
    dense = tft.GaussianProcessBuilder(x, y).set_noise(0.2).train()
    _close(tgp.predict(xq), dense.predict(xq), atol=1e-11)


@pytest.mark.parametrize("backend", ["tiled", "hybrid"])
def test_new_with_a_prior_and_capacity_matches_jax(backend):
    x, y, xq = _data(n=50)
    args = (0.25, 1e-9, x, y)
    jgp = jft.GaussianProcess.new(jp.LinearPrior(weights=np.array([0.2, -0.4]), intercept=0.1),
                                  jk.Matern2(ls=1.1, ampl=0.9), *args, capacity=64, backend=backend)
    tgp = tft.GaussianProcess.new(tp.LinearPrior(weights=torch.tensor([0.2, -0.4]), intercept=0.1),
                                  tk.Matern2(ls=1.1, ampl=0.9), *args, capacity=64, backend=backend)
    _close(tgp.state.l, jgp.state.l)
    _close(tgp.predict(xq), jgp.predict(xq))
    _close(tgp.likelihood(), jgp.likelihood())


@pytest.mark.parametrize("backend", ["tiled", "hybrid"])
def test_fit_matches_jax(backend):
    x, y, xq = _data(n=48)
    jgp = jft.GaussianProcess.builder(x, y).set_backend(backend).set_noise(0.3).train()
    tgp = tft.GaussianProcessBuilder(x, y).set_backend(backend).set_noise(0.3).train()
    jgp.fit_parameters(max_iter=5)
    tgp.fit_parameters(max_iter=5)
    assert tgp.state.backend == backend
    _close(tgp.kernel.get_params(), jgp.kernel.get_params(), rtol=1e-8)
    _close(tgp.state.l, jgp.state.l, rtol=1e-8, atol=1e-10)
    _close(tgp.predict(xq), jgp.predict(xq), rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("backend", ["tiled", "hybrid"])
def test_add_samples_matches_jax(backend):
    x, y, xq = _data(n=40)
    jgp = jft.GaussianProcess.builder(x, y).set_backend(backend).set_noise(0.3).train()
    tgp = tft.GaussianProcessBuilder(x, y).set_backend(backend).set_noise(0.3).train()
    x_new, y_new = xq[:3], np.array([0.2, -0.1, 0.4])
    jgp.add_samples(x_new, y_new)
    tgp.add_samples(x_new, y_new)
    assert tgp.num_samples == 43 and tgp.state.backend == backend
    _close(tgp.state.l[:43, :43], jgp.state.l[:43, :43])
    _close(tgp.predict(xq), jgp.predict(xq))


@pytest.mark.parametrize("backend", ["tiled", "hybrid"])
def test_storage_and_precision_raise_as_in_jax(backend):
    x, y, _ = _data(n=16)
    x32 = x.astype(np.float32)
    with pytest.raises(tft.ConfigError, match="requires the 'streamed' backend"):
        tft.GaussianProcess.new(tp.ZeroPrior(), tk.SquaredExp(), 0.1, None, x32, y, backend=backend,
                                storage="bf16", dtype="float32")
    with pytest.raises(jft.ConfigError, match="requires the 'streamed' backend"):
        jft.GaussianProcess.new(jp.ZeroPrior(), jk.SquaredExp(), 0.1, None, x32, y, backend=backend,
                                storage="bf16", dtype="float32")
    with pytest.raises(tft.ConfigError, match="requires the 'streamed' backend"):
        tft.GaussianProcess.new(tp.ZeroPrior(), tk.SquaredExp(), 0.1, None, x, y, backend=backend,
                                precision="f32")


@pytest.mark.parametrize("backend", ["tiled", "hybrid"])
def test_state_carried_both_ways(backend):
    x, y, xq = _data(n=30)
    jgp = jft.GaussianProcess.new(jp.ConstantPrior(0.3), jk.SquaredExp(ls=1.2, ampl=0.9), 0.25, None,
                                  x, y, capacity=32, backend=backend)
    js = jgp.state
    arrays = {k: np.asarray(getattr(js, k)) for k in ("x", "resid", "l", "n", "noise")}
    state = interop.state_from_arrays(arrays, _kernel_spec(js.kernel), _prior_spec(js.prior),
                                      eps=js.eps, method=js.method, device="cpu", backend=js.backend,
                                      block=js.block)
    assert state.backend == backend
    gp = tft.GaussianProcess(state)
    _close(gp.predict(xq), jgp.predict(xq))
    # a rebuild through the carried backend reproduces the carried factor
    gp.set_hyperparameters(noise=0.25)
    _close(gp.state.l, js.l)
    _, _, _, static = interop.state_to_arrays(gp.state)
    assert static["backend"] == backend


@pytest.mark.parametrize("backend", ["tiled", "hybrid"])
def test_jax_saved_model_loads(tmp_path, backend):
    x, y, xq = _data(n=40)
    jgp = jft.GaussianProcess.builder(x, y).set_backend(backend).set_noise(0.2).train()
    jgp.save(str(tmp_path / "m.npz"))
    gp = tft.GaussianProcess.load(tmp_path / "m.npz")
    assert gp.state.backend == backend
    _close(gp.predict(xq), jgp.predict(xq))
    # and the port's save loads back into the JAX package
    gp.save(tmp_path / "port.npz")
    back = jft.GaussianProcess.load(str(tmp_path / "port.npz"))
    assert back.state.backend == backend
    _close(back.predict(xq), jgp.predict(xq))
