"""Public surface of the PyTorch port: the demo against the JAX package's
demo, the device policy, the paths not yet ported, input polymorphism and
configuration errors."""

import re

import numpy as np
import pytest
import torch

import friedrich_tpu.demo as jdemo
import friedrich_tpu_torch as tft
import friedrich_tpu_torch.kernels as tk
import friedrich_tpu_torch.priors as tp
from friedrich_tpu_torch import config, demo
from friedrich_tpu_torch.models import gp as tgp
from friedrich_tpu_torch.models import optimizer as topt
from friedrich_tpu_torch.ops.streamed import streamed_cholesky_factor


@pytest.fixture(autouse=True)
def _port_on_cpu_in_f64():
    config.enable_x64()
    config.set_device("cpu")
    yield
    config.set_device("cpu")


_NUM = re.compile(r"-?\d+\.\d+(?:e-?\d+)?")

X = [[0.8], [1.2], [3.8], [4.2]]
Y = [3.0, 4.0, -2.0, -2.0]


def test_demo_prints_the_numbers_of_the_jax_demo(capsys):
    jdemo.main()
    jax_lines = capsys.readouterr().out.strip().splitlines()
    port_lines = []
    demo.main(device="cpu", out=port_lines.append)
    assert len(port_lines) == len(jax_lines)
    for got, want in zip(port_lines, jax_lines):
        assert _NUM.sub("#", got) == _NUM.sub("#", want)
        if want.startswith("sample"):
            continue  # posterior draws: torch.Generator vs jax.random
        np.testing.assert_allclose([float(v) for v in _NUM.findall(got)],
                                   [float(v) for v in _NUM.findall(want)], rtol=1e-9)


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config.set_device(None)
    with pytest.raises(tft.ConfigError, match="set_device"):
        tft.GaussianProcess.new(tp.ZeroPrior(), tk.SquaredExp(), 0.1, None, X, Y)
    with pytest.raises(tft.ConfigError, match="CUDA"):
        tft.GaussianProcessBuilder(X, Y)
    # asking for the CPU, per call or globally, works
    gp = tft.GaussianProcess.new(tp.ZeroPrior(), tk.SquaredExp(), 0.1, None, X, Y, device="cpu")
    assert gp.state.x.device.type == "cpu"
    config.set_device("cpu")
    assert tft.GaussianProcessBuilder(X, Y).train().state.x.device.type == "cpu"


def _returns_builder(call):
    assert isinstance(call(), tft.GaussianProcessBuilder)


def _raises(match):
    def check(call):
        with pytest.raises(tft.ConfigError, match=match):
            call()
    return check


NOT_PORTED = _raises("not yet ported to friedrich_tpu_torch")


# The factor storage and precision knobs are ported: each case that raised
# "not yet ported" now runs, or raises the JAX package's own error for a
# combination that package refuses too (bf16 storage of float64 inputs or
# on the dense backend). The tiled and hybrid backends still raise.
@pytest.mark.parametrize("call,check", [
    (lambda: tft.GaussianProcessBuilder(X, Y).set_backend("streamed").set_factor_precision("f32"),
     _returns_builder),
    (lambda: tft.GaussianProcessBuilder(X, Y).set_backend("tiled"), NOT_PORTED),
    (lambda: tft.GaussianProcessBuilder(X, Y).set_backend("hybrid"), NOT_PORTED),
    (lambda: tft.GaussianProcess.new(tp.ZeroPrior(), tk.SquaredExp(), 0.1, None, X, Y, backend="streamed",
                                     storage="bf16"), _raises("float32 inputs")),
    (lambda: tft.GaussianProcessBuilder(X, Y).set_factor_storage("bf16"), _returns_builder),
    (lambda: tft.GaussianProcess.new(tp.ZeroPrior(), tk.SquaredExp(), 0.1, None, X, Y, storage="bf16"),
     _raises("requires the 'streamed' backend")),
    (lambda: tft.GaussianProcessBuilder(X, Y).set_factor_precision("f32"), _returns_builder),
    (lambda: streamed_cholesky_factor(tk.SquaredExp(), torch.zeros((4, 1), dtype=torch.float64), 4, 0.1,
                                      block=2, precision="f32")[0].dtype == torch.float64,
     lambda call: call() or pytest.fail("precision='f32' factors in float64")),
], ids=["streamed", "tiled", "hybrid", "new-streamed", "bf16", "new-bf16", "factor-precision",
        "panel-block"])
def test_paths_not_yet_ported_raise(call, check):
    check(call)


def _hutchinson_fit(tmp_path):
    gp = tft.GaussianProcessBuilder(X, Y).set_fit_gradient("hutchinson").set_fit_subsample(None) \
        .fit_kernel().fit_prior().train()
    return gp.likelihood()


def _polish(tmp_path):
    builder = tft.GaussianProcessBuilder(X * 3, Y * 3).set_fit_subsample(8).set_fit_polish(True) \
        .fit_kernel().fit_prior()
    gp = builder.train()
    assert "polish" in builder.timings
    return gp.likelihood()


def _fit_map(tmp_path):
    gp = tft.GaussianProcess.default(X, Y)
    gp.fit_map(num_steps=5)
    return gp.likelihood()


def _save(tmp_path):
    tft.GaussianProcess.default(X, Y).save(tmp_path / "model")
    return float((tmp_path / "model.npz").stat().st_size)


def _load(tmp_path):
    gp = tft.GaussianProcess.default(X, Y)
    gp.save(tmp_path / "model")
    loaded = tft.GaussianProcess.load(tmp_path / "model")
    assert loaded.predict([1.0]) == gp.predict([1.0])
    return loaded.likelihood()


@pytest.mark.parametrize("call", [_hutchinson_fit, _polish, _fit_map, _save, _load],
                         ids=["hutchinson", "polish", "fit_map", "save", "load"])
def test_large_fit_map_fit_and_persistence_run(call, tmp_path):
    assert np.isfinite(call(tmp_path))


def test_auto_gradient_above_the_exact_threshold_runs_hutchinson(monkeypatch):
    # the Hutchinson fit: a capacity above the threshold, lowered to a test size
    monkeypatch.setattr(topt, "LARGE_FIT_THRESHOLD", 3)
    gp = tft.GaussianProcess.new(tp.ZeroPrior(), tk.SquaredExp(), 0.1, None, X, Y)
    gp.fit_parameters(fit_prior=False, max_iter=5)
    assert 1 <= gp.fit_iterations <= 5 and np.isfinite(gp.likelihood())


def test_auto_backend_is_dense():
    gp = tft.GaussianProcess.new(tp.ZeroPrior(), tk.SquaredExp(), 0.1, None, X, Y, backend="auto")
    assert gp.state.backend == "auto"
    ref = tft.GaussianProcess.new(tp.ZeroPrior(), tk.SquaredExp(), 0.1, None, X, Y)
    assert torch.equal(gp.state.l, ref.state.l)


def test_input_polymorphism():
    gp = tft.GaussianProcess.default(X, Y)
    assert isinstance(gp.predict([1.0]), float)
    assert isinstance(gp.predict([[1.0], [2.0]]), list)
    out = gp.predict(np.array([[1.0], [2.0]]))
    assert isinstance(out, np.ndarray) and out.shape == (2,)
    out = gp.predict(torch.tensor([[1.0], [2.0]], dtype=torch.float64))
    assert isinstance(out, torch.Tensor) and out.shape == (2,)
    mean, var = gp.predict_in_batches(np.linspace(0, 5, 11)[:, None], batch_size=4)
    np.testing.assert_allclose(mean.numpy(), gp.predict(np.linspace(0, 5, 11)[:, None]), rtol=1e-12)
    assert var.shape == (11,)


def test_configuration_errors():
    with pytest.raises(tft.ConfigError, match="non-negative"):
        tft.GaussianProcessBuilder(X, Y).set_noise(-1.0)
    with pytest.raises(tft.ConfigError, match="strictly positive"):
        tft.GaussianProcessBuilder(X, Y).set_cholesky_epsilon(0.0)
    with pytest.raises(tft.ConfigError, match="float32 or float64"):
        tft.GaussianProcessBuilder(X, Y).set_dtype("float16")
    with pytest.raises(tft.ShapeError):
        tft.GaussianProcess.default(X, Y).predict([[1.0, 2.0]])
    with pytest.raises(tft.CholeskyError, match="cholesky_epsilon"):
        tft.GaussianProcess.new(tp.ZeroPrior(), tk.SquaredExp(), 0.0, None, X + X, Y + Y)
    gp = tft.GaussianProcess.new(tp.ZeroPrior(), tk.SquaredExp(), 0.0, 1e-8, X + X, Y + Y)
    assert np.isfinite(gp.predict([1.0]))
    with pytest.raises(ValueError):
        with config.matmul_precision("tf32"):
            pass
    with config.matmul_precision("bf16"):
        assert torch.get_float32_matmul_precision() == "medium"
    assert torch.get_float32_matmul_precision() == "highest"


@pytest.mark.parametrize("mode", ["f32x3", "f32"])
def test_float32_precision_modes_never_enable_tf32(mode):
    # "f32x3" is the JAX package's near-float32 compensated mode; torch's
    # "high" would let float32 matmuls run in TF32, a weaker mode
    with config.matmul_precision(mode):
        assert torch.get_float32_matmul_precision() == "highest"
        assert not torch.backends.cuda.matmul.allow_tf32


def test_float32_models(monkeypatch):
    monkeypatch.setattr(config, "_x64", False)
    gp = tft.GaussianProcess.default(X, Y)
    assert gp.state.x.dtype == torch.float32 and gp.state.l.dtype == torch.float32
    ref = tft.GaussianProcessBuilder(X, Y).set_dtype("float64").fit_kernel().fit_prior().train()
    assert ref.state.x.dtype == torch.float64
    # float32 rounding through a 100-iteration multiplicative fit
    np.testing.assert_allclose(gp.predict([1.0]), ref.predict([1.0]), rtol=1e-4)
