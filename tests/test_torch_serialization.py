"""Save/load of the PyTorch port (``utils/serialization.py``): its own
round trip to bit-identical predictions, and the file format shared with
the JAX package, in both directions. float64 on the CPU."""

import json

import numpy as np
import pytest
import torch

import friedrich_tpu as jft
import friedrich_tpu.kernels as jk
import friedrich_tpu.priors as jp
import friedrich_tpu_torch as tft
import friedrich_tpu_torch.kernels as tk
import friedrich_tpu_torch.priors as tp
from friedrich_tpu_torch import config

# across the packages: the same factor and weights, predictions from two
# implementations of the same solves
TOL_CROSS = 1e-12


@pytest.fixture(autouse=True)
def _port_on_cpu_in_f64():
    config.enable_x64()
    config.set_device("cpu")
    yield


KERNELS = {
    "SquaredExp": lambda m: m.SquaredExp(ls=0.7, ampl=1.9),
    "Sum": lambda m: m.SquaredExp(ls=0.7, ampl=1.0) + m.Linear(c=0.3),
    "Prod": lambda m: m.Matern1(ls=1.0, ampl=1.0) * m.RationalQuadratic(alpha=0.9, ls=1.1),
}


def _data(n=12, d=2, seed=5):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, d)), rng.normal(size=n), rng.normal(size=(4, d))


def _linear_prior(m):
    if m is tp:
        return tp.LinearPrior(weights=torch.tensor([0.2, -0.5]), intercept=0.1)
    return jp.LinearPrior(weights=np.array([0.2, -0.5]), intercept=0.1)


def _models(name, **kw):
    x, y, xq = _data()
    jgp_ = jft.GaussianProcess.new(_linear_prior(jp), KERNELS[name](jk), 0.25, 1e-8, x, y, **kw)
    tgp_ = tft.GaussianProcess.new(_linear_prior(tp), KERNELS[name](tk), 0.25, 1e-8, x, y, **kw)
    return jgp_, tgp_, xq


def _assert_same_state(got, want):
    for field in ("x", "resid", "l", "noise"):
        np.testing.assert_array_equal(np.asarray(getattr(got, field)),
                                      np.asarray(getattr(want, field)))
    assert int(got.n) == int(want.n)
    assert (got.eps, got.method, got.backend) == (want.eps, want.method, want.backend)
    np.testing.assert_array_equal(np.asarray(got.kernel.get_params()),
                                  np.asarray(want.kernel.get_params()))
    assert type(got.kernel).__name__ == type(want.kernel).__name__


@pytest.mark.parametrize("name", KERNELS)
def test_port_round_trip_is_bit_identical(tmp_path, name):
    _, gp, xq = _models(name)
    path = tmp_path / "model.npz"
    gp.save(path)
    loaded = tft.GaussianProcess.load(path)
    _assert_same_state(loaded.state, gp.state)
    assert torch.equal(loaded.predict(torch.as_tensor(xq)), gp.predict(torch.as_tensor(xq)))
    assert torch.equal(loaded.predict_variance(torch.as_tensor(xq)),
                       gp.predict_variance(torch.as_tensor(xq)))
    assert loaded.likelihood() == gp.likelihood()
    assert loaded.cholesky_epsilon == 1e-8 and loaded.num_samples == 12
    # the header is the JAX package's, with numpy's dtype name
    with np.load(path) as data:
        header = json.loads(bytes(data["header"]).decode())
    assert set(header) == {"version", "kernel", "prior", "eps", "method", "backend", "storage",
                           "block", "precision", "n", "dtype"}
    assert header["dtype"] == "float64" and header["prior"]["class"] == "LinearPrior"


@pytest.mark.parametrize("name", KERNELS)
def test_jax_save_loads_in_the_port(tmp_path, name):
    jgp_, tgp_, xq = _models(name)
    path = str(tmp_path / "jax.npz")
    jgp_.save(path)
    loaded = tft.GaussianProcess.load(path)
    _assert_same_state(loaded.state, jgp_.state)
    np.testing.assert_array_equal(loaded.prior.weights.numpy(), np.asarray(jgp_.prior.weights))
    np.testing.assert_allclose(loaded.predict(xq), np.asarray(jgp_.predict(xq)), rtol=TOL_CROSS,
                               atol=TOL_CROSS)
    np.testing.assert_allclose(loaded.predict_variance(xq), np.asarray(jgp_.predict_variance(xq)),
                               rtol=TOL_CROSS, atol=TOL_CROSS)


@pytest.mark.parametrize("name", KERNELS)
def test_port_save_loads_in_jax(tmp_path, name):
    jgp_, tgp_, xq = _models(name)
    path = str(tmp_path / "port.npz")
    tgp_.save(path)
    loaded = jft.GaussianProcess.load(path)
    _assert_same_state(loaded.state, tgp_.state)
    np.testing.assert_allclose(np.asarray(loaded.predict(xq)), tgp_.predict(xq), rtol=TOL_CROSS,
                               atol=TOL_CROSS)
    np.testing.assert_allclose(np.asarray(loaded.predict_variance(xq)), tgp_.predict_variance(xq),
                               rtol=TOL_CROSS, atol=TOL_CROSS)


def test_extensionless_path_gets_npz(tmp_path):
    _, gp, xq = _models("SquaredExp")
    gp.save(tmp_path / "model")
    assert (tmp_path / "model.npz").exists()
    loaded = tft.GaussianProcess.load(tmp_path / "model")
    assert torch.equal(loaded.predict(torch.as_tensor(xq)), gp.predict(torch.as_tensor(xq)))


def test_float32_model_round_trips(tmp_path):
    x, y, xq = _data()
    gp = tft.GaussianProcess.new(tp.ZeroPrior(), tk.SquaredExp(ls=0.7, ampl=1.9), 0.25, None, x, y,
                                 dtype="float32")
    gp.save(tmp_path / "m")
    loaded = tft.GaussianProcess.load(tmp_path / "m")
    assert loaded.state.x.dtype == torch.float32 and loaded.state.l.dtype == torch.float32
    q = torch.as_tensor(xq, dtype=torch.float32)
    assert torch.equal(loaded.predict(q), gp.predict(q))


@pytest.mark.parametrize("block", (4, (5, 4, 7)), ids=("width", "schedule"))
def test_streamed_state_with_a_block_round_trips(tmp_path, block):
    x, y, xq = _data(n=14)
    gp = tft.GaussianProcess.new(tp.ZeroPrior(), tk.SquaredExp(ls=0.8, ampl=1.1), 0.2, None, x, y,
                                 capacity=16, backend="streamed", panel_block=block)
    gp.save(tmp_path / "m.npz")
    loaded = tft.GaussianProcess.load(tmp_path / "m.npz")
    assert loaded.state.backend == "streamed" and loaded.state.block == block
    assert torch.equal(loaded.predict(torch.as_tensor(xq)), gp.predict(torch.as_tensor(xq)))
    # the loaded model goes on working: an append, then a refit that rebuilds
    loaded.add_samples(xq[:2], [0.1, 0.2])
    loaded.fit_parameters(max_iter=2)
    assert loaded.num_samples == 16 and np.isfinite(loaded.likelihood())
    # and the JAX package reads the schedule as written
    jloaded = jft.GaussianProcess.load(str(tmp_path / "m.npz"))
    assert jloaded.state.backend == "streamed"
    np.testing.assert_allclose(np.asarray(jloaded.predict(xq)), gp.predict(xq), rtol=TOL_CROSS,
                               atol=TOL_CROSS)


# bf16 storage and a factor precision are ported: a header carrying them
# loads (under "bf16" storage, a streamed-backend knob, the factor is read
# as bfloat16 bits, so the case stores the factor's bits as the JAX package
# writes them); a tiled backend still raises.
@pytest.mark.parametrize("header", ({"storage": "bf16"}, {"precision": "f32"}, {"backend": "tiled"}),
                         ids=("bf16-storage", "precision", "tiled"))
def test_headers_of_paths_not_yet_ported_raise(tmp_path, header):
    _, gp, _ = _models("SquaredExp")
    gp.save(tmp_path / "m.npz")
    with np.load(tmp_path / "m.npz") as data:
        arrays = dict(data)
    meta = json.loads(bytes(arrays["header"]).decode())
    meta.update(header)
    arrays["header"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    if header.get("storage") == "bf16":
        # bf16 storage is a streamed-backend knob
        meta["backend"] = "streamed"
        arrays["header"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
        bits = torch.as_tensor(arrays["l"]).to(torch.bfloat16)
        arrays["l"] = bits.view(torch.int16).numpy().view(np.uint16)
    np.savez(tmp_path / "edited.npz", **arrays)
    if "backend" in header:
        with pytest.raises(tft.ConfigError, match="not yet ported to friedrich_tpu_torch"):
            tft.GaussianProcess.load(tmp_path / "edited.npz")
        return
    loaded = tft.GaussianProcess.load(tmp_path / "edited.npz")
    assert (loaded.state.storage, loaded.state.precision) == (meta["storage"], meta["precision"])
    want_dtype = torch.bfloat16 if meta["storage"] == "bf16" else torch.float64
    assert loaded.state.l.dtype == want_dtype