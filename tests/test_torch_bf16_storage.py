"""bfloat16 factor storage and the factor precision of the PyTorch port
against the JAX package (``tests/test_bf16_storage.py``, its single-device
cases): the factor, its reconstruction, validation, the builder flow end to
end, the append (against a retrain, at low noise, and both of its memory
branches), ``set_hyperparameters``, save/load in both directions between
the packages, ``fit_map``, and ``precision`` passed through every
factorization. float32 wherever bfloat16 is involved (the JAX package
requires it), on the CPU, where the panel strip is its plain version.

Tolerances: the port's plain downdate (bfloat16 upcast, a float32 GEMM) and
the JAX package's (a bfloat16 ``dot_general`` accumulating in float32)
differ only in summation order, but the write-back can round one bfloat16
ulp apart, and later panels carry that on; so factors agree within two
bfloat16 ulps of each entry (2^-6 relative, above a floor of 2^-12 of the
largest entry), and predictions within the JAX tests' own tolerances.
"""

import json

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
from friedrich_tpu.ops.streamed import streamed_cholesky_factor as jax_streamed
from friedrich_tpu_torch import config, interop
from friedrich_tpu_torch.mcmc import logprob as tlogprob
from friedrich_tpu_torch.models import gp as tgp
from friedrich_tpu_torch.ops.covariance import train_covariance_padded
from friedrich_tpu_torch.ops.streamed import streamed_cholesky_factor

RNG = np.random.default_rng(7)
F32 = torch.float32


@pytest.fixture(autouse=True)
def _port_on_cpu_in_f64():
    config.enable_x64()
    config.set_device("cpu")
    yield


def assert_bf16_close(got, want):
    """Within two bfloat16 ulps of each entry, above a floor."""
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want.float() if isinstance(want, torch.Tensor) else want, np.float64)
    bound = 2.0**-6 * np.abs(want) + 2.0**-12 * np.abs(want).max()
    assert np.all(np.abs(got - want) <= bound), float(np.max(np.abs(got - want) - bound))


def _factor_inputs(n=64, d=4):
    x = RNG.normal(size=(n, d)).astype(np.float32)
    return x, dict(ls=1.2, ampl=1.5), 0.4


def test_bf16_storage_factor_close_to_f32_and_to_jax():
    x, p, noise = _factor_inputs()
    kern = tk.SquaredExp(**p).to(F32, "cpu")
    xt = torch.as_tensor(x)
    l32, ok32 = streamed_cholesky_factor(kern, xt, 64, noise, block=16)
    lbf, okbf = streamed_cholesky_factor(kern, xt, 64, noise, block=16, storage="bf16")
    assert bool(ok32) and bool(okbf)
    assert lbf.dtype == torch.bfloat16
    diff = (l32.double() - lbf.double()).abs().max()
    assert 0 < diff < 3e-2
    jbf, jok = jax_streamed(jk.SquaredExp(ls=jnp.float32(1.2), ampl=jnp.float32(1.5)),
                            jnp.asarray(x), 64, jnp.float32(noise), block=16, storage="bf16")
    assert bool(jok)
    assert_bf16_close(lbf, np.asarray(jbf, np.float64))


def test_bf16_storage_reconstructs_covariance():
    x = torch.as_tensor(RNG.normal(size=(96, 4)), dtype=F32)
    kern = tk.SquaredExp(ls=1.2, ampl=1.5).to(F32, "cpu")
    k = train_covariance_padded(kern, x, 96, torch.tensor(0.4)).double()
    lbf, ok = streamed_cholesky_factor(kern, x, 96, 0.4, block=16, storage="bf16")
    assert bool(ok)
    b = lbf.double()
    assert float((b @ b.mT - k).abs().max()) < 5e-2 * float(k.abs().max())


def test_bf16_storage_validation():
    kern = tk.SquaredExp(ls=1.0, ampl=1.0)
    x32 = torch.as_tensor(RNG.normal(size=(32, 3)), dtype=F32)
    with pytest.raises(tft.ConfigError, match="storage must be None"):
        streamed_cholesky_factor(kern.to(F32, "cpu"), x32, 32, 0.5, block=16, storage="f8")
    with pytest.raises(tft.ConfigError, match="float32 inputs"):
        streamed_cholesky_factor(kern, x32.double(), 32, 0.5, block=16, storage="bf16")
    for mode in ("f32x3", "f32"):
        with pytest.raises(tft.ConfigError, match="incompatible"):
            streamed_cholesky_factor(kern.to(F32, "cpu"), x32, 32, 0.5, block=16, storage="bf16",
                                     precision=mode)
    with pytest.raises(tft.ConfigError, match="precision must be None"):
        streamed_cholesky_factor(kern.to(F32, "cpu"), x32, 32, 0.5, block=16, precision="tf32")
    # precision="bf16" is allowed: it is the storage mode's arithmetic
    l_mat, ok = streamed_cholesky_factor(kern.to(F32, "cpu"), x32, 32, 0.5, block=16,
                                         storage="bf16", precision="bf16")
    assert bool(ok) and l_mat.dtype == torch.bfloat16
    # a reused buffer must be of the storage dtype
    with pytest.raises(ValueError, match="does not match"):
        streamed_cholesky_factor(kern.to(F32, "cpu"), x32, 32, 0.5, block=16, storage="bf16",
                                 l0=torch.zeros((32, 32), dtype=F32))
    # ... and a bfloat16 one is reused
    buf = torch.full((32, 32), float("nan"), dtype=torch.bfloat16)
    again, ok = streamed_cholesky_factor(kern.to(F32, "cpu"), x32, 32, 0.5, block=16,
                                         storage="bf16", l0=buf)
    assert bool(ok) and again.data_ptr() == buf.data_ptr() and torch.equal(again, l_mat)


def test_bf16_storage_requires_streamed_backend():
    x = RNG.normal(size=(24, 2)).astype(np.float32)
    y = np.sin(x.sum(axis=1)).astype(np.float32)
    with pytest.raises(tft.ConfigError, match="streamed"):
        tft.GaussianProcess.new(tp.ConstantPrior(0.0), tk.SquaredExp(ls=1.0, ampl=1.0), 0.3, None,
                                x, y, backend="dense", storage="bf16", dtype="float32")
    with pytest.raises(tft.ConfigError, match="unknown factor storage"):
        tft.GaussianProcessBuilder(x, y).set_factor_storage("f8")
    with pytest.raises(tft.ConfigError, match="requires set_backend"):
        tft.GaussianProcessBuilder(x, y).set_dtype("float32").set_factor_storage("bf16").train()
    with pytest.raises(tft.ConfigError, match="float32 inputs"):
        tft.GaussianProcessBuilder(x, y).set_backend("streamed").set_factor_storage("bf16").train()


def _builders(x, y, mod, storage, noise=0.3, kern=None, cap=None):
    kern = kern or (lambda m: m.SquaredExp(ls=1.0, ampl=1.0))
    b = (mod.GaussianProcessBuilder(x, y).set_kernel(kern(tk if mod is tft else jk))
         .set_noise(noise).set_dtype("float32").set_backend("streamed")
         .set_factor_storage(storage))
    if cap is not None:
        b = b.set_capacity(cap)
    return b.train()


def test_bf16_storage_end_to_end_gp():
    x = RNG.normal(size=(96, 3)).astype(np.float32)
    y = np.sin(x.sum(axis=1)).astype(np.float32)
    xq = RNG.normal(size=(11, 3)).astype(np.float32)
    gp32 = (tft.GaussianProcessBuilder(x, y).set_kernel(tk.SquaredExp(ls=1.0, ampl=1.0))
            .set_noise(0.3).train())
    gpbf = _builders(x, y, tft, "bf16")
    jbf = _builders(x, y, jft, "bf16")
    assert gpbf.state.l.dtype == torch.bfloat16 and gpbf.state.storage == "bf16"
    np.testing.assert_allclose(gpbf.predict(xq), gp32.predict(xq), atol=0.05)
    np.testing.assert_allclose(gpbf.predict_variance(xq), gp32.predict_variance(xq), atol=0.05)
    mean, var = gpbf.predict_mean_variance(xq)
    assert np.all(np.isfinite(mean)) and np.all(var > -1e-3)
    lml32 = gp32.log_marginal_likelihood()
    assert abs(gpbf.log_marginal_likelihood() - lml32) < 0.5 + 0.02 * abs(lml32)
    assert np.isfinite(gpbf.likelihood())
    # against the JAX package's bf16-stored model
    assert_bf16_close(gpbf.state.l, np.asarray(jbf.state.l, np.float64))
    jmean, jvar = jbf.predict_mean_variance(xq)
    np.testing.assert_allclose(mean, np.asarray(jmean), atol=5e-3)
    np.testing.assert_allclose(var, np.asarray(jvar), atol=5e-3)
    assert abs(gpbf.log_marginal_likelihood() - jbf.log_marginal_likelihood()) < 0.05
    assert abs(gpbf.likelihood() - jbf.likelihood()) < 0.05


def test_bf16_storage_add_samples_matches_retrain():
    x = RNG.normal(size=(48, 2)).astype(np.float32)
    y = np.cos(x.sum(axis=1)).astype(np.float32)
    x2 = RNG.normal(size=(16, 2)).astype(np.float32)
    y2 = np.cos(x2.sum(axis=1)).astype(np.float32)
    xq = RNG.normal(size=(7, 2)).astype(np.float32)
    kern = lambda m: m.SquaredExp(ls=0.8, ampl=1.0)  # noqa: E731
    gp = _builders(x, y, tft, "bf16", noise=0.25, kern=kern, cap=64)
    jgp_ = _builders(x, y, jft, "bf16", noise=0.25, kern=kern, cap=64)
    gp.add_samples(x2, y2)
    jgp_.add_samples(x2, y2)
    assert gp.state.l.dtype == torch.bfloat16 and gp.num_samples == 64
    retrained = _builders(np.vstack([x, x2]), np.concatenate([y, y2]), tft, "bf16", noise=0.25,
                          kern=kern, cap=64)
    np.testing.assert_allclose(gp.predict(xq), retrained.predict(xq), atol=0.05)
    np.testing.assert_allclose(gp.predict(xq), np.asarray(jgp_.predict(xq)), atol=5e-3)
    # past the capacity: grown x1.5, rebuilt
    gp.add_samples(x2[:4], y2[:4])
    jgp_.add_samples(x2[:4], y2[:4])
    assert gp.state.capacity == 96 == jgp_.state.capacity
    np.testing.assert_allclose(gp.predict(xq), np.asarray(jgp_.predict(xq)), atol=5e-3)


def test_bf16_storage_append_survives_low_noise():
    """The bf16-storage append refactorizes where a rank-k update against
    the rounded factor goes indefinite (n=500, noise 0.1)."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(500, 4)).astype(np.float32)
    y = np.sin(x.sum(1)).astype(np.float32)
    x2 = rng.normal(size=(50, 4)).astype(np.float32)
    y2 = rng.normal(size=50).astype(np.float32)
    gp32 = _builders(x, y, tft, None, noise=0.1, cap=600)
    gpbf = _builders(x, y, tft, "bf16", noise=0.1, cap=600)
    gp32.add_samples(x2, y2)
    gpbf.add_samples(x2, y2)
    assert gpbf.num_samples == 550 and gpbf.state.l.dtype == torch.bfloat16
    lml32, lmlbf = gp32.log_marginal_likelihood(), gpbf.log_marginal_likelihood()
    assert np.isfinite(lmlbf)
    assert abs(lmlbf - lml32) < 5.0 + 0.01 * abs(lml32)


@pytest.mark.parametrize("two_fit", (True, False), ids=("new-buffer", "own-buffer"))
def test_bf16_append_memory_branches(monkeypatch, two_fit):
    """Where two bf16 factors fit the card the append rebuilds into a new
    buffer and a failure leaves the model as it was; where they do not it
    rebuilds into the factor's own buffer and a failure refactors the model
    at the old n. The card's memory is monkeypatched."""
    x = RNG.normal(size=(40, 3)).astype(np.float32)
    y = np.sin(x.sum(1)).astype(np.float32)
    gp = _builders(x, y, tft, "bf16", noise=0.3, cap=64)
    factor_bytes = 64 * 64 * 2
    monkeypatch.setattr(config, "device_memory_bytes",
                        lambda device=None: 4 * factor_bytes if two_fit else factor_bytes)
    before_ptr = gp.state.l.data_ptr()
    xq = x[:3]
    gp.add_samples(RNG.normal(size=(8, 3)), np.zeros(8))
    assert gp.num_samples == 48
    assert (gp.state.l.data_ptr() == before_ptr) == (not two_fit)
    # a point with no finite covariance: the rebuild fails
    ptr = gp.state.l.data_ptr()
    mid = gp.predict(xq)
    mid_l = gp.state.l.clone()
    bad = np.full((1, 3), np.nan, dtype=np.float32)
    with pytest.raises(tft.CholeskyError, match="refactorization"):
        gp.add_samples(bad, np.zeros(1))
    assert gp.num_samples == 48 and gp.state.l.data_ptr() == ptr
    assert torch.equal(gp.state.l, mid_l)
    np.testing.assert_array_equal(gp.predict(xq), mid)


def test_bf16_storage_set_hyperparameters_rebuild():
    x = RNG.normal(size=(32, 2)).astype(np.float32)
    y = np.sin(x.sum(axis=1)).astype(np.float32)
    kern = lambda m: m.SquaredExp(ls=0.7, ampl=1.0)  # noqa: E731
    gp = _builders(x, y, tft, "bf16", kern=kern)
    jgp_ = _builders(x, y, jft, "bf16", kern=kern)
    gp.set_hyperparameters(kernel=tk.SquaredExp(ls=1.3, ampl=0.9), noise=0.2)
    jgp_.set_hyperparameters(kernel=jk.SquaredExp(ls=1.3, ampl=0.9), noise=0.2)
    assert gp.state.l.dtype == torch.bfloat16
    assert np.isfinite(gp.log_marginal_likelihood())
    assert_bf16_close(gp.state.l, np.asarray(jgp_.state.l, np.float64))


def _header(path):
    with np.load(path) as data:
        return json.loads(bytes(data["header"]).decode())


def test_bf16_storage_serialization_both_directions(tmp_path):
    x = RNG.normal(size=(40, 2)).astype(np.float32)
    y = np.sin(x.sum(axis=1)).astype(np.float32)
    xq = RNG.normal(size=(5, 2)).astype(np.float32)
    gp = (tft.GaussianProcessBuilder(x, y).set_kernel(tk.SquaredExp(ls=1.0, ampl=1.0))
          .set_noise(0.3).set_dtype("float32").set_backend("streamed")
          .set_factor_storage("bf16").set_factor_precision("bf16").train())
    # the port's own round trip: bit-identical predictions
    gp.save(tmp_path / "port")
    loaded = tft.GaussianProcess.load(tmp_path / "port")
    assert loaded.state.l.dtype == torch.bfloat16
    assert (loaded.state.storage, loaded.state.precision) == ("bf16", "bf16")
    np.testing.assert_array_equal(gp.predict(xq), loaded.predict(xq))
    # the port's file in the JAX package: the same bits
    head = _header(tmp_path / "port.npz")
    assert (head["storage"], head["precision"]) == ("bf16", "bf16")
    jloaded = jft.GaussianProcess.load(str(tmp_path / "port.npz"))
    assert jloaded.state.l.dtype == jnp.bfloat16 and jloaded.state.precision == "bf16"
    np.testing.assert_array_equal(np.asarray(jloaded.state.l).view(np.uint16),
                                  gp.state.l.view(torch.int16).numpy().view(np.uint16))
    np.testing.assert_allclose(np.asarray(jloaded.predict(xq)), gp.predict(xq), atol=1e-5)
    # the JAX package's file in the port: the same bits, and a round trip of
    # its own that predicts bit for bit
    jgp_ = _builders(x, y, jft, "bf16")
    jgp_.save(str(tmp_path / "jax"))
    from_jax = tft.GaussianProcess.load(tmp_path / "jax.npz")
    assert from_jax.state.storage == "bf16" and from_jax.state.l.dtype == torch.bfloat16
    np.testing.assert_array_equal(from_jax.state.l.view(torch.int16).numpy().view(np.uint16),
                                  np.asarray(jgp_.state.l).view(np.uint16))
    np.testing.assert_allclose(from_jax.predict(xq), np.asarray(jgp_.predict(xq)), atol=1e-5)
    from_jax.save(tmp_path / "again")
    np.testing.assert_array_equal(tft.GaussianProcess.load(tmp_path / "again").predict(xq),
                                  from_jax.predict(xq))


def test_interop_carries_a_bf16_state():
    x = RNG.normal(size=(40, 2)).astype(np.float32)
    y = np.sin(x.sum(axis=1)).astype(np.float32)
    xq = RNG.normal(size=(5, 2)).astype(np.float32)
    jgp_ = _builders(x, y, jft, "bf16")
    from friedrich_tpu.utils.serialization import _kernel_spec, _prior_spec

    js = jgp_.state
    arrays = {k: np.asarray(getattr(js, k)) for k in ("x", "resid", "l", "n", "noise")}
    assert arrays["l"].dtype.name == "bfloat16"
    state = interop.state_from_arrays(arrays, _kernel_spec(js.kernel), _prior_spec(js.prior),
                                      eps=js.eps, method=js.method, backend=js.backend,
                                      block=js.block, device="cpu")
    assert state.storage == "bf16" and state.l.dtype == torch.bfloat16
    gp = tft.GaussianProcess(state)
    np.testing.assert_allclose(gp.predict(xq), np.asarray(jgp_.predict(xq)), atol=1e-5)
    back, kspec, pspec, static = interop.state_to_arrays(state)
    assert back["l"].dtype == np.uint16 and static["storage"] == "bf16"
    np.testing.assert_array_equal(back["l"], arrays["l"].view(np.uint16))


def test_bf16_storage_fit_map_smoke():
    """The exact-LML fit composes with a bf16-stored factor: its final
    rebuild keeps the storage."""
    x = RNG.normal(size=(32, 2)).astype(np.float32)
    y = np.sin(x.sum(axis=1)).astype(np.float32)
    kern = lambda m: m.SquaredExp(ls=0.9, ampl=1.0)  # noqa: E731
    gp = _builders(x, y, tft, "bf16", kern=kern)
    jgp_ = _builders(x, y, jft, "bf16", kern=kern)
    before = gp.log_marginal_likelihood()
    gp.fit_map(num_steps=10, learning_rate=0.05)
    jgp_.fit_map(num_steps=10, learning_rate=0.05)
    assert gp.state.l.dtype == torch.bfloat16 and gp.state.storage == "bf16"
    after = gp.log_marginal_likelihood()
    assert np.isfinite(after) and after >= before - 1.0
    np.testing.assert_allclose(gp.kernel.get_params().numpy(),
                               np.asarray(jgp_.kernel.get_params()), rtol=1e-3)
    assert abs(after - jgp_.log_marginal_likelihood()) < 0.05


# ---------------------------------------------------------------------------
# The factor precision
# ---------------------------------------------------------------------------


def test_precision_bf16_rounds_the_downdate_operands():
    """precision="bf16" multiplies bfloat16-rounded operands (the card's
    single-pass instantiation); the JAX package's CPU run of the same mode
    multiplies in float32, so the two agree to the operand rounding."""
    x, p, noise = _factor_inputs()
    kern = tk.SquaredExp(**p).to(F32, "cpu")
    xt = torch.as_tensor(x)
    got, ok = streamed_cholesky_factor(kern, xt, 64, noise, block=16, precision="bf16")
    full, _ = streamed_cholesky_factor(kern, xt, 64, noise, block=16, precision="f32")
    plain, _ = streamed_cholesky_factor(kern, xt, 64, noise, block=16)
    assert bool(ok) and got.dtype == F32
    assert torch.equal(full, plain)  # "f32" and None: one arithmetic
    assert 0 < float((got - plain).abs().max()) < 3e-2
    jl, jok = jax_streamed(jk.SquaredExp(ls=jnp.float32(1.2), ampl=jnp.float32(1.5)),
                           jnp.asarray(x), 64, jnp.float32(noise), block=16, precision="bf16")
    assert bool(jok)
    np.testing.assert_allclose(got.numpy(), np.asarray(jl), atol=3e-2)


def test_precision_reaches_every_factorization(monkeypatch):
    """One mode name, one arithmetic: the build, the rebuilds of the exact,
    Hutchinson and subsampled fits, ``set_hyperparameters``, the append and
    the streamed density all factor with the model's precision."""
    from friedrich_tpu_torch.models import large_fit as tlf
    from friedrich_tpu_torch.models import map_fit as tmap
    from friedrich_tpu_torch.ops import streamed as tstreamed

    seen = []
    real = tstreamed.streamed_cholesky_factor

    def spy(*args, **kw):
        seen.append(kw.get("precision"))
        return real(*args, **kw)

    monkeypatch.setattr(tgp, "streamed_cholesky_factor", spy)
    monkeypatch.setattr(tlogprob, "streamed_cholesky_factor", spy)
    x = RNG.normal(size=(48, 2)).astype(np.float32)
    y = np.sin(x.sum(axis=1)).astype(np.float32)
    gp = (tft.GaussianProcessBuilder(x, y).set_kernel(tk.SquaredExp(ls=0.9, ampl=1.0))
          .set_noise(0.3).set_dtype("float32").set_backend("streamed")
          .set_factor_precision("bf16").set_capacity(64).train())
    assert gp.state.precision == "bf16" and seen == ["bf16"]
    gp.fit_parameters(max_iter=2)
    gp.set_hyperparameters(noise=0.35)
    gp.add_samples(x[:3] + 3.0, y[:3])
    state, _ = tlf.fit_kernel_noise_large(gp.state, 2, 0.0, 3600.0, num_probes=4)
    assert state.precision == "bf16"
    monkeypatch.setattr(tlogprob, "STREAMED_LOGPROB_THRESHOLD", 16)
    tmap.polish_map(state, num_steps=2, precision=state.precision, num_probes=4)
    assert len(seen) > 6 and set(seen) == {"bf16"}


def test_precision_is_refused_by_the_dense_backend():
    x = RNG.normal(size=(24, 2)).astype(np.float32)
    y = np.sin(x.sum(axis=1)).astype(np.float32)
    with pytest.raises(tft.ConfigError, match="requires the 'streamed' backend"):
        tft.GaussianProcess.new(tp.ZeroPrior(), tk.SquaredExp(), 0.3, None, x, y, dtype="float32",
                                precision="bf16")
    # "auto" applies it where it streams, and builds dense without it here
    gp = tft.GaussianProcess.new(tp.ZeroPrior(), tk.SquaredExp(), 0.3, None, x, y, dtype="float32",
                                 backend="auto", precision="bf16")
    assert gp.state.precision == "bf16" and gp.state.l.dtype == F32
    jgp_ = jft.GaussianProcess.new(jp.ZeroPrior(), jk.SquaredExp(), 0.3, None, x, y, dtype="float32",
                                   backend="streamed", precision="bf16")
    assert jgp_.state.precision == "bf16"


def test_check80k_flow_matches_jax():
    """``scripts/check80k.py``'s data and flow (d = 8, y = sin(2.5 x0) +
    0.5 cos(2 x1) + 2 N(0, 1), noise 2.0, bf16 storage, 100 fit iterations
    at 0.05) at n = 2,000 through both packages: the same fitted
    hyperparameters, and the same training-point mean/target correlation,
    the number check80k.py gates at 0.1. Prints both for the record."""
    n = 2000
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    y = (np.sin(2.5 * x[:, 0]) + 0.5 * np.cos(2.0 * x[:, 1])
         + 2.0 * rng.normal(size=n)).astype(np.float32)
    out = {}
    for name, pkg in (("jax", jft), ("torch", tft)):
        gp = (pkg.GaussianProcessBuilder(x, y).set_noise(2.0).set_dtype("float32")
              .set_backend("streamed").set_factor_storage("bf16").set_fit_subsample(10_000)
              .set_fit_parameters(100, 0.05).fit_kernel().fit_prior().train())
        corr = float(np.corrcoef(np.asarray(gp.predict(x[:512])), y[:512])[0, 1])
        out[name] = (np.asarray(gp.kernel.get_params(), np.float64), float(gp.noise), corr)
    print(json.dumps({"check80k_flow_n2000": {
        k: {"kernel_params": v[0].tolist(), "noise": v[1], "train_corr": v[2]} for k, v in out.items()}}))
    (jparams, jnoise, jcorr), (params, noise, corr) = out["jax"], out["torch"]
    np.testing.assert_allclose(params, jparams, rtol=2e-3)
    assert abs(noise - jnoise) <= 2e-3 * jnoise
    assert abs(corr - jcorr) <= 1e-3 and corr > 0.1
