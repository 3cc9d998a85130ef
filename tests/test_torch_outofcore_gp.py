"""``OutOfCoreGP`` of the PyTorch port (``models/outofcore_gp.py``): its
predictions against the port's in-memory ``GaussianProcess`` on the same
data (the cases of ``tests/test_outofcore_gp.py``, whose comparison with
``LargeScaleGP`` waits for the multi-device port), its fits against the JAX
package's ``OutOfCoreGP`` with the JAX probes replayed, and a JAX model
carried across with ``interop``. float32 on the CPU.

Tolerances are the JAX tests': 2e-4 against the in-memory model (5e-4
after an append), 0.05 for bf16 storage; the fits' trajectories agree with
the JAX package's to rtol 2e-3, the bound the JAX tests set between two
float32 engines of the same estimator, and to 2e-2 under bf16 storage,
where the two packages' factors may round one bfloat16 ulp apart.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import friedrich_tpu.kernels as jk
import friedrich_tpu.priors as jp
import friedrich_tpu_torch as tft
import friedrich_tpu_torch.kernels as tk
import friedrich_tpu_torch.priors as tp
from friedrich_tpu.models import OutOfCoreGP as JaxOutOfCoreGP
from friedrich_tpu_torch import CholeskyError, OutOfCoreGP, config, interop

RNG = np.random.default_rng(17)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    config.set_device("cpu")
    yield


def _data(n=150, d=3):
    x = RNG.normal(size=(n, d)).astype(np.float32)
    y = np.sin(x.sum(axis=1)).astype(np.float32)
    return x, y


def _reference_gp(x, y, noise=0.25):
    return tft.GaussianProcess.new(tp.ZeroPrior(), tk.SquaredExp(ls=1.0, ampl=1.0), noise, None, x,
                                   y, dtype="float32")


def _se():
    return tk.SquaredExp(ls=1.0, ampl=1.0)


def test_outofcore_gp_matches_in_memory():
    x, y = _data()
    xq = RNG.normal(size=(9, 3)).astype(np.float32)
    ref = _reference_gp(x, y)
    gp = OutOfCoreGP(_se(), tp.ZeroPrior(), 0.25, x, y, block=32)
    np.testing.assert_allclose(gp.predict(xq).numpy(), ref.predict(xq), atol=2e-4)
    m, v = gp.predict_mean_variance(xq)
    mr, vr = ref.predict_mean_variance(xq)
    np.testing.assert_allclose(m.numpy(), mr, atol=2e-4)
    np.testing.assert_allclose(v.numpy(), vr, atol=2e-4)
    np.testing.assert_allclose(gp.predict_variance(xq).numpy(), vr, atol=2e-4)
    lml = ref.log_marginal_likelihood()
    assert abs(gp.log_marginal_likelihood() - lml) < 0.05 + 1e-3 * abs(lml)
    assert abs(gp.likelihood() - ref.likelihood()) < 0.05 + 1e-3 * abs(ref.likelihood())


def test_outofcore_gp_batches_and_sampling():
    x, y = _data()
    gp = OutOfCoreGP(_se(), tp.ZeroPrior(), 0.25, x, y, block=32)
    xq = RNG.normal(size=(20, 3)).astype(np.float32)
    m, v = gp.predict_in_batches(xq, batch_size=8)
    m2, v2 = gp.predict_mean_variance(xq)
    np.testing.assert_allclose(m.numpy(), m2.numpy(), atol=1e-5)
    np.testing.assert_allclose(v.numpy(), v2.numpy(), atol=1e-5)
    s = gp.sample_at(xq[:4]).sample(torch.Generator().manual_seed(0))
    assert s.shape == (4,) and bool(torch.isfinite(s).all())


def test_outofcore_gp_add_samples_and_hyperparams():
    x, y = _data(n=80)
    x2, y2 = _data(n=20)
    xq = RNG.normal(size=(6, 3)).astype(np.float32)
    gp = OutOfCoreGP(_se(), tp.ZeroPrior(), 0.25, x, y, block=16, capacity=112)
    gp.add_samples(x2, y2)
    assert gp.n == 100
    ref = _reference_gp(np.vstack([x, x2]), np.concatenate([y, y2]))
    np.testing.assert_allclose(gp.predict(xq).numpy(), ref.predict(xq), atol=5e-4)
    # growth past the capacity
    x3, y3 = _data(n=30)
    gp.add_samples(x3, y3)
    assert gp.n == 130 and gp.x.shape[0] >= 130
    # new hyperparameters refactor
    gp.set_hyperparameters(kernel=tk.SquaredExp(ls=1.5, ampl=0.8), noise=0.3)
    assert np.isfinite(gp.log_marginal_likelihood())
    gp.set_hyperparameters(prior=tp.ConstantPrior(0.5))
    ref2 = tft.GaussianProcess.new(tp.ConstantPrior(0.5), tk.SquaredExp(ls=1.5, ampl=0.8), 0.3, None,
                                   np.vstack([x, x2, x3]), np.concatenate([y, y2, y3]),
                                   dtype="float32")
    np.testing.assert_allclose(gp.predict(xq).numpy(), ref2.predict(xq), atol=5e-4)


def test_outofcore_gp_bf16_storage():
    x, y = _data()
    xq = RNG.normal(size=(7, 3)).astype(np.float32)
    ref = _reference_gp(x, y)
    gp = OutOfCoreGP(_se(), tp.ZeroPrior(), 0.25, x, y, block=32, storage="bf16")
    assert gp.l_host.dtype == torch.bfloat16
    np.testing.assert_allclose(gp.predict(xq).numpy(), ref.predict(xq), atol=0.05)


def test_outofcore_gp_failure_restores():
    # duplicate appended points with zero noise break positive definiteness
    x, y = _data(n=40)
    gp = OutOfCoreGP(_se(), tp.ZeroPrior(), 0.0, x, y, block=16, capacity=64)
    before = gp.predict(x[:3]).numpy()
    with pytest.raises(CholeskyError, match="restored"):
        gp.add_samples(x[:5], y[:5])
    assert gp.n == 40
    np.testing.assert_allclose(gp.predict(x[:3]).numpy(), before, atol=1e-6)


@pytest.mark.parametrize("storage", (None, "bf16"))
def test_outofcore_fits_match_jax_with_its_probes(storage):
    """Same estimator, same probes (the JAX package's, replayed), same ADAM
    rules: the port's fit follows the JAX package's."""
    x, y = _data(n=96)
    jgp = JaxOutOfCoreGP(jk.SquaredExp(ls=jnp.float32(0.8), ampl=jnp.float32(1.0)), jp.ZeroPrior(), 0.3,
                         x, y, block=16, storage=storage)
    gp = OutOfCoreGP(tk.SquaredExp(ls=0.8, ampl=1.0), tp.ZeroPrior(), 0.3, x, y, block=16,
                     storage=storage)
    probes = np.asarray(jgp._probes(4, 0))
    jgp.fit_scaled(max_iter=4, num_probes=4, seed=0)
    gp.fit_scaled(max_iter=4, probes=torch.as_tensor(probes))
    rtol = 2e-3 if storage is None else 2e-2
    np.testing.assert_allclose(gp.kernel.get_params().numpy(), np.asarray(jgp.kernel.get_params()),
                               rtol=rtol)
    np.testing.assert_allclose(float(gp.noise), float(jgp.noise), rtol=rtol)
    jgp.fit_generic(max_iter=3, num_probes=4, seed=0)
    gp.fit_generic(max_iter=3, probes=torch.as_tensor(probes))
    np.testing.assert_allclose(gp.kernel.get_params().numpy(), np.asarray(jgp.kernel.get_params()),
                               rtol=rtol)
    np.testing.assert_allclose(float(gp.noise), float(jgp.noise), rtol=rtol)
    assert np.isfinite(gp.log_marginal_likelihood()) and float(gp.noise) > 0
    # the port's own probes run the same fit
    own = OutOfCoreGP(tk.SquaredExp(ls=0.8, ampl=1.0), tp.ZeroPrior(), 0.3, x, y, block=16,
                      storage=storage)
    own.fit_generic(max_iter=2, num_probes=4, seed=0)
    assert np.isfinite(own.log_marginal_likelihood())


def test_outofcore_fit_scaled_requires_scalable():
    x, y = _data(n=32)
    gp = OutOfCoreGP(tk.RationalQuadratic(alpha=1.0, ls=1.0), tp.ZeroPrior(), 0.3, x, y, block=8)
    with pytest.raises(NotImplementedError):
        gp.fit_scaled(max_iter=1)


@pytest.mark.parametrize("storage", (None, "bf16"))
def test_interop_carries_a_jax_outofcore_model(storage):
    from friedrich_tpu.utils.serialization import _kernel_spec, _prior_spec

    x, y = _data(n=60)
    xq = RNG.normal(size=(5, 3)).astype(np.float32)
    jgp = JaxOutOfCoreGP(jk.SquaredExp(ls=jnp.float32(0.9), ampl=jnp.float32(1.1)), jp.ZeroPrior(),
                         0.3, x, y, block=16, capacity=64, storage=storage)
    arrays = {"x": np.asarray(jgp.x), "resid": np.asarray(jgp.resid), "n": jgp.n,
              "noise": np.asarray(jgp.noise), "l_host": jgp.l_host}
    gp = interop.outofcore_from_arrays(arrays, _kernel_spec(jgp.kernel), _prior_spec(jgp.prior),
                                       block=16, storage=storage, device="cpu")
    assert gp.storage == storage and gp.n == 60
    want_bits = jgp.l_host.view(np.uint16) if storage else jgp.l_host
    got = gp.l_host.view(torch.int16).numpy().view(np.uint16) if storage else gp.l_host.numpy()
    np.testing.assert_array_equal(got, want_bits)
    m, v = gp.predict_mean_variance(xq)
    jm, jv = jgp.predict_mean_variance(jnp.asarray(xq))
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), atol=2e-5)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=2e-5)
    assert abs(gp.log_marginal_likelihood() - jgp.log_marginal_likelihood()) < 1e-3


def test_interop_gives_the_port_its_own_host_factor():
    """The carried model refactors into a host factor of its own, never into
    the JAX model's arrays; a host factor of the wrong shape is refused."""
    from friedrich_tpu.utils.serialization import _kernel_spec, _prior_spec

    x, y = _data(n=60)
    jgp = JaxOutOfCoreGP(jk.SquaredExp(ls=jnp.float32(0.9), ampl=jnp.float32(1.1)), jp.ZeroPrior(),
                         0.3, x, y, block=16, capacity=64)
    l_jax = np.asarray(jgp.l_host)
    before = l_jax.copy()
    arrays = {"x": np.asarray(jgp.x), "resid": np.asarray(jgp.resid), "n": jgp.n,
              "noise": np.asarray(jgp.noise), "l_host": l_jax}
    gp = interop.outofcore_from_arrays(arrays, _kernel_spec(jgp.kernel), _prior_spec(jgp.prior),
                                       block=16, device="cpu")
    gp.set_hyperparameters(noise=0.5)
    np.testing.assert_array_equal(l_jax, before)
    assert not np.array_equal(gp.l_host.numpy(), before)
    with pytest.raises(ValueError, match="host factor"):
        OutOfCoreGP.from_factor(_se(), tp.ZeroPrior(), 0.3, arrays["x"], arrays["resid"], 60,
                                torch.zeros((32, 32)), block=16, device="cpu")
