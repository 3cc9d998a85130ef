"""The port's native C++ library loader (``friedrich_tpu_torch/native.py``)
against the JAX package's (``tests/test_native.py``): the same compiled
float64 loops, reached from the port's kernels and priors, give the same
numbers; ``NativeGP`` agrees with the port's GP; and the build lands in the
port's own ``_build/``, atomically, under a lock."""

import threading

import numpy as np
import pytest
import torch

import friedrich_tpu.kernels as jk
import friedrich_tpu.priors as jp
import friedrich_tpu_torch as tft
import friedrich_tpu_torch.kernels as tk
import friedrich_tpu_torch.priors as tp
from friedrich_tpu import native as jnative
from friedrich_tpu_torch import config, native

RNG = np.random.default_rng(41)


@pytest.fixture(autouse=True)
def _port_on_cpu_in_f64():
    config.enable_x64()
    config.set_device("cpu")
    yield


LEAVES = {
    "SquaredExp": dict(ls=0.8, ampl=1.4),
    "Exponential": dict(ls=1.1, ampl=0.9),
    "Matern1": dict(ls=0.7, ampl=1.2),
    "Matern2": dict(ls=1.3, ampl=0.6),
    "RationalQuadratic": dict(alpha=1.2, ls=0.9),
    "Linear": dict(c=0.4),
    "Polynomial": dict(alpha=0.9, c=1.3, d=2.0),
    "HyperTan": dict(alpha=0.5, c=0.2),
    "Multiquadric": dict(c=0.7),
}


@pytest.mark.parametrize("name", LEAVES)
def test_cov_matrix_matches_jax_loader(name):
    x1, x2 = RNG.normal(size=(6, 3)), RNG.normal(size=(4, 3))
    tker, jker = getattr(tk, name)(**LEAVES[name]), getattr(jk, name)(**LEAVES[name])
    np.testing.assert_array_equal(native.cov_matrix(tker, torch.as_tensor(x1), x2),
                                  jnative.cov_matrix(jker, x1, x2))
    np.testing.assert_array_equal(native.train_cov(tker, x1, 0.3), jnative.train_cov(jker, x1, 0.3))


def test_composite_kernels_match_jax_loader():
    x1, x2 = RNG.normal(size=(6, 2)), RNG.normal(size=(4, 2))
    pairs = [(tk.SquaredExp(ls=0.8, ampl=1.2) + tk.Linear(c=0.3),
              jk.SquaredExp(ls=0.8, ampl=1.2) + jk.Linear(c=0.3)),
             (tk.Matern1(ls=1.1, ampl=0.9) * tk.RationalQuadratic(alpha=0.8, ls=1.3),
              jk.Matern1(ls=1.1, ampl=0.9) * jk.RationalQuadratic(alpha=0.8, ls=1.3))]
    for tker, jker in pairs:
        np.testing.assert_array_equal(native.cov_matrix(tker, x1, x2), jnative.cov_matrix(jker, x1, x2))
    with pytest.raises(tft.ConfigError, match="simple kernels"):
        native.cov_matrix((pairs[0][0] + pairs[1][0]), x1, x2)


def test_cholesky_solves_and_eps():
    a = RNG.normal(size=(12, 12))
    k = a @ a.T + 12 * np.eye(12)
    l_native = native.cholesky(torch.as_tensor(k))
    np.testing.assert_allclose(l_native, np.linalg.cholesky(k), rtol=1e-10, atol=1e-12)
    b = RNG.normal(size=(12, 3))
    np.testing.assert_allclose(native.solve_lower(l_native, b), np.linalg.solve(l_native, b), rtol=1e-9)
    np.testing.assert_allclose(native.solve_lower(l_native, b[:, 0], trans=True),
                               np.linalg.solve(l_native.T, b[:, 0]), rtol=1e-9)
    low = RNG.normal(size=(10, 2))
    with pytest.raises(tft.CholeskyError):
        native.cholesky(low @ low.T)  # rank 2
    np.testing.assert_array_equal(native.cholesky(low @ low.T, eps=1e-8),
                                  jnative.cholesky(low @ low.T, eps=1e-8))


PRIORS = {
    "zero": (lambda: tp.ZeroPrior(), lambda: jp.ZeroPrior()),
    "constant": (lambda: tp.ConstantPrior(c=0.3), lambda: jp.ConstantPrior(c=0.3)),
    "linear": (lambda: tp.LinearPrior(weights=torch.tensor([0.2, -0.5], dtype=torch.float64),
                                      intercept=0.1),
               lambda: jp.LinearPrior(weights=np.array([0.2, -0.5]), intercept=0.1)),
}


@pytest.mark.parametrize("prior", PRIORS)
@pytest.mark.parametrize("kernel", ["Matern2", "Sum"])
def test_native_gp_matches_port_gp_and_jax_loader(kernel, prior):
    x = RNG.normal(size=(15, 2))
    y = np.sin(x[:, 0]) + 0.1 * RNG.normal(size=15)
    xq = RNG.normal(size=(5, 2))
    make = {"Matern2": lambda m: m.Matern2(ls=1.0, ampl=1.1),
            "Sum": lambda m: m.SquaredExp(ls=0.8, ampl=1.2) + m.Linear(c=0.3)}[kernel]
    tprior, jprior = PRIORS[prior]
    ngp = native.NativeGP(make(tk), tprior(), 0.2, x, y)
    tgp = tft.GaussianProcess.new(tprior(), make(tk), 0.2, None, x, y)
    m_n, v_n = ngp.predict_mean_variance(xq)
    m_t, v_t = tgp.predict_mean_variance(xq)
    np.testing.assert_allclose(m_n, m_t, rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(v_n, v_t, rtol=1e-8, atol=1e-11)
    m_j, v_j = jnative.NativeGP(make(jk), jprior(), 0.2, x, y).predict_mean_variance(xq)
    np.testing.assert_array_equal(m_n, m_j)
    np.testing.assert_array_equal(v_n, v_j)
    with pytest.raises(tft.ConfigError, match="query dim"):
        ngp.predict(RNG.normal(size=(2, 3)))


def test_build_is_the_port_own_and_atomic(tmp_path, monkeypatch):
    """Three threads build at once into an empty build directory: one
    compiles (the others wait on the lock) and all get the same directory,
    holding the library and the daemon and no leftover temporary."""
    own = native.BUILD_DIR
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    got, errors = [], []

    def one():
        try:
            got.append(native.build())
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    threads = [threading.Thread(target=one) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert len(set(got)) == 1
    out = got[0]
    assert out.parent == tmp_path / "_build"
    assert (out / native.LIB_NAME).is_file() and (out / native.DAEMON_NAME).is_file()
    assert sorted(p.name for p in out.parent.iterdir()) == sorted([out.name, "native.lock"])
    # the port's build directory is inside its package, not native/
    assert own == native.NATIVE_DIR.parent / "friedrich_tpu_torch" / "_build"


def test_failed_compile_raises(tmp_path, monkeypatch):
    bad = tmp_path / "friedrich_native.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_LIB_SRC", bad)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
    assert [p.name for p in (tmp_path / "_build").iterdir()] == ["native.lock"]
