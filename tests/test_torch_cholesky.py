"""Cholesky paths of the PyTorch port against the JAX package: the ``ok``
flag, per-pivot epsilon substitution, and the blocked rank-k append."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import friedrich_tpu.kernels as jk
import friedrich_tpu_torch.kernels as tk
from friedrich_tpu.ops.covariance import train_covariance_padded as j_train_cov
from friedrich_tpu_torch import config
from friedrich_tpu_torch.ops import cholesky as tch

# friedrich_tpu.ops re-exports a function named ``cholesky`` over the module
jch = importlib.import_module("friedrich_tpu.ops.cholesky")


@pytest.fixture(autouse=True)
def _port_on_cpu_in_f64():
    config.enable_x64()
    config.set_device("cpu")
    yield


def _spd(cap=300, n=257, d=3, seed=21):
    x = np.random.default_rng(seed).normal(size=(cap, d))
    k = j_train_cov(jk.SquaredExp(ls=1.3, ampl=1.1), jnp.asarray(x), n, 0.2)
    return x, np.array(k)  # writable copy for torch.as_tensor


def test_cholesky_ok_flag_and_factor_match_jax():
    _, k = _spd()
    jl, jok = jch.cholesky(jnp.asarray(k))
    tl, tok = tch.cholesky(torch.as_tensor(k))
    assert bool(jok) and bool(tok)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-12, atol=1e-13)


def test_cholesky_ok_flag_false_on_indefinite_matrix():
    _, k = _spd()
    k = k.copy()
    k[100, 100] = -1.0  # a clearly negative pivot
    _, jok = jch.cholesky(jnp.asarray(k))
    tl, tok = tch.cholesky(torch.as_tensor(k))
    assert not bool(jok) and not bool(tok)
    assert torch.isnan(tl).all()  # marked NaN, as JAX marks a failed factor


@pytest.mark.parametrize("block", (128, 64))
def test_substitute_factorization_matches_jax(block):
    _, k = _spd()
    k = k.copy()
    k[150, :] = 0.0  # an exactly zero pivot
    k[:, 150] = 0.0
    k[200, :] = 0.0  # an exactly negative pivot
    k[:, 200] = 0.0
    k[200, 200] = -3.0
    eps = 1e-6
    jl = jch.cholesky_with_substitute(jnp.asarray(k), eps, block=block)
    tl = tch.cholesky_with_substitute(torch.as_tensor(k), eps, block=block)
    assert tl[150, 150] == pytest.approx(eps**0.5) and tl[200, 200] == pytest.approx(eps**0.5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-12, atol=1e-13)
    jf, jok = jch.factor(jnp.asarray(k), eps)
    tf, tok = tch.factor(torch.as_tensor(k), eps)
    assert bool(jok) and bool(tok)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-12, atol=1e-13)
    _, tok_plain = tch.factor(torch.as_tensor(k))
    assert not bool(tok_plain)


@pytest.mark.parametrize("eps", (None, 1e-8))
def test_append_matches_jax(eps):
    x, k = _spd(cap=300, n=240)
    kern_j, kern_t = jk.Matern2(ls=1.2, ampl=0.9), tk.Matern2(ls=1.2, ampl=0.9)
    k = np.asarray(j_train_cov(kern_j, jnp.asarray(x), 240, 0.2))
    l_pad = np.asarray(jch.cholesky(jnp.asarray(k))[0])
    want = jch.cholesky_append_padded(
        jnp.asarray(l_pad), kern_j, jnp.asarray(x), jnp.asarray(240, jnp.int32), 37, 0.2, eps=eps
    )
    got = tch.cholesky_append_padded(
        torch.as_tensor(l_pad), kern_t, torch.as_tensor(x), 240, 37, torch.tensor(0.2, dtype=torch.float64), eps=eps
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=1e-12)
    # the appended factor is the factor of the grown covariance
    full = np.asarray(j_train_cov(kern_j, jnp.asarray(x), 277, 0.2))
    np.testing.assert_allclose((got @ got.T).numpy(), full, rtol=0, atol=1e-10)
