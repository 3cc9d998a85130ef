"""Covariance builders of the PyTorch port against the JAX package, the
postfix kernel program that the CUDA covariance kernel interprets, and the
single-leaf maps it compiles in.

The port runs on the CPU here, so its dispatchers use the plain builders
(``ops/covariance.py``); the CUDA kernel itself is held against them on
the card by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import friedrich_tpu.kernels as jk
import friedrich_tpu_torch.kernels as tk
from friedrich_tpu.ops import covariance as jcov
from friedrich_tpu.ops import distance as jdist
from friedrich_tpu.ops.pallas.covariance_pallas import (
    cross_covariance_train_pallas,
    train_covariance_pallas,
)
from friedrich_tpu_torch import config
from friedrich_tpu_torch.ops import covariance as tcov
from friedrich_tpu_torch.ops.cuda import build
from friedrich_tpu_torch.ops.cuda import covariance_cuda as cc
from friedrich_tpu_torch.ops.distance import DIST, DOT, SQDIST
from friedrich_tpu_torch.utils.errors import ConfigError


@pytest.fixture(autouse=True)
def _port_on_cpu_in_f64():
    config.enable_x64()
    config.set_device("cpu")
    yield


def _pair(name, **p):
    return getattr(jk, name)(**p), getattr(tk, name)(**p)


def _kernels():
    """(id, jax kernel, port kernel): the nine kernels, a Sum, a Prod, and a
    deeper composition."""
    leaves = {
        "Linear": dict(c=0.4),
        "Polynomial": dict(alpha=0.1, c=1.0, d=2.0),
        "SquaredExp": dict(ls=0.9, ampl=1.3),
        "Exponential": dict(ls=1.1, ampl=0.8),
        "Matern1": dict(ls=1.2, ampl=0.9),
        "Matern2": dict(ls=1.1, ampl=0.7),
        "HyperTan": dict(alpha=0.3, c=0.1),
        "Multiquadric": dict(c=0.7),
        "RationalQuadratic": dict(alpha=1.5, ls=1.2),
    }
    out = [(name, *_pair(name, **p)) for name, p in leaves.items()]
    se, m2 = _pair("SquaredExp", ls=0.9, ampl=1.3), _pair("Matern2", ls=1.1, ampl=0.7)
    lin, rq = _pair("Linear", c=0.4), _pair("RationalQuadratic", alpha=1.5, ls=1.2)
    out.append(("Sum", se[0] + m2[0], se[1] + m2[1]))
    out.append(("Prod", lin[0] * se[0], lin[1] * se[1]))
    out.append(("Composite", m2[0] * rq[0] + lin[0] * se[0], m2[1] * rq[1] + lin[1] * se[1]))
    return out


KERNELS = _kernels()
KERNEL_IDS = [k[0] for k in KERNELS]
METHODS = ("gram", "gram_bf16", "direct")


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("case", KERNELS, ids=KERNEL_IDS)
def test_plain_builders_match_jax(case, method):
    # float64 on both sides: the two differ only in summation order, so
    # atol 1e-12 on O(10) entries. gram_bf16 accumulates its dot product
    # in float32 by definition; the two float32 GEMMs may sum in another
    # order, so it is held at float32 rounding of O(10) values instead.
    atol = 2e-5 if method == "gram_bf16" else 1e-12
    _, jker, tker = case
    rng = np.random.default_rng(11)
    for cap, n, d in ((512, 400, 1), (512, 400, 8), (300, 257, 1), (300, 257, 8)):
        x = rng.normal(size=(cap, d))
        xq = rng.normal(size=(37, d))
        want = jcov.train_covariance_padded(jker, jnp.asarray(x), n, 0.3, method=method)
        got = tcov.train_covariance_padded(tker, _t(x), n, 0.3, method=method)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol)
        want = jcov.cross_covariance_train_padded(jker, jnp.asarray(x), n, jnp.asarray(xq), method=method)
        got = tcov.cross_covariance_train_padded(tker, _t(x), n, _t(xq), method=method)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol)
        want = jcov.cross_covariance(jker, jnp.asarray(xq), jnp.asarray(x), method=method)
        got = tcov.cross_covariance(tker, _t(xq), _t(x), method=method)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol)


@pytest.mark.parametrize("case", KERNELS, ids=KERNEL_IDS)
def test_gradient_covariances_match_jax(case):
    _, jker, tker = case
    rng = np.random.default_rng(12)
    x = rng.normal(size=(64, 3))
    want = jcov.gradient_covariances_padded(jker, jnp.asarray(x), 50)
    got = tcov.gradient_covariances_padded(tker, _t(x), 50)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("case", KERNELS, ids=KERNEL_IDS)
def test_plain_builders_match_pallas_kernel(case):
    # the Pallas kernel run as tests/test_pallas.py runs it, at its shape
    # (cap 512, n 400, d 8) and tolerance (float32, atol 2e-5). At d=1 the
    # float32 gram identity cancels for near-coincident points, and XLA
    # fuses it with a multiply-add where torch rounds each step, so
    # dist-based kernels (Exponential) differ there by sqrt of a rounding
    # error; the float64 comparison above covers d=1.
    _, jker, tker = case
    rng = np.random.default_rng(13)
    cap, n, d = 512, 400, 8
    x = rng.normal(size=(cap, d)).astype(np.float32)
    xq = rng.normal(size=(256, d)).astype(np.float32)
    noise = np.float32(0.3)
    with pltpu.force_tpu_interpret_mode():
        want_train = train_covariance_pallas(jker, jnp.asarray(x), n, jnp.asarray(noise))
        want_cross = cross_covariance_train_pallas(jker, jnp.asarray(x), n, jnp.asarray(xq))
    tk32 = tker.to(torch.float32, "cpu")
    got = tcov.train_covariance_padded(tk32, _t(x), n, torch.tensor(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want_train), rtol=0, atol=2e-5)
    got = tcov.cross_covariance_train_padded(tk32, _t(x), n, _t(xq))
    np.testing.assert_allclose(got.numpy(), np.asarray(want_cross), rtol=0, atol=2e-5)


def test_plain_train_strip_matches_whole_matrix():
    kern = tk.Matern2(ls=1.1, ampl=0.7)
    x = _t(np.random.default_rng(14).normal(size=(300, 4)))
    whole = tcov.plain_train_covariance_padded(kern, x, 257, 0.3)
    strip = tcov.plain_train_covariance_padded(kern, x, 257, 0.3, rows=(200, 290))
    assert torch.equal(strip, whole[200:290])


# -- the postfix program of the CUDA kernel ----------------------------------

SQRT3, SQRT5 = 3.0**0.5, 5.0**0.5


def _leaf(op, p, dot, sq, dist):
    """The leaf formulas of ``run_program`` in csrc/program.cuh."""
    if op == 0:
        return dot + p[0]
    if op == 1:
        return (p[0] * dot + p[1]) ** p[2]
    if op == 2:
        return torch.abs(p[1]) * torch.exp(-sq / (2.0 * p[0] * p[0]))
    if op == 3:
        return torch.abs(p[1]) * torch.exp(-dist / (2.0 * p[0] * p[0]))
    if op == 4:
        x = SQRT3 * dist / torch.abs(p[0])
        return torch.abs(p[1]) * (1.0 + x) * torch.exp(-x)
    if op == 5:
        l = torch.abs(p[0])
        x = SQRT5 * dist / l
        return torch.abs(p[1]) * (1.0 + x + (5.0 * dist * dist) / (3.0 * l * l)) * torch.exp(-x)
    if op == 6:
        return torch.tanh(p[0] * dot + p[1])
    if op == 7:
        return torch.hypot(sq, p[0])
    if op == 8:
        return (1.0 + sq / (2.0 * p[0] * p[1] * p[1])) ** (-p[0])
    raise AssertionError(f"unknown opcode {op}")


def run_program(program, dot, sq, dist):
    """Torch reference interpreter of the postfix program: the semantics
    the CUDA kernel implements."""
    ops, offs, params = program
    p = torch.tensor(params, dtype=torch.float64)
    stack = []
    for op, off in zip(ops, offs):
        if op in (cc.OP_ADD, cc.OP_MUL):
            b, a = stack.pop(), stack.pop()
            stack.append(a + b if op == cc.OP_ADD else a * b)
        else:
            stack.append(_leaf(op, p[off:], dot, sq, dist))
    assert len(stack) == 1
    return stack[0]


@pytest.mark.parametrize("case", KERNELS, ids=KERNEL_IDS)
def test_program_matches_pointwise_and_diagonal(case):
    _, _, tker = case
    rng = np.random.default_rng(15)
    x = _t(rng.normal(size=(40, 5)))
    feats = tcov.pairwise_features(x, x[:30], frozenset({DOT, SQDIST, DIST}))
    program = cc.encode_program(tker)
    got = run_program(program, feats[DOT], feats[SQDIST], feats[DIST])
    np.testing.assert_allclose(got.numpy(), tker.pointwise(feats).numpy(), rtol=1e-14, atol=1e-14)
    zeros = torch.zeros(40, dtype=torch.float64)
    diag = run_program(program, torch.sum(x * x, dim=1), zeros, zeros)
    np.testing.assert_allclose(diag.numpy(), tcov.kernel_diag(tker, x).numpy(), rtol=1e-14, atol=1e-14)


def test_program_layout_and_limits():
    se, lin = tk.SquaredExp(ls=0.9, ampl=1.3), tk.Linear(c=0.4)
    ops, offs, params = cc.encode_program(lin * se + se)
    assert ops == [0, 2, cc.OP_MUL, 2, cc.OP_ADD]
    assert offs == [0, 1, 0, 3, 0]
    assert params == [0.4, 0.9, 1.3, 0.9, 1.3]
    deep = se
    for _ in range(8):
        deep = deep + se
    with pytest.raises(ConfigError, match="too large"):
        cc.encode_program(deep)


# -- the compiled-in map of a single leaf -------------------------------------

LEAF_IDS = KERNEL_IDS[:9]


def _leaf_map(op, c, dot, sq, dist):
    """The leaf formulas of ``leaf_map`` in csrc/program.cuh, on the
    constants of ``build.leaf_constants``."""
    if op == 0:
        return dot + c[0]
    if op == 1:
        return (c[0] * dot + c[1]) ** c[2]
    if op == 2:
        return c[0] * np.exp(sq * c[1])
    if op == 3:
        return c[0] * np.exp(dist * c[1])
    if op == 4:
        x = dist * c[1]
        return c[0] * (1.0 + x) * np.exp(-x)
    if op == 5:
        x = dist * c[1]
        return c[0] * (1.0 + x + dist * dist * c[2]) * np.exp(-x)
    if op == 6:
        return np.tanh(c[0] * dot + c[1])
    if op == 7:
        return np.hypot(sq, c[0])
    if op == 8:
        return (1.0 + sq * c[1]) ** c[0]
    raise AssertionError(f"unknown opcode {op}")


@pytest.mark.parametrize("case", KERNELS, ids=KERNEL_IDS)
def test_kernel_map_selects_the_leaf_or_the_interpreter(case):
    # a single leaf launches its own instantiation (its opcode); a tree the
    # interpreter, with no constants
    name, _, tker = case
    op, consts = cc.kernel_map(tker)
    if name in LEAF_IDS:
        assert op == build.OPCODES[type(tker)] == cc.encode_program(tker)[0][0]
        assert 1 <= len(consts) <= 4
    else:
        assert (op, consts) == (cc.MAP_PROGRAM, [])


@pytest.mark.parametrize("case", KERNELS[:9], ids=LEAF_IDS)
def test_leaf_constants_give_the_jax_map(case):
    # the host's float64 constants (1 / (2 ls^2) and the like) in the
    # compiled-in formulas against the JAX package's pointwise map on the
    # same features, pairwise and diagonal, at float64 rounding; a negative
    # ls and ampl, as the multiplicative ADAM may leave them, included
    _, jker, tker = case
    rng = np.random.default_rng(16)
    x = rng.normal(size=(40, 5))
    feats = jdist.pairwise_features(jnp.asarray(x), jnp.asarray(x[:30]), frozenset({DOT, SQDIST, DIST}))
    dfeats = jdist.diag_features(jnp.asarray(x), frozenset({DOT, SQDIST, DIST}))
    for flip in (1.0, -1.0):
        signs = {f: (flip if f in ("ls", "ampl") else 1.0) for f in tker.PARAM_FIELDS}
        jk_ = type(jker)(**{f: signs[f] * float(getattr(jker, f)) for f in jker.PARAM_FIELDS})
        tk_ = type(tker)(**{f: signs[f] * float(getattr(tker, f)) for f in tker.PARAM_FIELDS})
        op, consts = cc.kernel_map(tk_)
        for fs in (feats, dfeats):
            f = {k: np.asarray(v) for k, v in fs.items()}
            got = _leaf_map(op, consts, f[DOT], f[SQDIST], f[DIST])
            np.testing.assert_allclose(got, np.asarray(jk_.pointwise(fs)), rtol=1e-14, atol=1e-14)


LS_LEAVES = [case for case in KERNELS[:9] if "ls" in case[2].PARAM_FIELDS]


@pytest.mark.parametrize("case", LS_LEAVES, ids=[case[0] for case in LS_LEAVES])
def test_leaf_constants_at_a_zero_lengthscale_give_the_jax_map(case):
    # a sampler's trajectory can underflow a lengthscale to zero: the
    # constants follow IEEE division (infinities, no exception), and the
    # compiled-in formulas on them give the JAX package's map, NaN where it
    # has NaN
    _, jker, tker = case
    x = np.random.default_rng(17).normal(size=(12, 3))
    feats = jdist.pairwise_features(jnp.asarray(x), jnp.asarray(x), frozenset({DOT, SQDIST, DIST}))
    values = {f: 0.0 if f == "ls" else float(getattr(jker, f)) for f in jker.PARAM_FIELDS}
    op, consts = cc.kernel_map(type(tker)(**values))
    f = {k: np.asarray(v) for k, v in feats.items()}
    with np.errstate(all="ignore"):
        got = _leaf_map(op, consts, f[DOT], f[SQDIST], f[DIST])
    np.testing.assert_allclose(got, np.asarray(type(jker)(**values).pointwise(feats)), rtol=1e-14,
                               atol=1e-14)


def test_kernel_wrapper_refuses_cpu_tensors():
    x = torch.zeros((4, 2), dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        cc.covariance(tk.SquaredExp(), x, x, 4)
