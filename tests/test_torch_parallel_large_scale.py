"""The port's ``LargeScaleGP`` and sharded exact steps
(``friedrich_tpu_torch/parallel/large_scale.py``, ``sharded.py``) against
the JAX package on the CPU: every case of ``tests/test_large_scale.py``
against the JAX object on a mesh of as many virtual devices as the port has
ranks, with the JAX object's Hutchinson probes handed to the port; the four
cases of ``tests/test_sharding.py``; failed appends that leave the model as
it was; and ``OutOfCoreGP``'s fit against ``LargeScaleGP``'s
(``tests/test_outofcore_gp.py:132``); and a JAX model carried into the
ranks by ``interop.large_scale_from_arrays``.

The port runs in a world of 4 gloo ranks (``tests/torch_parallel_ranks.py``),
spawned once for the file; the JAX objects are built once each.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import friedrich_tpu.kernels as fk
import friedrich_tpu.priors as fp
from friedrich_tpu.models import gp as core
from friedrich_tpu.models.optimizer import AdamState, _generic_step, _scaled_step
from friedrich_tpu.ops.streamed_matvec import streamed_grad_matvec
from friedrich_tpu.parallel.large_scale import LargeScaleGP
from friedrich_tpu.parallel.mesh import make_matrix_mesh

from friedrich_tpu_torch import config
from friedrich_tpu_torch import kernels as tk
from friedrich_tpu_torch.ops.streamed_matvec import streamed_grad_matvec as t_streamed_grad_matvec
from torch_parallel_ranks import run_world

RNG = np.random.default_rng(31)
#: Four ranks: n = 150 rounds the capacity up, and an append straddles two
#: rank blocks (the other test files run worlds of 1 and 2).
WORLDS = (4,)


def _data(n, d=2):
    x = RNG.normal(size=(n, d))
    return x, np.sin(x[:, 0]) + 0.1 * RNG.normal(size=n)


def _spec(cls, **params):
    return {"class": cls, "params": params}


def _jkernel(spec):
    return getattr(fk, spec["class"])(**{k: jnp.float64(v) for k, v in spec["params"].items()})


ZERO = {"class": "ZeroPrior"}


def _jprior(spec):
    return fp.ConstantPrior(c=spec["c"]) if spec["class"] == "ConstantPrior" else fp.ZeroPrior()


def _const(c):
    return {"class": "ConstantPrior", "c": c}


X160, Y160 = _data(160)
X120, Y120 = _data(120)
X150, Y150 = _data(150)
X115, Y115 = _data(115)
X96, Y96 = _data(96)
X64, Y64 = _data(64)
XQ37 = RNG.normal(size=(37, 2))
XQ6 = RNG.normal(size=(6, 2))
XN12, YN12 = RNG.normal(size=(12, 2)), RNG.normal(size=12)
XN6, YN6 = RNG.normal(size=(6, 2)), RNG.normal(size=6)
XN8, YN8 = RNG.normal(size=(8, 2)), RNG.normal(size=8)

PREDICT = dict(kernel=_spec("Matern2", ls=1.1, ampl=0.9), prior=_const(0.2), noise=0.25, x=X160,
               y=Y160, block=16, xq=XQ37, batch_size=16)
ROUNDING = dict(kernel=_spec("SquaredExp", ls=1.0, ampl=1.0), prior=ZERO, noise=0.3, x=X150,
                y=Y150, block=16, xq=XQ6)
FIT_SCALED = dict(kernel=_spec("SquaredExp", ls=1.0, ampl=1.0), prior=ZERO, noise=0.3, x=X120,
                  y=Y120, block=16, max_iter=10, scaled=True, num_probes=8)
FIT_GENERIC = dict(kernel=_spec("RationalQuadratic", alpha=1.0, ls=1.0), prior=ZERO, noise=0.3,
                   x=X120, y=Y120, block=16, max_iter=6, scaled=False, num_probes=16)
APPEND = dict(kernel=_spec("SquaredExp", ls=1.0, ampl=1.2), prior=_const(0.1), noise=0.25, x=X115,
              y=Y115, block=16, capacity=160, x_new=XN12, y_new=YN12, xq=XQ6)
GROW = dict(kernel=_spec("SquaredExp", ls=1.0, ampl=1.0), prior=ZERO, noise=0.3, x=X64, y=Y64,
            block=16, x_new=XN8, y_new=YN8, xq=XQ6)
CACHE = dict(kernel=_spec("SquaredExp", ls=1.0, ampl=1.1), prior=ZERO, noise=0.3, x=X96, y=Y96,
             block=16, capacity=112, xq=XQ6, x_new=XN6, y_new=YN6)
# 40 points 3 lengthscales apart: K is well conditioned at zero noise, and
# appending 5 of them again makes it singular
GRID = 3.0 * np.stack(np.meshgrid(np.arange(8.0), np.arange(5.0)), -1).reshape(-1, 2)
FAIL = dict(kernel=_spec("SquaredExp", ls=1.0, ampl=1.0), prior=ZERO, x=GRID, y=np.sin(GRID[:, 0]),
            block=16, capacity=64, xq=GRID[:3] + 0.5)

JAX_CASES = {"predict": (PREDICT, {})}

SHARD_X, SHARD_Y = RNG.normal(size=(48, 3)), RNG.normal(size=48)
SHARD_XQ = RNG.normal(size=(16, 3))
SHARD_SCALED = dict(kernel=_spec("SquaredExp", ls=1.2, ampl=1.5), prior=_const(0.3), noise=0.25,
                    x=SHARD_X, y=SHARD_Y, cap=64, xq=SHARD_XQ, scalable=True)
SHARD_GENERIC = dict(kernel=_spec("RationalQuadratic", alpha=1.1, ls=0.9), prior=ZERO, noise=0.25,
                     x=SHARD_X, y=SHARD_Y, cap=64, xq=SHARD_XQ, scalable=False)


@functools.lru_cache(maxsize=None)
def _jlarge_cached(w, name):
    case, kw = JAX_CASES[name]
    return _jlarge(w, case, **kw)


def _jlarge(w, case, **kw):
    return LargeScaleGP(make_matrix_mesh(n_devices=w), _jkernel(case["kernel"]),
                        _jprior(case["prior"]), case["noise"], jnp.asarray(case["x"]),
                        jnp.asarray(case["y"]), block=case["block"], **kw)


def _jax_probes(w, case):
    return np.asarray(_jlarge(w, case)._probes(case["num_probes"], 0))


def _fit_kwargs(w, case):
    kw = {k: case[k] for k in ("kernel", "prior", "noise", "x", "y", "block", "max_iter", "scaled")}
    return dict(kw, probes=_jax_probes(w, case))


def _jax_arrays(w):
    """The JAX PREDICT model's arrays and specs, for
    ``interop.large_scale_from_arrays``."""
    big = _jlarge_cached(w, "predict")
    arrays = {"x": np.asarray(big.x), "resid": np.asarray(big.resid), "n": big.n,
              "noise": float(big.noise), "l": np.asarray(big.l_sharded)}
    return dict(arrays=arrays, kernel=PREDICT["kernel"], prior=PREDICT["prior"],
                block=PREDICT["block"], xq=XQ37)


def _cache_kwargs(w):
    probes = np.asarray(_jlarge(w, CACHE, capacity=112)._probes(8, 0))
    return dict(CACHE, probes=probes)


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def world(request):
    w = request.param
    calls = [
        ("predict", "ls_predict", PREDICT),
        ("rounding", "ls_predict", ROUNDING),
        ("fit_scaled", "ls_fit", _fit_kwargs(w, FIT_SCALED)),
        ("fit_generic", "ls_fit", _fit_kwargs(w, FIT_GENERIC)),
        ("append", "ls_append", APPEND),
        ("grow", "ls_append", GROW),
        ("cache", "ls_cache", _cache_kwargs(w)),
        ("fail", "ls_append_failure", FAIL),
        ("fail_bf16", "ls_append_failure", dict(FAIL, storage="bf16")),
        ("shard_scaled", "sharded", SHARD_SCALED),
        ("shard_generic", "sharded", SHARD_GENERIC),
        ("outofcore", "outofcore_vs_large", dict(x=X96, y=Y96, block=16, max_iter=4, num_probes=4)),
        ("from_jax", "ls_from_arrays", _jax_arrays(w)),
    ]
    return w, run_world(w, calls)


def _assert_close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# tests/test_large_scale.py's cases
# ---------------------------------------------------------------------------


def test_streamed_grad_matvec_rows_match_jax():
    config.enable_x64()
    x = RNG.normal(size=(96, 2))
    v = RNG.normal(size=(96, 3))
    want = np.asarray(streamed_grad_matvec(fk.SquaredExp(ls=0.8, ampl=1.3), jnp.asarray(x), 80,
                                           jnp.asarray(v), block=16))
    kern = tk.SquaredExp(ls=0.8, ampl=1.3).to(torch.float64, "cpu")
    for rows in ((0, 96), (24, 48), (72, 96)):
        got = t_streamed_grad_matvec(kern, torch.as_tensor(x), 80, torch.as_tensor(v), block=16,
                                     rows=rows)
        _assert_close(got, want[:, rows[0]:rows[1]], 1e-9, 1e-11)


def test_predict_matches_jax(world):
    w, results = world
    res = results[0]["predict"]
    big = _jlarge_cached(w, "predict")
    xq = jnp.asarray(XQ37)
    m, v = big.predict_mean_variance(xq)
    _assert_close(res["mean"], m, 1e-9, 1e-11)
    _assert_close(res["var"], v, 1e-8, 1e-11)
    _assert_close(res["predict"], m, 1e-9, 1e-11)
    _assert_close(res["variance"], big.predict_variance(xq), 1e-8, 1e-11)
    _assert_close(res["lml"], big.log_marginal_likelihood(), 1e-9)
    for r in results[1:]:
        np.testing.assert_array_equal(r["predict"]["mean"], res["mean"])


def test_model_from_jax_arrays(world):
    """``interop.large_scale_from_arrays``: the JAX object's factor as each
    rank's row block, predicting as the JAX object does."""
    w, results = world
    big = _jlarge_cached(w, "predict")
    l_full = np.asarray(big.l_sharded)
    np.testing.assert_array_equal(np.vstack([r["from_jax"]["l_local"] for r in results]), l_full)
    m, v = big.predict_mean_variance(jnp.asarray(XQ37))
    res = results[0]["from_jax"]
    _assert_close(res["mean"], m, 1e-9, 1e-11)
    _assert_close(res["var"], v, 1e-8, 1e-11)
    _assert_close(res["lml"], big.log_marginal_likelihood(), 1e-9)


def test_likelihood_and_sampler_match_jax(world):
    w, results = world
    res = results[0]["predict"]
    big = _jlarge_cached(w, "predict")
    _assert_close(res["likelihood"], big.likelihood(), 1e-9)
    _assert_close(res["sample_mean"], big.sample_at(jnp.asarray(XQ37)).mean(), 1e-9, 1e-11)
    assert np.all(np.isfinite(res["draw"]))


def test_predict_in_batches(world):
    _, results = world
    res = results[0]["predict"]
    # different chunk widths change the products' reduction order
    _assert_close(res["batched_mean"], res["mean"], 1e-12)
    _assert_close(res["batched_var"], res["var"], 1e-10, 1e-13)


def test_capacity_rounding(world):
    # n = 150 on 4 ranks: capacity 152, results unchanged
    w, results = world
    res = results[0]["rounding"]
    assert res["capacity"] == -(-150 // w) * w
    big = _jlarge(w, ROUNDING)
    _assert_close(res["predict"], big.predict(jnp.asarray(XQ6)), 1e-9, 1e-11)


def test_fit_scaled_matches_jax(world):
    """A whole scaled fit with the JAX object's probes, and its LML gain."""
    w, results = world
    res = results[0]["fit_scaled"]
    big = _jlarge(w, FIT_SCALED)
    big.fit_scaled(max_iter=10, convergence_fraction=1e-12, num_probes=8)
    _assert_close(res["params"], big.kernel.get_params(), 1e-8)
    _assert_close(res["noise"], float(big.noise), 1e-8)
    _assert_close(res["lml"], big.log_marginal_likelihood(), 1e-8)
    assert res["lml"] > res["lml_before"]


def test_fit_generic_matches_jax(world):
    w, results = world
    res = results[0]["fit_generic"]
    big = _jlarge(w, FIT_GENERIC)
    big.fit_generic(max_iter=6, convergence_fraction=1e-12, num_probes=16)
    _assert_close(res["params"], big.kernel.get_params(), 1e-8)
    _assert_close(res["noise"], float(big.noise), 1e-8)
    assert np.isfinite(res["lml"])


def test_add_samples_matches_jax(world):
    # rows [115, 127) straddle the boundary of 40-row blocks at 120 (4 ranks)
    w, results = world
    res = results[0]["append"]
    assert res["raised"] is None and res["n"] == 127 and res["overflow_raised"]
    big = _jlarge(w, APPEND, capacity=160)
    big.add_samples(jnp.asarray(XN12), jnp.asarray(YN12))
    m, v = big.predict_mean_variance(jnp.asarray(XQ6))
    _assert_close(res["mean"], m, 1e-9, 1e-11)
    _assert_close(res["var"], v, 1e-8, 1e-11)


def test_auto_grow_append(world):
    w, results = world
    res = results[0]["grow"]
    assert res["raised"] and "capacity" in res["raised"]
    assert res["n"] == 72
    big = _jlarge(w, GROW)
    big.add_samples(jnp.asarray(XN8), jnp.asarray(YN8), auto_grow=True)
    _assert_close(res["predict"], big.predict(jnp.asarray(XQ6)), 1e-9, 1e-11)


def test_weights_cache_reuse_and_invalidation(world):
    w, results = world
    res = results[0]["cache"]
    assert res["empty_at_start"] and res["reused"]
    assert res["dropped_by_fit"] and res["moved"] and res["dropped_by_append"]
    _assert_close(res["got"], res["fresh"], 1e-8, 1e-10)
    big = _jlarge(w, CACHE, capacity=112)
    big.fit_scaled(max_iter=2, convergence_fraction=1e-12)
    big.add_samples(jnp.asarray(XN6), jnp.asarray(YN6))
    _assert_close(res["params"], big.kernel.get_params(), 1e-8)
    _assert_close(res["got"], big.predict(jnp.asarray(XQ6)), 1e-8, 1e-10)


@pytest.mark.parametrize("case", ["fail", "fail_bf16"])
def test_failed_append_leaves_the_model(world, case):
    """Exact duplicates at zero noise: the append (float64: the rank-k
    update; bfloat16 storage: the refactor, after which the port refactors
    the previous model into its buffer) raises and the model is as before,
    as the JAX package's is."""
    _, results = world
    for r in results:
        res = r[case]
        assert res["raised"] and res["n"] == 40
        _assert_close(res["after"], res["before"], 1e-6 if case == "fail_bf16" else 1e-12)


def test_outofcore_fit_matches_large_scale(world):
    """``tests/test_outofcore_gp.py:132``: the same estimator, probes and
    ADAM rules in float32, the out-of-core model in one process."""
    _, results = world
    res = results[0]["outofcore"]
    _assert_close(res["ooc_params"], res["large_params"], 2e-3)
    _assert_close(res["ooc_noise"], res["large_noise"], 2e-3)


# ---------------------------------------------------------------------------
# tests/test_sharding.py's four cases
# ---------------------------------------------------------------------------


def _jstate(case):
    state, ok = core.make_state(_jkernel(case["kernel"]), _jprior(case["prior"]), case["noise"],
                                jnp.asarray(case["x"]), jnp.asarray(case["y"]), cap=case["cap"])
    assert bool(ok)
    return state


def test_sharded_build_factor_matches_single_device(world):
    _, results = world
    got = np.vstack([r["shard_scaled"]["l"] for r in results])
    assert all(r["shard_scaled"]["ok"] for r in results)
    _assert_close(got, _jstate(SHARD_SCALED).l, 1e-9, 1e-11)


def test_sharded_train_step_matches_single_device(world):
    _, results = world
    state = _jstate(SHARD_SCALED)
    params = state.kernel.get_params()
    adam = AdamState(params=params, m=jnp.zeros_like(params), v=jnp.zeros_like(params))
    ref_state, ref_adam, _, ref_ok, _ = _scaled_step(state, adam, jnp.asarray(1),
                                                    jnp.asarray(0.05))
    assert bool(ref_ok)
    for r in results:
        res = r["shard_scaled"]
        assert res["step_ok"]
        _assert_close(res["adam_params"], ref_adam.params, 1e-9)
        _assert_close(res["noise"], float(ref_state.noise), 1e-9)
    got = np.vstack([r["shard_scaled"]["step_l"] for r in results])
    _assert_close(got, ref_state.l, 1e-8, 1e-10)


def test_sharded_predict_matches_single_device(world):
    _, results = world
    mean_ref, var_ref = core.predict_mean_variance(_jstate(SHARD_SCALED), jnp.asarray(SHARD_XQ))
    for r in results:
        _assert_close(r["shard_scaled"]["mean"], mean_ref, 1e-9)
        _assert_close(r["shard_scaled"]["var"], var_ref, 1e-8, 1e-11)


def test_sharded_train_step_generic_path(world):
    _, results = world
    state = _jstate(SHARD_GENERIC)
    params = jnp.concatenate([state.kernel.get_params(), jnp.log(state.noise)[None]])
    adam = AdamState(params=params, m=jnp.zeros_like(params), v=jnp.zeros_like(params))
    ref_state, ref_adam, _, ref_ok, _ = _generic_step(state, adam, jnp.asarray(1),
                                                     jnp.asarray(0.05))
    assert bool(ref_ok)
    for r in results:
        _assert_close(r["shard_generic"]["adam_params"], ref_adam.params, 1e-9)
    got = np.vstack([r["shard_generic"]["step_l"] for r in results])
    _assert_close(got, ref_state.l, 1e-8, 1e-10)
