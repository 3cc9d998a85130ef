"""The port's multi-rank layer (``friedrich_tpu_torch/parallel/``) against the
JAX package on the CPU: the row-sharded factorization (float64, epsilon
substitution, a rank block that is not a power of two, bfloat16 storage),
the distributed solves and cross-covariance, the append, the collectives
each sends, B2's two-operand plain version, and the entry points.

The port runs in worlds of 1, 2 and 4 gloo ranks, each spawned once for the
file (``tests/torch_parallel_ranks.py``); the JAX package runs here on
meshes of as many of conftest's virtual devices.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

import friedrich_tpu.kernels as fk
from friedrich_tpu.ops.cholesky import factor
from friedrich_tpu.ops.covariance import cross_covariance, train_covariance_padded
from friedrich_tpu.parallel import distributed_solve as jds
from friedrich_tpu.parallel.distributed_append import distributed_cholesky_append
from friedrich_tpu.parallel.distributed_cholesky import distributed_cholesky_factor
from friedrich_tpu.parallel.mesh import make_matrix_mesh

from friedrich_tpu_torch import config
from friedrich_tpu_torch import kernels as tk
from friedrich_tpu_torch.ops.panel_fused import plain_panel_strip
from friedrich_tpu_torch.parallel.distributed_cholesky import ROW_PAD
from torch_parallel_ranks import run_world

RNG = np.random.default_rng(41)
WORLDS = (1, 2, 4)


def _padded(cap, n, d, rng=RNG, dtype=np.float64):
    x = np.zeros((cap, d), dtype)
    x[:n] = rng.normal(size=(n, d))
    return x


SE = {"class": "SquaredExp", "params": {"ls": 0.9, "ampl": 1.4}}
SE1 = {"class": "SquaredExp", "params": {"ls": 1.0, "ampl": 1.0}}
M1 = {"class": "Matern1", "params": {"ls": 1.0, "ampl": 1.0}}
APP = {"class": "SquaredExp", "params": {"ls": 1.0, "ampl": 1.2}}

MAIN = dict(kernel=SE, x_pad=_padded(128, 100, 3), n=100, noise=0.3, block=8)
UNEVEN = dict(kernel=M1, x_pad=_padded(120, 90, 3), n=90, noise=0.25, block=64, eps=1e-8)
# 20 duplicates at zero noise: a rank-1 live block, every later pivot substituted
EPS_X = np.zeros((32, 1))
EPS_X[:20] = 1.0
EPS = dict(kernel=SE1, x_pad=EPS_X, n=20, noise=0.0, block=8, eps=1e-8)
BF16 = dict(kernel=SE, x_pad=_padded(128, 100, 3, dtype=np.float32), n=100, noise=0.3, block=8,
            storage="bf16")
C = RNG.normal(size=(128, 5))
XQ = RNG.normal(size=(7, 3))
APPEND = dict(kernel=APP, x_pad=_padded(128, 90, 3), n=90, noise=0.25, block=8,
              x_new=RNG.normal(size=(12, 3)))
FIT = dict(kernel=SE1, x=RNG.normal(size=(64, 4)), y=RNG.normal(size=64), noise=0.5, block=8,
           num_probes=4)


def _jkernel(spec, dtype=jnp.float64):
    cls = getattr(fk, spec["class"])
    return cls(**{k: dtype(v) for k, v in spec["params"].items()})


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def world(request):
    """Every rank's results of this file's calls, one world per size."""
    w = request.param
    calls = [
        ("main", "factor", MAIN), ("uneven", "factor", UNEVEN), ("eps", "factor", EPS),
        ("bf16", "factor", BF16),
        ("solves", "solves", dict(MAIN, c=C, xq=XQ)),
        ("append", "append", APPEND),
        ("fit", "fit_step_collectives", FIT),
    ]
    return w, run_world(w, calls)


def _gathered(results, key, field="l"):
    return np.vstack([r[key][field] for r in results])


def _jax_factor(w, case, dtype=jnp.float64):
    kw = {k: case[k] for k in ("eps", "storage") if k in case}
    l_mat, ok = distributed_cholesky_factor(
        make_matrix_mesh(n_devices=w), _jkernel(case["kernel"], dtype), jnp.asarray(case["x_pad"]),
        case["n"], dtype(case["noise"]), block=case["block"], **kw)
    assert bool(ok)
    return np.asarray(l_mat, np.float64)


def _dense(case):
    want, ok = factor(train_covariance_padded(_jkernel(case["kernel"]), jnp.asarray(case["x_pad"]),
                                              case["n"], case["noise"]))
    assert bool(ok)
    return np.asarray(want)


def test_factor_matches_jax_and_dense(world):
    w, results = world
    got = _gathered(results, "main")
    assert all(r["main"]["ok"] for r in results)
    np.testing.assert_allclose(got, _jax_factor(w, MAIN), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got, _dense(MAIN), rtol=1e-9, atol=1e-12)


def test_factor_uneven_rank_block_with_eps(world):
    # capacity 120: rank blocks of 120, 60 and 30 rows, panels of 60, 60, 30
    w, results = world
    got = _gathered(results, "uneven")
    np.testing.assert_allclose(got, _jax_factor(w, UNEVEN), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got, _dense(UNEVEN), rtol=1e-9, atol=1e-12)


def test_factor_eps_substitution_matches_jax(world):
    w, results = world
    got = _gathered(results, "eps")
    assert all(r["eps"]["ok"] for r in results)
    np.testing.assert_allclose(got, _jax_factor(w, EPS), rtol=1e-9, atol=1e-12)
    d = np.diagonal(got)[:20]
    assert np.sum(np.isclose(d, np.sqrt(1e-8))) >= 1


def test_factor_bf16_storage_matches_jax(world):
    w, results = world
    assert all(r["bf16"]["dtype"] == "torch.bfloat16" and r["bf16"]["ok"] for r in results)
    got = _gathered(results, "bf16")
    want = _jax_factor(w, BF16, jnp.float32)
    # within two bfloat16 ulps of each entry, above a floor
    # (tests/test_torch_bf16_storage.py's tolerance)
    bound = 2.0**-6 * np.abs(want) + 2.0**-12 * np.abs(want).max()
    assert np.all(np.abs(got - want) <= bound), float(np.max(np.abs(got - want) - bound))


def test_solves_match_jax_and_scipy(world):
    w, results = world
    res = results[0]["solves"]
    mesh = make_matrix_mesh(n_devices=w)
    l_j = jnp.asarray(_jax_factor(w, MAIN))
    l_np = _dense(MAIN)
    c = jnp.asarray(C)
    want = {
        "forward": (jds.distributed_solve_lower(mesh, l_j, c, block=8),
                    sla.solve_triangular(l_np, C, lower=True), 1e-9),
        "backward": (jds.distributed_solve_lower_t(mesh, l_j, c, block=8),
                     sla.solve_triangular(l_np, C, lower=True, trans=1), 1e-9),
        "sharded": (jds.distributed_solve_lower_sharded_rhs(mesh, l_j, c, block=8),
                    sla.solve_triangular(l_np, C, lower=True), 1e-9),
        "cho": (jds.distributed_cho_solve(mesh, l_j, c, block=8),
                sla.cho_solve((l_np, True), C), 1e-8),
    }
    for name, (jax_want, scipy_want, rtol) in want.items():
        np.testing.assert_allclose(res[name], np.asarray(jax_want), rtol=rtol, atol=1e-12,
                                   err_msg=name)
        np.testing.assert_allclose(res[name], scipy_want, rtol=rtol, atol=1e-12, err_msg=name)
    np.testing.assert_allclose(res["vector"], res["forward"][:, 0], rtol=1e-12, atol=1e-14)
    cross = np.vstack([r["solves"]["cross"] for r in results])
    want_cross = jds.distributed_cross_covariance(mesh, _jkernel(SE), jnp.asarray(MAIN["x_pad"]),
                                                  MAIN["n"], jnp.asarray(XQ))
    np.testing.assert_allclose(cross, np.asarray(want_cross), rtol=1e-12, atol=1e-14)


def test_append_matches_jax_and_retrain(world):
    # rows [90, 102) straddle the boundary of 32-row blocks at 96 (4 ranks)
    w, results = world
    assert all(r["append"]["ok"] for r in results)
    got = _gathered(results, "append")
    mesh = make_matrix_mesh(n_devices=w)
    l_j = jnp.asarray(_jax_factor(w, APPEND))
    k = len(APPEND["x_new"])
    x2 = APPEND["x_pad"].copy()
    x2[90:90 + k] = APPEND["x_new"]
    want = distributed_cholesky_append(mesh, l_j, _jkernel(APP), jnp.asarray(x2), 90,
                                       jnp.asarray(APPEND["x_new"]), 0.25, block=8)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got, _gathered(results, "append", "retrain"), rtol=1e-8, atol=1e-10)


def test_ranks_agree_on_replicated_results(world):
    _, results = world
    for r in results[1:]:
        for name in ("forward", "backward", "sharded", "cho"):
            np.testing.assert_array_equal(r["solves"][name], results[0]["solves"][name])


# ---------------------------------------------------------------------------
# the communication contract (tests/test_comm_volume.py's, by count)
# ---------------------------------------------------------------------------


def _factor_collectives(w, cap, b, d, dtype="float64", store="float64"):
    """What the factorization must send: per panel whose owner is not the
    last rank, the owner's X_j (B, d), its panel rows (B, round_up(j0, 8))
    (the one that grows with cap) and its (B, B) diagonal block; one flag."""
    if w == 1:
        return {}
    rows = cap // w
    want = collections.Counter({("all_reduce", (1,), "int32"): 1})
    for j0 in range(0, cap, b):
        if j0 // rows == w - 1:
            continue
        want[("broadcast", (b, d), dtype)] += 1
        want[("broadcast", (b, b), dtype)] += 1
        if j0:
            want[("broadcast", (b, min(-(-j0 // ROW_PAD) * ROW_PAD, cap)), store)] += 1
    return dict(want)


def test_factor_sends_one_dominant_broadcast_per_panel(world):
    w, results = world
    for r in results:
        assert r["main"]["collectives"] == _factor_collectives(w, 128, 8, 3)
        assert r["bf16"]["collectives"] == _factor_collectives(w, 128, 8, 3, "float32", "bfloat16")
    # everything but the panel rows is O(B^2)
    for key, _ in results[0]["main"]["collectives"].items():
        kind, shape, _ = key
        if np.prod(shape) > 8 * 8:
            assert kind == "broadcast" and shape[0] == 8 and shape[1] <= 128


def test_solves_send_only_solution_blocks(world):
    w, results = world
    panels, m = 128 // 8, C.shape[1]
    one = {} if w == 1 else {("all_reduce", (8, m), "float64"): panels}
    two = {} if w == 1 else {("all_reduce", (8, m), "float64"): 2 * panels}
    for r in results:
        res = r["solves"]
        assert res["forward_collectives"] == one
        assert res["sharded_collectives"] == one
        assert res["backward_collectives"] == two
        for key in res["cho_collectives"]:
            assert 128 not in key[1], f"a solve collective {key} scales with cap"


def test_fit_step_scales_with_cap_only_in_the_refactor(world):
    w, results = world
    for r in results:
        fit = r["fit"]
        step = collections.Counter(fit["step"])
        step.subtract(fit["refactor"])
        rest = {k: v for k, v in step.items() if v}
        assert all(v > 0 for v in rest.values()), rest
        for (kind, shape, _), _ in rest.items():
            assert fit["cap"] not in shape, f"fit-step collective {kind} {shape} scales with cap"
            assert np.prod(shape) <= 8 * (1 + FIT["num_probes"]), (kind, shape)


# ---------------------------------------------------------------------------
# B2's two-operand plain version and the entry points (no world)
# ---------------------------------------------------------------------------


def test_two_operand_plain_strip_matches_numpy():
    """A rank below the panel: rows from global row 70 (> j0 + B = 40),
    crossing the live count 80, against the kernel map minus P Q^T."""
    config.enable_x64()
    rng = np.random.default_rng(3)
    rows, b, j0, row0, n, d = 24, 8, 32, 70, 80, 3
    x = rng.normal(size=(rows, d))
    xj = rng.normal(size=(b, d))
    p = rng.normal(size=(rows, 40)) * 0.1
    q = rng.normal(size=(b, 40)) * 0.1
    kern = tk.SquaredExp(ls=0.9, ampl=1.4).to(torch.float64, "cpu")
    got = plain_panel_strip(kern, torch.as_tensor(x), torch.as_tensor(xj), None, n, 0.3, j0, b,
                            prefix=torch.as_tensor(p)[:, :j0], panel_rows=torch.as_tensor(q),
                            row0=row0).numpy()
    k = np.asarray(cross_covariance(_jkernel(SE), jnp.asarray(x), jnp.asarray(xj)))
    live = (np.arange(row0, row0 + rows) < n)[:, None]
    want = np.where(live, k, 0.0) - p[:, :j0] @ q[:, :j0].T
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)
    assert not np.any(live[-4:])  # some rows lie past the live count


def test_entry_matches_jax():
    import importlib.util
    import pathlib

    from friedrich_tpu_torch.entry import entry

    path = pathlib.Path(__file__).resolve().parents[1] / "__graft_entry__.py"
    spec = importlib.util.spec_from_file_location("graft_entry", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    jfn, jargs = mod.entry()
    jmean, jvar = jax.jit(jfn)(*jargs)
    fn, args = entry("cpu")
    mean, var = fn(*args)
    assert mean.dtype == torch.float32 and mean.shape == (64,)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), rtol=1e-4, atol=1e-4)


def test_dryrun_multichip_two_ranks():
    from friedrich_tpu_torch.entry import dryrun_multichip

    dryrun_multichip(2, "cpu")
