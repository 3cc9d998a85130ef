"""A ``LargeScaleGP`` of the port served by ``AcceleratedGPServer``
(``friedrich_tpu_torch/serving.py``) from a world of one and from two gloo
ranks, rank 0 serving and rank 1 running ``serving.follow``: the JAX
package's case (``tests/test_serving.py``'s ``LargeScaleGP`` model, n = 96,
d = 3, SquaredExp(1.0, 0.9), ZeroPrior, noise 0.3, block 32) in float64,
built once by the JAX package and carried into the ranks with
``interop.large_scale_from_arrays``.

Served replies must equal the port's own ``predict_mean_variance(rows,
block=)`` at the server's solve width bit for bit (the port's model takes
the "direct" distance, whose cross covariance is elementwise, as the
covariance kernel's is on the card; the "gram" distance's product rounds by
the batch's shape on the CPU), and lie within 1e-9 of the JAX model's
predictions; a request of the wrong width is refused without a collective;
closing the server ends every follower; a follower that fails inside a
sweep makes rank 0 answer with errors instead of waiting. Each world has a
time limit of its own (``run_world``'s ``timeout``), so a hung collective
fails its test.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

import friedrich_tpu.kernels as fk
import friedrich_tpu.priors as fp
from friedrich_tpu.parallel.large_scale import LargeScaleGP
from friedrich_tpu.parallel.mesh import make_matrix_mesh
from torch_parallel_ranks import run_world

RNG = np.random.default_rng(152)
N, D, BLOCK = 96, 3, 32
X = RNG.normal(size=(N, D))
Y = np.sin(X[:, 0])
XQ = RNG.normal(size=(37, D))
#: Requests of 1 to 40 rows, merged by the server.
REQUESTS = [RNG.normal(size=(k, D)) for k in (5, 1, 17, 40, 3, 9, 16, 2)]
#: The server's default solve width, and 16, at which merged chunks span
#: several blocks.
SOLVE_WIDTHS = (256, 16)
KERNEL = {"class": "SquaredExp", "params": {"ls": 1.0, "ampl": 0.9}}
PRIOR = {"class": "ZeroPrior"}
#: Seconds a world may take (a hung collective fails the test).
TIMEOUT_S = 150.0
#: Served (and in-process) replies against the JAX model, float64.
JAX_ATOL = 1e-9


@functools.lru_cache(maxsize=None)
def _jax_model():
    return LargeScaleGP(make_matrix_mesh(n_devices=4), fk.SquaredExp(jnp.float64(1.0), jnp.float64(0.9)),
                        fp.ZeroPrior(), 0.3, jnp.asarray(X), jnp.asarray(Y), block=BLOCK)


def _arrays():
    big = _jax_model()
    return {"x": np.asarray(big.x), "resid": np.asarray(big.resid), "n": big.n,
            "noise": float(big.noise), "l": np.asarray(big.l_sharded)}


def _jax_predict(xq):
    mean, var = _jax_model().predict_mean_variance(jnp.asarray(xq))
    return np.asarray(mean), np.asarray(var)


@pytest.fixture(scope="module", params=(1, 2), ids=lambda w: f"world{w}")
def served(request):
    w = request.param
    calls = [(width, "ls_serve", dict(arrays=_arrays(), kernel=KERNEL, prior=PRIOR, block=BLOCK,
                                      requests=REQUESTS, xq=XQ, solve_width=width, clients=3))
             for width in SOLVE_WIDTHS]
    return w, run_world(w, calls, timeout=TIMEOUT_S)


def _at(served, width):
    w, results = served
    return w, [r[width] for r in results]


@pytest.mark.parametrize("width", SOLVE_WIDTHS)
def test_served_replies_equal_the_in_process_answers_at_the_solve_width(served, width):
    _, ranks = _at(served, width)
    lead = ranks[0]
    assert lead["errors"] == [] and lead["broken"] is None
    for (mean, var), (want_mean, want_var) in zip(lead["served"], lead["in_process"]):
        assert np.array_equal(mean, want_mean) and np.array_equal(var, want_var)


@pytest.mark.parametrize("width", SOLVE_WIDTHS)
def test_served_replies_match_the_jax_model(served, width):
    _, ranks = _at(served, width)
    for q, (mean, var) in zip(REQUESTS, ranks[0]["served"]):
        want_mean, want_var = _jax_predict(q)
        np.testing.assert_allclose(mean, want_mean, rtol=0, atol=JAX_ATOL)
        np.testing.assert_allclose(var, want_var, rtol=0, atol=JAX_ATOL)


def test_wrong_width_is_refused_without_a_collective(served):
    _, ranks = _at(served, SOLVE_WIDTHS[0])
    assert "status 1" in ranks[0]["wrong_width"]
    assert ranks[0]["wrong_width_collectives"] == {}


@pytest.mark.parametrize("width", SOLVE_WIDTHS)
def test_close_ends_every_follower_after_the_same_sweeps(served, width):
    w, ranks = _at(served, width)
    lead = ranks[0]
    assert lead["sweeps"] >= 1
    for info in ranks[1:]:
        assert info["sweeps"] == lead["sweeps"]
    if w == 1:
        assert lead["collectives"] == {}  # a world of one sends nothing
    else:
        # per sweep: the (2,) header and the rows; then the closing header
        heads = lead["collectives"][("broadcast", (2,), "int64")]
        assert heads == lead["sweeps"] + 1
        for info in ranks[1:]:
            assert info["collectives"] == lead["collectives"]


def test_fixed_width_sweep_equals_one_solve(served):
    _, ranks = _at(served, SOLVE_WIDTHS[0])
    for info in ranks:
        for got, want in zip(info["width_8"], info["one_solve"]):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
        for got, want in zip(info["one_solve"], _jax_predict(XQ)):
            np.testing.assert_allclose(got, want, rtol=0, atol=JAX_ATOL)


def test_a_follower_failing_inside_a_sweep_fails_rank_0s_requests():
    calls = [("fail", "ls_serve_follower_fails",
              dict(arrays=_arrays(), kernel=KERNEL, prior=PRIOR, block=BLOCK, requests=REQUESTS[:4]))]
    lead, follower = (r["fail"] for r in run_world(2, calls, timeout=TIMEOUT_S))
    assert follower["raised"] == "rank 1 failed inside the sweep"
    assert lead["statuses"][0] == "ok"
    assert all("status 2" in s for s in lead["statuses"][1:]), lead["statuses"]
    assert lead["broken"]
