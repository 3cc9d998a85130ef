"""The builder's sharded backend (``set_backend("sharded")``,
``friedrich_tpu_torch/models/builder.py``): ``train()`` over every rank of a
process group returns a ``LargeScaleGP``; the multi-rank layer's counters
and spans (``parallel/mesh.COLLECTIVE_BYTES``, ``mesh/broadcast``,
``mesh/all_reduce``, ``large_scale/factor``) and B2's launches by shape
(``ops/cuda/panel_strip_cuda.LAUNCHES_BY_SHAPE``).

The ranks are a world of 4 gloo CPU processes (``tests/torch_parallel_ranks.py``),
spawned once for the file, in float64. Predictions are held against the
benchmark's plain reference (``gpbench/reference/gp.py``: plain torch, none
of the port's code).
"""

import numpy as np
import pytest
import torch

from friedrich_tpu_torch import GaussianProcess
from friedrich_tpu_torch.ops.cuda import panel_strip_cuda
from friedrich_tpu_torch.parallel.distributed_cholesky import ROW_PAD
from friedrich_tpu_torch.utils.errors import ConfigError
from gpbench.reference import gp as ref
from torch_parallel_ranks import run_world

WORLD = 4
RNG = np.random.default_rng(18)
D = 8
#: The sub-fit case: n = 2,048 points, 512 of them fitted on, 256 rows
#: predicted; the recipe's noise cut to 0.1, so that 512 points keep the
#: signal (under N(0, 1) the fit there takes the data for noise alone).
N, SUB, ROWS = 2048, 512, 256
X = RNG.normal(size=(N, D))
Y = np.sin(2.5 * X[:, 0]) + 0.5 * np.cos(2.0 * X[:, 1]) + 0.1 * RNG.normal(size=N)
XQ = RNG.normal(size=(ROWS, D))
#: The case without a sub-fit (its full-n fit is the slow part: kept small).
N_FULL, FULL_ITER = 512, 3
#: The counted build: 512 rows a rank, panels of 128.
BLOCK = 128


@pytest.fixture(scope="module")
def ranks():
    return run_world(WORLD, [
        ("subfit", "builder_subfit", dict(x=X, y=Y, xq=XQ, subsample=SUB)),
        ("full", "builder_full_fit", dict(x=X[:N_FULL], y=Y[:N_FULL], max_iter=FULL_ITER)),
        ("counts", "build_counts", dict(x=X, y=Y, block=BLOCK)),
    ])


def test_train_returns_a_large_scale_gp_on_every_rank(ranks):
    for rank, out in enumerate(ranks):
        got = out["subfit"]
        assert got["type"] == "LargeScaleGP" and got["mesh"] == (rank, WORLD)
        assert got["capacity"] == N
        assert got["timings"] == ["build", "heuristic", "subfit", "subfit_iterations"]


def test_the_hyperparameters_are_rank_0s_and_the_one_card_builders(ranks):
    """Every rank fits on its own data alike and builds at rank 0's
    hyperparameters: the same bits on every rank, and those of the one-card
    builder's flow (the same sub-fit in the same process)."""
    first = ranks[0]["subfit"]
    for out in ranks:
        got = out["subfit"]
        for key in ("kernel", "noise", "prior"):
            np.testing.assert_array_equal(got[key], first[key])
            np.testing.assert_array_equal(got[key], got["one"][key])


def test_predictions_match_the_plain_reference(ranks):
    """The plain reference at the fitted hyperparameters, in float64 as the
    model: the two differ only by the order of their sums (B2's plain version
    against the reference's panel Cholesky, a blocked solve against one
    triangular solve), a few hundred ulps of these O(1) answers, so 1e-9
    relative and absolute."""
    got = ranks[0]["subfit"]
    ls, ampl = (float(v) for v in got["kernel"])
    x, y, xq = (torch.as_tensor(a) for a in (X, Y, XQ))
    factor = ref.cholesky(x, ls, ampl, got["noise"])
    mean, var = ref.predict(factor, x, y - got["prior"], got["prior"], ls, ampl, xq)
    assert float(torch.max(var)) > 1e-3  # the answers carry the data, not only the prior
    for out in ranks:
        np.testing.assert_allclose(out["subfit"]["mean"], mean.numpy(), rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(out["subfit"]["var"], var.numpy(), rtol=1e-9, atol=1e-9)


def test_without_a_sub_fit_the_builder_runs_fit_scaled(ranks):
    """No sub-fit: the prior and the heuristic kernel on the full data, the
    sharded build, then ``LargeScaleGP.fit_scaled`` with the builder's
    settings: the same arithmetic as those steps taken by hand."""
    for out in ranks:
        got = out["full"]
        assert got["type"] == "LargeScaleGP"
        assert set(got["timings"]) == {"heuristic", "build", "fit", "fit_iterations"}
        assert got["timings"]["fit_iterations"] == got["iterations"] == FULL_ITER
        for key in ("kernel", "noise", "prior"):
            np.testing.assert_array_equal(got[key], got["by_hand"][key])


def _panels():
    """``(j0, owner)`` of each panel of the counted build."""
    rows = N // WORLD
    return [(j0, j0 // rows) for j0 in range(0, N, BLOCK)]


def test_a_builds_broadcast_bytes(ranks):
    """For each panel of a rank but the last: its inputs (B, d), its rows
    of the factor to its left (B, j0 padded to ROW_PAD; none at j0 = 0) and
    its diagonal block (B, B), float64."""
    want = sum(8 * BLOCK * (D + BLOCK + (-(-j0 // ROW_PAD) * ROW_PAD if j0 else 0))
               for j0, owner in _panels() if owner < WORLD - 1)
    for out in ranks:
        assert out["counts"]["bytes"]["broadcast"] == want
        assert out["counts"]["bytes"]["all_reduce"] == 4  # the one int32 flag


def test_one_span_per_collective(ranks):
    for out in ranks:
        spans = out["counts"]["spans"]
        for kind in ("broadcast", "all_reduce"):
            mine = [attrs for name, attrs in spans if name == f"mesh/{kind}"]
            assert len(mine) == out["counts"]["counts"][kind]
            assert sum(a["bytes"] for a in mine) == out["counts"]["bytes"][kind]
        factor = [attrs for name, attrs in spans if name == "large_scale/factor"]
        assert factor == [{"cap": N, "world": WORLD, "block": BLOCK}]


def test_b2_launches_by_shape(ranks):
    """A rank launches B2 once for each panel at or above its rows: its
    own with one operand, its rows below the panel's and the prefix's
    depth j0; below the owner with two, all its rows."""
    rows = N // WORLD
    for rank, out in enumerate(ranks):
        want = []
        for j0, owner in _panels():
            if owner == rank:
                want.append(panel_strip_cuda.launch_shape(rows - (j0 - rank * rows), BLOCK, j0, D,
                                                          torch.float64, False))
            elif owner < rank:
                want.append(panel_strip_cuda.launch_shape(rows, BLOCK, j0, D, torch.float64, True))
        assert [tuple(c) for c in out["counts"]["launches"]] == want


@pytest.mark.parametrize("setting", ["precision", "schedule", "exact_gradient"])
def test_a_knob_the_multi_rank_layer_does_not_take(setting):
    """Refused before any work, so here with no process group: the ranks'
    own check (``make_matrix_mesh``) comes after the knobs'."""
    x, y = torch.as_tensor(X[:64]), torch.as_tensor(Y[:64])
    builder = GaussianProcess.builder(x, y, device="cpu").set_backend("sharded")
    if setting == "precision":
        builder.set_factor_precision("bf16")
    elif setting == "schedule":
        builder.set_panel_block([32, 32])
    else:
        # no sub-fit: the fit at full n, which the multi-rank layer makes by
        # the Hutchinson gradient only
        builder.set_fit_subsample(None).set_fit_gradient("exact").fit_kernel()
    with pytest.raises(ConfigError, match="'sharded' backend takes"):
        builder.train()


def test_no_process_group():
    x, y = torch.as_tensor(X[:64]), torch.as_tensor(Y[:64])
    with pytest.raises(ConfigError, match="no torch.distributed process group"):
        GaussianProcess.builder(x, y, device="cpu").set_backend("sharded").fit_kernel().train()


def test_the_one_card_model_takes_no_sharded_backend():
    from friedrich_tpu_torch.kernels import Gaussian
    from friedrich_tpu_torch.priors import ZeroPrior

    x, y = torch.as_tensor(X[:64]), torch.as_tensor(Y[:64])
    with pytest.raises(ConfigError, match="unknown backend"):
        GaussianProcess.new(ZeroPrior(), Gaussian(), 0.1, None, x, y, device="cpu",
                            backend="sharded")
