"""The panel-blocked triangular solves of the PyTorch port
(``ops/blocked_solve.py``) against the JAX package's
(``friedrich_tpu/ops/blocked_solve.py``) and against ``torch.linalg``, on
float64, float32 and bfloat16 factors, with and without the precomputed
panel inverses. On the CPU.

Tolerances: float64 sweeps agree with the whole solve to 1e-10; float32 and
bfloat16 factors are solved in float32 by both packages, which differ in
summation order (and the JAX package's unrolled sweep applies each
diagonal block's inverse by a GEMM), so they agree to float32 rounding
amplified by the factor's conditioning: 1e-4 at these sizes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from friedrich_tpu.ops import blocked_solve as jbs
from friedrich_tpu_torch import config
from friedrich_tpu_torch.ops import blocked_solve as tbs


@pytest.fixture(autouse=True)
def _port_on_cpu():
    config.set_device("cpu")
    yield


def _factor(n, seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, n))
    k = a @ a.T + n * np.eye(n)
    return np.linalg.cholesky(k), rng


def _as(l64, dtype):
    """The factor in ``dtype`` for both packages (bfloat16 through float32)."""
    t = torch.as_tensor(l64, dtype=torch.float32 if dtype == "bf16" else dtype)
    j = jnp.asarray(t.numpy())
    if dtype == "bf16":
        return t.to(torch.bfloat16), j.astype(jnp.bfloat16)
    return t, j


SWEEPS = {
    "lower": (tbs.blocked_solve_lower, jbs.blocked_solve_lower, False),
    "lower_t": (tbs.blocked_solve_lower_t, jbs.blocked_solve_lower_t, True),
    "cho": (tbs.blocked_cho_solve, jbs.blocked_cho_solve, None),
}


@pytest.mark.parametrize("block", (16, 24))
@pytest.mark.parametrize("dtype", ("bf16", torch.float32), ids=("bf16", "f32"))
@pytest.mark.parametrize("sweep", SWEEPS)
def test_sweeps_match_jax_and_torch_linalg(sweep, dtype, block):
    l64, rng = _factor(96, 11)
    tl, jl = _as(l64, dtype)
    c = rng.normal(size=(96, 3)).astype(np.float32)
    tfn, jfn, trans = SWEEPS[sweep]
    got = tfn(tl, torch.as_tensor(c), block=block)
    assert got.dtype == torch.float32
    for unroll in (True, False):
        want = np.asarray(jfn(jl, jnp.asarray(c), block=block, unroll=unroll))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    # the whole solve against the same (rounded) factor, in float64
    lr = tl.double()
    if trans is None:
        ref = torch.cholesky_solve(torch.as_tensor(c).double(), lr)
    else:
        ref = torch.linalg.solve_triangular(lr.mT if trans else lr, torch.as_tensor(c).double(),
                                            upper=trans)
    np.testing.assert_allclose(got.double().numpy(), ref.numpy(), rtol=0, atol=1e-4)


@pytest.mark.parametrize("sweep", SWEEPS)
def test_float64_sweeps_match_the_whole_solve(sweep):
    l64, rng = _factor(100, 12)
    tl = torch.as_tensor(l64)
    c = torch.as_tensor(rng.normal(size=(100, 2)))
    tfn, _, trans = SWEEPS[sweep]
    got = tfn(tl, c, block=30)  # snapped to 25: four panels
    if trans is None:
        ref = torch.cholesky_solve(c, tl)
    else:
        ref = torch.linalg.solve_triangular(tl.mT if trans else tl, c, upper=trans)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-10)
    # the default panel width (one panel at this size), and a vector
    torch.testing.assert_close(tfn(tl, c[:, 0]), ref[:, 0], rtol=0, atol=1e-10)


@pytest.mark.parametrize("dtype", ("bf16", torch.float32), ids=("bf16", "f32"))
def test_panel_inverses_match_jax(dtype):
    l64, rng = _factor(64, 13)
    tl, jl = _as(l64, dtype)
    inv = tbs.panel_inverses(tl, block=16)
    assert inv.dtype == torch.float32 and inv.shape == (4, 16, 16)
    np.testing.assert_allclose(inv.numpy(), np.asarray(jbs.panel_inverses(jl, block=16)),
                               rtol=0, atol=1e-5)
    c = torch.as_tensor(rng.normal(size=(64, 3)), dtype=torch.float32)
    for sweep in SWEEPS:
        tfn, jfn, _ = SWEEPS[sweep]
        got = tfn(tl, c, diag_inv=inv)
        np.testing.assert_allclose(got.numpy(), tfn(tl, c, block=16).numpy(), rtol=0, atol=1e-4)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jfn(jl, jnp.asarray(c.numpy()), diag_inv=jnp.asarray(inv.numpy()))),
            rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="does not tile"):
        tbs.blocked_solve_lower(tl, c, diag_inv=inv[:3])


def test_bf16_factor_is_never_copied_whole(monkeypatch):
    """Each panel is cast on its own: no (cap, cap) float32 temporary."""
    l64, rng = _factor(64, 14)
    tl = torch.as_tensor(l64, dtype=torch.float32).to(torch.bfloat16)
    seen = []
    real = torch.Tensor.to

    def spy(self, *args, **kw):
        out = real(self, *args, **kw)
        if self.dtype == torch.bfloat16 and out.dtype == torch.float32:
            seen.append(out.numel())
        return out

    monkeypatch.setattr(torch.Tensor, "to", spy)
    tbs.blocked_cho_solve(tl, torch.as_tensor(rng.normal(size=(64, 2)), dtype=torch.float32),
                          block=16)
    assert seen and max(seen) <= 64 * 16
