"""The CUDA covariance-tile kernel against its plain PyTorch version, on the
card. The kernel has no CPU mode, so these tests skip without CUDA; run
them on a GPU machine with
``python -m pytest tests/test_torch_cuda.py -m cuda --noconftest``.
"""

import numpy as np
import pytest
import torch

import friedrich_tpu_torch.kernels as tk
from friedrich_tpu_torch.ops import covariance as cov
from friedrich_tpu_torch.ops.cuda import covariance_cuda as cc

pytestmark = pytest.mark.cuda

KERNELS = {
    "SquaredExp": tk.SquaredExp(ls=0.9, ampl=1.3),
    "Matern1": tk.Matern1(ls=1.2, ampl=0.9),
    "RationalQuadratic": tk.RationalQuadratic(alpha=1.5, ls=1.2),
    "Composite": tk.Matern2(ls=1.1, ampl=0.7) * tk.RationalQuadratic(alpha=1.5, ls=1.2)
    + tk.Linear(c=0.4) * tk.SquaredExp(ls=0.9, ampl=1.3),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the covariance kernel has no CPU mode")
    return torch.device("cuda")


# float64: summation order and fused multiply-adds only. float32: the
# rounding of sqdist's cancellation, scaled by the entry (the Composite's
# Linear factor reaches ~15 at d=5), so relative as well as absolute.
@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 2e-5, 2e-5), (torch.float64, 0, 1e-12)],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("name", KERNELS)
def test_kernel_matches_plain_version(card, name, dtype, rtol, atol):
    rng = np.random.default_rng(71)
    x = torch.as_tensor(rng.normal(size=(700, 5)), dtype=dtype, device=card)
    q = torch.as_tensor(rng.normal(size=(130, 5)), dtype=dtype, device=card)
    kern = KERNELS[name].to(dtype, card)
    before = cc.LAUNCHES
    got = cov.train_covariance_padded(kern, x, 650, 0.3)
    want = cov.plain_train_covariance_padded(kern, x, 650, 0.3)
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
    got = cov.cross_covariance_train_padded(kern, x, 650, q)
    want = cov.plain_cross_covariance_train_padded(kern, x, 650, q)
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
    assert cc.LAUNCHES == before + 2


def test_wrapper_refuses_what_the_kernel_does_not_take(card):
    x = torch.zeros((8, 3), device=card)
    kern = tk.SquaredExp()
    with pytest.raises(ValueError, match="dtype"):
        cc.covariance(kern, x.half(), x.half(), 8)
    with pytest.raises(ValueError, match="contiguous"):
        cc.covariance(kern, x.T, x.T, 8)
    with pytest.raises(ValueError, match="CUDA"):
        cc.covariance(kern, x, x.cpu(), 8)
