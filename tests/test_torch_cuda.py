"""The CUDA covariance-tile and panel-strip kernels against their plain
PyTorch versions, on the card. The kernels have no CPU mode, so these tests
skip without CUDA; run them on a GPU machine with
``python -m pytest tests/test_torch_cuda.py -m cuda --noconftest``.
"""

import numpy as np
import pytest
import torch

import friedrich_tpu_torch.kernels as tk
from friedrich_tpu_torch.ops import covariance as cov
from friedrich_tpu_torch.ops import panel_fused
from friedrich_tpu_torch.ops.cuda import covariance_cuda as cc
from friedrich_tpu_torch.ops.cuda import panel_strip_cuda as pc
from friedrich_tpu_torch.ops.streamed import streamed_cholesky_factor

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
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
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


LEAVES = {
    "Linear": tk.Linear(c=0.4),
    "Polynomial": tk.Polynomial(alpha=0.1, c=1.0, d=2.0),
    "SquaredExp": tk.SquaredExp(ls=0.9, ampl=1.3),
    "Exponential": tk.Exponential(ls=1.1, ampl=0.8),
    "Matern1": tk.Matern1(ls=1.2, ampl=0.9),
    "Matern2": tk.Matern2(ls=1.1, ampl=0.7),
    "HyperTan": tk.HyperTan(alpha=0.3, c=0.1),
    "Multiquadric": tk.Multiquadric(c=0.7),
    "RationalQuadratic": tk.RationalQuadratic(alpha=1.5, ls=1.2),
}


# Each leaf's compiled-in map, and the interpreter (Composite): a whole
# train matrix at capacity 1,000 and 1,001 (rows not 16-byte aligned, the
# masked scalar stores), a strip of rows across the diagonal, and cross
# mode with 333 queries (m2 % 4 != 0), against the plain version.
@pytest.mark.parametrize("cap", (1000, 1001))
@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 2e-5, 2e-5), (torch.float64, 0, 1e-12)],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("name", [*LEAVES, "Composite"])
def test_compiled_maps_match_plain_version(card, name, dtype, rtol, atol, cap):
    rng = np.random.default_rng(75)
    n = 937
    x = torch.as_tensor(rng.normal(size=(cap, 8)), dtype=dtype, device=card)
    q = torch.as_tensor(rng.normal(size=(333, 8)), dtype=dtype, device=card)
    kern = {**LEAVES, **KERNELS}[name].to(dtype, card)
    before = cc.LAUNCHES
    cases = (
        (cc.covariance(kern, x, x, n, 0.3, train=True),
         cov.plain_train_covariance_padded(kern, x, n, 0.3)),
        (cc.covariance(kern, x[300:700], x, n, 0.3, train=True, row0=300),
         cov.plain_train_covariance_padded(kern, x, n, 0.3, rows=(300, 700))),
        (cc.covariance(kern, x, q, n), cov.plain_cross_covariance_train_padded(kern, x, n, q)),
    )
    assert cc.LAUNCHES == before + 3
    for got, want in cases:
        torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


def test_wrapper_refuses_what_the_kernel_does_not_take(card):
    x = torch.zeros((8, 3), device=card)
    kern = tk.SquaredExp()
    with pytest.raises(ValueError, match="dtype"):
        cc.covariance(kern, x.half(), x.half(), 8)
    with pytest.raises(ValueError, match="contiguous"):
        cc.covariance(kern, x.T, x.T, 8)
    with pytest.raises(ValueError, match="CUDA"):
        cc.covariance(kern, x, x.cpu(), 8)


# The panel strip: the kernel map as above, plus a downdate of length j0
# whose two versions sum in different orders, held to its forward-error
# bound j0 * u * (|L_tail| |L_rows|^T) on top of the map's tolerance, and in
# float32 the 3xTF32 split's SPLIT_ERROR * (|L_tail| |L_rows|^T). The
# columns right of the prefix hold NaN: the kernel must never read them (a
# reused factor buffer holds an old factor there). Capacity 1,001 is not a
# multiple of 4: the float32 kernel's cp.async producer feeds it.
@pytest.mark.parametrize("cap", (1000, 1001))
@pytest.mark.parametrize("dtype,rtol,atol,unit,split", [
    (torch.float32, 2e-5, 2e-5, 2.0**-24, pc.SPLIT_ERROR), (torch.float64, 0, 1e-12, 2.0**-53, 0.0)],
    ids=["f32", "f64"])
@pytest.mark.parametrize("name", KERNELS)
def test_panel_strip_matches_plain_version(card, name, dtype, rtol, atol, unit, split, cap):
    rng = np.random.default_rng(72)
    n = 937
    x = torch.as_tensor(rng.normal(size=(cap, 5)), dtype=dtype, device=card)
    l_full = torch.as_tensor(np.tril(rng.normal(size=(cap, cap)) * 0.1), dtype=dtype, device=card)
    kern = KERNELS[name].to(dtype, card)
    for j0, block in ((0, 384), (300, 384), (300, 500), (801, cap - 801)):
        prefix = l_full.clone()
        prefix[:, j0:] = float("nan")
        before = pc.LAUNCHES
        got = panel_fused.panel_strip(kern, x[j0:], x[j0:j0 + block], prefix, n, 0.3, j0, block)
        assert pc.LAUNCHES == before + 1
        want = panel_fused.plain_panel_strip(kern, x[j0:], x[j0:j0 + block], prefix, n, 0.3, j0, block)
        bound = (j0 * unit + split) * (prefix[j0:, :j0].abs() @ prefix[j0:j0 + block, :j0].abs().mT)
        assert bool(((got - want).abs() <= atol + rtol * want.abs() + bound).all())


def _strip_bound(p, block, j0, unit):
    """j0 u (|P| |P[:B]|^T): the downdate's accumulation at unit roundoff u."""
    return j0 * unit * (p.abs() @ p[:block].abs().mT)


# B2's float64 instantiation (mma.sync on the FP64 tensor cores) against its
# plain version at ragged shapes: capacity 1,000 takes TMA, 1,001 and 1,003
# (odd row strides) cp.async; j0 = 0 (nothing to contract) and j0 not a
# multiple of the 16-deep box or the 32-deep stage; B below the
# instruction's 8 columns; rows not a multiple of the 128-row tile; strips
# whose rows end before the capacity (``end``); every distance method; a
# leaf and the Sum/Prod program. NaN right of j0 and below ``end`` must never
# be read. float64 differs only in summation order: 1e-12 plus j0 u
# (|P| |P[:B]|^T); gram_bf16's dot product is float32 by definition.
@pytest.mark.parametrize("cap", (1000, 1001, 1003))
@pytest.mark.parametrize("method", ("gram", "gram_bf16", "direct"))
@pytest.mark.parametrize("name", KERNELS)
def test_panel_strip_f64_matches_plain_version_at_ragged_shapes(card, name, method, cap):
    rng = np.random.default_rng(85)
    n = 937
    x = torch.as_tensor(rng.normal(size=(cap, 5)), device=card)
    l_full = torch.as_tensor(np.tril(rng.normal(size=(cap, cap)) * 0.1), device=card)
    kern = KERNELS[name].to(torch.float64, card)
    atol, rtol = (2e-5, 2e-5) if method == "gram_bf16" else (1e-12, 0.0)
    for j0, block, end in ((0, 384, cap), (0, 5, cap), (17, 130, cap), (300, 7, cap),
                           (333, 500, cap), (801, cap - 801, cap), (300, 77, 613), (96, 96, 500)):
        prefix = l_full.clone()
        prefix[:, j0:] = float("nan")
        prefix[end:] = float("nan")
        before = pc.LAUNCHES_BY_VARIANT["f64"]
        got = pc.panel_strip(kern, x[j0:end], x[j0:j0 + block], prefix, n, 0.3, j0, block, method,
                             end=end)
        assert pc.LAUNCHES_BY_VARIANT["f64"] == before + 1
        want = panel_fused.plain_panel_strip(kern, x[j0:end], x[j0:j0 + block], prefix, n, 0.3, j0,
                                             block, method, end=end)
        p = prefix[j0:end, :j0]
        bound = _strip_bound(p, block, j0, 2.0**-53)
        assert got.shape == (end - j0, block)
        assert bool(((got - want).abs() <= atol + rtol * want.abs() + bound).all())


# The float64 explicit prefix (the out-of-core factorization's chunks): a
# contiguous (cap - j0, C) tensor, C = 0, odd (7, 301: cp.async) and even
# (256: TMA).
@pytest.mark.parametrize("width", (0, 7, 256, 301))
def test_panel_strip_f64_explicit_prefix_matches_plain_version(card, width):
    rng = np.random.default_rng(86)
    cap, n, j0, block = 1000, 950, 416, 320
    x = torch.as_tensor(rng.normal(size=(cap, 5)), device=card)
    prefix = torch.as_tensor(rng.normal(size=(cap - j0, width)) * 0.1, device=card)
    kern = KERNELS["Composite"].to(torch.float64, card)
    before = pc.LAUNCHES_BY_VARIANT["f64"]
    got = panel_fused.panel_strip(kern, x[j0:], x[j0:j0 + block], None, n, 0.3, j0, block,
                                  prefix=prefix)
    assert pc.LAUNCHES_BY_VARIANT["f64"] == before + 1
    want = panel_fused.plain_panel_strip(kern, x[j0:], x[j0:j0 + block], None, n, 0.3, j0, block,
                                         prefix=prefix)
    bound = width * 2.0**-53 * (prefix.abs() @ prefix[:block].abs().mT)
    assert bool(((got - want).abs() <= 1e-12 + bound).all())


# The bfloat16-prefix and single-pass instantiations against the plain
# version in the same operand arithmetic (a bfloat16 prefix upcast; a float32
# prefix rounded to bfloat16 under precision "bf16"): each product is exact,
# so only float32 accumulation separates them. Capacity 1,000 takes TMA for
# both; 1,001 and 1,003 take the bfloat16 kernel's plain loads (row stride
# not a multiple of 8) and, for 1,001 and 1,003, the single pass's cp.async.
# j0 is not a multiple of 64 (one bfloat16 stage). NaN right of j0 must
# never be read.
@pytest.mark.parametrize("cap", (1000, 1001, 1003))
@pytest.mark.parametrize("kind", ("bf16", "one_pass"))
@pytest.mark.parametrize("name", KERNELS)
def test_panel_strip_bf16_instantiations_match_plain_version(card, name, kind, cap):
    rng = np.random.default_rng(75)
    n = 937
    x = torch.as_tensor(rng.normal(size=(cap, 5)), dtype=torch.float32, device=card)
    l_np = np.tril(rng.normal(size=(cap, cap)) * 0.1)
    ldtype, precision = (torch.bfloat16, None) if kind == "bf16" else (torch.float32, "bf16")
    kern = KERNELS[name].to(torch.float32, card)
    for j0, block in ((0, 384), (300, 384), (333, 500), (801, cap - 801)):
        l_full = torch.as_tensor(l_np, dtype=ldtype, device=card)
        l_full[:, j0:] = float("nan")
        before = dict(pc.LAUNCHES_BY_VARIANT)
        got = panel_fused.panel_strip(kern, x[j0:], x[j0:j0 + block], l_full, n, 0.3, j0, block,
                                      precision=precision)
        assert pc.LAUNCHES_BY_VARIANT[kind] == before[kind] + 1
        want = panel_fused.plain_panel_strip(kern, x[j0:], x[j0:j0 + block], l_full, n, 0.3, j0,
                                             block, precision=precision)
        p = panel_fused.downdate_operand(l_full[j0:, :j0], torch.float32, precision)
        bound = _strip_bound(p, block, j0, 2.0**-24)
        assert bool(((got - want).abs() <= 2e-5 + 2e-5 * want.abs() + bound).all())


# The explicit prefix (the out-of-core factorization's first chunk): a
# contiguous (cap - j0, C) tensor, C = 0 (the kernel strip alone), a multiple
# of 8 (TMA) and 300 (float32 TMA, bfloat16 plain loads).
@pytest.mark.parametrize("width", (0, 256, 300))
@pytest.mark.parametrize("kind", ("tf32x3", "bf16", "one_pass"))
def test_panel_strip_explicit_prefix_matches_plain_version(card, kind, width):
    rng = np.random.default_rng(76)
    cap, n, j0, block = 1000, 950, 416, 320
    x = torch.as_tensor(rng.normal(size=(cap, 5)), dtype=torch.float32, device=card)
    ldtype = torch.bfloat16 if kind == "bf16" else torch.float32
    precision = "bf16" if kind == "one_pass" else None
    prefix = torch.as_tensor(rng.normal(size=(cap - j0, width)) * 0.1, dtype=ldtype, device=card)
    kern = KERNELS["Composite"].to(torch.float32, card)
    before = pc.LAUNCHES_BY_VARIANT[kind]
    got = panel_fused.panel_strip(kern, x[j0:], x[j0:j0 + block], None, n, 0.3, j0, block,
                                  precision=precision, prefix=prefix)
    assert pc.LAUNCHES_BY_VARIANT[kind] == before + 1
    want = panel_fused.plain_panel_strip(kern, x[j0:], x[j0:j0 + block], None, n, 0.3, j0, block,
                                         precision=precision, prefix=prefix)
    p = panel_fused.downdate_operand(prefix, torch.float32, precision)
    split = pc.SPLIT_ERROR if kind == "tf32x3" else 0.0
    bound = (width * 2.0**-24 + split) * (p.abs() @ p[:block].abs().mT)
    assert bool(((got - want).abs() <= 2e-5 + 2e-5 * want.abs() + bound).all())


# The warp-specialized bf16-product kernel's geometry, against the plain
# version with the tolerance above: capacity 2,816 takes TMA, 2,817
# (bfloat16 and float32 rows not 16-byte aligned) the plain loads; panels
# whose row-tile count is odd, j0 one below, at and one above 512 (a
# promotion boundary of either consumer warpgroup: every 512 products,
# the second's offset by 256) and 1,024, several laps of the stage ring
# deep (2,430: 38 stages of 64), and widths that are not a multiple of the
# tile's 128 columns. NaN right of j0 must never be read.
@pytest.mark.parametrize("cap", (2816, 2817))
@pytest.mark.parametrize("kind", ("bf16", "one_pass"))
def test_panel_strip_bf16_products_geometry(card, kind, cap):
    rng = np.random.default_rng(84)
    n = 2750
    x = torch.as_tensor(rng.normal(size=(cap, 5)), dtype=torch.float32, device=card)
    l_np = np.tril(rng.normal(size=(cap, cap)) * 0.1)
    ldtype, precision = (torch.bfloat16, None) if kind == "bf16" else (torch.float32, "bf16")
    kern = KERNELS["Composite"].to(torch.float32, card)
    panels = ((511, 300), (512, 300), (513, 300), (1023, 384), (1024, 200), (1025, 250),
              (2430, cap - 2430))
    for j0, block in panels:
        l_full = torch.as_tensor(l_np, dtype=ldtype, device=card)
        l_full[:, j0:] = float("nan")
        before = dict(pc.LAUNCHES_BY_VARIANT)
        got = panel_fused.panel_strip(kern, x[j0:], x[j0:j0 + block], l_full, n, 0.3, j0, block,
                                      precision=precision)
        assert pc.LAUNCHES_BY_VARIANT[kind] == before[kind] + 1
        want = panel_fused.plain_panel_strip(kern, x[j0:], x[j0:j0 + block], l_full, n, 0.3, j0,
                                             block, precision=precision)
        p = panel_fused.downdate_operand(l_full[j0:, :j0], torch.float32, precision)
        bound = _strip_bound(p, block, j0, 2.0**-24)
        assert bool(((got - want).abs() <= 2e-5 + 2e-5 * want.abs() + bound).all()), (j0, block)


# The serialized consumer loop, which the kernel takes for a bfloat16
# factor read in place at a row stride of 125,000 or more: capacity
# 125,008, a contraction of 124,500 (1,946 stages, both warpgroups'
# staggered promotions), a row-tile count that is odd and a width that is
# not a multiple of 128. Only the strip's rows are written (31 GB reserved).
def test_panel_strip_bf16_serialized_loop_at_large_row_stride(card):
    rng = np.random.default_rng(87)
    cap, n, j0, block = 125_008, 124_900, 124_500, 200
    x = torch.as_tensor(rng.normal(size=(cap, 5)), dtype=torch.float32, device=card)
    l_full = torch.empty((cap, cap), dtype=torch.bfloat16, device=card)
    l_full[j0:, :j0] = torch.as_tensor(rng.normal(size=(cap - j0, j0)) * 0.01, device=card)
    l_full[j0:, j0:] = float("nan")
    kern = KERNELS["SquaredExp"].to(torch.float32, card)
    before = pc.LAUNCHES_BY_VARIANT["bf16"]
    got = panel_fused.panel_strip(kern, x[j0:], x[j0:j0 + block], l_full, n, 0.3, j0, block)
    assert pc.LAUNCHES_BY_VARIANT["bf16"] == before + 1
    want = panel_fused.plain_panel_strip(kern, x[j0:], x[j0:j0 + block], l_full, n, 0.3, j0, block)
    p = panel_fused.downdate_operand(l_full[j0:, :j0], torch.float32, None)
    bound = _strip_bound(p, block, j0, 2.0**-24)
    ok = bool(((got - want).abs() <= 2e-5 + 2e-5 * want.abs() + bound).all())
    del l_full
    torch.cuda.empty_cache()
    assert ok


# The explicit prefix at the widths of the out-of-core factorization's
# chunks: 8 (the narrowest a bfloat16 TMA row takes) and 8,192 (8c's panels).
@pytest.mark.parametrize("width", (8, 8192))
@pytest.mark.parametrize("kind", ("tf32x3", "bf16", "one_pass"))
def test_panel_strip_explicit_prefix_at_chunk_widths(card, kind, width):
    rng = np.random.default_rng(85)
    cap, n, j0, block = 1000, 950, 416, 320
    x = torch.as_tensor(rng.normal(size=(cap, 5)), dtype=torch.float32, device=card)
    ldtype = torch.bfloat16 if kind == "bf16" else torch.float32
    precision = "bf16" if kind == "one_pass" else None
    prefix = torch.as_tensor(rng.normal(size=(cap - j0, width)) * 0.1, dtype=ldtype, device=card)
    kern = KERNELS["SquaredExp"].to(torch.float32, card)
    before = pc.LAUNCHES_BY_VARIANT[kind]
    got = panel_fused.panel_strip(kern, x[j0:], x[j0:j0 + block], None, n, 0.3, j0, block,
                                  precision=precision, prefix=prefix)
    assert pc.LAUNCHES_BY_VARIANT[kind] == before + 1
    want = panel_fused.plain_panel_strip(kern, x[j0:], x[j0:j0 + block], None, n, 0.3, j0, block,
                                         precision=precision, prefix=prefix)
    p = panel_fused.downdate_operand(prefix, torch.float32, precision)
    split = pc.SPLIT_ERROR if kind == "tf32x3" else 0.0
    bound = (width * 2.0**-24 + split) * (p.abs() @ p[:block].abs().mT)
    assert bool(((got - want).abs() <= 2e-5 + 2e-5 * want.abs() + bound).all())


# The downdate of a real factor's middle panel against float64 products of
# the same bfloat16 operands, for both bf16-product instantiations: within
# sqrt(j0) u max(|P| |P[:B]|^T), the size of float32 sums whose errors do
# not pile up; an accumulation that drifts with the contraction's length
# (a tensor-core accumulator promoted too rarely) exceeds it.
@pytest.mark.parametrize("storage,precision", (("bf16", None), (None, "bf16")))
def test_panel_strip_downdate_error_against_float64(card, storage, precision):
    rng = np.random.default_rng(86)
    cap, n = 8192, 8000
    x = torch.zeros((cap, 8), dtype=torch.float32, device=card)
    x[:n] = torch.as_tensor(rng.normal(size=(n, 8)), dtype=torch.float32, device=card)
    kern = tk.SquaredExp(ls=1.2, ampl=0.6).to(torch.float32, card)
    l_full, ok = streamed_cholesky_factor(kern, x, n, 2.0, block=1024, storage=storage,
                                          precision=precision)
    assert bool(ok)
    j0, block = 4096, 1024
    got = panel_fused.panel_strip(kern, x[j0:], x[j0:j0 + block], l_full, n, 2.0, j0, block,
                                  precision=precision)
    k_strip = cov.plain_train_covariance_block(kern, x[j0:], x[j0:j0 + block], n, 2.0, row0=j0,
                                               col0=j0)
    p = panel_fused.downdate_operand(l_full[j0:, :j0], torch.float32, precision).double()
    err = float((k_strip.double() - got.double() - p @ p[:block].mT).abs().max())
    scale = float((p.abs() @ p[:block].abs().mT).max())
    print(f"downdate error {err}, {err / (scale * 2.0**-24)} u max(|P| |P|^T)")
    assert err <= j0**0.5 * 2.0**-24 * scale


@pytest.mark.parametrize("storage,precision,kind", (("bf16", None, "bf16"), (None, "bf16", "one_pass")))
def test_streamed_factor_runs_only_its_instantiation(card, storage, precision, kind):
    rng = np.random.default_rng(77)
    x = torch.as_tensor(rng.normal(size=(1024, 4)), dtype=torch.float32, device=card)
    kern = KERNELS["SquaredExp"].to(torch.float32, card)
    before = dict(pc.LAUNCHES_BY_VARIANT)
    got, ok = streamed_cholesky_factor(kern, x, 1000, 0.5, block=256, storage=storage,
                                       precision=precision)
    after = dict(pc.LAUNCHES_BY_VARIANT)
    assert bool(ok)
    assert {k: after[k] - before[k] for k in after} == {
        k: (4 if k == kind else 0) for k in after}
    want, _ = streamed_cholesky_factor(kern.to(torch.float32, "cpu"), x.cpu(), 1000, 0.5, block=256,
                                       storage=storage, precision=precision)
    # the card's and the CPU's float32 summation orders, rounded at write-back
    torch.testing.assert_close(got.float().cpu(), want.float(), rtol=0, atol=2e-2)


def test_bf16_append_on_the_card_matches_the_cpu(card):
    import friedrich_tpu_torch as ft

    rng = np.random.default_rng(78)
    x = rng.normal(size=(900, 4)).astype(np.float32)
    y = np.sin(x.sum(1)).astype(np.float32)
    x2 = rng.normal(size=(100, 4)).astype(np.float32)
    y2 = np.cos(x2.sum(1)).astype(np.float32)
    xq = rng.normal(size=(16, 4)).astype(np.float32)
    out = {}
    for device in ("cpu", "cuda"):
        gp = (ft.GaussianProcessBuilder(x, y, device=device).set_kernel(tk.SquaredExp(ls=1.0, ampl=1.0))
              .set_noise(0.3).set_dtype("float32").set_backend("streamed").set_factor_storage("bf16")
              .set_capacity(1024).set_panel_block(256).train())
        before = pc.LAUNCHES_BY_VARIANT["bf16"]
        gp.add_samples(x2, y2)
        if device == "cuda":
            assert pc.LAUNCHES_BY_VARIANT["bf16"] == before + 4
        assert gp.state.l.dtype == torch.bfloat16 and gp.num_samples == 1000
        out[device] = gp.predict_mean_variance(xq)
    for got, want in zip(out["cuda"], out["cpu"]):
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-3)


@pytest.mark.parametrize("storage", (None, "bf16"))
def test_outofcore_factor_on_the_card(card, storage):
    from friedrich_tpu_torch.ops import outofcore as ooc

    rng = np.random.default_rng(79)
    cap, n, block = 4096, 4000, 1024
    x = torch.as_tensor(rng.normal(size=(cap, 8)), dtype=torch.float32, device=card)
    kern = tk.SquaredExp(ls=1.0, ampl=1.0).to(torch.float32, card)
    kind = "bf16" if storage else "tf32x3"
    before, up, down = pc.LAUNCHES_BY_VARIANT[kind], ooc.TRAFFIC["up"], ooc.TRAFFIC["down"]
    l_host, ok = ooc.outofcore_cholesky_factor(kern, x, n, 1.0, block=block, storage=storage)
    assert ok and l_host.device.type == "cpu" and l_host.dtype == ooc.HOST_DTYPES[storage]
    assert pc.LAUNCHES_BY_VARIANT[kind] == before + cap // block
    es = l_host.element_size()
    panels = cap // block
    # rows >= j0 only: chunks i < j of panel j, and each finished strip once
    want_up = sum((cap - j * block) * block * j for j in range(panels)) * es
    want_down = sum((cap - j * block) * block for j in range(panels)) * es
    assert (ooc.TRAFFIC["up"] - up, ooc.TRAFFIC["down"] - down) == (want_up, want_down)
    want, _ = streamed_cholesky_factor(kern, x, n, 1.0, block=block, storage=storage)
    want = want.float().cpu()
    if storage is None:
        torch.testing.assert_close(l_host, want, rtol=0, atol=5e-5)
    else:
        # two bfloat16 ulps of each entry (2^-6 relative), above a floor
        bound = 2.0**-6 * want.abs() + 2.0**-12 * float(want.abs().max())
        assert bool(((l_host.float() - want).abs() <= bound).all())
    c = torch.as_tensor(rng.normal(size=(cap, 3)), dtype=torch.float32, device=card)
    got = ooc.outofcore_cho_solve(l_host, c)
    ref = torch.cholesky_solve(c.double().cpu(), l_host.double())
    torch.testing.assert_close(got.double().cpu(), ref, rtol=0, atol=5e-3)


def test_from_factor_page_locks_the_host_factor(card):
    """A host factor handed to a model on the card is page-locked in place,
    and the model refactors into it; a carried JAX model's factor too."""
    import friedrich_tpu_torch.priors as tp
    from friedrich_tpu_torch import OutOfCoreGP, interop
    from friedrich_tpu_torch.ops import outofcore as ooc

    rng = np.random.default_rng(83)
    cap, n, block = 2048, 2000, 512
    x = np.zeros((cap, 4), np.float32)
    x[:n] = rng.normal(size=(n, 4))
    resid = np.zeros(cap, np.float32)
    resid[:n] = np.sin(x[:n, 0])
    kern = tk.SquaredExp(ls=1.0, ampl=1.0)
    l_cpu, ok = ooc.outofcore_cholesky_factor(kern.to(torch.float32, "cpu"), torch.as_tensor(x), n,
                                              0.5, block=block)
    assert ok and not ooc.is_page_locked(l_cpu)
    gp = OutOfCoreGP.from_factor(kern, tp.ZeroPrior(), 0.5, x, resid, n, l_cpu.clone(), block=block,
                                 device=card)
    assert ooc.is_page_locked(gp.l_host)
    ptr, mean = gp.l_host.data_ptr(), gp.predict(x[:7])
    gp.set_hyperparameters(noise=0.5)
    assert gp.l_host.data_ptr() == ptr and ooc.is_page_locked(gp.l_host)
    torch.testing.assert_close(gp.l_host, l_cpu, rtol=0, atol=5e-5)
    torch.testing.assert_close(gp.predict(x[:7]), mean, rtol=0, atol=2e-4)
    arrays = {"x": x, "resid": resid, "n": n, "noise": np.float32(0.5), "l_host": l_cpu.numpy()}
    carried = interop.outofcore_from_arrays(arrays, interop.kernel_spec(kern),
                                            interop.prior_spec(tp.ZeroPrior()), block=block,
                                            device=card)
    assert ooc.is_page_locked(carried.l_host)


def test_streamed_factor_on_the_card_matches_the_cpu(card):
    rng = np.random.default_rng(73)
    x = rng.normal(size=(1300, 4))
    kern = KERNELS["Composite"]
    got, ok = streamed_cholesky_factor(kern.to(torch.float64, card), torch.as_tensor(x, device=card),
                                       1250, 0.3, block=(500, 300, 500))
    want, want_ok = streamed_cholesky_factor(kern.to(torch.float64, "cpu"), torch.as_tensor(x), 1250,
                                             0.3, block=(500, 300, 500))
    assert bool(ok) and bool(want_ok)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-10)


def test_f64_streamed_factor_at_an_odd_capacity_matches_the_cpu(card):
    # panels of odd width and odd offsets on the cp.async feed (row stride
    # 1,003), several 32-deep stages past the ring's three
    rng = np.random.default_rng(87)
    x = rng.normal(size=(1003, 4))
    kern = KERNELS["Composite"]
    got, ok = streamed_cholesky_factor(kern.to(torch.float64, card), torch.as_tensor(x, device=card),
                                       950, 0.3, block=(333, 401, 269))
    want, want_ok = streamed_cholesky_factor(kern.to(torch.float64, "cpu"), torch.as_tensor(x), 950,
                                             0.3, block=(333, 401, 269))
    assert bool(ok) and bool(want_ok)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-10)


@pytest.mark.parametrize("dtype", (torch.float32, torch.float64), ids=["f32", "f64"])
def test_streamed_factor_into_a_reused_buffer_on_the_card(card, dtype):
    # an unaligned capacity, and a buffer that holds a factor built at other
    # hyperparameters: the same factor, bit for bit, as a fresh buffer
    rng = np.random.default_rng(74)
    x = torch.as_tensor(rng.normal(size=(1001, 4)), dtype=dtype, device=card)
    kern = KERNELS["Composite"].to(dtype, card)
    old, ok_old = streamed_cholesky_factor(tk.SquaredExp(ls=0.5, ampl=2.0).to(dtype, card), x, 950,
                                           0.4, block=(400, 301, 300))
    fresh, ok = streamed_cholesky_factor(kern, x, 950, 0.3, block=(400, 301, 300))
    ptr = old.data_ptr()
    got, ok_got = streamed_cholesky_factor(kern, x, 950, 0.3, block=(400, 301, 300), l0=old)
    assert bool(ok_old) and bool(ok) and bool(ok_got)
    assert got.data_ptr() == ptr
    assert torch.equal(got, fresh)


# The panel's rows as a separate operand (a rank of the distributed
# factorization below the panel): every instantiation, the strip's rows from
# global row 1,000, the prefix read in place at row stride 1,001 (cp.async /
# plain loads) or 1,000 (TMA), panel rows of odd and aligned widths, kdim 0,
# B < 8 and fewer rows than B; NaN right of the prefix in both operands.
@pytest.mark.parametrize("kind", ("tf32x3", "one_pass", "bf16", "f64"))
@pytest.mark.parametrize("rows,block,j0,ldl,ldb", [(333, 128, 256, 1001, 264), (500, 96, 0, 1000, 8),
                                                   (257, 5, 77, 1000, 81), (64, 200, 300, 1000, 301)])
def test_panel_strip_two_operand_matches_plain_version(card, kind, rows, block, j0, ldl, ldb):
    rng = np.random.default_rng(93)
    dtype = torch.float64 if kind == "f64" else torch.float32
    pdtype = torch.bfloat16 if kind == "bf16" else dtype
    precision = "bf16" if kind == "one_pass" else None
    a = np.full((rows, ldl), np.nan)
    a[:, :j0] = rng.normal(size=(rows, j0)) * 0.1
    q = np.full((block, ldb), np.nan)
    q[:, :j0] = rng.normal(size=(block, j0)) * 0.1
    prefix = torch.as_tensor(a, dtype=pdtype, device=card)[:, :j0]
    panel_rows = torch.as_tensor(q, dtype=pdtype, device=card)[:, :max(j0, 1)]
    x = torch.as_tensor(rng.normal(size=(rows, 5)), dtype=dtype, device=card)
    xj = torch.as_tensor(rng.normal(size=(block, 5)), dtype=dtype, device=card)
    kern = KERNELS["Composite"].to(dtype, card)
    args = (kern, x, xj, None, 1200, 0.3, j0, block)
    kw = dict(precision=precision, prefix=prefix, panel_rows=panel_rows, row0=1000)
    before = pc.LAUNCHES_TWO_OPERAND[kind]
    got = panel_fused.panel_strip(*args, **kw)
    assert pc.LAUNCHES_TWO_OPERAND[kind] == before + 1
    want = panel_fused.plain_panel_strip(*args, **kw)
    p = panel_fused.downdate_operand(prefix, dtype, precision)
    r = panel_fused.downdate_operand(panel_rows[:, :j0], dtype, precision)
    unit, split = (2.0**-53, 0.0) if kind == "f64" else (2.0**-24, pc.SPLIT_ERROR if kind == "tf32x3" else 0.0)
    atol = 1e-12 if kind == "f64" else 2e-5
    bound = (j0 * unit + split) * (p.abs() @ r.abs().mT) + atol + (0 if kind == "f64" else 2e-5) * want.abs()
    assert bool(((got - want).abs() <= bound).all())


def test_panel_strip_wrapper_refuses_what_the_kernel_does_not_take(card):
    x = torch.zeros((8, 3), device=card)
    l_full = torch.zeros((8, 8), device=card)
    kern = tk.SquaredExp()
    with pytest.raises(ValueError, match="dtype"):
        pc.panel_strip(kern, x.double(), x[:4].double(), l_full, 8, 0.1, 0, 4)
    with pytest.raises(ValueError, match="contiguous"):
        pc.panel_strip(kern, x, x[:4], l_full.T, 8, 0.1, 0, 4)
    with pytest.raises(ValueError, match="fit"):
        pc.panel_strip(kern, x[6:], x[6:], l_full, 8, 0.1, 6, 4)
    # a second operand: only beside an explicit prefix, of the prefix's dtype,
    # B rows at least kdim wide; a one-operand strip starts at j0
    with pytest.raises(ValueError, match="explicit prefix"):
        pc.panel_strip(kern, x[4:], x[:4], l_full, 8, 0.1, 4, 4, panel_rows=l_full[:4, :4], row0=4)
    with pytest.raises(ValueError, match="dtype"):
        pc.panel_strip(kern, x, x[:4], None, 8, 0.1, 4, 4, prefix=l_full[:, :4],
                       panel_rows=l_full[:4, :4].double(), row0=0)
    with pytest.raises(ValueError, match="panel rows"):
        pc.panel_strip(kern, x, x[:4], None, 8, 0.1, 4, 4, prefix=l_full[:, :4],
                       panel_rows=l_full[:4, :2].contiguous(), row0=0)
    with pytest.raises(ValueError, match="row0"):
        pc.panel_strip(kern, x[4:], x[4:], None, 8, 0.1, 4, 4, prefix=l_full[4:, :4], row0=2)


@pytest.fixture
def plain_on_card(monkeypatch):
    """A function that makes every covariance build and panel strip on the
    card run its plain version (the kernels' counts then stay still)."""
    def swap():
        monkeypatch.setattr(cc, "covariance", cov.plain_covariance_tile)
        monkeypatch.setattr(pc, "panel_strip", panel_fused.plain_panel_strip)
    return swap


def _density_value_and_grad(logp, theta):
    theta = theta.clone().requires_grad_(True)
    val = logp(theta)
    val.backward()
    return float(val.detach()), theta.grad


# float64: the kernels differ from their plain versions by rounding only
@pytest.mark.parametrize("backend,cap", (("dense", 1024), ("streamed", 4096)))
def test_density_matches_its_plain_version_on_the_card(card, plain_on_card, backend, cap):
    import friedrich_tpu_torch as ft
    from friedrich_tpu_torch.mcmc.logprob import initial_signs, initial_theta, make_hyperparam_logprob

    rng = np.random.default_rng(75)
    x = rng.normal(size=(cap - 24, 6))
    y = np.sin(x[:, 0]) + 0.1 * rng.normal(size=cap - 24)
    gp = ft.GaussianProcess.new(ft.priors.ConstantPrior(c=0.0), KERNELS["Composite"], 0.5, None, x, y,
                                dtype="float64", capacity=cap, device=card)
    theta = initial_theta(gp.state) + 0.05
    logp = make_hyperparam_logprob(gp.state, signs=initial_signs(gp.state), backend=backend)
    before = (cc.LAUNCHES, pc.LAUNCHES)
    val, grad = _density_value_and_grad(logp, theta)
    assert (cc.LAUNCHES > before[0]) if backend == "dense" else (pc.LAUNCHES > before[1])
    plain_on_card()
    want_val, want_grad = _density_value_and_grad(logp, theta)
    np.testing.assert_allclose(val, want_val, rtol=1e-9)
    torch.testing.assert_close(grad, want_grad, rtol=1e-9, atol=1e-9)


# The backward (autograd through the plain builder) against the analytic
# gradient, a tree whose pointwise gradients are its map's derivatives:
# float64 at 1e-10, float32 at rtol 1e-4.
@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 1e-4, 0.0), (torch.float64, 1e-10, 1e-10)],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("points", (1000, 1001))
def test_covariance_backward_matches_the_analytic_gradient_on_the_card(card, points, dtype, rtol, atol):
    rng = np.random.default_rng(76)
    x = torch.as_tensor(rng.normal(size=(points, 5)), dtype=dtype, device=card)
    g = torch.as_tensor(rng.normal(size=(points, points)), dtype=dtype, device=card)
    kernel = (tk.Linear(c=0.4) * tk.SquaredExp(ls=0.9, ampl=1.3)
              + tk.RationalQuadratic(alpha=1.5, ls=1.2)).to(dtype, card)
    n = points - 37
    p = kernel.get_params().clone().requires_grad_(True)
    nz = torch.tensor(0.7, dtype=dtype, device=card, requires_grad=True)
    before = cc.LAUNCHES
    k = cov.TrainCovarianceFn.apply(p, nz, kernel, x, n, "gram")
    assert cc.LAUNCHES == before + 1
    got = torch.cat([t.reshape(-1) for t in torch.autograd.grad(torch.sum(g * k), (p, nz))])
    want_p, want_n = cov.analytic_train_covariance_grads(kernel, x, n, 0.7, g)
    torch.testing.assert_close(got, torch.cat([want_p, want_n.reshape(1)]), rtol=rtol, atol=atol)


def test_polish_and_fit_map_on_the_card_run_the_panel_strip_kernel(card):
    import friedrich_tpu_torch as ft
    from friedrich_tpu_torch.models.map_fit import polish_map

    rng = np.random.default_rng(77)
    x = rng.normal(size=(3000, 4))
    y = np.sin(x[:, 0]) + 0.1 * rng.normal(size=3000)
    gp = ft.GaussianProcess.new(ft.priors.ConstantPrior(c=0.0), tk.SquaredExp(ls=1.0, ampl=1.0), 0.3,
                                None, x, y, dtype="float32", device=card)
    before = pc.LAUNCHES
    polished = ft.GaussianProcess(polish_map(gp.state, num_steps=3))
    assert pc.LAUNCHES > before
    assert polished.log_marginal_likelihood() >= gp.log_marginal_likelihood() - 1e-4 * abs(
        gp.log_marginal_likelihood())
    before = pc.LAUNCHES
    gp.fit_map(num_steps=2)
    assert pc.LAUNCHES > before and np.isfinite(gp.log_marginal_likelihood())


def test_save_and_load_on_the_card_give_identical_predictions(card, tmp_path):
    import friedrich_tpu_torch as ft

    rng = np.random.default_rng(78)
    x, y = rng.normal(size=(700, 3)), rng.normal(size=700)
    gp = ft.GaussianProcess.new(ft.priors.ConstantPrior(c=0.0), KERNELS["SquaredExp"], 0.3, None, x, y,
                                dtype="float32", capacity=800, device=card)
    gp.save(tmp_path / "model")
    loaded = ft.GaussianProcess.load(tmp_path / "model")  # on the default device, CUDA
    xq = torch.as_tensor(rng.normal(size=(50, 3)), dtype=torch.float32, device=card)
    assert all(torch.equal(a, b) for a, b in zip(loaded.predict_mean_variance(xq),
                                                 gp.predict_mean_variance(xq)))


def _sampler_density(card, backend):
    """A GP density on the card: dense at capacity 512, streamed at 2,100
    (above the 2,048 threshold); float64."""
    import friedrich_tpu_torch as ft
    from friedrich_tpu_torch.mcmc.logprob import initial_signs, initial_theta, make_hyperparam_logprob

    cap = 512 if backend == "dense" else 2100
    rng = np.random.default_rng(79)
    x = rng.normal(size=(cap - 12, 4))
    y = np.sin(x[:, 0]) + 0.1 * rng.normal(size=cap - 12)
    gp = ft.GaussianProcess.new(ft.priors.ZeroPrior(), tk.SquaredExp(ls=1.0, ampl=1.0), 0.2, None, x, y,
                                dtype="float64", capacity=cap, device=card)
    logp = make_hyperparam_logprob(gp.state, signs=initial_signs(gp.state))
    return gp, logp, initial_theta(gp.state) + 0.05


# float64: the kernels differ from their plain versions by rounding only,
# over one transition's leapfrogs
@pytest.mark.parametrize("backend", ("dense", "streamed"))
def test_sampler_steps_match_their_plain_versions_on_the_card(card, plain_on_card, backend):
    from friedrich_tpu_torch.mcmc import _adapt, hmc, nuts

    _, logp, theta = _sampler_density(card, backend)
    val_grad = _adapt.value_and_grad(logp)
    inv_mass = torch.ones(3, dtype=torch.float64, device=card)

    def steps():
        logp0, g0 = val_grad(theta)
        draws = _adapt.GeneratorDraws(torch.Generator().manual_seed(5))
        t = nuts.transition(val_grad, theta, logp0, g0, 0.05, inv_mass, 6, draws)
        h = hmc.hmc_step(val_grad, theta, logp0, g0, 0.05, inv_mass, 8, 0.2, draws)
        return t, h

    before = (cc.LAUNCHES, pc.LAUNCHES)
    got = steps()
    assert (cc.LAUNCHES > before[0]) if backend == "dense" else (pc.LAUNCHES > before[1])
    assert got[0][0].device.type == "cuda" and got[0][4] >= 1
    plain_on_card()
    before = (cc.LAUNCHES, pc.LAUNCHES)
    want = steps()
    assert (cc.LAUNCHES, pc.LAUNCHES) == before
    for g, w in zip(got, want):
        assert g[4:] == w[4:]  # the transition's depth and divergence
        for a, b in zip(g[:3], w[:3]):
            torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(g[3], w[3], rtol=1e-9, atol=1e-12)


def test_predictive_mixture_matches_its_plain_version_on_the_card(card, plain_on_card):
    from friedrich_tpu_torch.mcmc import predictive_mixture, sample_predictive

    gp, _, theta = _sampler_density(card, "dense")
    rng = np.random.default_rng(80)
    thetas = torch.as_tensor(theta.cpu().numpy() + 0.1 * rng.normal(size=(6, 2, 3)), device=card)
    xq = torch.as_tensor(rng.normal(size=(300, 4)), device=card)
    z = rng.normal(size=(5, 300))
    before = cc.LAUNCHES
    got = (*predictive_mixture(gp.state, thetas, xq, max_draws=8, chunk_size=3),
           sample_predictive(gp.state, thetas, xq, indices=[0, 3, 5, 7, 11], z=z))
    assert cc.LAUNCHES >= before + 8 * 2
    plain_on_card()
    before = cc.LAUNCHES
    want = (*predictive_mixture(gp.state, thetas, xq, max_draws=8, chunk_size=3),
            sample_predictive(gp.state, thetas, xq, indices=[0, 3, 5, 7, 11], z=z))
    assert cc.LAUNCHES == before
    for a, b in zip(got, want):
        assert a.device.type == "cuda"
        torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("backend", ("dense", "streamed"))
def test_density_at_an_underflowed_lengthscale_on_the_card(card, backend):
    # exp(-800) is 0 in float64: the kernels' host constants are then
    # infinite (IEEE), and the density is evaluated, not an exception
    _, logp, theta = _sampler_density(card, backend)
    theta = theta.clone()
    theta[0] = -800.0
    val = logp(theta)
    assert not bool(torch.isnan(val))


# The hybrid factorization's leaf: a strip whose rows end at ``end`` < cap
# (rows j0..end of the factor, row stride cap), at ragged shapes, on every
# instantiation's feed: the float32 kernel's TMA (cap 1,000) and cp.async
# (1,001) producers, float64; NaN right of j0 and below ``end`` must never be
# read.
@pytest.mark.parametrize("cap", (1000, 1001))
@pytest.mark.parametrize("dtype,rtol,atol,unit,split", [
    (torch.float32, 2e-5, 2e-5, 2.0**-24, pc.SPLIT_ERROR), (torch.float64, 0, 1e-12, 2.0**-53, 0.0)],
    ids=["f32", "f64"])
def test_panel_strip_with_an_end_row_matches_plain_version(card, dtype, rtol, atol, unit, split, cap):
    rng = np.random.default_rng(76)
    n = 937
    x = torch.as_tensor(rng.normal(size=(cap, 5)), dtype=dtype, device=card)
    l_full = torch.as_tensor(np.tril(rng.normal(size=(cap, cap)) * 0.1), dtype=dtype, device=card)
    kern = KERNELS["Composite"].to(dtype, card)
    for j0, block, end in ((0, 96, 500), (96, 96, 500), (404, 96, 500), (300, 77, 613), (0, 128, 128)):
        prefix = l_full.clone()
        prefix[:, j0:] = float("nan")
        prefix[end:] = float("nan")
        before = pc.LAUNCHES
        got = panel_fused.panel_strip(kern, x[j0:end], x[j0:j0 + block], prefix, n, 0.3, j0, block,
                                      end=end)
        assert pc.LAUNCHES == before + 1 and got.shape == (end - j0, block)
        want = panel_fused.plain_panel_strip(kern, x[j0:end], x[j0:j0 + block], prefix, n, 0.3, j0,
                                             block, end=end)
        bound = (j0 * unit + split) * (prefix[j0:end, :j0].abs() @ prefix[j0:j0 + block, :j0].abs().mT)
        assert bool(((got - want).abs() <= atol + rtol * want.abs() + bound).all())
    with pytest.raises(ValueError, match="do not fit"):
        pc.panel_strip(kern, x[10:], x[10:20], l_full, n, 0.3, 10, 10, end=cap + 1)


# The hybrid factorization's K21 (cross mode, rows from h) and S22 (train
# mode shifted to the strip's diagonal: n - c0 live) strips against the
# plain version, where the live block ends inside, before and after them.
@pytest.mark.parametrize("n", (300, 700, 1001))
@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 2e-5, 2e-5), (torch.float64, 0, 1e-12)],
                         ids=["f32", "f64"])
def test_covariance_at_the_hybrid_strips_matches_plain_version(card, dtype, rtol, atol, n):
    rng = np.random.default_rng(77)
    cap, h, block = 1002, 501, 167
    x = torch.as_tensor(rng.normal(size=(cap, 5)), dtype=dtype, device=card)
    kern = KERNELS["SquaredExp"].to(dtype, card)
    for j0 in (0, 334):
        got = cov.covariance_tile(kern, x[h:], x[j0:j0 + block], n, row0=h)
        want = cov.plain_covariance_tile(kern, x[h:], x[j0:j0 + block], n, row0=h)
        torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
    for c0 in (h, h + block, cap - block):
        got = cov.covariance_tile(kern, x[c0:], x[c0:c0 + block], max(n - c0, 0), 0.3, train=True)
        want = cov.plain_train_covariance_block(kern, x[c0:], x[c0:c0 + block], n, 0.3, row0=c0,
                                                col0=c0)
        torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


# cuSOLVER's potrf reads the lower triangle of each diagonal tile: garbage
# above it changes nothing (the JAX package's mirror_diag has no counterpart)
def test_region_factorization_reads_the_lower_triangle_on_the_card(card):
    from friedrich_tpu_torch.ops.tiled import region_cholesky_inplace

    rng = np.random.default_rng(78)
    x = torch.as_tensor(rng.normal(size=(768, 4)), device=card)
    k = cov.train_covariance_padded(KERNELS["Matern1"].to(torch.float64, card), x, 700, 0.3)
    want = torch.linalg.cholesky(k)
    m = torch.tril(k) + torch.triu(torch.full_like(k, 7.0), 1)
    region_cholesky_inplace(m, 0, 3, 256, None)
    torch.testing.assert_close(torch.tril(m), want, rtol=0, atol=1e-10)


@pytest.mark.parametrize("backend", ("tiled", "hybrid"))
def test_tiled_and_hybrid_factors_on_the_card_match_the_cpu(card, backend):
    from friedrich_tpu_torch.ops.hybrid import hybrid_cholesky_factor
    from friedrich_tpu_torch.ops.tiled import tiled_cholesky_factor

    fn = tiled_cholesky_factor if backend == "tiled" else hybrid_cholesky_factor
    rng = np.random.default_rng(79)
    x = rng.normal(size=(1002, 4))
    kern = KERNELS["Composite"]
    b1, b2 = cc.LAUNCHES, pc.LAUNCHES
    got, ok = fn(kern.to(torch.float64, card), torch.as_tensor(x, device=card), 950, 0.3, block=167)
    assert cc.LAUNCHES > b1 and (pc.LAUNCHES > b2) == (backend == "hybrid")
    want, want_ok = fn(kern.to(torch.float64, "cpu"), torch.as_tensor(x), 950, 0.3, block=167)
    assert bool(ok) and bool(want_ok)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-10)


# With block, a query's mean and variance do not depend on the other
# queries of the call (models/gp.sweep_moments): what lets
# AcceleratedGPServer merge requests and still answer each as a call of its
# own rows would
@pytest.mark.parametrize("backend", ("dense", "tiled"))
def test_predictions_are_batch_invariant_on_the_card(card, backend):
    import friedrich_tpu_torch as ft

    rng = np.random.default_rng(81)
    x = rng.normal(size=(3000, 4)).astype(np.float32)
    y = np.sin(x[:, 0]).astype(np.float32)
    gp = ft.GaussianProcess.new(ft.priors.ConstantPrior(0.2), KERNELS["Matern1"], 0.1, None, x, y,
                                dtype="float32", backend=backend, device=card)
    xq = torch.as_tensor(rng.normal(size=(700, 4)), dtype=torch.float32, device=card)
    mean, var = gp.predict_mean_variance(xq, block=256)
    for lo, hi in ((0, 1), (3, 40), (250, 700), (255, 257)):
        m, v = gp.predict_mean_variance(xq[lo:hi], block=256)
        assert torch.equal(m, mean[lo:hi]) and torch.equal(v, var[lo:hi])
