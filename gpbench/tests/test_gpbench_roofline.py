"""Work counts and peaks of ``gpbench/roofline.py``."""

import pytest
import torch

from gpbench import roofline


def test_b1_work_from_shapes():
    flops, nbytes = roofline.covariance_work(50_512, 4_096, 8, torch.float32)
    assert flops == 2.0 * 50_512 * 4_096 * 8
    assert nbytes == 4 * ((50_512 + 4_096) * 8 + 50_512 * 4_096)
    # a tile this flat is bound by writing it
    assert roofline.bound_s(flops, nbytes, torch.float32) == nbytes / roofline.HBM_BYTES_PER_S


def test_b2_work_counts_the_downdate_once():
    """2 rows B j0 for the downdate, whatever the kernel does to form it (the
    3xTF32 kernel runs three products); the map adds 2 rows B d."""
    rows, block, j0, d = 50_256, 1_396, 50_256, 8
    flops, nbytes = roofline.panel_strip_work(rows, block, j0, d, torch.float32)
    assert flops == 2.0 * rows * block * j0 + 2.0 * rows * block * d
    assert nbytes == 4 * (rows * j0 + (rows + block) * d + rows * block)
    # the middle panel of 100,512 is compute bound at the TF32 peak: ~14.2 ms
    assert roofline.bound_s(flops, nbytes, torch.float32) == pytest.approx(flops / 495e12)


@pytest.mark.parametrize("widths", [[1_396] * 72, [512] * 196 + [160], [4_096] * 24 + [2_208]])
def test_b2_work_of_a_factorization_does_not_depend_on_the_panels(widths):
    """Summed over a streamed factorization of capacity C, the downdates come
    to about C^3 / 3 whichever panel widths the program picks."""
    cap = sum(widths)
    j0, total = 0, 0.0
    for b in widths:
        total += roofline.panel_strip_work(cap - j0, b, j0, 0, torch.float32)[0]
        j0 += b
    assert total == pytest.approx(cap ** 3 / 3, rel=0.05)


def test_float32_counts_at_the_tf32_peak():
    assert roofline.PEAK_FLOPS[torch.float32] == 495e12
    assert roofline.PEAK_FLOPS[torch.float64] == 67e12


def test_a_share_cannot_pass_100_for_float32_at_86_tflops():
    """B2's 3xTF32 product runs the middle panel's 7.05 TFLOP in 81.5 ms,
    86 TFLOP/s: past the CUDA cores' 67, so it must be counted at the TF32
    peak, where it reads 17 %."""
    flops = 7.05e12
    seconds = 81.5e-3
    share = roofline.share(roofline.bound_s(flops, 0, torch.float32), seconds)
    assert share == pytest.approx(100 * flops / 495e12 / seconds)
    assert 0 < share < 100
    assert 100 * flops / 67e12 / seconds > 100  # what counting at 67 would read


def test_share_is_silent_without_time():
    assert roofline.share(1.0, 0.0) is None
    assert roofline.share(0.0, 1.0) is None


def test_flow_counts():
    assert roofline.train_flops(100_000, 20_000, 11) == pytest.approx(
        12 * 20_000 ** 3 / 3 + 100_000 ** 3 / 3)
    assert roofline.train_flops(1_000, None, 5) == pytest.approx(1_000 ** 3 / 3)
    n = 50_000
    assert roofline.bo_step_flops(n, 4_096, 16) == n * n * 4_096 + 2 * n * 4_096 + n * n * 16
