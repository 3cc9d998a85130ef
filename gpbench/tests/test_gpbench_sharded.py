"""The reference with its factor in row blocks over the ranks
(``gpbench/reference/sharded.py``) against the one-card reference
(``gpbench/reference/gp.py``), on worlds of CPU ranks over gloo.

Tolerance: 1e-4, absolute, on factor entries, means and latent variances.
The two compute the same float32 quantities; only the order of the sums
differs (matmuls over the rank's rows only, a blocked forward solve in place
of one triangular solve). Reordering a float32 sum of n terms of size about
1 changes it by at most about n u, with u = 6e-8: 9e-5 at n = 1,501. What
they hold is well conditioned (ls 1.2, ampl 1.5, noise 0.5), so nothing
amplifies it; they read 2e-7 (factor) and 2e-6 (means) apart.
"""

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from gpbench.reference import gp as ref, sharded

TOL = 1e-4
LS, AMPL, NOISE = 1.2, 1.5, 0.5


def problem(n: int):
    gen = torch.Generator().manual_seed(n)
    x = torch.randn((n, 8), generator=gen)
    y = torch.sin(2.5 * x[:, 0]) + 0.5 * torch.cos(2.0 * x[:, 1]) + torch.randn((n,), generator=gen)
    return x, y, torch.randn((300, 8), generator=gen)


def answers(n: int, live: int, tf32: bool):
    x, y, q = problem(n)
    prior = float(torch.mean(y.double()))
    factor = sharded.cholesky(x, LS, AMPL, NOISE, tf32)
    return factor, [sharded.predict(factor, x, y - prior, prior, LS, AMPL, q, tf32, rows)
                    for rows in (n, live)]


def rank_main(rank: int, size: int, store: str, out: str, n: int, live: int, tf32: bool) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=size, rank=rank)
    try:
        factor, moments = answers(n, live, tf32)
        torch.save({"block": factor.block, "rows": factor.rows, "moments": moments},
                   f"{out}/{rank}.pt")
    finally:
        dist.destroy_process_group()


def world(tmp_path, size: int, n: int, live: int, tf32: bool = False) -> list:
    mp.spawn(rank_main, args=(size, str(tmp_path / "store"), str(tmp_path), n, live, tf32),
             nprocs=size)
    return [torch.load(tmp_path / f"{r}.pt") for r in range(size)]


def one_card(n: int, live: int, tf32: bool = False):
    x, y, q = problem(n)
    prior = float(torch.mean(y.double()))
    factor = ref.cholesky(x, LS, AMPL, NOISE, tf32)
    lead = factor[:live, :live].contiguous()
    return factor, [ref.predict(factor, x, y - prior, prior, LS, AMPL, q, tf32),
                    ref.predict(lead, x[:live], (y - prior)[:live], prior, LS, AMPL, q, tf32)]


def close(a, b) -> bool:
    return bool(torch.max(torch.abs(a.double() - b.double())) <= TOL)


@pytest.mark.parametrize("size,n,live", [(1, 1024, 700), (2, 1024, 700), (4, 1501, 1100),
                                         (4, 2100, 300)])
def test_the_sharded_reference_agrees_with_one_card(tmp_path, size, n, live):
    """Uneven row blocks (1,501 and 2,100 over 4), a panel split between
    two ranks (2,048 at 2,100 over 4), and the leading block of the factor
    (``live``, the BO loop's earlier steps)."""
    torch.set_num_threads(4)
    factor, truth = one_card(n, live)
    parts = world(tmp_path, size, n, live)
    assert [p["rows"] for p in parts] == sharded.bounds(n, size)
    for part in parts:
        r0, r1 = part["rows"]
        assert close(part["block"], factor[r0:r1])
        assert torch.equal(part["moments"][0][0], parts[0]["moments"][0][0])  # alike on every rank
        for (mean, var), (mean1, var1) in zip(part["moments"], truth):
            assert close(mean, mean1) and close(var, var1)


def test_the_sharded_control_departs_from_float32(tmp_path):
    """The control in TF32 departs from the float32 reference by far more
    than the tolerance, as the one-card control does."""
    parts = world(tmp_path, 2, 1024, 700, tf32=True)
    _, truth = one_card(1024, 700)
    _, control = one_card(1024, 700, tf32=True)
    sharded_gap = float(torch.max(torch.abs(parts[0]["moments"][0][1] - truth[0][1])))
    one_card_gap = float(torch.max(torch.abs(control[0][1] - truth[0][1])))
    assert sharded_gap > 10 * TOL and one_card_gap > 10 * TOL
