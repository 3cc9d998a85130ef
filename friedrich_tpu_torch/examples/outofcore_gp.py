"""Out-of-core exact GP on the port: one card, a factor bigger than its
memory; the twin of ``examples/outofcore_gp.py``.

``OutOfCoreGP`` keeps the (n, n) Cholesky factor in host memory
(page-locked on the card's machine) and streams column panels to the card,
so the exact-GP size ceiling of one card becomes the host's memory. The
card holds one working strip and one column chunk at a time; each chunk's
downdate is the panel-strip kernel's explicit-prefix entry.

What each call moves over the host link:

- training factorization: about n^3 * 2 / B factor bytes for panels of B;
- FIRST predict: two streamed sweeps to cache beta and alpha (2 n^2
  factor elements);
- every further MEAN-ONLY predict: no factor traffic, one covariance
  strip and a product against the cached K^-1 r;
- mean and variance: one streamed sweep per batch (n^2 elements).

Run: ``python -m friedrich_tpu_torch.examples.outofcore_gp [n]`` (the
card), or ``main(device="cpu")``, where the factor stays where it is
computed.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from .. import kernels, priors
from ..models import OutOfCoreGP
from ..models.builder import _clock



def main(n: int = 4096, d: int = 6, m: int = 512, seed: int = 0, device=None) -> dict:
    """The script's flow; returns the numbers it prints (seconds of each
    step, the means and variances of the ``m`` queries, the LML, the count
    after the append)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = np.sin(x.sum(axis=1)).astype(np.float32)
    xq = rng.normal(size=(m, d)).astype(np.float32)
    out = {}

    t0 = time.perf_counter()
    gp = OutOfCoreGP(
        kernels.SquaredExp(ls=1.0, ampl=1.0),
        priors.ZeroPrior(),
        noise=0.5,
        x=x,
        y=y,
        block=min(4096, n // 4),
        device=device,
    )
    dev = gp.device
    out["factor_s"] = _clock(dev) - t0
    host_gb = gp.l_host.numel() * gp.l_host.element_size() / 1e9
    print(f"factor (host memory, {host_gb:.2f} GB): {out['factor_s']:.2f}s")

    t0 = _clock(dev)
    mean = gp.predict(xq).cpu().numpy()  # caches beta/alpha (two sweeps)
    out["first_predict_s"] = _clock(dev) - t0
    print(f"first predict (derives weights): {out['first_predict_s']:.2f}s")

    t0 = _clock(dev)
    mean2 = gp.predict(xq).cpu().numpy()  # sweep-free: L never touched
    out["mean_only_predict_s"] = _clock(dev) - t0
    print(f"steady-state mean-only predict:  {out['mean_only_predict_s']:.2f}s")
    assert np.allclose(mean, mean2)

    t0 = _clock(dev)
    m_v, v_v = gp.predict_mean_variance(xq)  # one streamed sweep
    out["mean_variance_s"] = _clock(dev) - t0
    out["mean"], out["var"] = m_v.cpu().numpy(), v_v.cpu().numpy()
    print(f"mean+variance (1 streamed sweep): {out['mean_variance_s']:.2f}s")
    print(f"mean[:3]={out['mean'][:3].round(3)} var[:3]={out['var'][:3].round(3)}")
    out["lml"] = gp.log_marginal_likelihood()
    print(f"log marginal likelihood: {out['lml']:.2f}")

    # incremental data: rebuilds (an out-of-core rank update would stream
    # the whole factor anyway)
    x2 = rng.normal(size=(64, d)).astype(np.float32)
    y2 = np.sin(x2.sum(axis=1)).astype(np.float32)
    t0 = _clock(dev)
    gp.add_samples(x2, y2)
    out["add_samples_s"] = _clock(dev) - t0
    out["n"] = gp.n
    print(f"add_samples (rebuild): {out['add_samples_s']:.2f}s, n={gp.n}")
    return out


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 4096)
