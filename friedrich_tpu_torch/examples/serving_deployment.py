"""Model serving on the port: the twin of ``examples/serving_deployment.py``.

Export a trained GP and query it over the wire. Two deployment modes share
one length-prefixed binary protocol (the JAX package's, so either
package's client talks to either package's server):

1. ``GPServer``: the native C++ daemon (``native/friedrich_served.cpp``,
   built by ``native.build``) loads an exported ``.frsv`` bundle (factor,
   residual weights, kernel and prior spec) and answers posterior mean and
   variance queries with float64 triangular solves on the CPU: no Python,
   no PyTorch and no card at serve time.

2. ``AcceleratedGPServer``: serves the live model on the card it lives on,
   over the same protocol, each merged batch solved 256 columns at a time
   so that a reply equals the in-process prediction of its rows at that
   width. It serves a ``GaussianProcess`` and, rank 0 serving while every
   other rank runs ``serving.follow``, a ``LargeScaleGP`` spread over the
   ranks of a ``torch.distributed`` world (here a world of one, or the one
   the environment names).

``GPClient`` talks to either. The models are float64, so that the daemon's
float64 solves agree with the in-process ones to rounding.

Run: ``python -m friedrich_tpu_torch.examples.serving_deployment`` (the
card), or ``main(device="cpu")``.
"""

from __future__ import annotations

import tempfile
from pathlib import Path

import numpy as np
import torch

from .. import GaussianProcess, kernels, priors, serving
from ..parallel import LargeScaleGP
from ..parallel.multihost import joined


def main(n: int = 200, d: int = 3, seed: int = 0, device=None):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    y = np.sin(x[:, 0]) + 0.1 * rng.normal(size=n)

    gp = GaussianProcess.new(
        priors.ConstantPrior.default(1),
        kernels.Matern2(ls=1.0, ampl=1.0),
        0.2,
        None,
        x,
        y,
        dtype=torch.float64,
        device=device,
    )
    xq = rng.normal(size=(16, d))
    want = np.asarray(gp.predict(xq))

    # --- mode 1: standalone C++ daemon from an exported bundle ---------
    with tempfile.TemporaryDirectory() as tmp:
        bundle = Path(tmp) / "model.frsv"
        serving.export_bundle(gp, bundle)
        print(f"bundle: {bundle.stat().st_size / 1024:.1f} KiB")
        with serving.GPServer(bundle) as srv:
            with serving.GPClient(port=srv.port) as client:
                mean, var = client.predict_mean_variance(xq)
        print(f"C++ daemon:  max |served - in-process| = {np.abs(mean - want).max():.2e}")

    # --- mode 2: the card-backed server, same client ---------------------
    with serving.AcceleratedGPServer(gp) as srv:
        with serving.GPClient(port=srv.port) as client:
            mean2, var2 = client.predict_mean_variance(xq)
    print(f"accelerated: max |served - in-process| = {np.abs(mean2 - want).max():.2e}")

    # --- mode 2 over a LargeScaleGP: rank 0 serves, the other ranks follow
    with joined(device) as mesh:
        lgp = LargeScaleGP(mesh, kernels.Matern2(ls=1.0, ampl=1.0), priors.ConstantPrior.default(1),
                           0.2, torch.as_tensor(x, device=mesh.device),
                           torch.as_tensor(y, device=mesh.device))
        if mesh.rank == 0:
            with serving.AcceleratedGPServer(lgp) as srv:
                with serving.GPClient(port=srv.port) as client:
                    mean3, _ = client.predict_mean_variance(xq)
            print(f"LargeScaleGP ({mesh.size} rank{'s' if mesh.size > 1 else ''}): "
                  f"max |served - in-process| = {np.abs(mean3 - want).max():.2e}")
        else:
            serving.follow(lgp)
    return mean, mean2


if __name__ == "__main__":
    main()
