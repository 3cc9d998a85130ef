"""Large-n hyperparameter fitting strategies on the port: the twin of
``examples/large_scale_fit.py``.

The reference's fit (``optimizer.rs:211-283``) pays a full O(n^3)
factorization per ADAM iteration. Three strategies apply at large n, on
the streamed backend (whose factorization runs the panel-strip kernel on
the card):

1. full fit, streamed Hutchinson gradients (``gradient="hutchinson"``,
   the automatic choice above capacity 8,192): reference semantics, every
   iteration still rebuilds at full n;
2. subsampled fit (``subsample=``): hyperparameters fitted on a random
   subset, then ONE full-n factorization;
3. the builder's sub-fit-first flow, which ``train()`` takes on its own
   above n = 24,576: the hyperparameters on a max(8,192, n / 5) subset,
   the prior on the full data, then exactly one full-n factorization at
   the fitted values.

Every float32 factorization runs the 3xTF32 panel product on the card,
near full float32; ``set_factor_precision("bf16")`` trades that for one
bfloat16 pass.

Run: ``python -m friedrich_tpu_torch.examples.large_scale_fit`` (the
card), or ``main(device="cpu")``; ``main(n=...)`` sets the size.
"""

from __future__ import annotations

import numpy as np

from .. import GaussianProcessBuilder, kernels
from ..utils.fitlog import FitLog

D = 4


def data(n: int):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, D)).astype(np.float32)
    y = (np.sin(2.0 * x[:, 0]) + 0.5 * np.cos(x[:, 1]) + 0.3 * rng.normal(size=n)).astype(np.float32)
    return rng, x, y


def _fitted(gp) -> dict:
    return {"lml": gp.log_marginal_likelihood(), "ls": float(gp.kernel.get_params()[0]),
            "noise": gp.noise}


def main(n: int = 3000, device=None) -> dict:
    """The script's three fits at ``n`` points; returns the numbers it
    prints: each fit's LML, lengthscale and noise, the initial LML, the
    subsampled fit's iterations and the first model's 5 predictions."""
    rng, x, y = data(n)
    out = {}

    gp = (
        GaussianProcessBuilder(x, y, device=device)
        .set_kernel(kernels.SquaredExp(ls=2.0, ampl=1.0))
        .set_noise(0.3)
        .set_dtype("float32")
        .set_backend("streamed")
        # .set_factor_precision("f32"): on the card "f32" runs what the
        # default runs, the 3xTF32 product with float32 matmuls at torch's
        # "highest" precision, never plain TF32
        .train()
    )
    out["lml_initial"] = gp.log_marginal_likelihood()
    print(f"initial LML: {out['lml_initial']:.1f}")

    # strategy 2: subsampled fit: O(s^3) iterations and one full rebuild
    log = FitLog()
    gp.fit_parameters(fit_prior=True, fit_kernel=True, max_iter=40, subsample=1000, fit_log=log)
    out["subsampled"] = dict(_fitted(gp), iterations=len(log.records))
    print(f"subsampled fit: {len(log.records)} iterations, "
          f"LML now {out['subsampled']['lml']:.1f}, "
          f"ls={out['subsampled']['ls']:.3f}, noise={gp.noise:.3f}")

    # strategy 1: full streamed-Hutchinson fit (reference iteration shape)
    gp2 = (
        GaussianProcessBuilder(x, y, device=device)
        .set_kernel(kernels.SquaredExp(ls=2.0, ampl=1.0))
        .set_noise(0.3)
        .set_dtype("float32")
        .set_backend("streamed")
        .train()
    )
    gp2.fit_parameters(fit_prior=True, fit_kernel=True, max_iter=40, gradient="hutchinson")
    out["hutchinson"] = _fitted(gp2)
    print(f"full Hutchinson fit: LML {out['hutchinson']['lml']:.1f}, "
          f"ls={out['hutchinson']['ls']:.3f}, noise={gp2.noise:.3f}")
    del gp2

    # both models predict through the cached-weights path
    xq = rng.normal(size=(5, D)).astype(np.float32)
    out["predictions"] = np.asarray(gp.predict(xq))
    print("predictions:", np.round(out["predictions"], 3))
    del gp

    # strategy 3, automatic above n = 24,576 (sub-fit-first)
    gp3 = (
        GaussianProcessBuilder(x, y, device=device)
        .set_noise(0.3)
        .set_dtype("float32")
        .set_backend("streamed")
        # .set_fit_subsample(None)       # opt out: the reference's full fit
        .fit_kernel()
        .fit_prior()
        .train()
    )
    out["auto"] = _fitted(gp3)
    print(f"builder auto policy: LML {out['auto']['lml']:.1f} "
          f"({'sub-fit-first' if n > 24_576 else 'full fit'} at this n; sub-fit-first above n=24,576)")
    return out


if __name__ == "__main__":
    main()
