"""Factor precision and storage on the card: speed against accuracy; the
twin of ``examples/precision_modes.py``.

On the card a float32 factorization runs its panel downdates through the
panel-strip kernel, whose instantiation follows the factor precision and
storage. This example trains the same GP under each and reports the
factorization's wall-clock and the prediction spread against "f32":

    "bf16"   one pass of bfloat16-rounded operands (the single-pass
             instantiation); torch's float32 matmuls at "medium"
    "f32x3"  the 3xTF32 product, near float32; torch at "highest"
    "f32"    the same as "f32x3" on this card (there is no slower exact
             float32 tensor-core mode to pick); torch at "highest"

and, beside them, bf16 factor STORAGE (the bfloat16-prefix
instantiation): half the factor's memory, float32 compute. Each mode
wraps the model's construction and use in ``config.matmul_precision`` and
sets the builder's ``set_factor_precision``:

    with config.matmul_precision("bf16"):
        gp = builder.set_factor_precision("bf16").train()
        mean = gp.predict(q)

On the CPU the plain versions run the same arithmetic, the "bf16" mode
rounding the operands as the card does.

Run: ``python -m friedrich_tpu_torch.examples.precision_modes [n]`` (the
card), or ``main(device="cpu")``.
"""

from __future__ import annotations

import contextlib
import sys

import numpy as np
import torch

from .. import GaussianProcess, config, kernels
from ..models.builder import _clock

#: (mode, storage) of each run; "f32" is the reference of the spread.
RUNS = (("bf16", None), ("f32x3", None), ("f32", None), (None, "bf16"))



def train_and_predict(x, y, q, mode=None, storage=None, device=None):
    """Train and predict, inside a precision scope when ``mode`` is given.

    ``storage="bf16"`` stores the Cholesky factor in bfloat16 (float32
    compute, rounded write-back): the MEMORY knob next to the precision
    knob, half the factor's bytes. Returns the predicted means and the
    seconds of one refactorization (``set_hyperparameters``)."""

    def run():
        gp = (
            GaussianProcess.builder(x, y, device=device)
            .set_kernel(kernels.SquaredExp(ls=0.5, ampl=1.0))
            .set_noise(0.1)
            .set_backend("streamed")
            .set_factor_storage(storage)
            .set_factor_precision(mode)
            .train()
        )
        t0 = _clock(gp.state.x.device)
        gp.set_hyperparameters(noise=0.1)  # one more factorization, timed
        dt = _clock(gp.state.x.device) - t0
        mean = np.asarray(gp.predict(q))
        return mean, dt

    with config.matmul_precision(mode) if mode else contextlib.nullcontext():
        return run()


def main(n: int = 8192, d: int = 8, m: int = 512, seed: int = 0, device=None) -> dict:
    """Each run of :data:`RUNS`; returns the means by label, as the JAX
    script does."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = np.sin(x.sum(axis=1)).astype(np.float32)
    q = rng.normal(size=(m, d)).astype(np.float32)

    dev = config.resolve_device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device={name} n={n} d={d}")

    results = {}
    for mode, storage in RUNS:
        mean, dt = train_and_predict(x, y, q, mode, storage, device)
        label = (mode or "default") + ("+bf16store" if storage else "")
        results[label] = mean
        print(f"{label:>22}: factor {dt:.3f}s")

    ref = results["f32"]
    for label, mean in results.items():
        spread = float(np.abs(mean - ref).max())
        print(f"{label:>22}: max |mean - mean_f32| = {spread:.3e}")
    return results


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 8192)
