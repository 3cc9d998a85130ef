"""End-to-end usage demo — counterpart of ``friedrich_tpu/demo.py`` and of
the reference demo binary (``src/main.rs:12-69``): default GP, predict,
likelihood, add_samples + fit_parameters, multi-prediction, posterior
sampling, and a 2-D input case.

Run: ``python -m friedrich_tpu_torch.demo [cpu|cuda]``
"""

from __future__ import annotations

import sys

import torch

from . import GaussianProcess, enable_x64


def main(device=None, out=print) -> None:
    """Run the demo on ``device`` (default: the configured device), passing
    each line of output to ``out``."""
    enable_x64()

    # Trains a gaussian process on a dataset of one-dimension vectors.
    training_inputs = [[0.8], [1.2], [3.8], [4.2]]
    training_outputs = [3.0, 4.0, -2.0, -2.0]
    gp = GaussianProcess.default(training_inputs, training_outputs, device=device)

    # Predicts the mean and variance of a single point.
    mean = gp.predict([1.0])
    var = gp.predict_variance([1.0])
    out(f"prediction: {mean} ± {var ** 0.5}")

    # Computes the likelihood of the model.
    out(f"likelihood of the current model : {gp.likelihood()}")

    # Updates the model.
    gp.add_samples([[0.0], [1.0], [2.0], [5.0]], [2.0, 3.0, -1.0, -2.0])
    gp.fit_parameters(
        fit_prior=True, fit_kernel=True,
        max_iter=100, convergence_fraction=0.05, max_time=3600,
    )
    out("model is now updated.")

    # Makes several predictions.
    outputs = gp.predict([[1.0], [2.0], [3.0]])
    out(f"predictions: {outputs}")

    # Samples from the posterior distribution.
    sampler = gp.sample_at([[1.0], [2.0]])
    generator = torch.Generator().manual_seed(42)
    for i in range(1, 6):
        out(f"sample {i} : {sampler.sample(generator)}")

    # A 2-D input dataset.
    gp2 = GaussianProcess.default(
        [[0.8, 0.1], [1.2, 0.2], [3.8, 0.3], [4.2, 0.5]],
        [3.0, 4.0, -2.0, -2.0],
        device=device,
    )
    mean2 = gp2.predict([1.0, 0.4])
    var2 = gp2.predict_variance([1.0, 0.4])
    out(f"prediction: {mean2} ± {var2 ** 0.5}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
