"""Inputs of every cell, made from the run's seed.

The data recipe is a copy of ``bench.py:99-107``: inputs x ~ N(0, I_d) and
outputs y = sin(2.5 x_0) + 0.5 cos(2 x_1) + N(0, 1). Training data is drawn
on the device with a ``torch.Generator`` there, in two large calls; host-side
draws (query rows, arrivals, objective noise) use numpy. Every stream of
random numbers of a run is named, so that the same seed gives the same
inputs whatever else the run draws.
"""

from __future__ import annotations

import numpy as np
import torch

STREAMS = {"train": 1, "queries": 2, "candidates": 3, "objective": 4, "schedule": 5,
           "check": 6}


def substream(seed: int, stream: str, index: int = 0) -> int:
    """A 63-bit seed for stream ``stream`` (and its ``index``-th draw) of
    the run seeded ``seed``; any whole number is a seed."""
    words = [abs(int(seed)) & (2**64 - 1), abs(int(seed)) >> 64, int(seed < 0),
             STREAMS[stream], int(index)]
    return int(np.random.SeedSequence(words).generate_state(1, dtype=np.uint64)[0] >> 1)


def device_generator(seed: int, stream: str, device, index: int = 0) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(substream(seed, stream, index))
    return gen


def host_rng(seed: int, stream: str, index: int = 0) -> np.random.Generator:
    return np.random.default_rng(substream(seed, stream, index))


def objective(x: torch.Tensor) -> torch.Tensor:
    """The recipe's noise-free function of the inputs."""
    return torch.sin(2.5 * x[:, 0]) + 0.5 * torch.cos(2.0 * x[:, 1])


def training_data(seed: int, n: int, d: int, dtype: torch.dtype, device,
                  index: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """``n`` points of the recipe on ``device``: the ``index``-th data set
    of the run."""
    gen = device_generator(seed, "train", device, index)
    x = torch.randn((n, d), generator=gen, dtype=dtype, device=device)
    y = objective(x) + torch.randn((n,), generator=gen, dtype=dtype, device=device)
    return x, y


def objective_values(seed: int, x: np.ndarray, index: int) -> np.ndarray:
    """The recipe's noisy objective at host rows ``x`` (float64): what a
    Bayesian-optimization step evaluates for its ``index``-th batch."""
    noise = host_rng(seed, "objective", index).normal(size=x.shape[0])
    return np.sin(2.5 * x[:, 0]) + 0.5 * np.cos(2.0 * x[:, 1]) + noise
