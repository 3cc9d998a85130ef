"""Faults planted in the program, for reading what the comparison makes of
them: the CPU tests plant each under a tiny run (``correct`` must come out
false), and ``gpbench.control --fault <name>`` plants one under runs on the
card at a cell's own size, to read the upper end of a limit.

Each fault takes an object with ``setattr(target, name, value)``: pytest's
``monkeypatch``, or ``Patch`` for a process that ends with its runs. A
loop of ``gpbench/flows/`` brings its own faults as that file's ``FAULTS``
(a name to such a function); :func:`plant` finds a fault by name in either.
In a cell on several cards a fault is planted on every rank.
"""

from __future__ import annotations

import torch

import friedrich_tpu_torch.models.gp as core
from friedrich_tpu_torch.models.api import GaussianProcess
from friedrich_tpu_torch.models.builder import GaussianProcessBuilder


class Patch:
    """Plants a fault for the rest of the process."""

    @staticmethod
    def setattr(target, name, value) -> None:
        setattr(target, name, value)


def fit_unchanged(patch):
    """The fit returns its state unchanged."""
    patch.setattr(GaussianProcess, "fit_parameters", lambda self, *a, **k: None)


def half_the_data(patch):
    """The model is trained on half of its rows."""
    original = GaussianProcessBuilder.train

    def train(self):
        n = self._x.shape[0] // 2
        self._x, self._y = self._x[:n], self._y[:n]
        return original(self)

    patch.setattr(GaussianProcessBuilder, "train", train)


def append_unchanged(patch):
    """An append returns the model unchanged."""
    patch.setattr(GaussianProcess, "add_samples", lambda self, x, y: None)


def half_the_batch_appended(patch):
    original = GaussianProcess.add_samples
    patch.setattr(GaussianProcess, "add_samples",
                  lambda self, x, y: original(self, x[: len(x) // 2], y[: len(y) // 2]))


def wrong_y_appended(patch):
    """An append stores its rows with zeros for their outputs: the factor and
    the variances are right, the weights and the means are not."""
    original = GaussianProcess.add_samples
    patch.setattr(GaussianProcess, "add_samples",
                  lambda self, x, y: original(self, x, torch.zeros_like(y)))


def half_the_rows_answered(patch):
    """Half of a call's rows are answered, the rest given their mean."""
    original = core.predict_mean_variance

    def predict(state, xq, weights=None, block=None):
        m = xq.shape[0]
        if m < 2:
            return original(state, xq, weights, block)
        mean, var = original(state, xq[: m // 2], weights, block)
        fill = lambda t: torch.cat([t, t.mean().expand(m - m // 2)])  # noqa: E731
        return fill(mean), fill(var)

    patch.setattr(core, "predict_mean_variance", predict)


def answer_altered(patch):
    """The first answer (mean and variance) of every prediction is altered
    where it is made."""
    original = core.predict_mean_variance

    def predict(state, xq, weights=None, block=None):
        mean, var = original(state, xq, weights, block)
        bump = torch.nn.functional.one_hot(torch.tensor(0), mean.shape[0]).to(mean) * 0.05
        return mean + bump, var + bump

    patch.setattr(core, "predict_mean_variance", predict)


#: The faults each cell can have.
FAULTS = {
    "gp50k-train": [fit_unchanged, half_the_data, answer_altered],
    "gp100k-train": [fit_unchanged, half_the_data, answer_altered],
    "gp50k-bo": [append_unchanged, half_the_batch_appended, wrong_y_appended, answer_altered],
    "gp100k-serve": [half_the_rows_answered, answer_altered],
}

#: Every fault of this module, by name.
BY_NAME = {f.__name__: f for fs in FAULTS.values() for f in fs}


def plant(name: str, cell, patch) -> None:
    """Plants the fault ``name``: one of this module's, or of the ``FAULTS``
    of the flow file that ``cell``'s mix names."""
    fault = BY_NAME.get(name)
    if fault is None:
        from .loops import LOOPS, flow_module

        kind = cell.traffic["loop"]
        flows = {} if kind in LOOPS else getattr(flow_module(kind, cell.root), "FAULTS", {})
        fault = flows.get(name)
        if fault is None:
            raise ValueError(f"no fault {name!r} in gpbench/faults.py or the {kind!r} loop's "
                             "FAULTS")
    fault(patch)
