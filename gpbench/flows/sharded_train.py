"""The ``sharded_train`` loop: ``train()`` back to back over the ranks of a
process group, as ``loops.TrainLoop`` runs it on one card.

Every rank draws the same data set on its own card and calls the builder
with the configuration's settings, ``set_backend("sharded")`` among them:
the sub-fit runs whole on each card, then the build shards the factor over
the ranks (``parallel.LargeScaleGP``). The data sets cycle through the mix's
``datasets`` drawn from its ``data_seed``, in an order drawn from the run's
seed; the previous model is dropped before the next build. Rank 0 decides
whether the window goes on (``run.agree``).

``outputs()``: the last model's answers at 512 query rows, which the check
works out again with the sharded reference over the same ranks.

The cell runs on W > 1 cards, in the process group the benchmark makes
(``gpbench/world.py``); the loop reads the program's counters of the
collectives' bytes and of B2's launches by shape.
"""

from __future__ import annotations

import time

import torch

from gpbench import faults
from gpbench.loops import Outcome, TrainLoop, fitted_params, train_model


class ShardedTrain(TrainLoop):
    def setup(self) -> None:
        from friedrich_tpu_torch.parallel import multihost

        multihost.initialize(device=self.run.device)
        super().setup()

    def window(self, seconds: float) -> Outcome:
        """``TrainLoop.window`` but for two lines, which it cannot take as
        they are: every rank goes on while rank 0's clock says so
        (``run.agree``; on their own clocks the ranks would part on the last
        model and wait in each other's collectives), and only a failed
        factorization, which every rank sees alike, is counted and passed
        over (any other error may be one rank's, and ends the run)."""
        from friedrich_tpu_torch.utils.errors import CholeskyError

        run = self.run
        count = failed = 0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while run.agree(count + failed == 0 or time.perf_counter() < deadline):
            x, y = self.dataset(self.index)
            self.index += 1
            self.model = None  # the previous model's factor is freed before the next build
            try:
                with torch.profiler.record_function("gpbench/train"):
                    self.model, timings = train_model(run, x, y)
            except CholeskyError as e:
                failed += 1
                self.errors.append(repr(e))
                if failed > 3:
                    raise RuntimeError(f"train() failed {failed} times") from e
                continue
            self.x, self.y = x, y
            run.timings.append(timings)
            count += 1
        run.window_s = time.perf_counter() - t0
        last = run.timings[-1] if run.timings else {}
        ls, ampl, noise = fitted_params(self.model) if self.model is not None else (0.0,) * 3
        return Outcome({"train_s": run.window_s / max(count, 1)}, count + failed, failed,
                       [f"sharded_train: rank {run.rank} of {run.world}: {count} models in "
                        f"{run.window_s!r} s; the last, compared: sub-fit iterations "
                        f"{last.get('subfit_iterations')}, ls {ls!r}, ampl {ampl!r}, "
                        f"noise {noise!r}", *self.errors])

    def counters(self) -> dict:
        from friedrich_tpu_torch.ops.cuda import panel_strip_cuda
        from friedrich_tpu_torch.parallel import mesh

        return {"collective_bytes": dict(mesh.COLLECTIVE_BYTES),
                "b2_by_shape": dict(panel_strip_cuda.LAUNCHES_BY_SHAPE)}


LOOP = ShardedTrain


def answers_altered(patch):
    """Every answer of every rank, mean and variance, moved by 0.05 (the
    one-card ``answer_altered`` of ``gpbench/faults.py`` alters the one-card
    model's predictions, which this loop does not make)."""
    from friedrich_tpu_torch.parallel import LargeScaleGP

    original = LargeScaleGP.predict_mean_variance

    def predict(self, xq, block=None):
        mean, var = original(self, xq, block)
        return mean + 0.05, var + 0.05

    patch.setattr(LargeScaleGP, "predict_mean_variance", predict)


#: ``half_the_data`` is ``gpbench/faults.py``'s, which the builder's
#: sharded path takes as it is: the build over half of the data set.
FAULTS = {"answers_altered": answers_altered, "half_the_data": faults.half_the_data}
