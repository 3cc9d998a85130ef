"""A multi-rank loop for the tests, copied into a scratch tree as
``gpbench/flows/tiny_world.py``: a ``LargeScaleGP`` trained over the world
in set-up at the configuration's ``n``, then ``rows`` query rows predicted
back to back in the window. The mix's ``fail`` (``"setup"`` or
``"window"``) makes rank ``fail_rank`` raise in set-up or hang in the
window."""

import sys
import time

import numpy as np
import torch

from gpbench.loops import Loop, ModelOutputs, Outcome, fitted_params


class TinyWorld(Loop):
    def setup(self) -> None:
        from friedrich_tpu_torch import kernels, priors
        from friedrich_tpu_torch.parallel import LargeScaleGP, make_matrix_mesh, multihost

        multihost.initialize(device=self.run.device)
        self.fail("setup")
        if "peak_bytes" in self.mix:  # a peak of the mix's on each rank's (CPU) card
            from gpbench import harness

            harness.peak_bytes = lambda device: int(self.mix["peak_bytes"][self.run.rank])
        self.x, self.y = self.data(0)
        self.xq = self.queries(int(self.mix["rows"]))
        self.model = LargeScaleGP(make_matrix_mesh(), kernels.SquaredExp(ls=1.2, ampl=1.5),
                                  priors.ConstantPrior(c=torch.mean(self.y)),
                                  float(self.cfg["noise"]), self.x, self.y)
        self.model.predict_mean_variance(self.xq)

    def fail(self, where: str) -> None:
        if self.mix.get("fail") != where or self.run.rank != int(self.mix["fail_rank"]):
            return
        if where == "setup":
            raise RuntimeError(f"rank {self.run.rank} fails in set-up, as the mix asks")
        print(f"rank {self.run.rank} hangs in the window, as the mix asks", file=sys.stderr,
              flush=True)
        while True:
            time.sleep(1.0)

    def window(self, seconds: float, rate: float | None = None) -> Outcome:
        """Predictions back to back (``rate`` is the sweep's and ignored);
        ``latency`` and ``due`` are each prediction's, as the sweep reads."""
        run = self.run
        count, due, done = 0, [], []
        t0 = time.perf_counter()
        while run.agree(count == 0 or time.perf_counter() < t0 + seconds):
            self.fail("window")
            due.append(time.perf_counter())
            with torch.profiler.record_function("gpbench/predict"):
                self.mean, self.var = self.model.predict_mean_variance(self.xq)
            done.append(time.perf_counter())
            count += 1
        run.sync()
        run.window_s = time.perf_counter() - t0
        self.due, self.latency = np.array(due), np.array(done) - np.array(due)
        return Outcome({"predict_s": run.window_s / count}, count, 0,
                       [f"tiny_world: {count} predictions on rank {run.rank} of {run.world}"])

    def counters(self) -> dict:
        from friedrich_tpu_torch.parallel import mesh

        return {"collectives": sum(mesh.COLLECTIVES.values())}

    def outputs(self) -> ModelOutputs:
        program = {"mean": self.mean.cpu(), "var": self.var.cpu()}
        return ModelOutputs(self.run, self.x, self.y, self.x.shape[0], fitted_params(self.model),
                            [(self.x.shape[0], self.xq)], program)

    def release(self) -> None:
        self.model = None


LOOP = TinyWorld


def answers_altered(patch):
    """Every answer of every rank, mean and variance, moved by 0.05."""
    from friedrich_tpu_torch.parallel import LargeScaleGP

    original = LargeScaleGP.predict_mean_variance

    def predict(self, xq, block=None):
        mean, var = original(self, xq, block)
        return mean + 0.05, var + 0.05

    patch.setattr(LargeScaleGP, "predict_mean_variance", predict)


FAULTS = {"answers_altered": answers_altered}
