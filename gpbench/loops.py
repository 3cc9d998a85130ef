"""The one general generator of work: a traffic mix's ``"loop"`` names one
of these loops, or a file ``gpbench/flows/<loop>.py`` whose ``LOOP`` is a
subclass of :class:`Loop`, and its other keys are the loop's parameters.

- ``train``: closed loop, ``train()`` back to back, the previous model
  dropped first, as a user retraining does. The models cycle through
  ``datasets`` data sets drawn from the mix's ``data_seed``, in an order
  drawn from the run's seed: the fit's iterations differ from data set to
  data set, and with a fresh data set per model the seed moved ``train_s``
  six times as much as a second run of one seed did.
- ``bo``: closed loop, one client: each step predicts ``candidates``
  points drawn N(0, I), takes the ``batch`` of highest expected improvement,
  evaluates the recipe's objective for them on the host and appends them.
- ``serve``: open loop: ``AcceleratedGPServer`` over a model trained in
  set-up, ``clients`` connections, requests due at ``rate_per_s`` with
  exponential gaps and rows log-uniform on [``rows_min``, ``rows_max``].
  The arrivals and sizes are one draw, the mix's ``trace_seed``, replayed
  in every run: the run's seed draws the query rows (drawn from the run's
  seed, the order of a burst of large requests moved the 95th percentile
  by a quarter from seed to seed). Each request is timed from when it was
  due.

Every loop hands ``outputs()`` to ``gpbench/check.py``: the program's
answers and what the reference needs to work them out again.

In a cell on W > 1 cards the loop runs on every rank (``run.rank`` of
``run.world``, on ``run.device``), set-up, window and outputs alike: rank 0
measures and the others follow (``run.agree``). The reference then holds its
factor in row blocks over the ranks (``gpbench/reference/sharded.py``).
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time

import numpy as np
import torch

from . import data, harness
from .reference import gp as ref, sharded

QUERIES = 512
FIT_CHECK_POINTS = 10_000


@dataclasses.dataclass
class Outcome:
    metrics: dict
    attempted: int
    failed: int
    notes: list


def make_loop(run):
    kind = run.traffic["loop"]
    return LOOPS[kind](run) if kind in LOOPS else flow_module(kind, run.root).LOOP(run)


def flow_module(kind: str, root=harness.ROOT):
    """The module of ``gpbench/flows/<kind>.py``, whose ``LOOP`` is a
    subclass of :class:`Loop` (and whose optional ``FAULTS`` maps a name to
    a fault of ``gpbench/faults.py``'s form)."""
    path = root / "gpbench" / "flows" / f"{kind}.py"
    if not harness.NAME.match(kind) or not path.exists():
        raise ValueError(f"unknown loop {kind!r}: built in are {sorted(LOOPS)}, and there is "
                         f"no {path}")
    module = harness.load_module(path, "flow")
    loop = getattr(module, "LOOP", None)
    if not (isinstance(loop, type) and issubclass(loop, Loop)):
        raise ValueError(f"{path} defines no LOOP, a subclass of gpbench.loops.Loop")
    return module


def train_model(run, x, y):
    """The user's normal path: the builder with the configuration's
    settings, the default kernel, prior, sub-fit and fit settings.
    Returns the model and ``builder.timings``, with the sub-fit's size as
    the builder resolved it (``subfit_points``, None where it has no such
    rule) where a sub-fit ran."""
    from friedrich_tpu_torch import GaussianProcess

    cfg = run.config
    builder = (GaussianProcess.builder(x, y, device=run.device)
               .set_noise(cfg["noise"]).set_dtype(cfg["dtype"]).set_backend(cfg["backend"])
               .set_capacity(cfg["capacity"]).fit_kernel().fit_prior())
    model = builder.train()
    timings = dict(builder.timings)
    if "subfit" in timings:
        # a private method of the program: where a later program drops it,
        # mfu.train goes silent rather than the run failing
        resolve = getattr(builder, "_resolved_subsample", None)
        timings["subfit_points"] = resolve(x.shape[0]) if resolve else None
    return model, timings


def fitted_params(model) -> tuple[float, float, float]:
    kernel = model.kernel
    return float(kernel.ls), float(kernel.ampl), float(model.noise)


def expected_improvement(mean: torch.Tensor, var: torch.Tensor, best: float,
                         xi: float) -> torch.Tensor:
    """Expected improvement over ``best`` for maximization (a copy of the
    acquisition of ``examples/bayesian_optimization.py``)."""
    std = torch.sqrt(torch.clamp(var, min=1e-12))
    z = (mean - best - xi) / std
    pdf = torch.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)
    return (mean - best - xi) * torch.special.ndtr(z) + std * pdf


def check_sample(seed: int, count: int, size: int, must: list) -> list:
    """``size`` indices of ``range(count)`` drawn from the seed, with the
    indices ``must`` among them, sorted."""
    rng = data.host_rng(seed, "check")
    pool = [i for i in range(count) if i not in set(must)]
    pick = rng.choice(len(pool), size=min(max(size - len(must), 0), len(pool)), replace=False)
    return sorted(set(must) | {pool[i] for i in pick})


class ModelOutputs:
    """The answers of a model over rows ``x`` with outputs ``y``, and their
    reference: the program's means and variances at each query set
    ``(live, queries)``, answered by the model over the first ``live``
    rows."""

    def __init__(self, run, x, y, prior_rows: int, params, query_sets, program,
                 fit_start: bool = False):
        self.run, self.x, self.y = run, x, y
        self.prior = float(torch.mean(y[:prior_rows].double()))
        self.params = params
        self.query_sets = query_sets
        self.program = program
        self.fit_start = fit_start
        self.truth = None

    def reference(self, tf32: bool) -> dict:
        if self.run.world > 1:
            return self.sharded_reference(tf32)
        ls, ampl, noise = self.params
        resid = self.y - self.prior
        factor = ref.cholesky(self.x, ls, ampl, noise, tf32)
        means, variances = [], []
        for live, queries in self.query_sets:
            lead = factor if live == self.x.shape[0] else factor[:live, :live].contiguous()
            mean, var = ref.predict(lead, self.x[:live], resid[:live], self.prior, ls, ampl,
                                    queries, tf32)
            del lead
            means.append(mean)
            variances.append(var)
        del factor
        _free(self.run)
        return {"mean": torch.cat(means), "var": torch.cat(variances)}

    def sharded_reference(self, tf32: bool) -> dict:
        """The same answers on every rank together, the factor in row
        blocks over the ranks."""
        ls, ampl, noise = self.params
        resid = self.y - self.prior
        factor = sharded.cholesky(self.x, ls, ampl, noise, tf32)
        answers = [sharded.predict(factor, self.x, resid, self.prior, ls, ampl, queries, tf32, live)
                   for live, queries in self.query_sets]
        del factor
        _free(self.run)
        return {"mean": torch.cat([m for m, _ in answers]),
                "var": torch.cat([v for _, v in answers])}

    def extra(self) -> dict:
        """``fit_gain``, where the loop judges a fit: the reference's log
        marginal likelihood per point at the fitted hyperparameters less that
        at the fit's start (the heuristic kernel and the configuration's
        noise), on ``FIT_CHECK_POINTS`` rows drawn from the seed, on one card
        (rank 0's)."""
        if not self.fit_start or self.run.rank != 0:
            return {}
        n = self.x.shape[0]
        m = min(n, FIT_CHECK_POINTS)
        idx = torch.as_tensor(np.sort(data.host_rng(self.run.seed, "check", 1).choice(
            n, size=m, replace=False)), device=self.x.device)
        xs, rs = self.x[idx], self.y[idx] - self.prior
        ls0, ampl0 = ref.heuristic_start(self.x, self.y)
        per_point = []
        for ls, ampl, noise in (self.params, (ls0, ampl0, float(self.run.config["noise"]))):
            factor = ref.cholesky(xs, ls, ampl, noise)
            per_point.append(ref.log_marginal_likelihood(factor, rs) / m)
            del factor
        return {"fit_gain": per_point[0] - per_point[1]}


def _free(run) -> None:
    if run.device.type == "cuda":
        torch.cuda.empty_cache()


class Loop:
    def __init__(self, run):
        self.run = run
        self.cfg = run.config
        self.mix = run.traffic

    def data(self, index: int):
        return data.training_data(self.run.seed, self.cfg["n"], self.cfg["d"], self.run.dtype,
                                  self.run.device, index)

    def queries(self, count: int = QUERIES) -> torch.Tensor:
        gen = data.device_generator(self.run.seed, "queries", self.run.device)
        return torch.randn((count, self.cfg["d"]), generator=gen, dtype=self.run.dtype,
                           device=self.run.device)

    def counters(self) -> dict:
        return {}


class TrainLoop(Loop):
    def setup(self) -> None:
        pool = int(self.mix["datasets"])
        self.order = data.host_rng(self.run.seed, "train").permutation(pool)
        x, y = self.dataset(0)
        model, _ = train_model(self.run, x, y)  # warm-up on the cycle's first data set
        del model
        self.index, self.model, self.errors = 1, None, []

    def dataset(self, i: int):
        element = int(self.order[i % len(self.order)])
        return data.training_data(int(self.mix["data_seed"]), self.cfg["n"], self.cfg["d"],
                                  self.run.dtype, self.run.device, element)

    def window(self, seconds: float) -> Outcome:
        run = self.run
        count = failed = 0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while count + failed == 0 or time.perf_counter() < deadline:
            x, y = self.dataset(self.index)
            self.index += 1
            self.model = None  # the previous model's factor is freed before the next build
            try:
                with torch.profiler.record_function("gpbench/train"):
                    self.model, timings = train_model(run, x, y)
            except Exception as e:  # noqa: BLE001 — a failed model is counted
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
                       [f"train: {count} models in {run.window_s!r} s; the last, compared: "
                        f"sub-fit iterations {last.get('subfit_iterations')}, "
                        f"ls {ls!r}, ampl {ampl!r}, noise {noise!r}", *self.errors])

    def outputs(self) -> ModelOutputs:
        model, queries = self.model, self.queries()
        mean, var = model.predict_mean_variance(queries)
        program = {"mean": mean.cpu(), "var": var.cpu()}
        return ModelOutputs(self.run, self.x, self.y, self.x.shape[0], fitted_params(model),
                            [(self.x.shape[0], queries)], program, fit_start=True)

    def release(self) -> None:
        self.model = None


class BOLoop(Loop):
    def setup(self) -> None:
        self.x0, self.y0 = self.data(0)
        self.model, _ = train_model(self.run, self.x0, self.y0)
        self.best = float(torch.max(self.y0))
        self.new_x, self.new_y, self.log = [], [], []
        self.k = 0
        for _ in range(int(self.mix["warmup_steps"])):
            self.step()
        self.first = len(self.log)

    def step(self) -> None:
        run, model, mix = self.run, self.model, self.mix
        gen = data.device_generator(run.seed, "candidates", run.device, self.k)
        cand = torch.randn((int(mix["candidates"]), self.cfg["d"]), generator=gen,
                           dtype=run.dtype, device=run.device)
        live = model.num_samples
        t0 = time.perf_counter()
        mean, var = model.predict_mean_variance(cand)
        if run.traced:
            run.sync()
            run.span("predict", time.perf_counter() - t0)
        top = torch.topk(expected_improvement(mean, var, self.best, float(mix["xi"])),
                         int(mix["batch"])).indices
        x_new = cand[top]
        y_host = data.objective_values(run.seed, x_new.double().cpu().numpy(), self.k)
        y_new = torch.as_tensor(y_host, dtype=run.dtype, device=run.device)
        t1 = time.perf_counter()
        model.add_samples(x_new, y_new)
        if run.traced:
            run.sync()
            run.span("append", time.perf_counter() - t1)
        self.best = max(self.best, float(np.max(y_host)))
        self.new_x.append(x_new)
        self.new_y.append(y_new)
        self.log.append((live, cand, mean, var))
        self.k += 1

    def window(self, seconds: float) -> Outcome:
        run = self.run
        steps = 0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while steps == 0 or time.perf_counter() < deadline:
            start = time.perf_counter()
            with torch.profiler.record_function("gpbench/bo_step"):
                self.step()
            run.steps.append((self.log[-1][0], time.perf_counter() - start))
            steps += 1
        run.window_s = time.perf_counter() - t0
        room = self.cfg["capacity"] - self.model.num_samples
        return Outcome({"bo_step_s": run.window_s / steps}, steps, 0,
                       [f"bo: {steps} steps in {run.window_s!r} s, n = {self.model.num_samples}, "
                        f"room left {room}"])

    def outputs(self) -> ModelOutputs:
        model, run = self.model, self.run
        window = range(self.first, len(self.log))
        picked = check_sample(run.seed, len(window), int(self.mix["check_steps"]),
                              [len(window) - 1])
        query_sets, means, variances = [], [], []
        for i in picked:
            live, cand, mean, var = self.log[self.first + i]
            query_sets.append((live, cand))
            means.append(mean.cpu())
            variances.append(var.cpu())
        queries = self.queries()
        mean, var = model.predict_mean_variance(queries)
        x = torch.cat([self.x0, *self.new_x])
        y = torch.cat([self.y0, *self.new_y])
        query_sets.append((x.shape[0], queries))
        program = {"mean": torch.cat([*means, mean.cpu()]), "var": torch.cat([*variances, var.cpu()])}
        return ModelOutputs(run, x, y, self.x0.shape[0], fitted_params(model), query_sets, program)

    def release(self) -> None:
        self.model, self.log = None, []


class ServeLoop(Loop):
    def setup(self) -> None:
        from friedrich_tpu_torch import serving

        mix = self.mix
        self.x, self.y = self.data(0)
        self.model, _ = train_model(self.run, self.x, self.y)
        self.server = serving.AcceleratedGPServer(self.model, block=int(mix["block"]),
                                                  max_rows=int(mix["max_rows"]))
        self.clients = [serving.GPClient(port=self.server.port, timeout=float(mix["timeout_s"]))
                        for _ in range(int(mix["clients"]))]
        # warm-up: every connection at once, rows spread over the mix's range
        sizes = np.geomspace(int(mix["rows_min"]), int(mix["rows_max"]), len(self.clients))
        rng = data.host_rng(self.run.seed, "schedule", 1)
        threads = [threading.Thread(target=c.predict_mean_variance,
                                    args=(rng.normal(size=(int(s), self.cfg["d"])),))
                   for c, s in zip(self.clients, sizes)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        # then the mix itself for a few seconds, on draws of its own
        self.window(float(mix["warmup_s"]), index=1)

    def counters(self) -> dict:
        if not hasattr(self, "server"):
            return {}
        return {"requests_per_dispatch": dict(self.server.requests_per_dispatch)}

    def schedule(self, seconds: float, rate: float, index: int = 0):
        """Due times and row counts of the window's requests: exponential
        gaps and log-uniform sizes at their quantiles, in an order drawn
        from the mix's ``trace_seed``, the same for every run."""
        mix = self.mix
        count = max(1, round(rate * seconds))
        q = (np.arange(count) + 0.5) / count
        gaps = -np.log1p(-q)
        rows = np.exp(np.log(mix["rows_min"]) + q * (np.log(mix["rows_max"] + 1) - np.log(mix["rows_min"])))
        rows = np.minimum(np.floor(rows).astype(np.int64), int(mix["rows_max"]))
        rng = data.host_rng(int(mix["trace_seed"]), "schedule", index)
        gaps = rng.permutation(gaps)
        rows = rng.permutation(rows)
        due = np.cumsum(gaps)
        due *= seconds / (due[-1] + gaps[0])  # the last request is due inside the window
        return due, rows

    def window(self, seconds: float, rate: float | None = None, index: int = 0) -> Outcome:
        mix, run = self.mix, self.run
        rate = float(mix["rate_per_s"] if rate is None else rate)
        due, rows = self.schedule(seconds, rate, index)
        count = len(due)
        gen = data.host_rng(run.seed, "queries", index)
        offsets = np.concatenate([[0], np.cumsum(rows)])
        self.rows = gen.normal(size=(int(offsets[-1]), self.cfg["d"])).astype(np.float32)
        self.offsets = offsets
        self.replies = [None] * count
        sent = np.full(count, np.nan)
        done = np.full(count, np.nan)
        lock = threading.Lock()
        cursor = [0]
        t0 = time.perf_counter() + 0.05

        def worker(client):
            while True:
                with lock:
                    i = cursor[0]
                    cursor[0] += 1
                if i >= count:
                    return
                wait = t0 + due[i] - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                sent[i] = time.perf_counter()
                try:
                    q = self.rows[offsets[i]:offsets[i + 1]].astype(np.float64)
                    self.replies[i] = client.predict_mean_variance(q)
                    done[i] = time.perf_counter()
                except Exception:  # noqa: BLE001 — a failed request counts as missed
                    self.replies[i] = None

        threads = [threading.Thread(target=worker, args=(c,), daemon=True) for c in self.clients]
        for t in threads:
            t.start()
        end = t0 + seconds + float(mix["timeout_s"])
        for t in threads:
            t.join(timeout=max(0.0, end - time.perf_counter()))
        run.window_s = time.perf_counter() - t0
        failed = int(np.sum(np.isnan(done)))
        latency = np.where(np.isnan(done), run.window_s, done - (t0 + due))
        late = sent[~np.isnan(sent)] - (t0 + due[~np.isnan(sent)])
        p95 = float(np.percentile(latency, 95))
        notes = [f"serve: {count} requests at {rate!r}/s over {seconds!r} s, {failed} failed; "
                 f"latency p50 {float(np.percentile(latency, 50))!r} s, p95 {p95!r} s; "
                 f"generator late p50 {float(np.percentile(late, 50)) if late.size else 0.0!r} s, "
                 f"p99 {float(np.percentile(late, 99)) if late.size else 0.0!r} s, "
                 f"max {float(np.max(late)) if late.size else 0.0!r} s"]
        self.latency, self.due = latency, due
        return Outcome({"serve_p95_s": p95}, count, failed, notes)

    def outputs(self) -> ModelOutputs:
        run = self.run
        answered = [i for i, r in enumerate(self.replies) if r is not None]
        longest = max(answered, key=lambda i: self.offsets[i + 1] - self.offsets[i])
        picked = [answered[i] for i in check_sample(run.seed, len(answered),
                                                   int(self.mix["check_requests"]),
                                                   [answered.index(longest)])]
        rows = np.concatenate([self.rows[self.offsets[i]:self.offsets[i + 1]] for i in picked])
        program = {"mean": torch.as_tensor(np.concatenate([self.replies[i][0] for i in picked])),
                   "var": torch.as_tensor(np.concatenate([self.replies[i][1] for i in picked]))}
        queries = torch.as_tensor(rows, device=run.device)
        return ModelOutputs(run, self.x, self.y, self.x.shape[0], fitted_params(self.model),
                            [(self.x.shape[0], queries)], program)

    def release(self) -> None:
        for c in self.clients:
            c.close()
        self.server.close()
        self.server = self.model = None


LOOPS = {"train": TrainLoop, "bo": BOLoop, "serve": ServeLoop}
