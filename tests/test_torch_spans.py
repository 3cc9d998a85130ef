"""The port's in-memory span recorder (``friedrich_tpu_torch/utils/profiling.py``)
and the spans and counters the program opens with it: the recorder itself
(off, nesting, threads, capacity), its clock against ``torch.profiler``'s,
the server's request, queue and dispatch spans, the large fit's
iterations, the builder's steps and the facade append's counters. float64
on the CPU."""

import threading
import time
import tracemalloc

import numpy as np
import pytest
import torch

import friedrich_tpu_torch as tft
import friedrich_tpu_torch.kernels as tk
import friedrich_tpu_torch.priors as tp
from friedrich_tpu_torch import config, serving
from friedrich_tpu_torch.models import api
from friedrich_tpu_torch.models import gp as tgp
from friedrich_tpu_torch.models import large_fit as tlf
from friedrich_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def _port_on_cpu_in_f64():
    config.enable_x64()
    config.set_device("cpu")
    profiling.disable()
    profiling.drain()
    yield
    profiling.disable()
    profiling.drain()


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_recording_off_records_nothing():
    log = []
    with profiling.scope("a", rows=3) as span:
        assert span is None
    with profiling.timed("b", log) as span:
        assert span is None
    assert profiling.record_span("c", 1, 2) is None
    assert profiling.drain() == [] and profiling.dropped() == 0
    assert [name for name, _ in log] == ["b"]


def test_a_scope_off_costs_a_flag_test_and_no_allocation():
    """With recording off a scope is its bare profiler range: no byte
    allocated beyond what the range allocates, and nothing recorded."""
    def peak(enter, n=200):
        for _ in range(20):
            enter()
        tracemalloc.start()
        try:
            base = tracemalloc.get_traced_memory()[0]
            for _ in range(n):
                enter()
            return tracemalloc.get_traced_memory()[1] - base
        finally:
            tracemalloc.stop()

    def bare():
        with profiling.annotate("x"):
            pass

    def scoped():
        with profiling.scope("x", rows=1):
            pass

    # the first measurement also pays tracemalloc's own start-up
    assert min(peak(scoped) for _ in range(3)) <= min(peak(bare) for _ in range(3))
    assert profiling.drain() == []


def test_nested_spans_carry_parent_thread_and_attrs():
    with profiling.record_spans():
        assert profiling.recording()
        with profiling.scope("outer", rows=4) as outer:
            with profiling.scope("inner") as inner:
                inner.attrs["applied"] = False

            def on_a_thread():
                with profiling.scope("thread"):
                    pass

            t = threading.Thread(target=on_a_thread)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
    assert not profiling.recording()
    spans = _by_name(profiling.drain())
    (o,), (i,), (th,) = spans["outer"], spans["inner"], spans["thread"]
    assert o.id == outer.id and i.id == inner.id
    assert o.parent is None and i.parent == o.id and th.parent is None
    assert o.attrs == {"rows": 4} and i.attrs == {"applied": False}
    assert o.thread == i.thread == threading.get_native_id() != th.thread
    assert o.start_ns <= i.start_ns <= i.end_ns <= o.end_ns
    assert o.seconds == (o.end_ns - o.start_ns) / 1e9


def test_a_span_one_thread_opens_and_another_closes():
    opened = []
    with profiling.record_spans():
        t = threading.Thread(target=lambda: opened.append(profiling.time.time_ns()))
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        with profiling.scope("closer") as closer:
            sid = profiling.record_span("queue", opened[0], profiling.time.time_ns(),
                                        parent=closer.id, request=7)
    spans = _by_name(profiling.drain())
    (q,) = spans["queue"]
    assert q.id == sid and q.parent == spans["closer"][0].id
    assert q.attrs == {"request": 7} and q.start_ns == opened[0] <= q.end_ns
    assert q.thread == threading.get_native_id()


def test_the_buffer_holds_its_capacity_and_counts_the_rest(monkeypatch):
    assert profiling.CAPACITY == 1 << 20
    monkeypatch.setattr(profiling, "CAPACITY", 3)
    with profiling.record_spans():
        for k in range(5):
            with profiling.scope("s", k=k):
                pass
    assert profiling.dropped() == 2
    assert [s.attrs["k"] for s in profiling.drain()] == [0, 1, 2]
    assert profiling.dropped() == 0 and profiling.drain() == []


def test_enabling_twice_is_harmless():
    profiling.enable()
    profiling.enable()
    with profiling.record_spans():
        pass
    assert profiling.recording()  # it was on before the block
    with profiling.scope("on"):
        pass
    profiling.disable()
    assert not profiling.recording()
    assert [s.name for s in profiling.drain()] == ["on"]


def test_spans_are_on_the_profilers_clock():
    """A span's ends lie within 1 ms of its ``record_function`` twin in a
    ``torch.profiler`` trace taken at the same time."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.record_spans():
            for _ in range(3):
                with profiling.scope("clock/probe"):
                    torch.ones(64).cumsum(0)
    twins = sorted((e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                   if e.name() == "clock/probe")
    spans = sorted((s.start_ns, s.end_ns) for s in profiling.drain())
    assert len(twins) == len(spans) == 3
    for (t0, t1), (s0, s1) in zip(twins, spans):
        assert abs(s0 - t0) < 1_000_000 and abs(s1 - t1) < 1_000_000


def _gp(n=40, d=3, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    return tft.GaussianProcess.new(tp.ConstantPrior(0.3), tk.SquaredExp(1.2, 0.9), 0.25, None,
                                   x, np.sin(x[:, 0]))


def test_the_servers_spans_name_each_request_and_sweep():
    gp = _gp()
    shapes = [3, 7, 11, 5, 9, 2, 8, 4, 6, 1]
    errors = []
    with profiling.record_spans():
        with serving.AcceleratedGPServer(gp, block=8, max_rows=16) as srv:
            barrier = threading.Barrier(5)

            def client(i):
                rng = np.random.default_rng(i)
                try:
                    with serving.GPClient(port=srv.port, timeout=30.0) as c:
                        barrier.wait(timeout=30)
                        for s in shapes[i::5]:
                            c.predict_mean_variance(rng.normal(size=(s, 3)))
                except Exception as e:  # noqa: BLE001 — asserted below
                    errors.append(e)

            threads = [threading.Thread(target=client, args=(i,)) for i in range(5)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
            # a connection's thread records its request after the reply
            # has left: wait for the last ones
            deadline = time.monotonic() + 30
            while (sum(s.name == "serving/request" for s in list(profiling._SPANS)) < len(shapes)
                   and time.monotonic() < deadline):
                time.sleep(0.01)
    assert not errors, errors
    spans = _by_name(profiling.drain())
    requests = {s.attrs["request"]: s for s in spans["serving/request"]}
    queued = {s.attrs["request"]: s for s in spans["serving/queue"]}
    assert len(requests) == len(spans["serving/request"]) == len(shapes)
    assert set(queued) == set(requests) and len(spans["serving/queue"]) == len(shapes)
    assert sorted(s.attrs["rows"] for s in queued.values()) == sorted(shapes)
    dispatches = spans["serving/dispatch"]
    answered = [i for d in dispatches for i in d.attrs["ids"]]
    assert sorted(answered) == sorted(requests)
    merged = {}
    rows = {}
    for d in dispatches:
        assert d.attrs["requests"] == len(d.attrs["ids"]) and d.attrs["block"] == 8
        assert d.attrs["rows"] == sum(queued[i].attrs["rows"] for i in d.attrs["ids"])
        merged[d.attrs["requests"]] = merged.get(d.attrs["requests"], 0) + 1
        rows[d.attrs["rows"]] = rows.get(d.attrs["rows"], 0) + 1
        for i in d.attrs["ids"]:
            # the queue ends where the sweep that answers it starts, inside
            # the request's own span
            assert queued[i].end_ns == d.start_ns
            assert requests[i].start_ns <= queued[i].start_ns <= d.start_ns <= requests[i].end_ns
    assert merged == dict(srv.requests_per_dispatch) and rows == dict(srv.dispatches)
    for child in ("serving/merge", "serving/batch", "serving/fetch"):
        assert sorted(s.parent for s in spans[child]) == sorted(d.id for d in dispatches)
    assert all(s.parent is None for s in spans.get("serving/wait", []))
    # the dispatcher is in one of its two top ranges at a time: waiting on
    # an empty queue, or busy until it finds the queue empty again
    busy = {s.id: s for s in spans["serving/busy"]}
    assert {d.parent for d in dispatches} <= set(busy)
    assert all(s.parent is None for s in busy.values())
    top = sorted(list(busy.values()) + spans.get("serving/wait", []), key=lambda s: s.start_ns)
    assert len({s.thread for s in top}) == 1
    assert all(a.end_ns <= b.start_ns for a, b in zip(top, top[1:]))


@pytest.mark.parametrize("name,max_iter,converges", [("scalable", 60, True),
                                                      ("generic", 6, False)])
def test_one_iteration_span_per_step_of_the_large_fit(name, max_iter, converges):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(120, 3))
    y = np.sin(x[:, 0]) + 0.1 * rng.normal(size=120)
    kernel = tk.SquaredExp(ls=0.9, ampl=1.2) if name == "scalable" else tk.RationalQuadratic(
        alpha=1.1, ls=0.8)
    state, ok = tgp.make_state(kernel, tp.ConstantPrior(c=0.0), 0.3, torch.as_tensor(x),
                               torch.as_tensor(y), cap=128)
    assert bool(ok)
    with profiling.record_spans():
        _, iterations = tlf.fit_kernel_noise_large(state, max_iter, 0.05, 3600.0)
    spans = _by_name(profiling.drain())
    steps = spans["fit_large/iteration"]
    applied = [s for s in steps if s.attrs["applied"]]
    assert len(steps) == iterations
    assert len(applied) == (iterations - 1 if converges else iterations)
    assert converges == (not steps[-1].attrs["applied"])
    ids = {s.id for s in steps}
    for child in ("fit_large/solves", "fit_large/grad_matvec", "fit_large/adam"):
        assert len(spans[child]) == iterations and {s.parent for s in spans[child]} == ids
    assert {s.parent for s in spans["fit_large/rebuild"]} == {s.id for s in applied}


@pytest.mark.parametrize("subfit", [None, 16])
def test_the_builders_timings_are_its_spans(subfit):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(40, 2))
    y = np.sin(x[:, 0])
    builder = tft.GaussianProcessBuilder(x, y).set_fit_subsample(subfit).set_fit_parameters(5, 0.05)
    builder.fit_kernel().fit_prior()
    with profiling.record_spans():
        builder.train()
    spans = _by_name(profiling.drain())
    (train,) = spans["builder/train"]
    steps = ("heuristic", "subfit", "build") if subfit else ("heuristic", "build", "fit")
    assert set(builder.timings) == set(steps) | {"subfit_iterations" if subfit else "fit_iterations"}
    for key in steps:
        (span,) = spans[f"builder/{key}"]
        assert span.parent == train.id
        assert builder.timings[key] == span.seconds
    # without recording the same keys, from the same clock
    builder.train()
    assert set(builder.timings) == set(steps) | {"subfit_iterations" if subfit else "fit_iterations"}
    assert profiling.drain() == []


@pytest.mark.parametrize("in_place", [False, True], ids=["copied", "in_place"])
def test_the_append_counts_its_mode_and_the_bytes_it_copies(monkeypatch, in_place):
    gp = tft.GaussianProcess.new(tp.ConstantPrior(0.3), tk.SquaredExp(1.2, 0.9), 0.25, None,
                                 np.random.default_rng(2).normal(size=(40, 3)),
                                 np.zeros(40), capacity=64)
    if in_place:
        monkeypatch.setattr(config, "two_matrices_fit", lambda *a: False)
    before_modes, before_bytes = dict(api.APPENDS), api.APPEND_COPY_BYTES
    with profiling.record_spans():
        gp.add_samples(np.random.default_rng(4).normal(size=(4, 3)), np.ones(4))
    mode = "in_place" if in_place else "copied"
    copied = 0 if in_place else 64 * 64 * 8
    assert api.APPENDS[mode] == before_modes.get(mode, 0) + 1
    assert sum(api.APPENDS.values()) == sum(before_modes.values()) + 1
    assert api.APPEND_COPY_BYTES == before_bytes + copied
    (span,) = [s for s in profiling.drain() if s.name == "gp/add_samples"]
    assert span.attrs == {"mode": mode, "copy_bytes": copied}
    assert gp.num_samples == 44


def test_a_grown_append_counts_the_old_factor_copied():
    gp = tft.GaussianProcess.new(tp.ConstantPrior(0.3), tk.SquaredExp(1.2, 0.9), 0.25, None,
                                 np.random.default_rng(2).normal(size=(40, 3)),
                                 np.zeros(40), capacity=40)
    before, before_bytes = api.APPENDS["grown"], api.APPEND_COPY_BYTES
    gp.add_samples(np.random.default_rng(4).normal(size=(4, 3)), np.ones(4))
    cap = gp.state.capacity
    assert api.APPENDS["grown"] == before + 1
    assert api.APPEND_COPY_BYTES == before_bytes + 40 * 40 * 8 + cap * cap * 8
