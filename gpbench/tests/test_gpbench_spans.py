"""The readers of the program's own spans and append counters
(``gpbench/spans.py`` and the metrics that use it) on synthetic spans and
device operations, and one traced tiny serve run that records them."""

import types

import pytest

from gpbench import harness, spans, trace

from .tiny import run_tiny

WINDOW = (1_000, 100_000_000)


def op(start, end, name="k"):
    return trace.DeviceOp(name, start, end, 0)


def span(name, start, end, **attrs):
    from friedrich_tpu_torch.utils.profiling import Span

    return Span(name, start, end, 0, None, 1, attrs)


def fake_run(recorded, ops=(), appends=None):
    t = trace.Trace(list(ops), [trace.HostRange(trace.WINDOW_RANGE, *WINDOW, 1)], [], WINDOW)
    records = {"spans": recorded}
    if appends is not None:
        records["appends_before"], records["appends_after"] = appends
    return types.SimpleNamespace(records=records, trace=t)


def read(metric, run):
    return harness.load_metric_module(metric).read(run)


def test_queue_wait_is_the_95th_percentile_in_ms():
    waits = [span("serving/queue", 0, ms * 1_000_000, request=ms) for ms in range(1, 101)]
    other = [span("serving/request", 0, 10**9)]
    assert read("serve.queue_wait_ms", fake_run(waits + other)) == pytest.approx(95.05)


def test_dispatch_idle_counts_overlapping_streams_once():
    """Two streams overlap inside the first sweep (busy 2-7 ms of 0-10 ms
    once, not 9 ms summed); the second sweep has no device work at all."""
    sweeps = [span("serving/dispatch", 1_000_000, 11_000_000, rows=3, block=256),
              span("serving/dispatch", 20_000_000, 24_000_000, rows=300, block=256)]
    ops = [op(3_000_000, 7_000_000, "a"), op(4_000_000, 8_000_000, "b"),
           op(30_000_000, 31_000_000, "c")]  # outside every sweep
    # first sweep idle 10 - 5 = 5 ms, second 4 ms
    assert read("serve.dispatch_idle_ms", fake_run(sweeps, ops)) == pytest.approx(4.5)


def test_block_fill_is_rows_over_solved_columns():
    sweeps = [span("serving/dispatch", 0, 1, rows=3, block=256),
              span("serving/dispatch", 2, 3, rows=300, block=256),
              span("serving/dispatch", 4, 5, rows=512, block=256)]
    assert read("serve.block_fill", fake_run(sweeps)) == pytest.approx(100 * 815 / 1280)


def test_iteration_time_counts_the_applied_steps():
    steps = [span("fit_large/iteration", 0, 30_000_000, applied=True),
             span("fit_large/iteration", 30_000_000, 70_000_000, applied=True),
             span("fit_large/iteration", 70_000_000, 71_000_000, applied=False)]
    assert read("fit.iter_ms.train", fake_run(steps)) == pytest.approx(35.0)


def test_iteration_idle_is_a_share_of_the_iterations():
    steps = [span("fit_large/iteration", 10_000_000, 20_000_000, applied=True),
             span("fit_large/iteration", 20_000_000, 30_000_000, applied=False)]
    # two overlapping streams cover 12-18 ms; the second step is busy 25-30
    ops = [op(12_000_000, 16_000_000), op(14_000_000, 18_000_000), op(25_000_000, 30_000_000),
           op(40_000_000, 50_000_000)]
    assert read("fit.iter_idle.train", fake_run(steps, ops)) == pytest.approx(100 * 9 / 20)


def test_append_copy_is_bytes_per_append_in_gb():
    appends = ({"appends": 5, "copy_bytes": 10}, {"appends": 155, "copy_bytes": 10 + 150 * 13_545_000_000})
    assert read("gp.append_copy_gb.bo", fake_run([], appends=appends)) == pytest.approx(13.545)
    assert read("gp.append_copy_gb.bo", fake_run([], appends=(appends[0], appends[0]))) is None


@pytest.mark.parametrize("metric", ["serve.queue_wait_ms", "serve.dispatch_idle_ms",
                                    "serve.block_fill", "fit.iter_ms.train",
                                    "fit.iter_idle.train", "gp.append_copy_gb.bo"])
def test_a_program_without_spans_reads_nothing(metric):
    run = fake_run(None)
    run.records = {"spans": None}
    assert read(metric, run) is None


def test_start_and_collect_keep_the_windows_spans():
    from friedrich_tpu_torch.utils import profiling

    run = fake_run(None)
    run.records = {}
    spans.start(run)
    spans.start(run)  # a second reader's prepare
    assert profiling.recording()
    for name, start, end in (("before", 0, 500), ("inside", 2_000, 3_000),
                             ("across", 500, 2_000), ("after", 10**9, 10**9 + 1)):
        profiling.record_span(name, start, end)
    spans.collect(run)
    spans.collect(run)
    assert not profiling.recording()
    assert sorted(s.name for s in run.records["spans"]) == ["across", "inside"]
    assert spans.append_delta(run) == (0, 0)


def test_a_traced_tiny_serve_run_reads_the_servers_spans():
    result = run_tiny("gp100k-serve", traced=True)
    assert result["correct"], result["checks"]
    for name in ("serve.queue_wait_ms", "serve.dispatch_idle_ms", "serve.block_fill"):
        assert name in result["metrics"], name
    assert 0 < result["metrics"]["serve.block_fill"]["value"] <= 100
