"""The device-idle arithmetic of ``gpbench/trace.py``."""

from gpbench import trace


def op(start, end, name="k", corr=0):
    return trace.DeviceOp(name, start, end, corr)


def test_union_counts_overlap_once():
    assert trace.union_length([(0, 10), (5, 15), (20, 30)]) == 25
    assert trace.union_length([(0, 10), (2, 3), (3, 4)]) == 10
    assert trace.union_length([]) == 0


def test_overlapping_streams_never_read_negative_idle():
    """Two streams each busy 77 % of a 100 ns window, overlapping: the sum
    of their kernel times is 154 % of the window, the arithmetic that read
    an idle share of -0.54; the union reads 23 %."""
    window = (0, 100)
    stream_a = [op(0, 77)]
    stream_b = [op(23, 100)]
    t = trace.Trace(stream_a + stream_b, [trace.HostRange(trace.WINDOW_RANGE, 0, 100, 1)], [], window)
    summed = sum(o.end - o.start for o in t.ops)
    assert 1.0 - summed / 100 == -0.54
    assert trace.busy_ns(t) == 100
    t2 = trace.Trace([op(0, 40), op(10, 50), op(60, 77)], [], [], window)
    assert trace.busy_ns(t2) == 67


def test_ops_outside_the_window_are_cut():
    t = trace.Trace([op(-50, 10), op(90, 150)], [], [], (0, 100))
    assert trace.busy_ns(t) == 20


def test_idle_gaps_and_their_labels():
    window = (0, 100)
    ranges = [
        trace.HostRange(trace.WINDOW_RANGE, 0, 100, 1),
        trace.HostRange("gpbench/train", 0, 100, 1),
        trace.HostRange("fit_large/adam", 10, 30, 1),
        trace.HostRange("gpbench/inner", 12, 18, 1),
    ]
    t = trace.Trace([op(0, 10, "a"), op(30, 60, "b"), op(60, 70, "b")], ranges, [], window)
    assert trace.idle_gaps([(o.start, o.end) for o in t.ops], window) == [(10, 30), (70, 100)]
    out = trace.breakdown(t)
    # the program's scope wins over a range of the benchmark's own
    assert out["idle_gaps"] == [["gpbench/train", 30e-9], ["fit_large/adam", 20e-9]]
    assert out["device_ops"] == [["b", 40e-9], ["a", 10e-9]]


def test_labels_default_to_host():
    assert trace.labels_at([], [5]) == ["host"]


def test_breakdown_keeps_ten():
    ops = [op(i * 10, i * 10 + 1, f"k{i}") for i in range(15)]
    out = trace.breakdown(trace.Trace(ops, [], [], (0, 150)))
    assert len(out["device_ops"]) == 10 and len(out["idle_gaps"]) == 1


def test_breakdown_sums_the_cards():
    """Operations summed by name and idle gaps by label over every card's
    trace, each card's gaps within its own window."""
    window = (0, 100)
    ranges = [trace.HostRange("fit_large/adam", 0, 100, 1)]
    a = trace.Trace([op(0, 60, "k"), op(60, 70, "c")], ranges, [], window)
    b = trace.Trace([op(1000, 1050, "k")], [], [], (1000, 1100))
    out = trace.breakdown(a, b)
    assert out["device_ops"] == [["k", 110e-9], ["c", 10e-9]]
    assert out["idle_gaps"] == [["host", 50e-9], ["fit_large/adam", 30e-9]]
    assert trace.breakdown(a) == trace.breakdown(a, top=10)
