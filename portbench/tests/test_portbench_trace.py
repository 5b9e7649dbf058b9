"""Reading a device trace: busy time, operations by name, and idle gaps
shared among the harness spans that cover their middle."""

import pytest
from torch.autograd import DeviceType

from portbench.core import trace


class _Ev:
    def __init__(self, a, d, name, dev=DeviceType.CUDA):
        self.a, self.d, self.n, self.dev = a, d, name, dev

    def start_ns(self):
        return self.a

    def duration_ns(self):
        return self.d

    def name(self):
        return self.n

    def device_type(self):
        return self.dev


class _Prof:
    def __init__(self, events):
        self.profiler = self
        self.kineto_results = self
        self._events = events

    def events(self):
        return self._events


def _read(items, events, host_marks=(0, 10_000)):
    spans = trace.HostSpans(True)
    spans.items = list(items)
    dt = trace.DeviceTrace(spans)
    dt.marks = list(host_marks)
    dt.t_start, dt.t_stop = 0.0, 1e-5
    dt.prof = _Prof(events)
    dt._read()
    return dt


EVENTS = [_Ev(0, 10, "spin_kernel"), _Ev(2000, 500, "k1"),
          _Ev(6000, 500, "k2"), _Ev(6200, 100, "k2"),
          _Ev(3000, 9, "cpu op", DeviceType.CPU), _Ev(10_000, 10, "spin_kernel")]


def test_busy_ops_and_gaps():
    dt = _read([(1000, 5000, "push"), (4000, 9000, "drain")], EVENTS)
    assert dt.busy_s == pytest.approx(1e-6)
    assert dt.ops == pytest.approx({"k1": 5e-7, "k2": 6e-7})
    # gaps [0, 2000], [2500, 6000], [6500, 10000]: their middles lie in
    # push; push and drain (half each); drain
    assert dt.gaps == pytest.approx({"push": 3.75e-6, "drain": 5.25e-6})
    top = dt.breakdown()
    assert top["device_ops"][0][0] == "k2" and len(top["idle_gaps"]) == 2


def test_host_clock_shift_and_no_spans():
    # the marks' device times lie 500 ns after their host times
    dt = _read([(500, 4500, "push")], EVENTS, host_marks=(-500, 9500))
    # the span lands on [1000, 5000]: the first two gaps' middles
    assert dt.gaps == pytest.approx({"push": 5.5e-6,
                                     "no harness span": 3.5e-6})
    dt = _read([], EVENTS)
    assert dt.gaps == pytest.approx({"no harness span": 9e-6})


def test_missing_marks():
    dt = _read([], [_Ev(2000, 500, "k1")])
    assert set(dt.gaps) == {"trace marks missing"}
