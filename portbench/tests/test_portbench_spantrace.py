"""The program's spans in a traced run: self time and children's share by
span name, and idle gaps split by overlap among the threads' innermost
open spans, on a host clock shifted onto the device's."""

from types import SimpleNamespace

import pytest

from portbench.core import spantrace

SHIFT = 500                       # device clock = host clock + 500 ns
BUSY = [[2000, 2500], [6000, 6500]]
LO, HI = 0, 10_000


def _span(sid, parent, thread, name, t0, t1, cpu=0):
    return SimpleNamespace(span_id=sid, parent_span_id=parent, thread=thread,
                           name=name, t0_ns=t0, t1_ns=t1, cpu_ns=cpu)


# client thread 1: a push with two stages; scheduler thread 2: a dispatch
# with its launch (host clock)
SPANS = [
    _span(b"1", b"", 1, "generator.Push", 600, 8400, cpu=3000),
    _span(b"2", b"1", 1, "generator.stage", 700, 2700, cpu=2000),
    _span(b"3", b"1", 1, "processor.span-metrics", 3500, 5500, cpu=1000),
    _span(b"4", b"", 2, "sched.dispatch", 4500, 7500, cpu=500),
    _span(b"5", b"4", 2, "sched.launch", 5000, 7000, cpu=400),
]
HARNESS = [(500, 8500, "generator.push_otlp"), (9000, 9200, "harness.stamp")]


def test_overlap_split_two_threads_nested_shifted():
    got = spantrace.split_idle(BUSY, LO, HI, SHIFT, SPANS, HARNESS)
    # device clock: push_otlp [1000, 9000] around Push [1100, 8900] with
    # stage [1200, 3200] and span metrics [4000, 6000]; dispatch
    # [5000, 8000] around launch [5500, 7500]; the stamp [9500, 9700] on a
    # thread of its own. Idle [0, 2000], [2500, 6000], [6500, 10000].
    want = {"no harness span": 1800, "generator.push_otlp": 200,
            "generator.Push": 100 + 800 + 500 + 250 + 900,
            "generator.stage": 800 + 700,
            "processor.span-metrics": 1000 + 250 + 250,
            "sched.dispatch": 250 + 250, "sched.launch": 250 + 500,
            "harness.stamp": 200}
    assert got == pytest.approx({k: v / 1e9 for k, v in want.items()})
    assert sum(got.values()) == pytest.approx(9000 / 1e9)
    assert spantrace.top(got, 2) == [
        ["generator.Push", pytest.approx(2.55e-6)],
        ["no harness span", pytest.approx(1.8e-6)]]


def test_without_spans_or_gaps():
    got = spantrace.split_idle(BUSY, LO, HI, SHIFT, [], [])
    assert got == pytest.approx({"no harness span": 9e-6})
    assert spantrace.split_idle([[LO, HI]], LO, HI, 0, SPANS, HARNESS) == {}


def test_summary_and_child_share():
    rows = spantrace.summary(SPANS)
    assert rows["generator.Push"] == pytest.approx(
        {"count": 1, "wall_s": 7.8e-6, "cpu_s": 3e-6, "self_s": 3.8e-6})
    assert rows["sched.dispatch"]["self_s"] == pytest.approx(1e-6)
    assert rows["sched.launch"]["self_s"] == pytest.approx(2e-6)
    assert spantrace.child_share(SPANS, "generator.Push") == \
        pytest.approx(4000 / 7800)
    assert spantrace.child_share(SPANS, "no such span") is None
