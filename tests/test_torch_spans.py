"""Spans inside the port's push and dispatch, and the registry's timed
state lock.

Held: a `Generator.push_otlp` with span metrics and service graphs under
a `SpanRecorder` gives one tree a push (`generator.Push` > staging and
each processor's stages, on the pushing thread) and one a merged
dispatch (`sched.dispatch` > coalesce and launch, on the scheduler's
thread), every span on the monotonic clock and inside its parent, each
carrying its counts; under the default `NoopTracer` no span is kept and
no thread clock is read; the recorder's bound drops and counts; the
state lock counts a wait only when another thread holds it, and stays
re-entrant on dense and paged registries.
"""

from __future__ import annotations

import threading
import time

import pytest

import tempo_tpu_torch as tt
from tempo_tpu_torch.generator import Generator
from tempo_tpu_torch.model.otlp import encode_spans_otlp
from tempo_tpu_torch.obs.runtime import RUNTIME
from tempo_tpu_torch.registry import pages
from tempo_tpu_torch.registry.registry import ManagedRegistry
from tempo_tpu_torch.utils import tracing

T0 = 1_700_000_000.0
PAIRS = 48
WAIT = "tempo_registry_state_lock_wait_seconds_total"
CONTENDED = "tempo_registry_state_lock_contended_total"


@pytest.fixture(autouse=True)
def _singletons():
    tt.native.load()
    tt.sched.reset()
    yield
    tt.sched.reset()
    tracing.install(tracing.NoopTracer())


def _payload() -> bytes:
    """PAIRS client/server pairs across two services, one trace each."""
    now = int(T0 * 1e9)
    spans = []
    for i in range(PAIRS):
        tid = (i + 1).to_bytes(16, "big")
        cid, sid = (2 * i + 1).to_bytes(8, "big"), (2 * i + 2).to_bytes(8, "big")
        spans.append(dict(trace_id=tid, span_id=cid, parent_span_id=b"",
                          name=f"call-{i % 3}", service="front", kind=3,
                          status_code=0, start_unix_nano=now - 4_000_000,
                          end_unix_nano=now))
        spans.append(dict(trace_id=tid, span_id=sid, parent_span_id=cid,
                          name=f"serve-{i % 3}", service="back", kind=2,
                          status_code=2 * (i % 5 == 0),
                          start_unix_nano=now - 3_000_000,
                          end_unix_nano=now - 1_000_000))
    return encode_spans_otlp(spans)


def _generator() -> Generator:
    tt.sched.configure(tt.SchedConfig())
    return Generator(tt.GeneratorConfig(
        processors=("span-metrics", "service-graphs"),
        registry=tt.RegistryOverrides(max_active_series=1024),
        spanmetrics=tt.SpanMetricsConfig(sketch_max_series=256)),
        now=lambda: T0, device="cpu")


def _counter(name: str) -> float:
    for line in RUNTIME.render().splitlines():
        if line.startswith(name + " "):
            return float(line.split()[1])
    raise AssertionError(f"{name} not on the runtime registry")


def test_push_and_dispatch_span_trees():
    gen = _generator()
    rec = tracing.SpanRecorder()
    tracing.install(rec)
    assert gen.push_otlp("t", _payload()) == 2 * PAIRS
    # the scheduler's worker closes the window (a flush from this thread
    # would run the dispatch here)
    deadline = time.monotonic() + 10
    while not any(s.name == "sched.dispatch" for s in rec.spans):
        assert time.monotonic() < deadline, "no dispatch within 10 s"
        time.sleep(0.001)
    tracing.install(tracing.NoopTracer())
    spans = rec.spans
    by_id = {s.span_id: s for s in spans}
    tree = {(s.name, by_id[s.parent_span_id].name
             if s.parent_span_id in by_id else None) for s in spans}
    assert tree == {
        ("generator.Push", None),
        ("generator.stage", "generator.Push"),
        ("processor.span-metrics", "generator.Push"),
        ("spanmetrics.resolve", "processor.span-metrics"),
        ("sched.submit", "processor.span-metrics"),
        ("spanmetrics.exemplars", "processor.span-metrics"),
        ("processor.service-graphs", "generator.Push"),
        ("servicegraphs.match", "processor.service-graphs"),
        ("servicegraphs.emit", "processor.service-graphs"),
        ("servicegraphs.expire", "processor.service-graphs"),
        ("sched.dispatch", None),
        ("sched.coalesce", "sched.dispatch"),
        ("sched.launch", "sched.dispatch"),
    }
    push = {s.thread for s in spans if not s.name.startswith("sched.")
            or s.name == "sched.submit"}
    disp = {s.thread for s in spans if s.name in
            ("sched.dispatch", "sched.coalesce", "sched.launch")}
    assert push == {threading.get_ident()}
    assert len(disp) == 1 and disp != push
    for s in spans:
        assert 0 < s.t0_ns <= s.t1_ns and s.cpu_ns >= 0
        assert s.start_ns == 0 and s.end_ns == 0   # no wall clock exported
        p = by_id.get(s.parent_span_id)
        if p is not None:
            assert p.thread == s.thread
            assert p.t0_ns <= s.t0_ns and s.t1_ns <= p.t1_ns
    (root,) = [s for s in spans if s.name == "generator.Push"]
    (stage,) = [s for s in spans if s.name == "generator.stage"]
    (match,) = [s for s in spans if s.name == "servicegraphs.match"]
    (disp_sp,) = [s for s in spans if s.name == "sched.dispatch"]
    (submit,) = [s for s in spans if s.name == "sched.submit"]
    assert stage.t0_ns >= root.t0_ns and stage.attrs["spans"] == 2 * PAIRS
    assert match.attrs == {"spans": 2 * PAIRS, "edges": PAIRS}
    assert [s.attrs["edges"] for s in spans
            if s.name == "servicegraphs.emit"] == [PAIRS]
    # the batch's rows ride padded to its capacity (slot -1 drops them)
    assert disp_sp.attrs["rows"] == submit.attrs["rows"] >= 2 * PAIRS
    assert disp_sp.attrs["bucket"] >= disp_sp.attrs["rows"]
    assert "device_ns" not in disp_sp.attrs
    assert rec.dropped == 0 and rec.tenant is None


def test_noop_tracer_records_nothing_and_reads_no_thread_clock(monkeypatch):
    gen = _generator()
    rec = tracing.SpanRecorder()      # made, never installed
    assert isinstance(tracing.tracer(), tracing.NoopTracer)

    def no_clock():
        raise AssertionError("a span read the thread's CPU clock")

    monkeypatch.setattr(time, "thread_time_ns", no_clock)
    assert gen.push_otlp("t", _payload()) == 2 * PAIRS
    tt.sched.flush()
    with tracing.span("outside") as sp:
        assert sp is None
    assert rec.spans == [] and rec.dropped == 0


def test_recorder_bound_drops_and_counts():
    rec = tracing.SpanRecorder(max_spans=3)
    tracing.install(rec)
    with tracing.span("a"):
        for i in range(4):
            with tracing.span("b", i=i):
                pass
    assert [s.name for s in rec.spans] == ["b", "b", "b"]
    assert rec.dropped == 2
    # a recorder is never the reserved tenant: nothing is suppressed
    with tracing.span_for_tenant("c", "tempo-self") as sp:
        assert sp is not None and sp.attrs == {"tenant": "tempo-self"}


def test_self_tracer_spans_carry_both_clocks():
    tr = tracing.SelfTracer(flush_interval_s=3600, sink=lambda b: None,
                            seed=3)
    tracing.install(tr)
    try:
        before = time.time_ns()
        with tracing.span("outer") as s:
            with tracing.span("inner") as c:
                pass
        assert s.start_ns >= before - 10**9 and s.end_ns >= s.start_ns
        assert s.t0_ns <= c.t0_ns <= c.t1_ns <= s.t1_ns
        assert c.thread == s.thread == threading.get_ident()
        assert c.parent_span_id == s.span_id and c.trace_id == s.trace_id
    finally:
        tr.shutdown()


def _hold(lock, held: threading.Event, release: threading.Event):
    with lock:
        held.set()
        release.wait(10)


def test_state_lock_counts_only_contended_waits():
    reg = ManagedRegistry("t", tt.RegistryOverrides(max_active_series=64),
                          device="cpu")
    w0, c0 = _counter(WAIT), _counter(CONTENDED)
    with reg.state_lock:
        with reg.state_lock:            # re-entrant
            pass
    assert (_counter(WAIT), _counter(CONTENDED)) == (w0, c0)
    held, release = threading.Event(), threading.Event()
    th = threading.Thread(target=_hold, args=(reg.state_lock, held, release))
    th.start()
    assert held.wait(10)
    threading.Timer(0.05, release.set).start()
    with reg.state_lock:
        pass
    th.join(10)
    assert not th.is_alive()
    assert _counter(CONTENDED) == c0 + 1
    assert _counter(WAIT) - w0 >= 0.04


def test_paged_state_lock_is_the_pools_and_reentrant():
    pool = pages.PagePool(tt.PagePoolConfig(enabled=True, page_rows=64,
                                            arena_slots=1024), device="cpu")
    with pages.use(pool):
        reg = ManagedRegistry("p", tt.RegistryOverrides(max_active_series=128))
    assert reg.pages is pool and reg.state_lock.lock is pool.lock
    with reg.state_lock:
        with pool.lock:
            with reg.state_lock:
                pass
    c0 = _counter(CONTENDED)
    held, release = threading.Event(), threading.Event()
    th = threading.Thread(target=_hold, args=(pool.lock, held, release))
    th.start()
    assert held.wait(10)
    threading.Timer(0.02, release.set).start()
    with reg.state_lock:       # the pool's lock, held by another thread
        pass
    th.join(10)
    assert not th.is_alive() and _counter(CONTENDED) == c0 + 1
