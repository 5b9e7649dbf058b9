"""The port's ingest pipeline (`generator/pipeline.py`) on the staged fast
route under the port's device scheduler, after the reference's
`tests/test_ingest_pipeline.py`.

Held: the staging-buffer ring recycles after warm-up (no more fresh
buffer sets than the depth allows); `drain()` before a collection sees
every accepted push, agreeing with the route without a scheduler (counts
exact, float sums at rtol 1e-6: merged windows fold their f32 deltas in
another order); `pipeline_depth` 0 turns the ring off; the depth bounds
the batches in flight, the producer stalling on the oldest; the seven
`tempo_ingest_pipeline_*` families are on the process runtime registry;
and producers on several tenants at once, at a short switch interval,
land every weighted span.
"""

from __future__ import annotations

import sys
import threading
import time

import numpy as np
import pytest

import tempo_tpu_torch as tt
from tempo_tpu_torch.generator.pipeline import IngestPipeline
from tempo_tpu_torch.obs.runtime import RUNTIME
from tests.test_torch_native import rich_payload

T0 = 1_700_000_000.0
N = 200


@pytest.fixture(autouse=True)
def _singletons():
    tt.native.load()
    tt.sched.reset()
    yield
    tt.sched.reset()


def _inst(name="t", paged=False):
    from tempo_tpu_torch.registry import pages

    pool = pages.PagePool(tt.PagePoolConfig(enabled=True, page_rows=64,
                                            arena_slots=2048), device="cpu") \
        if paged else None
    with pages.use(pool):
        return tt.GeneratorInstance(name, tt.GeneratorConfig(
            processors=("span-metrics",),
            registry=tt.RegistryOverrides(max_active_series=1024),
            spanmetrics=tt.SpanMetricsConfig(sketch_max_series=256)),
            now=lambda: T0, device="cpu")


def _payload(seed=40):
    return rich_payload(seed, n=N, now_ns=int(T0 * 1e9))


def _calls(g):
    g.drain()
    proc = g.processors["span-metrics"]
    with g.registry.state_lock:
        (vals,) = proc.calls._snap()
    return float(np.asarray(vals)[proc.calls.table.active_slots()].sum())


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_pipeline_buffer_reuse(paged):
    tt.sched.configure(tt.SchedConfig(pipeline_depth=2))
    g = _inst(paged=paged)
    data = _payload()
    for _ in range(6):
        assert g.push_otlp_staged(data) == N
    pipe = g.processors["span-metrics"]._pipe
    assert pipe is not None and pipe.depth == 2
    assert _calls(g) == 6 * N
    assert pipe.submitted_total == 6
    assert pipe.reuse_total >= 3          # the ring recycles after warm-up
    assert pipe.alloc_total <= 3          # depth + 1 fresh sets at most
    assert pipe.in_flight() == 0          # drained
    assert pipe.decode_ns > 0 and 0.0 <= pipe.overlap_ratio() <= 1.0


def _sample_weighted(g, data, seed):
    st = tt.stage_otlp(data, g.registry.interner, include_span_attrs=False)
    st.sample_weight = np.random.default_rng(seed).integers(
        1, 4, st.n).astype(np.float32)
    return g.push_staged_view(st.view())


@pytest.mark.parametrize("depth", [2, 0])
def test_drain_before_collect_matches_the_direct_route(depth):
    """`collect_and_push` drains the scheduler and the ring first: the
    collected samples equal the route without a scheduler's. Depth 0
    turns the ring off (every push allocates its staging)."""
    payloads = [_payload(41 + k) for k in range(4)]

    def run(cfg):
        tt.sched.reset()
        if cfg is not None:
            tt.sched.configure(cfg)
        g = _inst()
        for k, data in enumerate(payloads):
            assert _sample_weighted(g, data, k) == N
        n = g.collect_and_push(ts_ms=12345)
        pipe = g.processors["span-metrics"]._pipe
        out = {(s.name, s.labels): s.value
               for s in g.registry.collect(ts_ms=12345)}
        assert n == len(out)
        tt.sched.reset()
        return out, pipe

    base, none = run(None)
    got, pipe = run(tt.SchedConfig(pipeline_depth=depth))
    assert none is None
    assert (pipe is None) == (depth == 0)
    if pipe is not None:
        assert pipe.in_flight() == 0 and pipe.submitted_total == 4
    assert got.keys() == base.keys()
    for k, v in got.items():
        b = base[k]
        if k[0] == "traces_spanmetrics_size_total" or k[0].endswith("_sum"):
            assert abs(v - b) <= 1e-6 * abs(b), k
        else:
            assert v == b, k


class _Job:
    def __init__(self):
        self.event = threading.Event()


def test_pipeline_depth_bounds_inflight():
    pipe = IngestPipeline(depth=2)
    b1 = pipe.acquire(256, 4)
    j1 = _Job()
    pipe.track(j1, b1)
    b2 = pipe.acquire(256, 4)
    j2 = _Job()
    pipe.track(j2, b2)
    assert pipe.in_flight() == 2
    # a third acquire blocks on the OLDEST job; a timer releases it
    timer = threading.Timer(0.05, j1.event.set)
    timer.start()
    t0 = time.perf_counter()
    b3 = pipe.acquire(256, 4)
    assert time.perf_counter() - t0 >= 0.04     # it waited
    assert pipe.stall_ns > 0
    assert b3 is b1                             # recycled, not fresh
    j2.event.set()
    assert pipe.drain(timeout_s=5.0)
    assert pipe.in_flight() == 0
    timer.join(5.0)
    assert not timer.is_alive()
    pipe.release(b3)
    assert pipe.acquire(256, 4) is b3 and pipe.alloc_total == 2


def test_pipeline_families_registered():
    text = RUNTIME.render()
    for fam in ("tempo_ingest_pipeline_inflight",
                "tempo_ingest_pipeline_batches_total",
                "tempo_ingest_pipeline_staging_reuse_total",
                "tempo_ingest_pipeline_staging_alloc_total",
                "tempo_ingest_pipeline_decode_seconds_total",
                "tempo_ingest_pipeline_stall_seconds_total",
                "tempo_ingest_pipeline_overlap_ratio"):
        assert f"# TYPE {fam} " in text, fam


def _samples(g):
    g.drain()
    return {(s.name, s.labels): s.value for s in g.registry.collect(1)}


def test_producers_on_many_tenants_land_every_span():
    """Nine producer threads, one tenant each, push weighted staged views
    of different payloads through one scheduler with the ring on, at a
    1 µs switch interval: every tenant's samples (calls, latency
    histogram, size) equal those of a twin fed the same pushes without a
    scheduler, the float sums at rtol 1e-6 (a buffer set recycled before
    its dispatch had read it would carry another push's durations and
    sizes)."""
    tt.sched.configure(tt.SchedConfig(pipeline_depth=2))
    insts = [_inst(f"t{j}") for j in range(9)]
    pushes = [[(_payload(60 + 5 * j + k), np.random.default_rng(
        10 * j + k).integers(1, 4, N).astype(np.float32)) for k in range(3)]
        for j in range(len(insts))]
    errors = []

    def producer(j, g):
        try:
            for data, w in pushes[j]:
                st = tt.stage_otlp(data, g.registry.interner,
                                   include_span_attrs=False)
                st.sample_weight = w
                g.push_staged_view(st.view())
        except BaseException as e:   # noqa: BLE001 — re-raised below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=producer, args=(j, g))
                   for j, g in enumerate(insts)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(30.0)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors[0]
    got = [_samples(g) for g in insts]
    pipes = [g.processors["span-metrics"]._pipe for g in insts]
    assert all(p.submitted_total == 3 and p.in_flight() == 0 for p in pipes)
    assert sum(p.reuse_total for p in pipes) > 0
    tt.sched.reset()
    for j in range(len(insts)):
        twin = _inst(f"t{j}")
        producer(j, twin)
        want = _samples(twin)
        assert got[j].keys() == want.keys()
        for k, v in got[j].items():
            sums = k[0].endswith(("_sum", "size_total"))
            assert abs(v - want[k]) <= 1e-6 * abs(want[k]) if sums \
                else v == want[k], k
        calls = sum(v for k, v in got[j].items()
                    if k[0] == "traces_spanmetrics_calls_total")
        assert calls == sum(float(w.sum()) for _, w in pushes[j])
