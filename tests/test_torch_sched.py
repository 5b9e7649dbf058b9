"""The port's device scheduler (`tempo_tpu_torch.sched`) against the
reference's (`tempo_tpu.sched`), and the span-metrics scheduler route.

Scheduler mechanics (tests/test_sched.py): each scenario runs once on
each package's `DeviceScheduler` (driven by hand, `start_worker=False`,
under a fake clock where a window matters) and what the dispatches
received, the order they ran in and the scheduler's counters must be
equal: the coalescer's padded tensors and packed matrix, chunking at
`max_batch_rows`, deadline and occupancy close, priority order, shed
accounting, a flush from inside a job, error propagation, `run` and its
`QueryStats`, `WindowTuner.choice`, the devtime ledger and cost model.

The write path: the span-metrics scheduler route against the direct
route (counts, histogram buckets and DDSketch grids bit-identical; f32
sums at rtol 1e-5), against the reference's scheduler route on the same
merged windows, across tenants, disabled or absent, behind a collection,
and under compact state against the direct route fed the same merged
windows. Also: K1's plan cache from two threads, and the `tempo_sched_*`
exposition read with the reference's `parse_exposition`.
"""

from __future__ import annotations

import sys
import threading
import time

import numpy as np
import pytest
import torch

from tempo_tpu import sched as jsched
from tempo_tpu.obs import devtime as jdevtime
from tempo_tpu.obs import querystats as jqs
from tempo_tpu.obs import registry as jreg_mod
from tempo_tpu.obs.jaxruntime import RUNTIME as J_RUNTIME
from tempo_tpu.obs.registry import parse_exposition

import tempo_tpu_torch as tt
from tempo_tpu_torch import sched as tsched
from tempo_tpu_torch.model.otlp import encode_spans_otlp, synthetic_spans
from tempo_tpu_torch.obs import devtime as tdevtime
from tempo_tpu_torch.obs import querystats as tqs
from tempo_tpu_torch.obs import registry as treg_mod
from tempo_tpu_torch.obs.runtime import RUNTIME as T_RUNTIME
from tempo_tpu_torch.ops import cuda_kernels as ck
from tempo_tpu_torch.registry import pages as tpages
from tempo_tpu_torch.utils import faults as tfaults
from tests.test_torch_spanmetrics import (POOL, SM, T0, _compare_collect,
                                          _payload, _push, _worlds)

KERNEL = "spanmetrics_fused_update"
BOTH = ((jsched, jdevtime, jqs), (tsched, tdevtime, tqs))


@pytest.fixture(autouse=True)
def _singletons():
    """The port's process scheduler, devtime ledger and fault points reset
    around each test (the reference's are reset by tests/conftest.py)."""
    tsched.reset()
    tfaults.reset()
    yield
    tsched.reset()
    tfaults.reset()
    jdevtime.reset()


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _manual(mod, cfg=None, now=None, **kw):
    return mod.DeviceScheduler(mod.SchedConfig(**(cfg or {}), **kw),
                               now=now or time.monotonic, start_worker=False)


def _on_both(scenario):
    """Run `scenario(sched_module, devtime_module, querystats_module)` for
    the reference and the port; both results must be equal."""
    ref, port = (scenario(*mods) for mods in BOTH)
    assert port == ref
    return port


def _stats(sc):
    return dict(jobs=dict(sc.jobs_total), shed=dict(sc.shed_total),
                batches=dict(sc.batches_total),
                coalesced=dict(sc.coalesced_total),
                waste=dict(sc.padding_waste_bytes),
                warm=dict(sc.bucket_warmups), errors=sc.dispatch_errors,
                occ=sc.mean_occupancy(), pending=sc.pending())


# ---------------------------------------------------------------------------
# scheduler mechanics, the port against the reference
# ---------------------------------------------------------------------------

def test_bucket_rows_and_pressure_law_match_reference():
    for n in (0, 1, 63, 64, 65, 300, 16384, 16385):
        for lo, hi in ((64, None), (16, None), (64, 256), (1, 8)):
            assert tsched.bucket_rows(n, lo, hi) == \
                jsched.bucket_rows(n, lo, hi)
    assert tt.device.bucket_rows is tsched.bucket_rows
    for p in np.linspace(-0.5, 1.5, 41):
        for start, floor in ((0.5, 0.05), (0.0, 0.1), (1.0, 0.2), (0.9, 0.5)):
            assert tsched.fraction_for_pressure(p, start, floor) == \
                jsched.fraction_for_pressure(p, start, floor)


def test_window_tuner_choice_matches_reference():
    """The same cost-model observations and arrival stream give the same
    (window, bucket target) under a fake clock, cold (None) then warm."""
    def scenario(mod, dt, _):
        clock = FakeClock()
        cfg = mod.SchedConfig(tuning="auto")
        tuner = mod.WindowTuner(now=clock)
        picks = [tuner.choice("k", cfg)]            # cold: static window
        rng = np.random.default_rng(3)
        for bucket in (64, 128, 256, 512, 1024):
            for _ in range(60):
                rows = int(rng.integers(bucket // 2, bucket + 1))
                dt.COST_MODEL.observe("k", bucket, rows,
                                      2e-4 + 1e-7 * rows * rng.uniform(0.9, 1.1))
        for step in range(6):
            tuner.note_rows("k", 2000 * (step + 1))
            clock.t += 0.6
            picks.append(tuner.choice("k", cfg))
        picks.append(dt.COST_MODEL.predict("k", 300, 200))
        dt.reset()
        return picks

    picks = _on_both(scenario)
    assert picks[0] is None and all(p is not None for p in picks[1:])


def test_coalescer_padded_tensor_and_packed_matrix_match_reference():
    """tests/test_sched.py:55,83: three jobs → one padded dispatch (pads
    -1 / 0); pack=True → one [n_roles, bucket] f32 matrix."""
    def scenario(mod, *_):
        sc = _manual(mod)
        got = []
        for base in (0, 10, 20):
            sc.submit_rows("k", "a", (np.arange(base, base + 5, dtype=np.int32),
                                      np.full(5, 2.0, np.float32)), 5,
                           lambda s, w: got.append((s.tolist(), w.tolist())),
                           pads=(-1, 0.0))
        for base in (0, 100):
            sc.submit_rows("p", "m", (np.arange(base, base + 5, dtype=np.float32),
                                      np.full(5, 2.5, np.float32)), 5,
                           lambda mat: got.append((mat.dtype.str,
                                                   mat.tolist())),
                           pads=(-1.0, 0.0), pack=True)
        sc.drain_once(force=True)
        return got, _stats(sc)

    got, st = _on_both(scenario)
    assert len(got) == 2 and len(got[0][0]) == 64 and st["batches"]["k"] == 1
    assert st["waste"]["k"] == (64 - 15) * 8


def test_merge_keys_and_chunking_match_reference():
    """Distinct merge keys never merge (:128); a group past
    `max_batch_rows` dispatches in chunks (:143)."""
    def scenario(mod, *_):
        sc = _manual(mod)
        calls = []
        for key in ("a", "b", "a"):
            sc.submit_rows("k", key, (np.zeros(4, np.int32),), 4,
                           lambda s, key=key: calls.append((key, len(s))),
                           pads=(-1,))
        sc.drain_once(force=True)
        sc2 = _manual(mod, max_batch_rows=128, min_bucket_rows=64)
        for _ in range(4):
            sc2.submit_rows("k", "m", (np.zeros(100, np.int32),), 100,
                            lambda s: calls.append(("c", len(s))), pads=(-1,))
        sc2.drain_once(force=True)
        return sorted(calls), _stats(sc), _stats(sc2)

    calls, st, st2 = _on_both(scenario)
    assert st["batches"]["k"] == 2 and st2["batches"]["k"] == 4


def test_deadline_and_occupancy_close_match_reference():
    """:161 (a window closes at its deadline) and :178 (occupancy closes
    it before the deadline), under a fake clock."""
    def scenario(mod, *_):
        clock = FakeClock()
        sc = _manual(mod, dict(batch_window_ms=10.0, occupancy_target=1.0,
                               max_batch_rows=1 << 20), now=clock)
        seen = []
        sc.submit_rows("k", "m", (np.zeros(8, np.int32),), 8,
                       lambda s: seen.append(("deadline", clock.t)), pads=(-1,))
        for dt in (0.0, 0.005, 0.006):
            clock.t += dt
            sc.drain_once()
            seen.append(sc.pending())
        sc2 = _manual(mod, dict(batch_window_ms=10_000.0, occupancy_target=0.5,
                                max_batch_rows=1000), now=clock)
        for n in (100, 450):
            sc2.submit_rows("k", "m", (np.zeros(n, np.int32),), n,
                            lambda s: seen.append(("occupancy", len(s))),
                            pads=(-1,))
            sc2.drain_once()
            seen.append(sc2.pending())
        return seen

    assert _on_both(scenario) == [1, 1, ("deadline", 1000.011), 0, 1,
                                  ("occupancy", 1024), 0]


def test_priority_order_and_shed_accounting_match_reference():
    """:199 ingest > query > compaction (compaction waits for an idle
    cycle); :234 a full ingest queue runs the excess inline (shed) and
    the queued pair merges into one dispatch."""
    def scenario(mod, *_):
        clock = FakeClock()
        sc = _manual(mod, dict(batch_window_ms=0.0), now=clock)
        order = []
        for tag, prio in (("compaction", mod.PRIO_COMPACTION),
                          ("query", mod.PRIO_QUERY)):
            job = mod.Job(priority=prio, kernel=tag,
                          fn=lambda tag=tag: order.append(tag))
            with sc._cond:
                sc._queues[prio].append(job)
        sc.submit_rows("k", "m", (np.zeros(4, np.int32),), 4,
                       lambda s: order.append("ingest"), pads=(-1,))
        sc.drain_once()
        order.append("|")
        sc.drain_once()
        shed = _manual(mod, max_queue_ingest=2)
        rows = []
        for _ in range(4):
            shed.submit_rows("k", "m", (np.zeros(4, np.int32),), 4,
                             lambda s: rows.append(int((s >= 0).sum())),
                             pads=(-1,))
        rows.append("|")
        shed.drain_once(force=True)
        return order, rows, _stats(shed)

    order, rows, st = _on_both(scenario)
    assert order == ["ingest", "query", "|", "compaction"]
    assert rows == [4, 4, "|", 8] and st["shed"]["ingest"] == 2


def test_run_inline_queued_and_shed_match_reference():
    """:251 a full query class sheds `run` inline; :262 `run` is inline
    when idle and queued (then drained) when busy."""
    def scenario(mod, *_):
        sc = _manual(mod, max_queue_query=1)
        out = [sc.run(lambda: 7)]                     # idle: inline
        sc.submit_rows("k", "m", (np.zeros(4, np.int32),), 4, lambda s: None,
                       pads=(-1,))
        done = {}
        t = threading.Thread(target=lambda: done.setdefault(
            "v", sc.run(lambda: 9)))
        t.start()
        deadline = time.monotonic() + 2.0
        while not sc._queues[mod.PRIO_QUERY] and time.monotonic() < deadline:
            time.sleep(0.001)
        out.append(len(sc._queues[mod.PRIO_QUERY]))
        out.append(sc.run(lambda: "shed"))           # class full: inline
        sc.drain_once(force=True)
        t.join(2.0)
        out.append(done.get("v"))
        return out, _stats(sc)

    out, st = _on_both(scenario)
    assert out == [7, 1, "shed", 9] and st["shed"]["query"] == 1


def test_flush_inside_a_job_does_not_deadlock():
    """:287 a dispatched job that flushes drains the queued work on its
    own thread instead of waiting for itself."""
    def scenario(mod, *_):
        sc = _manual(mod, batch_window_ms=60_000.0)
        seen = []

        def outer():
            sc.submit_rows("k", "m", (np.zeros(4, np.int32),), 4,
                           lambda s: seen.append("ingest"), pads=(-1,))
            seen.append(sc.flush(timeout=2.0))
            seen.append("outer-done")

        job = mod.Job(priority=mod.PRIO_QUERY, kernel="q", fn=outer)
        with sc._cond:
            sc._queues[mod.PRIO_QUERY].append(job)
        sc.drain_once(force=True)
        job.wait(2.0)
        return seen

    assert _on_both(scenario) == ["ingest", True, "outer-done"]


def test_errors_propagate_and_count_match_reference():
    """:310 a fn job's error reaches its waiting caller and is no dispatch
    error; :329 a failed ingest dispatch lands on `Job.error` and in
    `dispatch_errors` (then in the exposition), never elsewhere; the
    `sched.dispatch` fault point fails a dispatch the same way."""
    def scenario(mod, *_):
        sc = _manual(mod)

        def boom():
            raise RuntimeError("kernel exploded")

        fn_job = mod.Job(priority=mod.PRIO_QUERY, kernel="q", fn=boom)
        with sc._cond:
            sc._queues[mod.PRIO_QUERY].append(fn_job)
        sc.drain_once(force=True)
        out = [type(fn_job.error).__name__, sc.dispatch_errors]

        def bad(s):
            raise RuntimeError("scatter failed")

        job = sc.submit_rows("k", "m", (np.zeros(4, np.int32),), 4, bad,
                             pads=(-1,))
        sc.drain_once(force=True)
        out += [str(job.error), sc.dispatch_errors]
        with pytest.raises(RuntimeError, match="scatter failed"):
            job.wait(1.0)
        return out

    assert _on_both(scenario) == ["RuntimeError", 0, "scatter failed", 1]
    sc = _manual(tsched)
    spec = tfaults.FaultSpec(point="sched.dispatch", probability=1.0,
                             error="OSError")
    ran = []
    with tfaults.use([spec]):
        job = sc.submit_rows("k", "m", (np.zeros(4, np.int32),), 4,
                             lambda s: ran.append(1), pads=(-1,))
        sc.drain_once(force=True)
    assert isinstance(job.error, OSError) and not ran
    assert sc.dispatch_errors == 1 and tfaults.STATS == {}


def test_run_threads_query_stats_into_jobs():
    """:584 `run` from a busy scheduler: the job runs on the draining
    thread inside the caller's QueryStats scope."""
    def scenario(mod, _, qs):
        sc = _manual(mod)
        sc.submit_rows("k", "m", (np.zeros(4, np.int32),), 4, lambda s: None,
                       pads=(-1,))
        with qs.scope() as st:
            def runner():
                with qs.scope(st):
                    sc.run(lambda: qs.add(inspected_spans=5),
                           kernel="test_kernel")

            t = threading.Thread(target=runner)
            t.start()
            deadline = time.monotonic() + 2.0
            while not sc._queues[mod.PRIO_QUERY] and \
                    time.monotonic() < deadline:
                time.sleep(0.001)
            sc.drain_once(force=True)
            t.join(2.0)
        return st.sched_jobs, st.inspected_spans, "sched_wait" in st.stage_ns

    assert _on_both(scenario) == (1, 5, True)


def test_devtime_ledger_and_cost_model_match_reference():
    """The same dispatches give the same ledger cells, tenant split and
    status, and the same cost-model coefficients and predictions."""
    def scenario(_, dt, __):
        led, cm = dt.DeviceTimeLedger(), dt.CostModel(now=lambda: 5.0)
        rng = np.random.default_rng(11)
        for i in range(120):
            led.record_batch(kernel="k", bucket=64 << (i % 3), prio=i % 3,
                             shards=0, wall_ns=int(rng.integers(1e3, 1e6)),
                             rows=i, padded_rows=3, queue_wait_ns=7,
                             h2d_bytes=100,
                             tenant_rows={"a": i, "b": 1} if i % 4 else None)
            cm.observe("k", 64 << (i % 3), int(rng.integers(1, 64 << (i % 3))),
                       float(rng.uniform(1e-5, 1e-3)))
        return (led.snapshot(), led.tenant_device_ns(), led.total_device_ns(),
                cm.status(), [cm.predict("k", b, 50) for b in (64, 100, 512)],
                cm.warm_pairs())

    snap, tenants, *_ = _on_both(scenario)
    assert len(snap) == 3 and set(tenants) == {"a", "b", "_unattributed"}


# ---------------------------------------------------------------------------
# the span-metrics scheduler route
# ---------------------------------------------------------------------------

def _tworlds(layout, **sm):
    """(clock, port instance on the scheduler route, port instance on the
    direct route), span metrics only, on `layout` state."""
    clock = [T0]
    insts = []
    for use in (True, False):
        pool = POOL if layout == "paged" else None
        with tpages.use(pool and tpages.PagePool(tpages.PagePoolConfig(**pool),
                                                 device="cpu")):
            insts.append(tt.GeneratorInstance("t", tt.GeneratorConfig(
                processors=("span-metrics",),
                registry=tt.RegistryOverrides(max_active_series=1024),
                spanmetrics=tt.SpanMetricsConfig(use_scheduler=use, **SM, **sm)),
                now=lambda: clock[0], device="cpu"))
    assert insts[0].state_layout == insts[1].state_layout == layout
    return clock, insts[0], insts[1]


def _tpush(g, data, sizes=None):
    sb = tt.otlp_proto_to_batch(data, tt.SpanBatchBuilder(g.registry.interner))
    if sizes is not None:
        sizes = np.resize(sizes, sb.capacity).astype(np.float32)
    g.push_batch(sb, sizes)


def _compare_states(a, b, ctx):
    """Two port instances fed the same pushes in the same order: their
    slots agree, so every state plane compares row for row (counts and
    grids exact, sums at rtol 1e-5), and so do their samples."""
    pa, pb = a.processors["span-metrics"], b.processors["span-metrics"]
    for r, (x, y) in enumerate(zip(_planes(pa), _planes(pb))):
        if r in (1, 3):          # latency sum, size sum
            torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6,
                                       msg=f"{ctx}: role {r}")
        else:
            assert torch.equal(x, y), f"{ctx}: role {r}"
    _compare_collect(a, b, ctx)


def _planes(proc):
    if proc._paged:
        return [p.data for p in proc._paged_planes()]
    return list(proc._dense_views())


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_sched_route_equals_direct_route(layout):
    """:105 pushes coalesced into merged windows (three pushes, then two)
    leave the state the direct route leaves; DDSketch quantiles equal."""
    _, gs, gd = _tworlds(layout)
    sc = tsched.DeviceScheduler(tsched.SchedConfig(), start_worker=False)
    with tsched.use(sc):
        for seed in range(5):
            data = _payload(seed, T0)
            _tpush(gs, data, np.arange(600.0))
            _tpush(gd, data, np.arange(600.0))
            if seed in (2, 4):
                sc.drain_once(force=True)
        assert sc.batches_total[KERNEL] == 2
        assert sc.coalesced_total[KERNEL] == 5
        # windows of 3 and 2 pushes of 1,024 rows: buckets 4,096 and 2,048
        assert sc.bucket_warmups[KERNEL] == 2
    _compare_states(gs, gd, layout)
    ps, pd = gs.processors["span-metrics"], gd.processors["span-metrics"]
    assert ps.quantiles((0.5, 0.99)) == pd.quantiles((0.5, 0.99))
    snap = tdevtime.LEDGER.snapshot()
    assert {k[0] for k in snap} == {KERNEL}
    assert sum(c["batches"] for c in snap.values()) == 2
    assert tdevtime.LEDGER.tenant_device_ns().keys() == {"t"}


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_sched_route_matches_reference_sched_route(layout):
    """Both packages' scheduler routes on the same merged windows (two
    pushes a window): counts exact, sums at rtol 1e-5, DDSketch
    quantiles equal."""
    pool = POOL if layout == "paged" else None
    _, jg, tg = _worlds(jsm=dict(use_scheduler=True),
                        tsm=dict(use_scheduler=True), pool=pool)
    jsc = jsched.DeviceScheduler(jsched.SchedConfig(), start_worker=False)
    tsc = tsched.DeviceScheduler(tsched.SchedConfig(), start_worker=False)
    with jsched.use(jsc), tsched.use(tsc):
        for seed in range(4):
            _push(jg, tg, _payload(seed, T0))
            if seed % 2:
                jsc.drain_once(force=True)
                tsc.drain_once(force=True)
        assert _stats(tsc)["batches"] == _stats(jsc)["batches"] == {KERNEL: 2}
        assert _compare_collect(jg, tg, layout) > 1000
        jp, tp = jg.processors["span-metrics"], tg.processors["span-metrics"]
        for q in (0.5, 0.99):
            assert tp.quantile(q) == jp.quantile(q)


def test_cross_tenant_merge_matches_unbatched():
    """:470 two tenants' interleaved pushes through one scheduler: each
    tenant's state equals its direct-route twin's; both shared the drain
    cycles (one merged dispatch each)."""
    sc = tsched.DeviceScheduler(tsched.SchedConfig(), start_worker=False)
    worlds = [_tworlds("dense") for _ in range(2)]
    with tsched.use(sc):
        for seed in range(6):
            for k, (_, gs, gd) in enumerate(worlds):
                data = _payload(100 * k + seed, T0, n=200)
                _tpush(gs, data)
                _tpush(gd, data)
        sc.flush()
    for k, (_, gs, gd) in enumerate(worlds):
        _compare_states(gs, gd, f"tenant {k}")
    assert sc.coalesced_total[KERNEL] == 12 and sc.batches_total[KERNEL] == 2


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_disabled_or_absent_scheduler_is_bit_identical(layout):
    """:509 the flag off with a scheduler present, the flag on with none,
    and the flag on with a disabled one all take the direct route: state
    bit-identical, nothing rode a scheduler."""
    worlds = [_tworlds(layout) for _ in range(2)]
    (_, on_none, off_present), (_, on_disabled, _) = worlds
    present = tsched.DeviceScheduler(tsched.SchedConfig(), start_worker=False)
    disabled = tsched.DeviceScheduler(tsched.SchedConfig(enabled=False),
                                      start_worker=False)
    for seed in range(3):
        data = _payload(seed, T0)
        with tsched.use(present):
            _tpush(off_present, data)
        with tsched.use(None):
            _tpush(on_none, data)
        with tsched.use(disabled):
            _tpush(on_disabled, data)
    for other in (on_none, on_disabled):
        for x, y in zip(_planes(off_present.processors["span-metrics"]),
                        _planes(other.processors["span-metrics"])):
            assert torch.equal(x, y)
    assert present.jobs_total["ingest"] == disabled.jobs_total["ingest"] == 0


def test_collect_flushes_queued_batches():
    """:554 with a far window the push stays queued until the collection
    tick, whose drain flushes it."""
    sc = tsched.DeviceScheduler(tsched.SchedConfig(batch_window_ms=60_000.0),
                                start_worker=False)
    with tsched.use(sc):
        g = tt.GeneratorInstance("t", tt.GeneratorConfig(
            registry=tt.RegistryOverrides(max_active_series=1024),
            spanmetrics=tt.SpanMetricsConfig(**SM)),
            now=lambda: T0, device="cpu")
        _tpush(g, _payload(1, T0, n=50))
        assert sc.pending() == 1
        assert g.collect_and_push() > 0
        assert sc.pending() == 0
        calls = sum(s.value for s in g.registry.collect(2)
                    if s.name == "traces_spanmetrics_calls_total")
    assert calls == 50


def test_compact_sched_route_equals_direct_route_on_merged_windows():
    """Compact K1 rounds each cell's whole-dispatch delta once, so the
    scheduler route (three pushes a window) is held against the direct
    route fed each merged window as one push: counts, buckets and the
    DDSketch grid exact, the folded bf16 pair and sizes at rtol 1e-5."""
    sm = dict(sketch="both", compact_state=True)
    _, gs, gd = _tworlds("paged", **sm)
    sc = tsched.DeviceScheduler(tsched.SchedConfig(), start_worker=False)
    with tsched.use(sc):
        for window in range(2):
            spans = [synthetic_spans(150, seed=10 * window + k,
                                     now_ns=int(T0 * 1e9), n_services=4,
                                     n_ops=6) for k in range(3)]
            for part in spans:
                _tpush(gs, encode_spans_otlp(part))
            _tpush(gd, encode_spans_otlp([s for p in spans for s in p]))
            sc.drain_once(force=True)
        assert sc.batches_total[KERNEL] == 2
        assert sc.coalesced_total[KERNEL] == 6
    ja = {(s.name, s.labels): s.value for s in gs.registry.collect(1)}
    jb = {(s.name, s.labels): s.value for s in gd.registry.collect(1)}
    assert ja.keys() == jb.keys() and len(ja) > 100
    for k, v in ja.items():
        if k[0].endswith("_sum") or k[0] == "traces_spanmetrics_size_total":
            assert v == pytest.approx(jb[k], rel=1e-5), k
        else:
            assert v == jb[k], k
    ps, pd = gs.processors["span-metrics"], gd.processors["span-metrics"]
    assert ps.dd_quantiles((0.5, 0.99)) == pd.dd_quantiles((0.5, 0.99))
    rs, rd = _moment_rows(ps), _moment_rows(pd)      # pad rows drop here too
    assert rs.keys() == rd.keys() and rs
    for k, row in rs.items():
        np.testing.assert_allclose(row, rd[k], rtol=1e-5, atol=1e-6,
                                   err_msg=str(k))


def _moment_rows(proc):
    """{labels: moments row} of the processor's sketch slots."""
    from tempo_tpu_torch.generator.processors.spanmetrics import _MOMENTS

    with proc.registry.state_lock:
        slots = proc._sketch_slots()
        rows = proc._rows(slots, _MOMENTS).numpy()
    return {proc.calls.labels_of(int(s)): rows[i]
            for i, s in enumerate(slots.tolist())}


def test_worker_thread_coalesces_and_stops():
    """The worker thread closes windows by deadline on its own; `stop`
    flushes and joins it."""
    _, gs, gd = _tworlds("dense")
    sc = tsched.DeviceScheduler(tsched.SchedConfig(batch_window_ms=20.0))
    with tsched.use(sc):
        for seed in range(3):
            data = _payload(seed, T0, n=100)
            _tpush(gs, data)
            _tpush(gd, data)
        deadline = time.monotonic() + 5.0
        while sc.pending() and time.monotonic() < deadline:
            time.sleep(0.005)
        assert sc.pending() == 0 and sc.batches_total[KERNEL] >= 1
    sc.stop()
    assert sc._worker is None
    _compare_states(gs, gd, "worker")


def test_k1_plan_cache_from_many_threads():
    """K1's plan lookup and insert, and its launch counts, are guarded:
    eight threads (more than this box's cores, with a shortened switch
    interval) asking at once for the same tensors' plan build one; their
    launch counts add up."""
    tables = torch.full((5, 4), -1, dtype=torch.int32)
    arenas = tuple(torch.zeros(256) for _ in range(4)) + (
        torch.zeros(256, 16),)
    kw = dict(page_rows=64, edges=tuple(float(e) for e in range(15)),
              gamma=1.02, min_value=1e-6, dd_rows=0, mom_rows=0,
              mom_meta=None, compact=False)
    tensors = (tables, *arenas)
    key = (*kw.values(), *map(id, tensors))
    built = []

    def build():
        time.sleep(0.01)          # widen the race
        built.append(1)
        return ck._Plan(tables, arenas, None, kw["page_rows"], kw["edges"],
                        kw["gamma"], kw["min_value"], 0, 0, None, False)

    before = ck.paged_fused_update.plans
    launches = ck.paged_fused_update.launches
    n_threads, n_counts = 8, 2000
    barrier = threading.Barrier(n_threads)
    got = []

    def worker():
        barrier.wait()
        got.append(ck._plan_for(key, tensors, build))
        for _ in range(n_counts):
            ck._count(ck.paged_fused_update, 1)

    threads = [threading.Thread(target=worker) for _ in range(n_threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(5)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(built) == 1 and all(p is got[0] for p in got)
    assert len(got) == n_threads
    assert ck.paged_fused_update.plans == before + 1
    assert ck.paged_fused_update.launches == launches + n_threads * n_counts
    other = torch.full((5, 4), -1, dtype=torch.int32)
    ck._plan_for((*kw.values(), *map(id, (other, *arenas))),
                 (other, *arenas), build)
    assert ck.paged_fused_update.plans == before + 2


# ---------------------------------------------------------------------------
# exposition
# ---------------------------------------------------------------------------

SCHED_FAMILIES = (
    "tempo_sched_queue_depth", "tempo_sched_queue_limit",
    "tempo_sched_jobs_total", "tempo_sched_shed_jobs_total",
    "tempo_sched_batches_total", "tempo_sched_coalesced_jobs_total",
    "tempo_sched_padding_waste_bytes_total",
    "tempo_sched_bucket_warmups_total", "tempo_sched_batch_occupancy_ratio",
    "tempo_sched_dispatch_duration_seconds", "tempo_sched_queue_wait_seconds")


def test_sched_exposition_parses_with_reference_and_has_its_families():
    """:652 the port's RUNTIME renders the scheduler families; the
    reference's parser reads them, and every `tempo_sched_*` /
    `tempo_devtime_*` family of the reference's runtime registry is
    there under the same name, type and labels."""
    sc = tsched.configure(tsched.SchedConfig(batch_window_ms=0.0))
    sc.submit_rows("k", "m", (np.zeros(4, np.int32),), 4, lambda s: None,
                   pads=(-1,))
    sc.flush()
    fams = parse_exposition(T_RUNTIME.render())
    for name in SCHED_FAMILIES + ("tempo_torch_k1_launch_plans_total",
                                  "tempo_torch_kernel_launches_total",
                                  "tempo_faults_injected_total"):
        assert name in fams, name
    key = ("tempo_sched_jobs_total", (("class", "ingest"),))
    assert fams["tempo_sched_jobs_total"]["samples"][key] >= 1.0
    jsc = jsched.configure(jsched.SchedConfig(batch_window_ms=0.0))
    jsc.submit_rows("k", "m", (np.zeros(4, np.int32),), 4, lambda s: None,
                    pads=(-1,))
    jsc.flush()
    ref = parse_exposition(J_RUNTIME.render())
    mine = {n: f for n, f in fams.items()
            if n.startswith(("tempo_sched_", "tempo_devtime_"))}
    theirs = {n: f for n, f in ref.items()
              if n.startswith(("tempo_sched_", "tempo_devtime_"))}
    assert mine.keys() == theirs.keys()
    for n in mine:
        assert mine[n]["type"] == theirs[n]["type"], n
        assert {tuple(k for k, _ in lbl) for _, lbl in mine[n]["samples"]} \
            <= {tuple(k for k, _ in lbl) for _, lbl in theirs[n]["samples"]} \
            or not theirs[n]["samples"], n
    jsched.reset()


def test_registry_renders_byte_compatible_with_reference():
    """The port's `obs.registry` renders the same families, samples and
    escapes byte for byte as the reference's."""
    out = []
    for mod in (jreg_mod, treg_mod):
        r = mod.Registry()
        c = r.counter("a_total", 'help with "quotes" and \\ and\nnewline',
                      labels=("x", "y"))
        c.inc(3, ("v\n1", 'q"2'))
        c.inc(1.5, ("b", "c"))
        g = r.gauge("b_gauge", "g", labels=())
        g.set(-2.25)
        h = r.histogram("c_seconds", "h", labels=("k",),
                        buckets=mod.exponential_buckets(1e-3, 2.0, 6))
        for v in (0.0005, 0.003, 0.05, 7.0):
            h.observe(v, ("z",))
        r.gauge_func("d", lambda: [(("p",), 1.0)], help="d", labels=("l",))
        out.append(r.render())
    assert out[0] == out[1]
    assert treg_mod.parse_exposition(out[1]) == jreg_mod.parse_exposition(out[0])


def test_runtime_families_and_kernel_timer():
    """The port's RUNTIME keeps the reference's device-put and kernel-time
    family names; `kernel_timer` on host tensors times on the host's
    clock; the K1 plan and launch families read the wrappers' counts."""
    from tempo_tpu_torch.obs import runtime

    with runtime.kernel_timer("t_kernel", device="cpu"):
        torch.ones(4).sum()
    runtime.record_device_put(128, "t_site")
    fams = parse_exposition(T_RUNTIME.render())
    key = ("tempo_jax_device_put_bytes_total", (("site", "t_site"),))
    assert fams["tempo_jax_device_put_bytes_total"]["samples"][key] >= 128
    counts = [v for (name, labels), v in
              fams["tempo_jax_kernel_duration_seconds"]["samples"].items()
              if name.endswith("_count") and dict(labels).get("kernel")
              == "t_kernel"]
    assert counts and counts[0] >= 1
    plans = fams["tempo_torch_k1_launch_plans_total"]["samples"]
    assert list(plans.values()) == [float(ck.paged_fused_update.plans)]
    launches = fams["tempo_torch_kernel_launches_total"]["samples"]
    assert {dict(lbl)["kernel"] for _, lbl in launches} == {
        "paged_fused_update", "fused_spanmetrics_matmul"}
