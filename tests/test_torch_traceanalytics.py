"""The trace-analytics processor
(`tempo_tpu_torch/generator/processors/traceanalytics.py`) against the
reference's (`tests/test_traceanalytics.py`'s processor cases), each on
both packages with the same inputs and a pinned clock (the port on the
CPU).

Held: root-cause counters equal exactly, critical-path seconds within
rtol 1e-5, the latency-share moment rows within the write path's
moments rule (ROADMAP section 3: rtol 1e-5 plus 2e-5 a unit of weight,
bounds 2e-6) and their quantiles with them; the late, cut, span, cycle
and orphan counters equal; both caps and `void_keys` as the reference's.
Also: dense against paged state, the scheduler route against the direct
one, the evict hook, the `ta_*` limits through `Generator`, and the
processor's own `aux_checkpoint` → `aux_restore` round trip.

Three reference tests wait for other work, so they are not mirrored:
`test_checkpoint_*` go through `fleet.checkpoint` and
`test_wal_replay_reproduces_planes_bit_identically` through the
generator WAL (ROADMAP section 1, item 12);
`test_quantile_endpoint_serves_latency_shares` through the App's HTTP API
(item 9).
"""

from __future__ import annotations

import numpy as np
import pytest

from tempo_tpu_torch import sched as tsched
from tempo_tpu_torch.generator.processors import traceanalytics as tta
from tempo_tpu_torch.registry import pages as tpages
from tempo_tpu_torch.utils import dataquality as tdq
from tests.test_torch_frontend import mod

T0 = 1_700_000_000.0
SIDES = ("ref", "port")
CP = "tempo_critical_path_seconds_total"
RC = "tempo_error_root_cause_total"


@pytest.fixture(autouse=True)
def _singletons():
    """The port's scheduler, trace-analytics counters and orphan tally
    are process-wide: reset around each test (the reference's are reset
    by tests/conftest.py)."""
    tsched.reset()
    tta.reset_counters()
    tdq.reset_orphan_spans()
    yield
    tsched.reset()
    tta.reset_counters()
    tdq.reset_orphan_spans()


def _ns(s: float) -> int:
    return int(s * 1e9)


def _kw(side):
    return {"device": "cpu"} if side == "port" else {}


def ta_mod(side):
    return mod(side, "generator.processors.traceanalytics")


def ta_inst(side, clock, processors=("trace-analytics",), **kw):
    gi = mod(side, "generator.instance")
    ta = dict(trace_idle_s=1.0, late_window_s=30.0)
    ta.update(kw)
    cfg = gi.GeneratorConfig(
        processors=processors,
        traceanalytics=ta_mod(side).TraceAnalyticsConfig(**ta))
    return gi.GeneratorInstance("t1", cfg, now=lambda: clock[0],
                                **_kw(side))


def builder(side, gi):
    return mod(side, "model.span_batch").SpanBatchBuilder(
        gi.registry.interner)


def known_trace(b):
    """root(svc-a, 10s) -> c1(svc-b, ends 9s, ERR) -> g1(svc-c, ends 8s,
    ERR); root -> c2(svc-b, ends 5s). Critical path root->c1->g1 with
    self-times 1s/1s/7s; both errors root-cause to svc-c."""
    tid = b"\x01" * 16
    b.append(trace_id=tid, span_id=b"\x01" * 8, name="root", service="svc-a",
             start_unix_nano=_ns(T0), end_unix_nano=_ns(T0 + 10))
    b.append(trace_id=tid, span_id=b"\x02" * 8, parent_span_id=b"\x01" * 8,
             name="c1", service="svc-b", status_code=2,
             start_unix_nano=_ns(T0 + 0.5), end_unix_nano=_ns(T0 + 9))
    b.append(trace_id=tid, span_id=b"\x03" * 8, parent_span_id=b"\x02" * 8,
             name="g1", service="svc-c", status_code=2,
             start_unix_nano=_ns(T0 + 1), end_unix_nano=_ns(T0 + 8))
    b.append(trace_id=tid, span_id=b"\x04" * 8, parent_span_id=b"\x01" * 8,
             name="c2", service="svc-b",
             start_unix_nano=_ns(T0 + 0.5), end_unix_nano=_ns(T0 + 5))


def collect(side, gi) -> dict:
    mod(side, "sched").flush()
    return {(s.name, s.labels): s.value
            for s in gi.registry.collect(ts_ms=1) if not s.is_stale_marker}


def val(samples: dict, name: str, **labels) -> float:
    for (n, labs), v in samples.items():
        if n == name and all((k, want) in labs for k, want in labels.items()):
            return v
    raise KeyError((name, labels, sorted(samples)))


def counters(side) -> dict:
    t = ta_mod(side)
    return {k: dict(getattr(t, k)) for k in
            ("_late_spans", "_cut_traces", "_cut_spans", "_cycle_spans",
             "_cp_mirror", "_rc_mirror")}


def same_samples(port: dict, ref: dict) -> None:
    """Root-cause counts exactly, critical-path seconds within rtol 1e-5."""
    assert set(port) == set(ref), (sorted(port), sorted(ref))
    for k, v in ref.items():
        if k[0] == CP:
            assert port[k] == pytest.approx(v, rel=1e-5), k
        else:
            assert port[k] == v, k


def same_counters(port: dict, ref: dict) -> None:
    for k in ("_late_spans", "_cut_traces", "_cut_spans", "_cycle_spans",
              "_rc_mirror"):
        assert port[k] == ref[k], k
    assert set(port["_cp_mirror"]) == set(ref["_cp_mirror"])
    for k, v in ref["_cp_mirror"].items():
        assert port["_cp_mirror"][k] == pytest.approx(v, rel=1e-5), k


def share_rows(side, gi) -> dict:
    """{cp label set: share moment row} of every active cp slot."""
    p = gi.processors["trace-analytics"]
    slots = p.cp.table.active_slots()
    slots = slots[slots < p.cfg.sketch_max_series]
    meta, rows = p.aux_checkpoint(slots)
    out = {}
    for i, r in zip(rows["mom_sel"].tolist(), rows["mom_rows"]):
        out[p.cp.labels_of(int(slots[i]))] = np.asarray(r, np.float64)
    return out


def same_shares(port: dict, ref: dict, k: int = 8) -> None:
    """The write path's moments rule: count and sums within rtol 1e-5
    plus 2e-5 a unit of weight, bounds within 2e-6."""
    assert set(port) == set(ref)
    for lab, r in ref.items():
        p = port[lab]
        w = r[0]
        np.testing.assert_allclose(p[:k + 1], r[:k + 1], rtol=1e-5,
                                   atol=2e-5 * w, err_msg=str(lab))
        np.testing.assert_allclose(p[k + 1:], r[k + 1:], rtol=2e-6,
                                   err_msg=str(lab))


def same_quantiles(port: dict, ref: dict, rel: float) -> None:
    assert set(port) == set(ref)
    for lab, v in ref.items():
        assert port[lab] == pytest.approx(v, rel=rel), lab


# ---------------------------------------------------------------------------
# processor end to end (tests/test_traceanalytics.py's processor cases)
# ---------------------------------------------------------------------------

def _topology(side):
    clock = [T0]
    gi = ta_inst(side, clock)
    b = builder(side, gi)
    known_trace(b)
    tid2 = b"\x02" * 16            # a parent 2-cycle: counted, not attributed
    b.append(trace_id=tid2, span_id=b"\x0a" * 8, parent_span_id=b"\x0b" * 8,
             name="x", service="svc-a",
             start_unix_nano=_ns(T0), end_unix_nano=_ns(T0 + 1))
    b.append(trace_id=tid2, span_id=b"\x0b" * 8, parent_span_id=b"\x0a" * 8,
             name="y", service="svc-a",
             start_unix_nano=_ns(T0), end_unix_nano=_ns(T0 + 1))
    gi.push_batch(b.build())
    clock[0] += 2
    gi.tick()
    got = collect(side, gi)
    assert val(got, CP, service="svc-a", operation="root") == \
        pytest.approx(1.0)
    assert val(got, CP, service="svc-b", operation="c1") == \
        pytest.approx(1.0)
    assert val(got, CP, service="svc-c", operation="g1") == \
        pytest.approx(7.0)
    with pytest.raises(KeyError):
        val(got, CP, operation="c2")
    assert val(got, RC, service="svc-b", root_service="svc-c") == 1.0
    assert val(got, RC, service="svc-c", root_service="svc-c") == 1.0
    assert ta_mod(side)._cycle_spans.get("t1") == 2.0
    assert ta_mod(side)._cut_traces.get("t1") == 2.0
    q = gi.processors["trace-analytics"].quantile(0.5)
    shares = {dict(lab)["operation"]: v for lab, v in q.items()}
    assert shares["g1"] == pytest.approx(0.7, abs=0.05)
    assert shares["root"] == pytest.approx(0.1, abs=0.05)
    return got, counters(side), share_rows(side, gi), q


def test_processor_known_topology_attribution():
    port, ref = _topology("port"), _topology("ref")
    same_samples(port[0], ref[0])
    same_counters(port[1], ref[1])
    same_shares(port[2], ref[2])
    same_quantiles(port[3], ref[3], 1e-6)


def _weighted(side):
    clock = [T0]
    gi = ta_inst(side, clock)
    b = builder(side, gi)
    known_trace(b)
    gi.push_batch(b.build(), sample_weights=np.full(4, 3.0, np.float32))
    clock[0] += 2
    gi.tick()
    got = collect(side, gi)
    assert val(got, CP, service="svc-c", operation="g1") == \
        pytest.approx(21.0)
    assert val(got, RC, service="svc-c", root_service="svc-c") == 3.0
    return got, share_rows(side, gi)


def test_processor_weighted_attribution():
    port, ref = _weighted("port"), _weighted("ref")
    same_samples(port[0], ref[0])
    same_shares(port[1], ref[1])


def _late(side):
    clock = [T0]
    gi = ta_inst(side, clock, late_window_s=10.0)
    b = builder(side, gi)
    known_trace(b)
    gi.push_batch(b.build())
    clock[0] += 2
    gi.tick()
    base = collect(side, gi)
    b2 = builder(side, gi)
    b2.append(trace_id=b"\x01" * 16, span_id=b"\x05" * 8,
              parent_span_id=b"\x01" * 8, name="late", service="svc-b",
              start_unix_nano=_ns(T0), end_unix_nano=_ns(T0 + 20))
    gi.push_batch(b2.build())
    clock[0] += 1
    gi.tick()
    assert ta_mod(side)._late_spans.get("t1") == 1.0
    assert collect(side, gi) == base
    clock[0] += 20                 # past the late window: a NEW trace
    gi.tick()
    gi.push_batch(b2.build())
    assert ta_mod(side)._late_spans.get("t1") == 1.0
    return base, counters(side), \
        gi.processors["trace-analytics"].spans_buffered


def test_late_spans_counted_not_reattributed():
    port, ref = _late("port"), _late("ref")
    same_samples(port[0], ref[0])
    same_counters(port[1], ref[1])
    assert port[2] == ref[2]


def _orphans(side):
    clock = [T0]
    gi = ta_inst(side, clock)
    b = builder(side, gi)
    known_trace(b)
    b.append(trace_id=b"\x01" * 16, span_id=b"\x06" * 8,
             parent_span_id=b"\xee" * 8, name="lost", service="svc-b",
             start_unix_nano=_ns(T0), end_unix_nano=_ns(T0 + 1))
    gi.push_batch(b.build())
    clock[0] += 2
    gi.tick()
    snap = mod(side, "utils.dataquality").orphan_spans_snapshot()
    assert snap.get("t1") == 1
    return snap, collect(side, gi)


def test_orphan_spans_feed_dataquality_counter():
    port, ref = _orphans("port"), _orphans("ref")
    assert port[0] == ref[0]
    same_samples(port[1], ref[1])


def _span_cap(side):
    clock = [T0]
    gi = ta_inst(side, clock, max_spans_per_trace=8)
    b = builder(side, gi)
    tid = b"\x03" * 16
    for i in range(12):
        b.append(trace_id=tid, span_id=bytes([i + 1]) * 8,
                 parent_span_id=b"" if i == 0 else bytes([1]) * 8,
                 name="op", service="svc",
                 start_unix_nano=_ns(T0), end_unix_nano=_ns(T0 + 1))
    gi.push_batch(b.build())
    assert gi.processors["trace-analytics"].spans_buffered == 8
    assert ta_mod(side)._late_spans.get("t1") == 4.0
    gi.tick(immediate=True)
    return collect(side, gi), counters(side)


def test_max_spans_per_trace_overflow_counts_late():
    port, ref = _span_cap("port"), _span_cap("ref")
    same_samples(port[0], ref[0])
    same_counters(port[1], ref[1])


def _trace_cap(side):
    clock = [T0]
    gi = ta_inst(side, clock, max_live_traces=8)
    b = builder(side, gi)
    for i in range(16):
        b.append(trace_id=bytes([i + 1]) * 16, span_id=b"\x01" * 8,
                 name="op", service="svc",
                 start_unix_nano=_ns(T0), end_unix_nano=_ns(T0 + 1))
    gi.push_batch(b.build())
    p = gi.processors["trace-analytics"]
    assert len(p._live) <= 8
    assert ta_mod(side)._cut_traces.get("t1", 0) >= 8
    return sorted(p._live), collect(side, gi), counters(side)


def test_max_live_traces_cuts_oldest_early():
    port, ref = _trace_cap("port"), _trace_cap("ref")
    assert port[0] == ref[0]
    same_samples(port[1], ref[1])
    same_counters(port[2], ref[2])


def test_void_keys_match_byte_concatenation():
    rng = np.random.default_rng(3)
    tid = rng.integers(0, 256, (50, 16), dtype=np.uint8)
    sid = rng.integers(0, 256, (50, 8), dtype=np.uint8)
    for side in SIDES:
        vk = mod(side, "model.span_batch").void_keys
        keys = vk(tid, sid)
        for i in range(50):
            assert keys[i].item() == tid[i].tobytes() + sid[i].tobytes()
        assert vk(tid)[0].item() == tid[0].tobytes()
        order = np.argsort(keys, kind="stable")
        assert order.tolist() == sorted(range(50),
                                        key=lambda i: keys[i].item())


# ---------------------------------------------------------------------------
# the port against the reference on seeded traffic
# ---------------------------------------------------------------------------

def random_push(side, gi, seed, n_traces=24, now=T0, weights=False):
    """Seeded 6-span trace trees over 2 services and 3 operations, about
    a third of the spans errored, pushed interleaved (trace runs out of
    order) when `seed` is odd."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n_traces):
        tid = rng.bytes(16)
        sids = [rng.bytes(8) for _ in range(6)]
        for i in range(6):
            par = b"" if i == 0 else sids[int(rng.integers(0, i))]
            rows.append(dict(
                trace_id=tid, span_id=sids[i], parent_span_id=par,
                name=f"op-{i % 3}", service=f"svc-{i % 2}",
                status_code=int(rng.random() < 0.35) * 2,
                start_unix_nano=_ns(now) + i * 1000,
                end_unix_nano=_ns(now) + int(rng.integers(10**6, 10**9))))
    if seed % 2:
        rows = [rows[i] for i in rng.permutation(len(rows))]
    b = builder(side, gi)
    for r in rows:
        b.append(**r)
    w = (rng.integers(1, 4, len(rows)).astype(np.float32)
         if weights else None)
    gi.push_batch(b.build(), sample_weights=w)


def _traffic(side, seeds, weights):
    clock = [T0]
    gi = ta_inst(side, clock)
    for k, seed in enumerate(seeds):
        random_push(side, gi, seed, now=clock[0], weights=weights)
        clock[0] += 0.5
    gi.tick(immediate=True)
    p = gi.processors["trace-analytics"]
    return (collect(side, gi), counters(side), share_rows(side, gi),
            {q: p.quantile(q) for q in (0.5, 0.9)})


@pytest.mark.parametrize("seeds,weights", [((1,), False), ((2, 3), False),
                                           ((4, 5, 6), True)])
def test_seeded_traffic_matches_reference(seeds, weights):
    """Counters exact for root cause, critical-path seconds within rtol
    1e-5, the share rows within the moments rule and the share quantiles
    within rtol 1e-3 of the reference's."""
    port, ref = _traffic("port", seeds, weights), \
        _traffic("ref", seeds, weights)
    same_samples(port[0], ref[0])
    same_counters(port[1], ref[1])
    same_shares(port[2], ref[2])
    for q in (0.5, 0.9):
        same_quantiles(port[3][q], ref[3][q], 1e-3)
    assert any(k[0] == RC for k in port[0]) and port[3][0.5]


# ---------------------------------------------------------------------------
# the port's layouts and routes
# ---------------------------------------------------------------------------

def _port_run(clock, paged=False, sched=False, **kw):
    gi = None
    pool = tpages.PagePool(tpages.PagePoolConfig(
        enabled=True, page_rows=64, arena_slots=4096), device="cpu") \
        if paged else None
    with tpages.use(pool):
        gi = mod("port", "generator.instance").GeneratorInstance(
            "t1", mod("port", "generator.instance").GeneratorConfig(
                processors=("trace-analytics",),
                registry=mod("port", "registry").RegistryOverrides(
                    max_active_series=1024),
                traceanalytics=tta.TraceAnalyticsConfig(
                    trace_idle_s=1.0, **kw)),
            now=lambda: clock[0], device="cpu")
    if sched:
        tsched.configure(tsched.SchedConfig())
    for seed in (7, 8):
        random_push("port", gi, seed, now=clock[0], weights=True)
        clock[0] += 0.5
    gi.tick(immediate=True)
    return gi


def test_paged_state_matches_dense_and_scheduler_matches_direct():
    """The share sidecar on paged state (a `PagedPlane` backed with the cp
    family's pages) and the scheduler route give the dense direct route's
    counters, share rows and quantiles bit for bit."""
    runs = {}
    for name, kw in (("dense", {}), ("paged", {"paged": True}),
                     ("sched", {"sched": True})):
        gi = _port_run([T0], **kw)
        p = gi.processors["trace-analytics"]
        assert p._paged == (name == "paged")
        runs[name] = (collect("port", gi), share_rows("port", gi),
                      p.quantile(0.5))
        if name == "paged":
            assert p.device_state_bytes() > 0
            assert p.device_state_bytes() < \
                p._pmom[0].capacity * p._pmom[0].width * 4
        tsched.reset()
    for name in ("paged", "sched"):
        assert runs[name][0] == runs["dense"][0], name
        assert set(runs[name][1]) == set(runs["dense"][1])
        for lab, r in runs["dense"][1].items():
            assert np.array_equal(runs[name][1][lab], r), (name, lab)
        assert runs[name][2] == runs["dense"][2], name


@pytest.mark.parametrize("paged", [False, True])
def test_evict_hook_zeroes_the_share_rows(paged):
    """A stale-series purge zeroes the evicted cp slots' share rows (a
    reused slot must not inherit another series' share history)."""
    clock = [T0]
    gi = _port_run(clock, paged=paged)
    p = gi.processors["trace-analytics"]
    assert p.quantile(0.5)
    clock[0] += 3600.0
    assert gi.registry.purge_stale() > 0
    slots = np.arange(64, dtype=np.int32)
    _, rows = p.aux_checkpoint(slots)
    assert not rows["mom_rows"].any()
    assert p.quantile(0.5) == {}


def test_aux_checkpoint_restore_round_trip():
    """The processor's own aux pair: a fresh instance restored from a
    checkpoint of another answers the same share quantiles (add-to-zero
    is exact); restoring again ADDS the sums and MAXes the bounds; a
    checkpoint with a share sketch refuses an instance without one."""
    clock = [T0]
    a = _port_run(clock)
    pa = a.processors["trace-analytics"]
    slots = pa.cp.table.active_slots()
    meta, rows = pa.aux_checkpoint(slots)
    assert meta == {"mom": {"k": 8, "lo": pytest.approx(np.log(1e-4)),
                            "hi": 0.0}}
    b = mod("port", "generator.instance").GeneratorInstance(
        "t1", a.cfg, now=lambda: clock[0], device="cpu")
    pb = b.processors["trace-analytics"]
    # the two instances share no interner: map through label strings
    labels = [b.registry.interner.intern_many(
        a.registry.interner.lookup_many(pa.cp.table.slot_keys[s]))
        for s in slots]
    live = pb.cp.resolve_slots(np.stack(labels).astype(np.int32))
    assert (live >= 0).all()
    pb.aux_meta_check(meta)
    pb.aux_restore(meta, live, np.ones(len(live), bool), rows)
    want = {pa.cp.labels_of(int(s)): r for s, r in
            zip(slots, rows["mom_rows"])}
    got_meta, got_rows = pb.aux_checkpoint(live)
    got = {pb.cp.labels_of(int(s)): r for s, r in
           zip(live, got_rows["mom_rows"])}
    assert set(got) == set(want)
    for lab, r in want.items():
        assert np.array_equal(got[lab], r), lab
    assert pb.quantile(0.5) == pa.quantile(0.5)
    pb.aux_restore(meta, live, np.ones(len(live), bool), rows)
    _, twice = pb.aux_checkpoint(live)
    for r1, r2 in zip(rows["mom_rows"], twice["mom_rows"]):
        np.testing.assert_allclose(r2[:9], 2 * r1[:9], rtol=1e-6)
        assert np.array_equal(r2[9:], r1[9:])
    c = mod("port", "generator.instance").GeneratorInstance(
        "t1", mod("port", "generator.instance").GeneratorConfig(
            processors=("trace-analytics",),
            traceanalytics=tta.TraceAnalyticsConfig(
                enable_latency_share_sketch=False)),
        now=lambda: clock[0], device="cpu")
    pc = c.processors["trace-analytics"]
    with pytest.raises(ValueError, match="share-sketch mismatch"):
        pc.aux_meta_check(meta)
    assert pc.aux_checkpoint(slots) == (None, {})
    assert pc.quantile(0.5) == {} and pc.device_state_bytes() == 0
    assert pa.aux_family() is pa.cp


def test_generator_applies_ta_limits_and_cuts_through_tick():
    """`Generator` hands the tenant's `ta_*` limits to the processor (the
    reference's rule) and a pushed trace-analytics tenant cuts through
    `GeneratorInstance.tick`, as in the reference."""
    got = {}
    for side in SIDES:
        clock = [T0]
        ov = mod(side, "overrides").Overrides()
        ov.set_tenant_patch("t1", {"generator": {
            "processors": ["span-metrics", "trace-analytics"],
            "ta_max_spans_per_trace": 4, "ta_trace_idle_s": 2.0,
            "ingestion_time_range_slack_s": 0.0}})
        gen = mod(side, "generator.generator").Generator(
            overrides=ov, now=lambda: clock[0], **_kw(side))
        gi = gen.instance("t1")
        cfg = gi.cfg.traceanalytics
        assert (cfg.max_spans_per_trace, cfg.trace_idle_s) == (4, 2.0)
        assert gi._fast_spanmetrics() is None
        random_push(side, gi, 5, n_traces=6)
        clock[0] += 1.0
        gi.tick()
        assert ta_mod(side)._cut_traces.get("t1") is None   # not idle yet
        clock[0] += 1.5
        gi.tick()
        got[side] = (collect(side, gi), counters(side))
        assert ta_mod(side)._cut_traces.get("t1") == 6.0
        assert ta_mod(side)._late_spans.get("t1") == 12.0   # 6 a trace > 4
    same_counters(got["port"][1], got["ref"][1])
    port = {k: v for k, v in got["port"][0].items() if k[0] in (CP, RC)}
    ref = {k: v for k, v in got["ref"][0].items() if k[0] in (CP, RC)}
    same_samples(port, ref)


def test_runtime_families_match_reference():
    """The process-wide families render on both RUNTIMEs under the same
    names, with the cut's values."""
    fams = {}
    for side, rt_name in (("port", "obs.runtime"), ("ref", "obs.jaxruntime")):
        clock = [T0]
        gi = ta_inst(side, clock)
        random_push(side, gi, 2)
        gi.tick(immediate=True)
        text = mod(side, rt_name).RUNTIME.render()
        fams[side] = sorted(
            ln.split()[2] for ln in text.splitlines()
            if ln.startswith("# TYPE") and ("traceanalytics" in ln
                                            or "critical_path" in ln
                                            or "root_cause" in ln))
        assert 'tempo_traceanalytics_cut_traces_total{tenant="t1"} 24' \
            in text
    assert fams["port"] == fams["ref"] and len(fams["port"]) == 7
