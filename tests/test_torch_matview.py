"""The materialized query grids (`tempo_tpu_torch.matview`) against the
reference's (`tests/test_matview.py`), each case on both packages with
the same inputs and a pinned clock (the port on the CPU).

Held: served reads equal the recompute path bit for bit for the rate,
count, bucket-quantile and histogram kinds, and the moments tier within
the reference's 0.02 relative; the port's answers equal the reference's
(count and bucket series exactly, moments within 0.02); the coverage,
staleness, alignment, budget, auto-subscribe, idle-expiry, fast-route
and frontend behaviours and counters are the reference's. Differential
cases run the reference's `Materializer` and the port's on the same
batches and compare the grids and `slice_series`.

Two reference tests wait for other work, so they are not mirrored:
`test_config_check_matview_bounds` checks the App config's `matview:`
bounds, which come with the app wiring (ROADMAP section 1, item 9);
`test_zero_steady_state_recompiles_on_append` counts JAX traces, and
its counterpart here is `test_steady_state_appends_allocate_no_new_grid`.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from tempo_tpu_torch import matview as tmatview
from tempo_tpu_torch import sched as tsched
from tempo_tpu_torch.generator.processors import traceanalytics as tta
from tempo_tpu_torch.utils import dataquality as tdq
from tests.test_torch_frontend import mod

T0 = 1_700_000_000.0
SIDES = ("ref", "port")
RATE_Q = "{ } | rate() by (name)"


@pytest.fixture(autouse=True)
def _singletons():
    """The port's scheduler, materializer and trace-analytics counters
    are process-wide: reset around each test (the reference's are reset
    by tests/conftest.py)."""
    tsched.reset()
    tmatview.reset()
    yield
    tsched.reset()
    tmatview.reset()
    tta.reset_counters()
    tdq.reset_orphan_spans()


def _kw(side):
    return {"device": "cpu"} if side == "port" else {}


def mkgen(side, now, tmp_path, processors=("span-metrics", "local-blocks")):
    gi = mod(side, "generator.instance")
    lb = mod(side, "generator.processors.localblocks")
    sm = mod(side, "generator.processors.spanmetrics").SpanMetricsConfig(
        sketch_max_series=256, **({} if side == "port" else {"kernel": "xla"}))
    cfg = gi.GeneratorConfig(
        processors=processors, spanmetrics=sm,
        localblocks=lb.LocalBlocksConfig(data_dir=str(tmp_path / side)))
    return mod(side, "generator.generator").Generator(
        cfg, overrides=mod(side, "overrides").Overrides(), now=now,
        **_kw(side))


def configure(side, now, **cfg):
    mat = mod(side, "matview.materializer")
    return mod(side, "matview").configure(mat.MatViewConfig(**cfg), now=now,
                                          **_kw(side))


def push(side, inst, ids, n_ops=3, per=6, statuses=(0,), attr=None):
    b = mod(side, "model.span_batch").SpanBatchBuilder(inst.registry.interner)
    t0 = int(inst.now() * 1e9)
    for i in range(n_ops):
        for j in range(per):
            c = next(ids)
            b.append(trace_id=c.to_bytes(16, "big"),
                     span_id=c.to_bytes(8, "big"),
                     name=f"op{i}", service="svc", kind=2,
                     status_code=statuses[j % len(statuses)],
                     start_unix_nano=t0 - j * 1_000_000_000,
                     end_unix_nano=t0 - j * 1_000_000_000
                     + (5 + i) * 1_000_000,
                     attrs=attr)
    inst.push_batch(b.build())


def final_map(side, series, req):
    em = mod(side, "traceql.engine_metrics")
    comb = em.SeriesCombiner(em.metrics_kind(req.query), req.n_steps)
    comb.add_all(series or [])
    return {ts.labels: ts.samples for ts in comb.final(req)}


def aligned_req(side, now_s, query, step_s=10.0, back_steps=11,
                span_steps=12):
    start = (int(now_s) // int(step_s) - back_steps) * int(step_s)
    return mod(side, "traceql.engine_metrics").QueryRangeRequest(
        query, int(start * 1e9), int((start + span_steps * step_s) * 1e9),
        int(step_s * 1e9))


def assert_bitident(side, got, recompute, req):
    f1, f2 = final_map(side, got, req), final_map(side, recompute, req)
    assert set(f1) == set(f2), (sorted(f1), sorted(f2))
    for k in f1:
        assert np.array_equal(f1[k], f2[k]), (k, f1[k], f2[k])
    return f1


def same_maps(a, b, rel=None):
    """Two sides' final maps: equal keys, and samples equal (or within
    `rel` of the reference's)."""
    assert set(a) == set(b), (sorted(a), sorted(b))
    for k in a:
        if rel is None:
            assert np.array_equal(a[k], b[k]), (k, a[k], b[k])
        else:
            d = np.maximum(np.abs(b[k]), 1e-12)
            assert np.max(np.abs(a[k] - b[k]) / d) <= rel, (k, a[k], b[k])


def both(fn, *args, **kw):
    return {side: fn(side, *args, **kw) for side in SIDES}


# ---------------------------------------------------------------------------
# fingerprint (obs/queryfp.py, obs/qlog.py)
# ---------------------------------------------------------------------------

def test_fingerprint_whitespace_and_label_order_stable():
    a = '{ resource.service.name = "a" && name = "b" } | rate() by (name)'
    b = '{name="b"&&resource.service.name="a"}   |   rate()   by(name)'
    got = {}
    for side in SIDES:
        fp = mod(side, "obs.queryfp")
        assert fp.canonical_query(a) == fp.canonical_query(b)
        assert fp.query_fingerprint("metrics", a, 10.0) == \
            fp.query_fingerprint("metrics", b, 10.0)
        assert fp.canonical_query('{ .a = 1 || .b = 2 }') == \
            fp.canonical_query('{ .b = 2 || .a = 1 }')
        assert fp.canonical_query('{.a=1} && {.b=2}') == \
            fp.canonical_query('{.b=2} && {.a=1}')
        got[side] = (fp.canonical_query(a),
                     fp.query_fingerprint("metrics", a, 10.0))
    assert got["port"] == got["ref"]


def test_fingerprint_time_window_independent_but_step_sensitive():
    q = "{ } | rate()"
    for side in SIDES:
        qf = mod(side, "obs.queryfp").query_fingerprint
        assert qf("metrics", q, 10.0) == qf("metrics", q, 10.0)
        assert qf("metrics", q, 10.0) != qf("metrics", q, 60.0)
        assert qf("metrics", q, 10.0) != qf("search", q, 10.0)
        assert qf("metrics", "{ } | count_over_time()", 10.0) != \
            qf("metrics", q, 10.0)


def test_fingerprint_unparseable_fallback_stable():
    for side in SIDES:
        fp = mod(side, "obs.queryfp")
        assert fp.canonical_query("  not   a query ") == "not a query"
        assert fp.query_fingerprint("metrics", "not a query", 1.0) == \
            fp.query_fingerprint("metrics", " not  a  query", 1.0)


def test_qlog_recurrence_counter():
    for side in SIDES:
        clock = [T0]
        ql = mod(side, "obs.qlog").QueryLogger(now=lambda: clock[0])
        fp = mod(side, "obs.queryfp").query_fingerprint(
            "metrics", "{ } | rate()", 10.0)
        assert [ql.note_fingerprint(fp) for _ in range(3)] == [1, 2, 3]
        assert ql.fingerprint_count(fp) == 3
        clock[0] += 700.0
        assert ql.fingerprint_count(fp) == 0
        assert ql.note_fingerprint(fp) == 1


# ---------------------------------------------------------------------------
# subscription gating
# ---------------------------------------------------------------------------

QUERIES = ("{ } | rate() by (name)",
           "{ } | quantile_over_time(duration, .5, .99) by (name)",
           "{ } | histogram_over_time(duration)",
           "{ } | min_over_time(duration)", "{ } | avg_over_time(duration)",
           "{ nestedSetLeft > 0 } | rate()", "{ rootName = `x` } | rate()",
           "{ parent.name = `x` } | rate()", "{.a=1} && {.b=2} | rate()",
           "{ }", "{{{")


def test_query_supported_gates():
    for side in SIDES:
        qs = mod(side, "matview").query_supported
        assert qs(QUERIES[0])[0] and qs(QUERIES[1])[0] and qs(QUERIES[2])[0]
        for bad in QUERIES[3:]:
            ok, why = qs(bad)
            assert not ok and why, bad
    # the same verdict and reason in both packages
    assert [tmatview.query_supported(q) for q in QUERIES] == \
        [mod("ref", "matview").query_supported(q) for q in QUERIES]


def _refusals(side):
    mv = configure(side, lambda: T0, max_subscriptions=2)
    out = [mv.subscribe("t", "{ } | min_over_time(duration)", 10.0)[1],
           mv.subscribe("t", "{ } | rate()", 0.1)[1]]
    s1, _ = mv.subscribe("t", "{ } | rate()", 10.0)
    s1b, why = mv.subscribe("t", "{ } | rate()", 10.0)
    assert s1 is s1b and why == "exists"
    s2, _ = mv.subscribe("t", "{ } | count_over_time()", 10.0)
    assert s1 is not None and s2 is not None
    s3, why = mv.subscribe("t", "{ } | rate() by (name)", 10.0)
    assert s3 is None and "budget" in why
    out.append(why)
    assert mv.unsubscribe("t", "{ } | rate()", 10.0)
    assert not mv.unsubscribe("t", "{ } | rate()", 10.0)
    assert mv.wants("t") and not mv.wants("u")
    s3, why = mv.subscribe("t", "{ } | rate() by (name)", 10.0)
    assert s3 is not None and why == ""
    assert "not materializable" in out[0] and "outside" in out[1]
    return out


def test_subscribe_refusals_and_budget():
    got = both(_refusals)
    assert got["port"] == got["ref"]


# ---------------------------------------------------------------------------
# streaming append + read: bit-identity vs the recompute path
# ---------------------------------------------------------------------------

def _rate_read(side, tmp_path):
    clock = [T0]
    now = lambda: clock[0]
    ids = itertools.count(1)
    inst = mkgen(side, now, tmp_path).instance("t1")
    mv = configure(side, now, max_staleness_s=1e9)
    mv.subscribe("t1", RATE_Q, 10.0)
    push(side, inst, ids)            # builds (empty backfill) + appends
    clock[0] += 25
    push(side, inst, ids)
    mod(side, "sched").flush()
    req = aligned_req(side, now(), RATE_Q)
    got = mv.read("t1", req)
    assert got is not None and mv.reads.get("hit") == 1
    return assert_bitident(side, got, inst.query_range(req), req)


def test_rate_read_bit_identical_to_recompute(tmp_path):
    got = both(_rate_read, tmp_path)
    same_maps(got["port"], got["ref"])


def _backfill(side, tmp_path):
    clock = [T0]
    now = lambda: clock[0]
    ids = itertools.count(1)
    inst = mkgen(side, now, tmp_path).instance("t1")
    mv = configure(side, now, max_staleness_s=1e9)
    query = "{ } | count_over_time() by (name)"
    push(side, inst, ids)
    clock[0] += 30
    push(side, inst, ids)            # pre-subscription history
    mv.subscribe("t1", query, 10.0)
    clock[0] += 10
    push(side, inst, ids)            # triggers build (backfill) + append
    mod(side, "sched").flush()
    req = aligned_req(side, now(), query)
    got = mv.read("t1", req)
    assert got is not None
    return assert_bitident(side, got, inst.query_range(req), req)


def test_backfill_on_late_subscribe_bit_identical(tmp_path):
    got = both(_backfill, tmp_path)
    same_maps(got["port"], got["ref"])


def _dd_rebuild(side, tmp_path):
    clock = [T0]
    now = lambda: clock[0]
    ids = itertools.count(1)
    gen = mkgen(side, now, tmp_path)
    inst = gen.instance("t1")
    mv = configure(side, now, max_staleness_s=1e9,
                   overrides_check_interval_s=0.0)
    query = "{ } | quantile_over_time(duration, .5, .9, .99) by (name)"
    mv.subscribe("t1", query, 10.0)
    push(side, inst, ids)
    clock[0] += 15
    push(side, inst, ids)
    mod(side, "sched").flush()
    req = aligned_req(side, now(), query)
    got = mv.read("t1", req)
    assert got is not None
    first = assert_bitident(side, got, inst.query_range(req), req)
    gen.overrides.set_tenant_patch(
        "t1", {"generator": {"collection_interval_s": 30.0}})
    clock[0] += 10
    push(side, inst, ids)
    mod(side, "sched").flush()
    assert mv.rebuilds.get("overrides", 0) >= 1
    assert not mv.subscriptions()[0].needs_build
    req2 = aligned_req(side, now(), query)
    got2 = mv.read("t1", req2)
    assert got2 is not None
    return first, assert_bitident(side, got2, inst.query_range(req2), req2)


def test_quantile_dd_bit_identical_across_override_rebuild(tmp_path):
    got = both(_dd_rebuild, tmp_path)
    for a, b in zip(got["port"], got["ref"]):
        same_maps(a, b)


def _moments(side, tmp_path):
    msk = mod(side, "ops.moments")
    clock = [T0]
    now = lambda: clock[0]
    ids = itertools.count(1)
    inst = mkgen(side, now, tmp_path).instance("t1")
    mv = configure(side, now, max_staleness_s=1e9)
    query = "{ } | quantile_over_time(duration, .5, .99) by (name)"
    with msk.use_query_tier("moments"):
        mv.subscribe("t1", query, 10.0)
        push(side, inst, ids, per=12)
        clock[0] += 15
        push(side, inst, ids, per=12)
        mod(side, "sched").flush()
        req = aligned_req(side, now(), query)
        got = mv.read("t1", req)
        assert got is not None
        f1 = final_map(side, got, req)
        same_maps(f1, final_map(side, inst.query_range(req), req), rel=0.02)
    return f1


def test_moments_tier_within_error_budget(tmp_path):
    got = both(_moments, tmp_path)
    same_maps(got["port"], got["ref"], rel=0.02)


def _tier_change(side, tmp_path):
    msk = mod(side, "ops.moments")
    clock = [T0]
    now = lambda: clock[0]
    ids = itertools.count(1)
    inst = mkgen(side, now, tmp_path).instance("t1")
    mv = configure(side, now, max_staleness_s=1e9)
    query = "{ } | quantile_over_time(duration, .5) by (name)"
    mv.subscribe("t1", query, 10.0)
    push(side, inst, ids)
    mod(side, "sched").flush()
    req = aligned_req(side, now(), query)
    assert mv.read("t1", req) is not None
    with msk.use_query_tier("moments"):
        assert mv.read("t1", req) is None        # tier flip → miss
        assert mv.reads.get("miss_tier_changed") == 1
        push(side, inst, ids)                    # rebuilds on moments axis
        mod(side, "sched").flush()
        assert mv.read("t1", req) is not None
        assert mv.subscriptions()[0].moments
    return dict(mv.reads)


def test_tier_change_expires_grid(tmp_path):
    got = both(_tier_change, tmp_path)
    assert got["port"] == got["ref"]


# ---------------------------------------------------------------------------
# ring mechanics, coverage, staleness
# ---------------------------------------------------------------------------

def _ring(side, tmp_path):
    clock = [T0]
    now = lambda: clock[0]
    ids = itertools.count(1)
    inst = mkgen(side, now, tmp_path).instance("t1")
    mv = configure(side, now, window_steps=8, max_staleness_s=1e9)
    mv.subscribe("t1", RATE_Q, 10.0)
    push(side, inst, ids, per=1)
    clock[0] += 200                  # advance far: ring recycles columns
    push(side, inst, ids, per=1)
    mod(side, "sched").flush()
    req = aligned_req(side, now(), RATE_Q, back_steps=5, span_steps=6)
    got = mv.read("t1", req)
    assert got is not None
    req_old = aligned_req(side, now(), RATE_Q, back_steps=30, span_steps=6)
    assert mv.read("t1", req_old) is None
    assert mv.reads.get("miss_coverage", 0) >= 1
    em = mod(side, "traceql.engine_metrics")
    req_un = em.QueryRangeRequest(RATE_Q, req.start_ns + 1, req.end_ns + 1,
                                  req.step_ns)
    assert mv.read("t1", req_un) is None
    assert mv.reads.get("miss_unaligned") == 1
    return final_map(side, got, req), dict(mv.reads)


def test_ring_advance_and_coverage_misses(tmp_path):
    got = both(_ring, tmp_path)
    same_maps(got["port"][0], got["ref"][0])
    assert got["port"][1] == got["ref"][1]


def _late(side, tmp_path):
    clock = [T0]
    now = lambda: clock[0]
    ids = itertools.count(1)
    inst = mkgen(side, now, tmp_path).instance("t1")
    mv = configure(side, now, window_steps=4, max_staleness_s=1e9)
    mv.subscribe("t1", "{ } | rate()", 10.0)
    push(side, inst, ids, n_ops=1, per=1)
    sub = mv.subscriptions()[0]
    b = mod(side, "model.span_batch").SpanBatchBuilder(inst.registry.interner)
    c = next(ids)
    old = int((now() - 1000) * 1e9)
    b.append(trace_id=c.to_bytes(16, "big"), span_id=c.to_bytes(8, "big"),
             name="op0", service="svc", kind=2, status_code=0,
             start_unix_nano=old, end_unix_nano=old + 1_000_000)
    inst.cfg.ingestion_time_range_slack_s = 0   # let the old span through
    inst.push_batch(b.build())
    mod(side, "sched").flush()
    assert sub.late_dropped >= 1
    return sub.late_dropped, sub.appends, sub.append_spans


def test_late_spans_dropped_and_counted(tmp_path):
    got = both(_late, tmp_path)
    assert got["port"] == got["ref"]


def _stale(side, tmp_path):
    clock = [T0]
    now = lambda: clock[0]
    ids = itertools.count(1)
    inst = mkgen(side, now, tmp_path).instance("t1")
    mv = configure(side, now, max_staleness_s=30.0)
    mv.subscribe("t1", "{ } | rate()", 10.0)
    push(side, inst, ids)
    mod(side, "sched").flush()
    assert mv.read("t1", aligned_req(side, now(), "{ } | rate()")) \
        is not None
    clock[0] += 120                  # no batches: grid goes stale
    assert mv.read("t1", aligned_req(side, now(), "{ } | rate()")) is None
    assert mv.reads.get("miss_stale") == 1
    rows = dict(mod(side, "matview.materializer")._mv_staleness())
    assert rows[("t1",)] == pytest.approx(120.0, abs=1.0)
    return rows


def test_staleness_gate_and_gauge(tmp_path):
    got = both(_stale, tmp_path)
    assert got["port"] == got["ref"]


def _overflow(side, tmp_path):
    clock = [T0]
    now = lambda: clock[0]
    ids = itertools.count(1)
    inst = mkgen(side, now, tmp_path).instance("t1")
    mv = configure(side, now, max_series=64, max_staleness_s=1e9)
    mv.subscribe("t1", RATE_Q, 10.0)
    push(side, inst, ids, n_ops=100, per=1)     # 100 groups > 64 budget
    mod(side, "sched").flush()
    sub = mv.subscriptions()[0]
    assert sub.overflow_dropped > 0
    req = aligned_req(side, now(), RATE_Q)
    got = mv.read("t1", req)
    assert got is not None and len(got) <= 64
    return sub.overflow_dropped, final_map(side, got, req)


def test_series_overflow_budget(tmp_path):
    got = both(_overflow, tmp_path)
    assert got["port"][0] == got["ref"][0]
    same_maps(got["port"][1], got["ref"][1])


# ---------------------------------------------------------------------------
# auto-subscribe + idle expiry + fast-route gate
# ---------------------------------------------------------------------------

def _auto(side, tmp_path):
    clock = [T0]
    now = lambda: clock[0]
    ids = itertools.count(1)
    inst = mkgen(side, now, tmp_path).instance("t1")
    mv = configure(side, now, auto_subscribe_after=3, idle_expire_s=100.0,
                   max_staleness_s=1e9)
    q = "{ } | rate()"
    mv.consider_auto_subscribe("t1", q, 10.0, recurrences=2)
    assert not mv.subscriptions()
    mv.consider_auto_subscribe("t1", q, 10.0, recurrences=3)
    subs = mv.subscriptions()
    assert len(subs) == 1 and subs[0].origin == "auto"
    assert mv.auto_subscribed == 1
    push(side, inst, ids)
    mod(side, "sched").flush()
    assert not subs[0].needs_build
    clock[0] += 200                  # never read → idle expiry on push
    push(side, inst, ids)
    assert not mv.subscriptions()
    mv.consider_auto_subscribe("t-gone", q, 10.0, recurrences=3)
    assert len(mv.subscriptions()) == 1
    clock[0] += 200
    st = mv.status()                 # scrape-path sweep
    assert not mv.subscriptions()
    return st


def test_auto_subscribe_and_idle_expiry(tmp_path):
    got = both(_auto, tmp_path)
    assert got["port"] == got["ref"]


def test_matview_disables_staged_fast_route(tmp_path):
    for side in SIDES:
        clock = [T0]
        now = lambda: clock[0]
        gen = mkgen(side, now, tmp_path, processors=("span-metrics",))
        inst = gen.instance("t1")
        assert inst._fast_spanmetrics() is not None
        mv = configure(side, now)
        mv.subscribe("t1", "{ } | rate()", 10.0)
        assert inst._fast_spanmetrics() is None      # full SpanBatch route
        assert gen.instance("t2")._fast_spanmetrics() is not None


def test_staged_routes_take_the_spanbatch_route_for_a_tenant_with_grids(
        tmp_path):
    """Every staged route of the port sends a tenant with a grid down the
    SpanBatch route, so the grid sees each batch: `push_otlp_staged` and
    `push_otlp_recs` return None (the caller takes the payload route) and
    `push_staged_view` feeds `push_batch`."""
    import tempo_tpu_torch as tt

    clock = [T0]
    now = lambda: clock[0]
    gen = mkgen("port", now, tmp_path, processors=("span-metrics",))
    inst = gen.instance("t1")
    mv = configure("port", now, max_staleness_s=1e9)
    mv.subscribe("t1", "{ } | rate()", 10.0)
    from tempo_tpu_torch.model.otlp import encode_spans_otlp, synthetic_spans

    data = encode_spans_otlp(synthetic_spans(
        64, seed=3, now_ns=int((T0 - 5) * 1e9)))
    assert inst.push_otlp_staged(data) is None
    assert inst.push_otlp_recs(data, tt.native.otlp_scan(data)) is None
    st = tt.stage_otlp(data, inst.registry.interner)
    assert inst.push_staged_view(st.view()) == 64
    tsched.flush()
    sub = mv.subscriptions()[0]
    assert sub.appends == 1 and sub.append_spans == 64
    assert inst.spans_received == 64


# ---------------------------------------------------------------------------
# frontend integration: hit path, auto-subscribe wiring, per-op cache
# ---------------------------------------------------------------------------

def fe_rig(side, tmp_path):
    clock = [T0]
    now = lambda: clock[0]
    gen = mkgen(side, now, tmp_path)
    be = mod(side, "backend.mem").MemBackend()
    db = mod(side, "db.tempodb").TempoDB(be, be, **_kw(side))
    ring = mod(side, "ring").Ring(replication_factor=1, now=now)
    q = mod(side, "querier").Querier(
        db, ring, {}, cfg=mod(side, "querier.querier").QuerierConfig(rf=1))
    fm = mod(side, "frontend")
    fe = fm.Frontend(db, q, cfg=fm.FrontendConfig(
        query_backend_after_s=10 * 365 * 86400.0),   # generator-only leg
        generator_query_range=gen.query_range, now=now)
    return clock, now, gen, fe


def _fe_hit(side, tmp_path):
    clock, now, gen, fe = fe_rig(side, tmp_path)
    inst = gen.instance("t1")
    ids = itertools.count(1)
    mv = configure(side, now, max_staleness_s=1e9)
    ok, why = fe.subscribe_query("t1", RATE_Q, 10.0)
    assert ok, why
    push(side, inst, ids)
    clock[0] += 20
    push(side, inst, ids)
    mod(side, "sched").flush()
    start = (int(now()) // 10 - 11) * 10
    kw = dict(start_s=float(start), end_s=float(start + 120), step_s=10.0)
    served = fe.query_range("t1", RATE_Q, **kw)
    assert mv.reads.get("hit") == 1
    mod(side, "matview").reset()          # force the recompute path
    recomputed = fe.query_range("t1", RATE_Q, **kw)
    a = {s.labels: s.samples.tolist() for s in served}
    b = {s.labels: s.samples.tolist() for s in recomputed}
    assert a == b
    assert fe.unsubscribe_query("t1", RATE_Q, 10.0) is False  # mv reset
    assert fe.subscribe_query("t1", RATE_Q, 10.0) == \
        (False, "matview tier disabled")
    fe.shutdown()
    return a


def test_frontend_serves_hit_and_matches_recompute(tmp_path):
    got = both(_fe_hit, tmp_path)
    assert got["port"] == got["ref"]


def _fe_auto(side, tmp_path):
    clock, now, gen, fe = fe_rig(side, tmp_path)
    inst = gen.instance("t1")
    ids = itertools.count(1)
    mv = configure(side, now, auto_subscribe_after=3, max_staleness_s=1e9)
    push(side, inst, ids)
    start = (int(now()) // 10 - 5) * 10
    kw = dict(start_s=float(start), end_s=float(start + 60), step_s=10.0)
    for _ in range(3):                    # misses feed qlog recurrence
        fe.query_range("t1", RATE_Q, **kw)
    subs = mv.subscriptions()
    assert len(subs) == 1 and subs[0].origin == "auto"
    push(side, inst, ids)                 # builds the grid
    mod(side, "sched").flush()
    res = fe.query_range("t1", RATE_Q, **kw)
    assert mv.reads.get("hit", 0) >= 1
    fe.shutdown()
    return dict(mv.reads), {s.labels: s.samples.tolist() for s in res}


def test_frontend_auto_subscribes_recurring_query(tmp_path):
    got = both(_fe_auto, tmp_path)
    assert got["port"] == got["ref"]


def _per_op_cache(side):
    clock = [T0 + 7200.0]
    now = lambda: clock[0]
    be = mod(side, "backend.mem").MemBackend()
    db = mod(side, "db.tempodb").TempoDB(be, be, **_kw(side))
    traces = []
    for i in range(1, 6):
        tid = bytes([i]) * 16
        t0 = int((T0 + i) * 1e9)
        traces.append((tid, [{
            "trace_id": tid, "span_id": bytes([i]) * 8, "name": "op",
            "service": "svc", "start_unix_nano": t0,
            "end_unix_nano": t0 + 50_000_000}]))
    db.write_block("acme", traces, replication_factor=1)
    db.poll_now()
    ring = mod(side, "ring").Ring(replication_factor=1, now=now)
    q = mod(side, "querier").Querier(
        db, ring, {}, cfg=mod(side, "querier.querier").QuerierConfig(rf=1))
    fm = mod(side, "frontend")
    fe = fm.Frontend(db, q, cfg=fm.FrontendConfig(
        target_bytes_per_job=1,
        slo={"search": mod(side, "frontend.slos").SLOConfig(
            duration_slo_s=60.0)}),
        cache_provider=mod(side, "backend.cache").CacheProvider(), now=now)
    fe.search("acme", "{ }", limit=10, start_s=0, end_s=now())
    assert fe._cache_ops["search"]["misses"] > 0
    assert fe._cache_ops["search"].get("hits", 0) == 0
    fe.search("acme", "{ }", limit=10, start_s=0, end_s=now())
    assert fe._cache_ops["search"]["hits"] > 0
    kw = dict(start_s=T0, end_s=T0 + 60, step_s=10.0)
    fe.query_range("acme", "{ } | rate()", **kw)
    fe.query_range("acme", "{ } | rate()", **kw)
    assert fe._cache_ops["metrics"]["misses"] > 0
    assert fe._cache_ops["metrics"]["hits"] > 0
    text = fe.obs.render()
    assert 'tempo_tpu_frontend_cache_hits_total{op="search"}' in text
    assert 'tempo_tpu_frontend_cache_misses_total{op="metrics"}' in text
    fe.shutdown()
    return {op: dict(c) for op, c in fe._cache_ops.items()}


def test_per_op_cache_counters():
    got = both(_per_op_cache)
    assert got["port"] == got["ref"]


# ---------------------------------------------------------------------------
# obs + status surfaces
# ---------------------------------------------------------------------------

def _obs(side, tmp_path):
    clock = [T0]
    now = lambda: clock[0]
    ids = itertools.count(1)
    inst = mkgen(side, now, tmp_path).instance("t1")
    mv = configure(side, now, max_staleness_s=1e9)
    mv.subscribe("t1", "{ } | rate()", 10.0)
    push(side, inst, ids)
    mod(side, "sched").flush()
    mv.read("t1", aligned_req(side, now(), "{ } | rate()"))
    em = mod(side, "traceql.engine_metrics")
    mv.read("t1", em.QueryRangeRequest("{ } | count_over_time()",
                                       int(T0 * 1e9), int((T0 + 60) * 1e9),
                                       int(10e9)))
    rt = mod(side, "obs.runtime" if side == "port" else "obs.jaxruntime")
    text = rt.RUNTIME.render()
    assert 'tempo_matview_subscriptions{origin="explicit"} 1' in text
    assert "tempo_matview_grids 1" in text
    assert 'tempo_matview_reads_total{result="hit"} 1' in text
    assert 'tempo_matview_reads_total{result="miss_unsubscribed"} 1' in text
    assert "tempo_matview_appends_total" in text
    assert "tempo_matview_state_bytes" in text
    assert 'tempo_matview_staleness_seconds{tenant="t1"}' in text
    st = mv.status()
    assert st["subscriptions"] == 1 and st["grids_built"] == 1
    assert st["subscribed"][0]["tenant"] == "t1"
    fams = sorted({ln.split()[2] for ln in text.splitlines()
                   if ln.startswith("# TYPE tempo_matview_")})
    return fams, st


def test_matview_obs_families_render(tmp_path):
    got = both(_obs, tmp_path)
    assert got["port"][0] == got["ref"][0]
    assert got["port"][1] == got["ref"][1]


def test_steady_state_appends_allocate_no_new_grid(tmp_path):
    """Counterpart of the reference's zero-recompile gate: once warm, an
    append updates the standing grid tensors in place — the same
    storage, no new tensor."""
    clock = [T0]
    now = lambda: clock[0]
    ids = itertools.count(1)
    gen = mkgen("port", now, tmp_path)
    # a small dense registry: each push folds the whole of it on the CPU
    gen.overrides.set_tenant_patch("t1", {
        "generator": {"max_active_series": 1024}})
    inst = gen.instance("t1")
    mv = configure("port", now, max_staleness_s=1e9)
    mv.subscribe("t1", RATE_Q, 10.0)
    for _ in range(3):                   # warm: the grid is built
        push("port", inst, ids, n_ops=3, per=6)
        clock[0] += 10
    sub = mv.subscriptions()[0]
    warm = {k: (g, g.data_ptr()) for k, g in sub.grids.items()}
    appends = sub.appends
    for _ in range(5):
        push("port", inst, ids, n_ops=3, per=6)
        clock[0] += 10
    assert sub.appends == appends + 5
    assert {k: (g, g.data_ptr()) for k, g in sub.grids.items()} == warm


def test_batchview_dict_codes_parity():
    got = {}
    for side in SIDES:
        b = mod(side, "model.span_batch").SpanBatchBuilder()
        for i in range(64):
            b.append(trace_id=bytes([i % 7 + 1]) * 16,
                     span_id=bytes([2]) * 8,
                     name=f"op-{i % 5}", service=f"svc-{i % 3}",
                     status_code=0,
                     start_unix_nano=int(T0 * 1e9) + i,
                     end_unix_nano=int(T0 * 1e9) + i + 1000)
        view = mod(side, "matview.batchview").view_from_span_batch(b.build())
        for key in ("name", "resource.service.name", "statusMessage"):
            c = view.col(key)
            assert c.codes is not None and c.code_values is not None
            assert [str(c.code_values[int(cd)]) for cd in c.codes] == \
                [str(v) for v in c.values]
        em = mod(side, "traceql.engine_metrics")
        by = mod(side, "traceql.parser").parse(
            "{ } | rate() by (name, resource.service.name)").metrics.by
        rows = np.arange(view.n, dtype=np.int64)
        si_code, si_str = em.SeriesIndex(), em.SeriesIndex()
        keep_c, slots_c = em.group_slots(list(by), si_code, view, rows)
        for key in ("name", "resource.service.name"):
            view.set_col(key, dataclasses.replace(
                view.col(key), codes=None, code_values=None))
        keep_s, slots_s = em.group_slots(list(by), si_str, view, rows)
        assert np.array_equal(keep_c, keep_s)
        lab_c = {si_code.keys[int(s)] for s in np.unique(slots_c)}
        lab_s = {si_str.keys[int(s)] for s in np.unique(slots_s)}
        assert lab_c == lab_s == {
            (("name", f"op-{i}"), ("resource.service.name", f"svc-{j}"))
            for i in range(5) for j in range(3)}
        got[side] = (si_code.keys, slots_c.tolist(),
                     {k: (view.col(k).t, view.col(k).values.tolist())
                      for k in ("__startTime", "status", "kind", "name")})
    assert got["port"] == got["ref"]


def test_batchview_durations_equal_memview_below_a_microsecond():
    """The batch view's durations are the int64 difference of end and
    start, as `view_from_traces` takes them, so a grid and its recompute
    bucket a sub-microsecond span alike. The reference's batch view
    subtracts float64 copies of the epoch-ns stamps, which rounds to
    their 256 ns spacing (a deliberate difference, ROADMAP section 3)."""
    from tempo_tpu_torch.matview.batchview import view_from_span_batch
    from tempo_tpu_torch.model.span_batch import SpanBatchBuilder
    from tempo_tpu_torch.traceql.memview import view_from_traces

    durs = [1, 7, 100, 255, 300, 1000, 123_456]
    b = SpanBatchBuilder()
    spans = []
    for i, d in enumerate(durs):
        t0 = int(T0 * 1e9) + 12_345 * i
        sp = dict(trace_id=bytes([i + 1]) * 16, span_id=bytes([i + 1]) * 8,
                  name="op", service="svc", start_unix_nano=t0,
                  end_unix_nano=t0 + d)
        b.append(**sp)
        spans.append((sp["trace_id"], [sp]))
    got = view_from_span_batch(b.build()).col("duration").values
    want = view_from_traces(spans).col("duration").values
    assert got.tolist() == want.tolist() == [float(d) for d in durs]
    ref_b = mod("ref", "model.span_batch").SpanBatchBuilder()
    for _, (sp,) in spans:
        ref_b.append(**sp)
    ref = mod("ref", "matview.batchview").view_from_span_batch(
        ref_b.build()).col("duration").values
    assert np.abs(ref - got).max() <= 256 and (ref != got).any()


# ---------------------------------------------------------------------------
# differential: the reference's Materializer and the port's, same batches
# ---------------------------------------------------------------------------

DIFF_QUERIES = {
    "rate": "{ } | rate() by (name)",
    "count": "{ status = error } | count_over_time() by (name)",
    "quantile_buckets": "{ } | quantile_over_time(duration, .5, .9) by (name)",
    "histogram": "{ } | histogram_over_time(duration) by (name)",
    "quantile_moments": "{ } | quantile_over_time(duration, .5, .99) by "
                        "(name)",
}


def _diff_drive(side, tmp_path, query, tier):
    msk = mod(side, "ops.moments")
    clock = [T0]
    now = lambda: clock[0]
    ids = itertools.count(1)
    with msk.use_query_tier(tier):
        inst = mkgen(side, now, tmp_path).instance("t1")
        mv = configure(side, now, window_steps=16, max_staleness_s=1e9)
        push(side, inst, ids, n_ops=4, per=9, statuses=(0, 2, 1))
        sub, _ = mv.subscribe("t1", query, 10.0)
        for k in range(4):       # the first push builds from the history
            clock[0] += 7 + 5 * k
            push(side, inst, ids, n_ops=4 + k, per=9, statuses=(0, 2, 1))
        mod(side, "sched").flush()
        grids = {k: np.asarray(g.cpu().numpy() if side == "port" else g,
                               np.float64)
                 for k, g in sub.grids.items()}
        req = aligned_req(side, now(), query, back_steps=12, span_steps=14)
        series = {ts.labels: ts.samples for ts in sub.slice_series(req)}
        got = mv.read("t1", req)
        assert got is not None
        f = final_map(side, got, req)
        same_maps(f, final_map(side, inst.query_range(req), req),
                  rel=0.02 if tier == "moments" else None)
    return grids, series, f, (sub.appends, sub.append_spans,
                              list(sub.series.keys))


def _exact_reference_durations(monkeypatch):
    """Give the reference's batch view the int64 durations the port's
    takes (its own float64 difference rounds to 256 ns, a documented
    difference), so the two materializers see the same batches."""
    bv = mod("ref", "matview.batchview")
    inner = bv.view_from_span_batch

    def exact(sb):
        view = inner(sb)
        rows = np.flatnonzero(sb.valid[: sb.n])
        d = np.maximum(sb.end_unix_nano[rows].astype(np.int64)
                       - sb.start_unix_nano[rows].astype(np.int64), 0)
        view.set_col("duration", dataclasses.replace(
            view.col("duration"), values=d.astype(np.float64)))
        return view

    monkeypatch.setattr(bv, "view_from_span_batch", exact)


@pytest.mark.parametrize("kind", sorted(DIFF_QUERIES))
def test_differential_grids_match_reference(kind, tmp_path, monkeypatch):
    """The grids and `slice_series` of the port's Materializer equal the
    reference's on the same batches (the backfill, then appends that
    advance the ring): count and bucket cells exactly, moment sums within
    f32 rounding of the reference's f32 sums (the port's are float64),
    bound planes exactly, and the served finals as the read contract."""
    _exact_reference_durations(monkeypatch)
    tier = "moments" if kind == "quantile_moments" else "log2"
    got = both(_diff_drive, tmp_path, DIFF_QUERIES[kind], tier)
    (gp, sp, fp, cp), (gr, sr, fr, cr) = got["port"], got["ref"]
    assert cp == cr
    assert set(gp) == set(gr)
    for name in gr:
        assert gp[name].shape == gr[name].shape, name
        if name == "mmt":
            np.testing.assert_allclose(gp[name], gr[name], rtol=1e-5,
                                       atol=1e-4)
        else:
            assert np.array_equal(gp[name], gr[name]), name
    assert set(sp) == set(sr)
    for k in sr:
        if kind == "quantile_moments":
            np.testing.assert_allclose(sp[k], sr[k], rtol=1e-5, atol=1e-4)
        else:
            assert np.array_equal(sp[k], sr[k]), k
    same_maps(fp, fr, rel=0.02 if kind == "quantile_moments" else None)


def test_overflow_and_ring_advance_drop_without_raising(tmp_path):
    """The reference leaves two drops to JAX's out-of-bounds scatter: slots
    past the series budget and the column zeroer's sentinel. The port
    drops both on the host: a batch whose groups overflow the budget and
    an advance past the whole ring raise nothing, count the overflow, and
    leave exactly the reference's grid."""
    def drive(side):
        clock = [T0]
        now = lambda: clock[0]
        ids = itertools.count(1)
        inst = mkgen(side, now, tmp_path).instance("t1")
        mv = configure(side, now, max_series=64, window_steps=4,
                       max_staleness_s=1e9)
        sub, _ = mv.subscribe("t1", RATE_Q, 10.0)
        push(side, inst, ids, n_ops=100, per=2)  # 100 groups > 64 budget
        clock[0] += 3600                         # far past the 4-step ring
        push(side, inst, ids, n_ops=90, per=1)
        clock[0] += 20                           # a partial advance
        push(side, inst, ids, n_ops=70, per=3)
        mod(side, "sched").flush()
        g = sub.grids["count"]
        return (np.asarray(g.cpu().numpy() if side == "port" else g),
                sub.overflow_dropped, sub.late_dropped, sub.cap)

    got = both(drive)
    assert got["port"][1:] == got["ref"][1:]
    assert got["port"][1] > 0 and got["port"][3] == 64
    assert np.array_equal(got["port"][0], got["ref"][0])


def test_moments_grid_stays_float64(tmp_path):
    """A moments grid built from the evaluator (float64 moment sums) and
    then appended to keeps its dtype; the bound planes, count and bucket
    grids are float32."""
    from tempo_tpu_torch.ops import moments as msk

    clock = [T0]
    now = lambda: clock[0]
    ids = itertools.count(1)
    with msk.use_query_tier("moments"):
        inst = mkgen("port", now, tmp_path).instance("t1")
        mv = configure("port", now, max_staleness_s=1e9)
        push("port", inst, ids)
        q = mv.subscribe("t1", DIFF_QUERIES["quantile_moments"], 10.0)[0]
        h = mv.subscribe("t1", DIFF_QUERIES["histogram"], 10.0)[0]
        c = mv.subscribe("t1", RATE_Q, 10.0)[0]
        for _ in range(2):
            clock[0] += 10
            push("port", inst, ids)
    assert {k: g.dtype for k, g in q.grids.items()} == {
        "mmt": torch.float64, "mhi": torch.float32, "mlo": torch.float32}
    assert c.grids["count"].dtype == torch.float32
    assert h.grids["hist"].dtype == torch.float32
    assert q.state_bytes() == sum(g.numel() * g.element_size()
                                  for g in q.grids.values())


def test_materializer_runs_on_cuda_unless_asked_for_the_cpu():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tmatview.configure(tmatview.MatViewConfig())
        assert tmatview.materializer() is None
    mv = tmatview.configure(tmatview.MatViewConfig(), device="cpu")
    assert mv.device.type == "cpu" and tmatview.materializer() is mv
    assert tmatview.configure(tmatview.MatViewConfig(enabled=False)) is None
