"""The port's staged push routes against the reference's, on dense and on
paged state, on the same OTLP bytes and a pinned clock.

Routes: `push_otlp_staged` (bytes → C++ staging → fused resolve),
`push_staged_view` over a decode-once `stage_otlp` (the full view and a
row-sliced one, with and without sample weights), and `push_otlp_recs`
(`native.otlp_scan` records, whole and a sharded subset). Both
instances run span metrics alone (the fast route), the reference on its
direct route (`kernel="xla"`) and the port on its direct route (K1's
plain version on the CPU), both on their native series tables.

Held bit-identical: the interners' strings and ids, the series tables
(first-seen slots and last-seen stamps), every count plane (calls,
histogram buckets, latency counts), the DDSketch rows, every collected
sample but the float sums, and every exemplar; also the received and
slack-filtered span counts, and a series-budget rejection that leaves no
pending row in the native table. The float-sum planes (latency `_sum`,
size) are bit-identical after a series' first push and are held at rtol
1e-6 after that (ROADMAP's numerics contract: f32 reduction order): K1
adds a push's whole f32 delta per row to the state, where the
reference's scatter adds span by span.
"""

from __future__ import annotations

import numpy as np
import pytest

from tempo_tpu import native as jnative
from tempo_tpu.generator.instance import (GeneratorConfig as JGenCfg,
                                          GeneratorInstance as JGen)
from tempo_tpu.generator.processors.spanmetrics import SpanMetricsConfig as JSmCfg
from tempo_tpu.model.otlp_batch import stage_otlp as j_stage_otlp
from tempo_tpu.registry import pages as jpages
from tempo_tpu.registry.registry import RegistryOverrides as JOv

import tempo_tpu_torch as tt
from tempo_tpu_torch.generator.processors.spanmetrics import (_DD_COUNTS,
                                                              _DD_ZEROS)
from tempo_tpu_torch.registry import pages as tpages
from tests.test_torch_native import rich_payload

T0 = 1_700_000_000.0
POOL = dict(enabled=True, page_rows=64, arena_slots=2048)
SERIES = 1024
SM = dict(sketch_max_series=256)
LAYOUTS = ("dense", "paged")


@pytest.fixture(autouse=True)
def _singletons():
    assert jnative.available(), "the reference's native layer must build"
    tt.sched.reset()
    yield
    tt.sched.reset()


def pair(layout, clock=None, series=SERIES, slack=30.0, sm=None):
    """(reference instance, port instance): span metrics alone, `layout`
    state, the clock `clock` (a one-element list)."""
    clock = clock if clock is not None else [T0]
    now = lambda: clock[0]  # noqa: E731
    pool = POOL if layout == "paged" else None
    sm = dict(SM, **(sm or {}))
    with jpages.use(pool and jpages.PagePool(jpages.PagePoolConfig(**pool))):
        jg = JGen("t", JGenCfg(
            processors=("span-metrics",), registry=JOv(max_active_series=series),
            spanmetrics=JSmCfg(**{"kernel": "xla", **sm}),
            ingestion_time_range_slack_s=slack), now=now)
    with tpages.use(pool and tpages.PagePool(tpages.PagePoolConfig(**pool),
                                             device="cpu")):
        tg = tt.GeneratorInstance("t", tt.GeneratorConfig(
            processors=("span-metrics",),
            registry=tt.RegistryOverrides(max_active_series=series),
            spanmetrics=tt.SpanMetricsConfig(**sm),
            ingestion_time_range_slack_s=slack), now=now, device="cpu")
    assert tg.state_layout == layout
    return jg, tg


def _dd_rows(proc, slots, jax_ref):
    """(counts, zeros) DDSketch rows of `slots`, as numpy."""
    if not jax_ref:
        with proc.registry.state_lock:
            return tuple(proc._rows(slots, r).numpy()
                         for r in (_DD_COUNTS, _DD_ZEROS))
    if proc._pdd is not None:
        return tuple(proc._pdd[i].gather(slots) for i in (0, 1))
    return (np.asarray(proc.dd.counts)[slots],
            np.asarray(proc.dd.zeros)[slots])


SUM_RTOL = 1e-6


def _is_sum(name, snap, i):
    """The float-sum planes: the size counter and a histogram's sums."""
    return name == "traces_spanmetrics_size_total" or (len(snap) == 3
                                                       and i == 1)


def _samples(g):
    """{(name, labels): (value, exemplar)} of one collection."""
    out = {}
    for s in g.registry.collect(1):
        ex = s.exemplar and (s.exemplar.trace_id_hex, s.exemplar.value,
                             s.exemplar.ts_ms)
        out[(s.name, s.labels)] = (s.value, ex)
    return out


def _close(a, b, is_sum) -> bool:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if not is_sum:
        return np.array_equal(a, b, equal_nan=True)
    return bool((np.abs(a - b) <= SUM_RTOL * np.abs(b)).all())


def assert_same(jg, tg) -> int:
    """The instances agree as the module doc says: span counts, interner,
    series tables, family rows, DDSketch rows, collected samples and
    exemplars. Returns the number of series."""
    assert (tg.spans_received, tg.spans_filtered_slack) == \
        (jg.spans_received, jg.spans_filtered_slack)
    assert tg.registry.interner.snapshot() == jg.registry.interner.snapshot()
    for name, jm in jg.registry._metrics.items():
        tm = tg.registry.metric(name)
        assert np.array_equal(tm.table.active, jm.table.active), name
        assert np.array_equal(tm.table.slot_keys, jm.table.slot_keys), name
        assert np.array_equal(tm.table.last_seen, jm.table.last_seen), name
        live = jm.table.active_slots()
        with tg.registry.state_lock:
            tsnap = tm._snap()
        for i, (a, b) in enumerate(zip(tsnap, jm._snap(), strict=True)):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            assert _close(np.asarray(a)[live], np.asarray(b)[live],
                          _is_sum(name, tsnap, i)), f"{name}[{i}]"
        assert tm.table._nat.size() == tm.table.active_count
    jp, tp = jg.processors["span-metrics"], tg.processors["span-metrics"]
    slots = tp._sketch_slots()
    for a, b in zip(_dd_rows(tp, slots, False), _dd_rows(jp, slots, True)):
        assert np.array_equal(a, b)
    ts, js = _samples(tg), _samples(jg)
    assert ts.keys() == js.keys()
    for (name, labels), (v, ex) in ts.items():
        jv, jex = js[(name, labels)]
        is_sum = name == "traces_spanmetrics_size_total" or \
            name.endswith("_sum")
        assert _close(v, jv, is_sum), (name, labels, v, jv)
        assert ex == jex, (name, labels)
    assert any(ex for _, ex in ts.values())
    return len(jm.table.active_slots())


def _payloads(k=3, n=500, seed=20, now=T0):
    return [rich_payload(seed + i, n=n, now_ns=int(now * 1e9))
            for i in range(k)]


def _push(route, g, stage, data, seed):
    """One push of `data` into `g` on `route`; `stage` is its package's
    stage_otlp. Returns the span count the route reports."""
    if route == "otlp_staged":
        return g.push_otlp_staged(data)
    if route.startswith("view"):
        st = stage(data, g.registry.interner, include_span_attrs=False)
        rows = None
        if "rows" in route:
            rows = np.flatnonzero(
                np.random.default_rng(seed).random(st.n) < 0.6)
        if "weighted" in route:
            st.sample_weight = np.random.default_rng(seed).integers(
                1, 4, st.n).astype(np.float32)
        return g.push_staged_view(st.view(rows))
    recs = tt.native.otlp_scan(data)
    if route == "recs_sharded":
        recs = recs[np.arange(len(recs)) % 3 == seed % 3]
    return g.push_otlp_recs(data, recs)


ROUTES = ("otlp_staged", "view_full", "view_full_weighted", "view_rows",
          "view_rows_weighted", "recs", "recs_sharded")


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("route", ROUTES)
def test_staged_route_matches_reference(route, layout):
    jg, tg = pair(layout)
    assert tg._fast_spanmetrics() is tg.processors["span-metrics"]
    for i, data in enumerate(_payloads()):
        got = _push(route, tg, tt.stage_otlp, data, i)
        assert got == _push(route, jg, j_stage_otlp, data, i) and got > 0
    assert assert_same(jg, tg) > 100


@pytest.mark.parametrize("layout", LAYOUTS)
def test_slack_filter_counts_match(layout):
    """A 5 s ingestion slack against end times spread over the 10 s before
    the clock filters about half the spans on every route; with the
    clock far ahead, every span."""
    clock = [T0]
    jg, tg = pair(layout, clock, slack=5.0)
    data = _payloads(k=1)[0]
    for route in ("otlp_staged", "view_full", "recs"):
        for g, stage in ((jg, j_stage_otlp), (tg, tt.stage_otlp)):
            _push(route, g, stage, data, 0)
    assert 0.3 < tg.spans_filtered_slack / tg.spans_received < 0.7
    assert_same(jg, tg)
    clock[0] += 10_000
    before = tg.spans_filtered_slack
    for g, stage in ((jg, j_stage_otlp), (tg, tt.stage_otlp)):
        _push("view_full", g, stage, data, 0)
    assert tg.spans_filtered_slack - before == 500
    assert_same(jg, tg)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_series_budget_rejection_leaves_no_pending_row(layout):
    """A tenant budget of 64 series under ~500 label sets a push: the same
    series are accepted and rejected in both packages, the rejected ones
    leave no pending entry in the native row table, and a later push
    resolves the same way again."""
    jg, tg = pair(layout, series=64)
    for i, data in enumerate(_payloads(k=2)):
        for route in ("otlp_staged", "recs"):
            assert _push(route, tg, tt.stage_otlp, data, i) == \
                _push(route, jg, j_stage_otlp, data, i)
    table = tg.processors["span-metrics"].calls.table
    assert table.active_count == 64 and table._nat.size() == 64
    assert tg.registry.discarded_series == jg.registry.discarded_series > 0
    assert_same(jg, tg)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_default_instance_staged_batch_route_matches_reference(layout):
    """Default instances (span metrics and service graphs) take the staged
    SpanBatch route of `push_staged_view` (full and row-sliced views of
    trace-tree payloads with sample weights): every span-metrics and
    service-graph family agrees with the reference's, under the rules
    of the module doc."""
    from chip_smoke import trace_tree_spans
    from tempo_tpu_torch.model.otlp import encode_spans_otlp

    pool = POOL if layout == "paged" else None
    now = lambda: T0  # noqa: E731
    with jpages.use(pool and jpages.PagePool(jpages.PagePoolConfig(**pool))):
        jg = JGen("t", JGenCfg(registry=JOv(max_active_series=SERIES),
                               spanmetrics=JSmCfg(kernel="xla", **SM)),
                  now=now)
    with tpages.use(pool and tpages.PagePool(tpages.PagePoolConfig(**pool),
                                             device="cpu")):
        tg = tt.GeneratorInstance("t", tt.GeneratorConfig(
            registry=tt.RegistryOverrides(max_active_series=SERIES),
            spanmetrics=tt.SpanMetricsConfig(**SM)), now=now, device="cpu")
    assert tuple(tg.processors) == ("span-metrics", "service-graphs")
    assert tg._fast_spanmetrics() is None
    for k in range(3):
        data = encode_spans_otlp(trace_tree_spans(
            400, seed=30 + k, now_ns=int(T0 * 1e9), n_services=6, n_ops=6))
        for g, stage in ((jg, j_stage_otlp), (tg, tt.stage_otlp)):
            st = stage(data, g.registry.interner)
            st.sample_weight = np.random.default_rng(k).integers(
                1, 4, st.n).astype(np.float32)
            rows = None if k < 2 else np.arange(0, st.n, 2)
            assert g.push_staged_view(st.view(rows)) == (400 if k < 2 else 200)
    assert tg.registry.metric("traces_service_graph_request_total") \
        .table.active_count > 10
    assert assert_same(jg, tg) > 10


def test_ineligible_instances_take_the_batch_route():
    """A default instance (span metrics and service graphs), or span
    metrics with a custom dimension, is not eligible for the fast
    routes: `push_otlp_staged` / `push_otlp_recs` return None and change
    nothing, and `push_staged_view` rides the staged SpanBatch. A view
    of another tenant's staging is refused."""
    data = _payloads(k=1)[0]
    for cfg in (tt.GeneratorConfig(),
                tt.GeneratorConfig(processors=("span-metrics",),
                                   spanmetrics=tt.SpanMetricsConfig(
                                       dimensions=("http.method",)))):
        cfg.registry = tt.RegistryOverrides(max_active_series=SERIES)
        cfg.spanmetrics.sketch_max_series = 256
        g = tt.GeneratorInstance("t", cfg, now=lambda: T0, device="cpu")
        assert g._fast_spanmetrics() is None
        assert g.push_otlp_staged(data) is None
        assert g.push_otlp_recs(data, tt.native.otlp_scan(data)) is None
        assert g.registry.active_series == 0 and g.spans_received == 0
        st = tt.stage_otlp(data, g.registry.interner)
        assert g.push_staged_view(st.view()) == 500
        assert g.registry.active_series > 0 and g.spans_received == 500
        other = tt.stage_otlp(data, tt.model.StringInterner())
        assert g.push_staged_view(other.view()) is None


@pytest.mark.parametrize("layout", LAYOUTS)
def test_service_name_fixup_payload_leaves_the_fast_route(layout):
    """A resource whose last service.name is not a string needs the Python
    fixup: `push_otlp_staged` returns None and changes nothing, and
    `push_staged_view` takes the staged SpanBatch route, whose series
    carry the stringified name, in both packages alike."""
    from tests.test_torch_otlp_batch import _svc_payload

    jg, tg = pair(layout)
    data = _svc_payload(["x", 42], t0=int((T0 - 1) * 1e9))
    assert tg.push_otlp_staged(data) is None is jg.push_otlp_staged(data)
    assert tg.registry.active_series == 0 and tg.spans_received == 0
    for g, stage in ((jg, j_stage_otlp), (tg, tt.stage_otlp)):
        assert g.push_staged_view(stage(data, g.registry.interner).view()) == 1
    assert {dict(s.labels)["service"] for s in tg.registry.collect(1)} == \
        {"42"}
    assert_same(jg, tg)
