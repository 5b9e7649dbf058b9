"""The generator's local-blocks processor and the span-metrics summary
against the reference (`tests/test_localblocks.py`, its 9 tests, each on
both packages with the same inputs).

`query_range` counts and `get_metrics` histograms are equal to the
reference's through the live → WAL → complete → flush lifecycle (to a
`MemBackend`), through `GeneratorInstance` and through `Generator`'s
overrides; without the processor both packages raise.
"""

from __future__ import annotations

import dataclasses
import os
import shutil

import numpy as np
import pytest

from tempo_tpu.generator.processors.spanmetrics import (
    SpanMetricsConfig as JSmCfg)
import tempo_tpu_torch as tt
from tempo_tpu_torch import sched as tsched
from tests.test_torch_frontend import mod

T0 = 1_700_000_000.0
SIDES = ("ref", "port")


@pytest.fixture(autouse=True)
def _singletons():
    tsched.reset()
    yield
    tsched.reset()


def _kw(side):
    return {"device": "cpu"} if side == "port" else {}


def build_batch(side, n=20, interner=None, t0_s=T0):
    b = mod(side, "model.span_batch").SpanBatchBuilder(interner)
    for i in range(n):
        tid = bytes([i + 1]) * 16
        b.append(trace_id=tid, span_id=bytes([1]) * 8,
                 name=f"op-{i % 3}", service=f"svc-{i % 2}",
                 status_code=(2 if i % 5 == 0 else 0),
                 start_unix_nano=int((t0_s + i) * 1e9),
                 end_unix_nano=int((t0_s + i) * 1e9) + (1 << (20 + i % 4)),
                 attrs={"http.path": f"/p{i % 2}", "n": i})
    return b.build()


def gen_cfg(side, **lb):
    lbm = mod(side, "generator.processors.localblocks")
    sm = (tt.SpanMetricsConfig(sketch_max_series=256) if side == "port"
          else JSmCfg(kernel="xla", sketch_max_series=256))
    return mod(side, "generator.instance").GeneratorConfig(
        processors=("span-metrics", "local-blocks"), spanmetrics=sm,
        localblocks=lbm.LocalBlocksConfig(**lb))


def counts(series) -> dict:
    return {s.labels: float(np.nansum(s.samples)) for s in series}


def summary(res) -> list:
    return [(r.labels if hasattr(r, "labels") else None,
             r.histogram.count, r.error_count, r.histogram.buckets.tolist())
            for r in res.results()]


def test_span_dicts_respect_valid_mask():
    """Rows invalidated (e.g. slack-filtered) must not be persisted."""
    got = []
    for side in SIDES:
        sb = build_batch(side, 5)
        valid = sb.valid.copy()
        valid[2] = False
        spans = dataclasses.replace(sb, valid=valid).to_span_dicts()
        assert len(spans) == 4
        assert all(s["trace_id"] != bytes([3]) * 16 for s in spans)
        got.append(spans)
    assert got[0] == got[1]


def test_span_dicts_round_trip():
    got = []
    for side in SIDES:
        spans = build_batch(side, 5).to_span_dicts()
        assert len(spans) == 5
        s = spans[0]
        assert s["name"] == "op-0" and s["service"] == "svc-0"
        assert s["attrs"]["http.path"] == "/p0" and s["attrs"]["n"] == 0
        assert isinstance(s["attrs"]["n"], int)
        assert s["status_code"] == 2
        got.append(spans)
    assert got[0] == got[1]


def test_bucketize_matches_reference_semantics():
    d = np.array([1, 2, 3, 1024, 1025, 1 << 40, (1 << 40) + 1])
    want = [0, 1, 2, 10, 11, 40, 41]
    for side in SIDES:
        assert mod(side, "traceql.metrics_summary").bucketize_ns(
            d).tolist() == want


def test_latency_histogram_percentile():
    got = []
    for side in SIDES:
        h = mod(side, "traceql.metrics_summary").LatencyHistogram.empty()
        h.buckets[10] = 100  # all values in (512, 1024]
        p50 = h.percentile(0.5)
        assert 512 < p50 <= 1024
        assert h.percentile(1.0) == 1024
        assert h.percentile(0.1) <= h.percentile(0.5) <= h.percentile(0.9)
        got.append([h.percentile(q) for q in (0.1, 0.5, 0.9, 1.0)])
    assert got[0] == got[1]


def test_get_metrics_grouping_and_errors():
    out = {}
    for side in SIDES:
        ms = mod(side, "traceql.metrics_summary")
        traces = {}
        for s in build_batch(side, 20).to_span_dicts():
            traces.setdefault(s["trace_id"], []).append(s)
        view = mod(side, "traceql.memview").view_from_traces(
            list(traces.items()))
        res = ms.get_metrics("{ }", ["resource.service.name"],
                             iter([(view, np.arange(view.n))]))
        assert len(res.series) == 2
        assert sum(s.histogram.count for s in res.results()) == 20
        assert sum(s.error_count for s in res.results()) == 4
        res2 = ms.get_metrics('{ resource.service.name = "svc-0" }', [],
                              iter([(view, np.arange(view.n))]))
        assert res2.results()[0].histogram.count == 10
        js = res.results()[0].to_json()
        assert js["p50"] > 0 and js["spanCount"] > 0
        out[side] = ([r.to_json() for r in res.results()],
                     [r.to_json() for r in res2.results()])
    assert out["port"] == out["ref"]


def test_localblocks_lifecycle_and_query(tmp_path):
    req_kw = dict(query="{ } | rate()", start_ns=int(T0 * 1e9),
                  end_ns=int((T0 + 60) * 1e9), step_ns=int(60 * 1e9))
    got = {}
    for side in SIDES:
        clock = [T0 + 100]
        be = mod(side, "backend.mem").MemBackend()
        lbm = mod(side, "generator.processors.localblocks")
        p = lbm.LocalBlocksProcessor(
            "t1", lbm.LocalBlocksConfig(
                data_dir=str(tmp_path / side), trace_idle_s=1.0,
                max_block_duration_s=10.0, flush_to_storage=True),
            flush_writer=be, now=lambda: clock[0], **_kw(side))
        p.push_batch(build_batch(side, 20))
        req = mod(side, "traceql.engine_metrics").QueryRangeRequest(**req_kw)
        live = counts(p.query_range(req))
        assert sum(live.values()) > 0
        clock[0] += 2
        p.cut_tick()
        assert not p.inst.complete_blocks() and p.inst.head is not None
        wal = counts(p.query_range(req))
        clock[0] += 11
        p.cut_tick()
        assert len(p.inst.complete_blocks()) == 1
        meta = next(iter(p.inst.complete.values())).meta
        assert meta.replication_factor == 1
        assert meta.block_id in mod(side, "backend.raw").blocks(be, "t1")
        done = counts(p.query_range(req))
        assert sum(done.values()) == 20
        res = p.get_metrics("{ }", ["name"])
        assert sum(s.histogram.count for s in res.results()) == 20
        views = list(p.views_for_matview())
        got[side] = (live, wal, done, summary(res), len(views))
        if side == "port":
            assert p.device.type == "cpu"
            assert all(v.meta.get("device") == p.device for v, _ in views)
    assert got["port"] == got["ref"]


def test_generator_instance_localblocks_wiring(tmp_path):
    got = {}
    for side in SIDES:
        clock = [T0]
        gi = mod(side, "generator.instance").GeneratorInstance(
            "t1", gen_cfg(side, data_dir=str(tmp_path / side),
                          trace_idle_s=1.0),
            now=lambda: clock[0], **_kw(side))
        assert gi._fast_spanmetrics() is None     # the SpanBatch route
        sb = build_batch(side, 10, interner=gi.registry.interner,
                         t0_s=clock[0] - 5)
        gi.push_batch(sb)
        req = mod(side, "traceql.engine_metrics").QueryRangeRequest(
            query="{ } | count_over_time()",
            start_ns=int((clock[0] - 60) * 1e9),
            end_ns=int((clock[0] + 60) * 1e9), step_ns=int(120 * 1e9))
        series = counts(gi.query_range(req))
        assert sum(series.values()) == 10
        res = gi.get_metrics("{ }", ["resource.service.name"])
        assert sum(s.histogram.count for s in res.results()) == 10
        gi.tick()  # maintenance pass runs without error
        clock[0] += 10
        gi.tick(immediate=True)
        lb = gi.processors["local-blocks"]
        assert len(lb.inst.complete_blocks()) == 1
        got[side] = (series, summary(res), counts(gi.query_range(req)),
                     gi.needs_attr_columns())
    assert got["port"] == got["ref"]


def test_generator_service_push_and_query(tmp_path):
    """Generator service: the distributor's client protocol end-to-end,
    through overrides-driven processor selection."""
    got = {}
    for side in SIDES:
        clock = [T0]
        ov = mod(side, "overrides").Overrides()
        ov.set_tenant_patch("t1", {"generator": {
            "processors": ["span-metrics", "local-blocks"]}})
        g = mod(side, "generator").Generator(
            gen_cfg(side, data_dir=str(tmp_path / side)), overrides=ov,
            now=lambda: clock[0], **_kw(side))
        spans = []
        for i in range(15):
            t0 = int((clock[0] - 5) * 1e9)
            spans.append({"trace_id": bytes([i + 1]) * 16,
                          "span_id": b"\x01" * 8, "name": "op",
                          "service": "svc", "start_unix_nano": t0,
                          "end_unix_nano": t0 + 10 ** 7})
        g.push_spans("t1", spans)
        assert set(g.instance("t1").processors) == {"span-metrics",
                                                    "local-blocks"}
        req = mod(side, "traceql.engine_metrics").QueryRangeRequest(
            query="{ } | count_over_time()",
            start_ns=int((clock[0] - 60) * 1e9),
            end_ns=int((clock[0] + 60) * 1e9), step_ns=int(120 * 1e9))
        series = counts(g.query_range("t1", req))
        assert sum(series.values()) == 15
        assert g.query_range("ghost", req) == []
        assert "ghost" not in g.instances
        g.collect_all()
        got[side] = (series, summary(g.get_metrics("t1", "{ }", ["name"])))
    assert got["port"] == got["ref"]


def test_generator_without_localblocks_raises():
    for side in SIDES:
        gi = mod(side, "generator.instance").GeneratorInstance(
            "t1", mod(side, "generator.instance").GeneratorConfig(
                processors=("span-metrics",)), **_kw(side))
        with pytest.raises(RuntimeError, match="local-blocks"):
            gi.get_metrics("{ }", [])
        with pytest.raises(RuntimeError, match="local-blocks"):
            gi.query_range(None)
        ta = mod(side, "generator.instance").GeneratorInstance(
            "t1", mod(side, "generator.instance").GeneratorConfig(
                processors=("trace-analytics",)), **_kw(side))
        with pytest.raises(RuntimeError, match="local-blocks"):
            ta.query_range(None)


def test_default_config_matches_reference(tmp_path):
    """`GeneratorConfig.localblocks` and `localblocks_flush_writer` carry
    the reference's defaults; an empty `data_dir` makes a temporary one."""
    from tempo_tpu.generator.instance import GeneratorConfig as JCfg

    t, j = tt.GeneratorConfig(), JCfg()
    assert dataclasses.asdict(t.localblocks) == dataclasses.asdict(
        j.localblocks)
    assert t.localblocks_flush_writer is j.localblocks_flush_writer is None
    lbm = mod("port", "generator.processors.localblocks")
    p = lbm.LocalBlocksProcessor("t1", device="cpu")
    assert p.inst.wal_dir.endswith("wal") and p.flush_writer is None
    shutil.rmtree(os.path.dirname(p.inst.wal_dir))
