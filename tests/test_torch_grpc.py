"""The port's gRPC plane against the reference's, on the same bytes.

Mirrors `tests/test_grpc.py`'s 9 tests on the CPU. Each side boots the
same small microservices cluster (an ingester, a metrics-generator, a
query-frontend and a distributor, joined by `grpc://` peers), takes the
same wire bytes over the same methods (OTLP `TraceService/Export`, Jaeger
`CollectorService/PostSpans`, the OpenCensus bidirectional `Export`), and
answers the same reads; the answers are compared side against side, with
no tolerance (both packages run the same host code over the same spans).
The worker-pull test runs a frontend with two remote queriers a side.

Each reference test pushes its own trace id into a cluster of its own;
here one cluster a side serves the module, so the ids differ test to test
and each test reads back only its own.
"""

from __future__ import annotations

import json
import time

import grpc
import numpy as np
import pytest

from tests.test_torch_app import free_port, _reset_port
from tests.test_torch_frontend import mod

SIDES = ("port", "ref")
TENANT = "single-tenant"
EXPORT = "/opentelemetry.proto.collector.trace.v1.TraceService/Export"



def make_app(side: str, cfg):
    App = mod(side, "app").App
    return App(cfg, device="cpu") if side == "port" else App(cfg)


def otlp_proto(trace_id: str, t0: int, name="grpc-op", svc="grpc-svc") -> bytes:
    """One span as an ExportTraceServiceRequest, written with the port's
    wire codec (the reference's test builds the same fields)."""
    from tempo_tpu_torch.model.proto_wire import (
        enc_field_bytes, enc_field_msg, enc_field_str, enc_field_varint)

    def attr(k, v):
        av = enc_field_str(1, v) if isinstance(v, str) \
            else enc_field_varint(3, v)
        return enc_field_str(1, k) + enc_field_msg(2, av)

    span = (enc_field_bytes(1, bytes.fromhex(trace_id)) +
            enc_field_bytes(2, bytes.fromhex("ab" * 8)) +
            enc_field_str(5, name) + enc_field_varint(6, 2) +
            enc_field_varint(7, t0) + enc_field_varint(8, t0 + 30_000_000) +
            enc_field_msg(9, attr("http.status_code", 200)))
    rs = (enc_field_msg(1, enc_field_msg(1, attr("service.name", svc))) +
          enc_field_msg(2, enc_field_msg(2, span)))
    return enc_field_msg(1, rs)


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    """distributor + ingester + generator + query tier over grpc:// peers,
    one cluster a side."""
    _reset_port()
    out = {}
    for side in SIDES:
        Config = mod(side, "app.config").Config
        build = mod(side, "grpcplane").build_grpc_server
        tmp = tmp_path_factory.mktemp(f"grpc-{side}")
        store = str(tmp / "store")
        apps, servers, ports = {}, [], {}

        def boot(name, cfg):
            cfg.server.http_listen_port = free_port()
            app = make_app(side, cfg)
            app.overrides.set_tenant_patch(TENANT, {
                "generator": {"processors": ["span-metrics", "local-blocks"]}})
            app.start_loops()
            srv, ports[name] = build(app)
            apps[name] = app
            servers.append(srv)

        ing = Config(target="ingester")
        ing.storage.backend = "local"
        ing.storage.local_path = store
        ing.storage.wal_path = str(tmp / "ing" / "wal")
        ing.ingester.instance.trace_idle_s = 0.1
        boot("ing", ing)
        gen = Config(target="metrics-generator")
        gen.storage.backend = "local"
        gen.storage.local_path = store
        gen.generator.localblocks.data_dir = str(tmp / "gen-lb")
        boot("gen", gen)
        peers = ({"ing-1": f"grpc://127.0.0.1:{ports['ing']}"},
                 {"gen-1": f"grpc://127.0.0.1:{ports['gen']}"})
        q = Config(target="query-frontend")
        q.storage.backend = "local"
        q.storage.local_path = store
        q.peers.ingesters, q.peers.generators = peers
        boot("query", q)
        d = Config(target="distributor")
        d.peers.ingesters, d.peers.generators = peers
        boot("dist", d)
        out[side] = (apps, ports, servers)
    yield out
    for side in SIDES:
        apps, _, servers = out[side]
        for s in servers:
            s.stop(grace=0.5)
        for a in apps.values():
            a.shutdown()
    _reset_port()


def _export(ports, body: bytes) -> bytes:
    with grpc.insecure_channel(f"127.0.0.1:{ports['dist']}") as ch:
        return ch.unary_unary(EXPORT)(body, timeout=10)


def _spans_key(spans):
    return sorted((s["span_id"], s["name"], s.get("service"), s["kind"],
                   s["status_code"], s["start_unix_nano"],
                   s["end_unix_nano"], json.dumps(s.get("attrs", {}),
                                                  sort_keys=True))
                  for s in spans)


def test_grpc_microservices_e2e(clusters):
    """OTLP/gRPC in at the distributor; trace by id, search, tag values
    and the generator's tee out of the query tier, every hop over gRPC;
    a malformed payload is INVALID_ARGUMENT on both sides."""
    t0 = int((time.time() - 5) * 1e9)
    tid = "cd" * 16
    body = otlp_proto(tid, t0)
    got = {}
    for side in SIDES:
        apps, ports, _ = clusters[side]
        assert _export(ports, body) == b""
        with pytest.raises(grpc.RpcError) as ei:
            _export(ports, b"\xff\xfe garbage")
        assert ei.value.code() == grpc.StatusCode.INVALID_ARGUMENT
        fe = apps["query"].frontend
        spans = fe.find_trace(TENANT, bytes.fromhex(tid))
        assert spans and spans[0]["name"] == "grpc-op"
        res = fe.search(TENANT, '{ resource.service.name = "grpc-svc" }')
        vals = fe.tag_values(TENANT, ".http.status_code")
        gi = apps["gen"].generator.instances.get(TENANT)
        got[side] = (_spans_key(spans), [md.to_json() for md in res],
                     sorted(v["value"] for v in vals), gi.spans_received)
    assert got["port"] == got["ref"]
    assert got["port"][1][0]["traceID"] == tid and got["port"][3] >= 1


def test_grpc_streaming_search(clusters):
    """The streaming search: a partial diff before the final message, and
    the same final trace set on both sides."""
    t0 = int((time.time() - 5) * 1e9)
    tid = "ef" * 16
    body = otlp_proto(tid, t0, name="stream-op")
    stream = {s: mod(s, "grpcplane.client").streaming_search for s in SIDES}
    got = {}
    for side in SIDES:
        apps, ports, _ = clusters[side]
        _export(ports, body)
        msgs = list(stream[side](f"127.0.0.1:{ports['query']}", TENANT,
                                 '{ name = "stream-op" }'))
        assert msgs[-1][1] is True
        assert any(not fin and any(md.trace_id == tid for md in tr)
                   for tr, fin in msgs[:-1])
        got[side] = [md.to_json() for md in msgs[-1][0]]
    assert got["port"] == got["ref"] and got["port"][0]["traceID"] == tid


def _worker_pull(side, tmp_path):
    store = str(tmp_path / side / "store")
    Config = mod(side, "app.config").Config
    be = mod(side, "backend.local").LocalBackend(store)
    TempoDB = mod(side, "db.tempodb").TempoDB
    seed_db = TempoDB(be, be, device="cpu") if side == "port" \
        else TempoDB(be, be)
    t_base = int((time.time() - 7200) * 1e9)
    for i in range(6):
        tid = bytes([i + 1] * 16)
        spans = [{"trace_id": tid, "span_id": bytes([i + 1] * 8),
                  "name": f"op-{i}", "kind": 2, "service": "scale",
                  "start_unix_nano": t_base + i * 1_000_000_000,
                  "end_unix_nano": t_base + i * 1_000_000_000 + 5_000_000,
                  "res_attrs": {"service.name": "scale"}}]
        seed_db.write_block(TENANT, [(tid, spans)])
    seed_db.poll_now()
    n_blocks = len(seed_db.blocks(TENANT))
    seed_db.shutdown()
    fe_cfg = Config(target="query-frontend")
    fe_cfg.storage.backend = "local"
    fe_cfg.storage.local_path = store
    fe_cfg.server.http_listen_port = free_port()
    fe_app = make_app(side, fe_cfg)
    fe_app.start_loops()
    fe_app.db.poll_now()
    fe_srv, fe_port = mod(side, "grpcplane").build_grpc_server(fe_app)
    Worker = mod(side, "grpcplane.client").FrontendWorker
    workers, qapps = [], []
    try:
        for i in range(2):
            q_cfg = Config(target="querier")
            q_cfg.storage.backend = "local"
            q_cfg.storage.local_path = store
            q_cfg.server.http_listen_port = free_port()
            qa = make_app(side, q_cfg)
            qa.db.poll_now()
            qapps.append(qa)
            w = Worker(f"127.0.0.1:{fe_port}", qa.querier, worker_id=f"w{i}")
            w.start()
            workers.append(w)
        deadline = time.time() + 5
        while fe_app.frontend.remote_workers < 2 and time.time() < deadline:
            time.sleep(0.05)
        assert fe_app.frontend.remote_workers == 2
        res = fe_app.frontend.search(TENANT, "{ }", limit=50,
                                     start_s=t_base / 1e9 - 60,
                                     end_s=t_base / 1e9 + 3600)
        counts = [w.jobs_executed for w in workers]
        assert sum(counts) >= n_blocks >= 2
        assert all(c > 0 for c in counts), counts
        return sorted((md.trace_id, md.root_trace_name, md.duration_ms)
                      for md in res)
    finally:
        for w in workers:
            w.shutdown()
        fe_srv.stop(grace=0.5)
        fe_app.shutdown()
        for qa in qapps:
            qa.shutdown()


def test_worker_pull_scale_out(tmp_path):
    """One frontend and two remote queriers a side: backend search jobs
    run on both workers, and the answers equal the reference's."""
    _reset_port()
    try:
        got = {side: _worker_pull(side, tmp_path) for side in SIDES}
    finally:
        _reset_port()
    assert len(got["port"]) == 6 and got["port"] == got["ref"]


def test_tempopb_wire_is_protobuf():
    """`tests/test_grpc.py:257`, each encoding byte-identical to the
    reference's and decoded to the same values by both packages (more
    cases in `test_torch_wire_models.py`)."""
    encs = {}
    for side in SIDES:
        tp = mod(side, "model.tempopb")
        md = mod(side, "traceql.engine").TraceSearchMetadata(
            trace_id="ab" * 16, root_service_name="svc",
            root_trace_name="op",
            start_time_unix_nano=1_700_000_000_000_000_000, duration_ms=42,
            span_sets=[{"spans": [{"spanID": "cd" * 8, "name": "child",
                                   "startTimeUnixNano": "123",
                                   "durationNanos": "456",
                                   "attributes": [{"key": "k", "value": {
                                       "stringValue": "v"}}]}],
                        "matched": 3}])
        TS = mod(side, "traceql.engine_metrics").TimeSeries
        series = [TS(labels=(("service", "s1"), ("name", "op")),
                     samples=np.array([0.0, 2.5, 7.0])),
                  TS(labels=(("__bucket", 0.002), ("code", 500), ("neg", -3),
                             ("flag", True)), samples=np.array([1.0]))]
        spans = [{"trace_id": b"\x01" * 16, "span_id": b"\x02" * 8,
                  "name": "t", "service": "s", "start_unix_nano": 5,
                  "end_unix_nano": 9,
                  "events": [{"time_unix_nano": 7, "name": "ev"}],
                  "links": [{"trace_id": b"\x03" * 16,
                             "span_id": b"\x04" * 8}]}]
        body = tp.enc_search_response([md], inspected=7, final=False)
        assert body[:1] != b"{"
        mds, final, inspected, stats = tp.dec_search_response(body)
        assert not final and inspected == 7 and stats.inspected_traces == 7
        got = mds[0]
        assert (got.trace_id, got.start_time_unix_nano, got.duration_ms) == \
            (md.trace_id, md.start_time_unix_nano, 42)
        assert got.span_sets[0]["matched"] == 3
        qr = tp.enc_query_range_response(series)
        for want, back in zip(series, tp.dec_query_range_response(qr)):
            assert back.labels == want.labels
            assert [type(v) for _, v in back.labels] == \
                [type(v) for _, v in want.labels]
            np.testing.assert_array_equal(back.samples, want.samples)
        tb = tp.enc_trace_by_id_response(spans)
        back = tp.dec_trace_by_id_response(tb)
        assert back[0]["events"] == [{"time_unix_nano": 7, "name": "ev"}]
        assert back[0]["links"][0]["trace_id"] == b"\x03" * 16
        assert tp.dec_trace_by_id_response(b"") is None
        pr = tp.enc_push_response([None, "trace_too_large", None])
        assert tp.dec_push_response(pr, 3) == [None, "trace_too_large", None]
        assert tp.dec_push_response(b"", 2) == [None, None]
        encs[side] = (body, qr, tb, pr)
    assert encs["port"] == encs["ref"]


def test_jaeger_grpc_post_spans(clusters):
    """`CollectorService/PostSpans`: the same jaeger-proto batch (built
    with the port's tempo-query encoder) lands in both ingesters with
    span.kind and error tags mapped to intrinsics, and is searchable."""
    from tempo_tpu_torch.model import proto_wire as pw
    from tempo_tpu_torch.tempoquery.plugin import _jaeger_span

    t0 = int((time.time() - 5) * 1e9)
    tid = bytes.fromhex("e1" * 16)
    span = {"trace_id": tid, "span_id": "aa" * 8, "name": "jgrpc-op",
            "service": "jgrpc-svc", "kind": 2, "status_code": 2,
            "start_unix_nano": t0, "end_unix_nano": t0 + 40_000_000,
            "attrs": {"http.method": "GET"},
            "res_attrs": {"service.name": "jgrpc-svc", "region": "r1"}}
    batch = (pw.enc_field_msg(1, _jaeger_span(span, tid)) +
             pw.enc_field_msg(2, pw.enc_field_str(1, "jgrpc-svc")))
    request = pw.enc_field_msg(1, batch)
    from tempo_tpu.tempoquery.plugin import _jaeger_span as ref_span
    assert ref_span(span, tid) == _jaeger_span(span, tid)
    got = {}
    for side in SIDES:
        apps, ports, _ = clusters[side]
        with grpc.insecure_channel(f"127.0.0.1:{ports['dist']}") as ch:
            post = ch.unary_unary("/jaeger.api_v2.CollectorService/PostSpans")
            assert post(request, timeout=10) == b""
        fe = apps["query"].frontend
        spans = fe.find_trace(TENANT, tid)
        assert spans and spans[0]["name"] == "jgrpc-op"
        assert (spans[0]["service"], spans[0]["kind"],
                spans[0]["status_code"]) == ("jgrpc-svc", 2, 2)
        assert spans[0]["attrs"]["http.method"] == "GET"
        res = fe.search(TENANT, '{ status = error && name = "jgrpc-op" }')
        got[side] = (_spans_key(spans), [md.to_json() for md in res])
    assert got["port"] == got["ref"] and len(got["port"][1]) == 1


def _oc_messages(t0: int, tid: bytes) -> list[bytes]:
    from tempo_tpu_torch.model import proto_wire as pw

    def ts(ns):
        return pw.enc_field_varint(1, ns // 10**9) + \
            pw.enc_field_varint(2, ns % 10**9)

    def attr(k, v):
        av = pw.enc_field_msg(1, pw.enc_field_str(1, v)) \
            if isinstance(v, str) else pw.enc_field_varint(2, v)
        return pw.enc_field_msg(1, pw.enc_field_str(1, k) +
                                pw.enc_field_msg(2, av))

    span = (pw.enc_field_bytes(1, tid) +
            pw.enc_field_bytes(2, bytes.fromhex("2c" * 8)) +
            pw.enc_field_msg(5, pw.enc_field_str(1, "oc-op")) +
            pw.enc_field_varint(6, 1) +
            pw.enc_field_msg(7, ts(t0)) +
            pw.enc_field_msg(8, ts(t0 + 25_000_000)) +
            pw.enc_field_msg(9, attr("oc.key", "v1")) +
            pw.enc_field_msg(13, pw.enc_field_varint(1, 5)))
    node = pw.enc_field_msg(3, pw.enc_field_str(1, "oc-svc"))
    span2 = (pw.enc_field_bytes(1, tid) +
             pw.enc_field_bytes(2, bytes.fromhex("3d" * 8)) +
             pw.enc_field_msg(5, pw.enc_field_str(1, "oc-op2")) +
             pw.enc_field_msg(7, ts(t0)) +
             pw.enc_field_msg(8, ts(t0 + 1_000_000)))
    return [pw.enc_field_msg(1, node) + pw.enc_field_msg(2, span),
            pw.enc_field_msg(2, span2)]


def test_opencensus_grpc_export(clusters):
    """The OpenCensus agent's bidirectional `Export`: the node on the first
    message holds for the stream; the spans land alike on both sides."""
    t0 = int((time.time() - 5) * 1e9)
    tid = bytes.fromhex("1b" * 16)
    got = {}
    for side in SIDES:
        apps, ports, _ = clusters[side]
        with grpc.insecure_channel(f"127.0.0.1:{ports['dist']}") as ch:
            export = ch.stream_stream(
                "/opencensus.proto.agent.trace.v1.TraceService/Export")
            assert len(list(export(iter(_oc_messages(t0, tid)),
                                   timeout=10))) == 2
        spans = apps["query"].frontend.find_trace(TENANT, tid)
        by_name = {s["name"]: s for s in spans}
        assert len(spans) == 2
        assert (by_name["oc-op"]["kind"], by_name["oc-op"]["status_code"]) \
            == (2, 2)
        assert by_name["oc-op"]["attrs"]["oc.key"] == "v1"
        assert by_name["oc-op2"]["service"] == "oc-svc"
        got[side] = _spans_key(spans)
    assert got["port"] == got["ref"]


def test_grpc_streaming_metrics_query_range(clusters):
    """The streaming metrics `query_range` over three backend blocks:
    diff messages that compose to the final set, and the same final
    series on both sides."""
    rng = np.random.default_rng(9)
    now_s = time.time()
    base = now_s - 7200
    blocks = []
    for b in range(3):
        traces = []
        for i in range(60):
            tid = rng.bytes(16)
            start = int((base + b * 300 + i) * 1e9)
            traces.append((tid, [{
                "trace_id": tid, "span_id": rng.bytes(8), "name": f"op-{b}",
                "service": "svc", "kind": 2, "status_code": 0,
                "start_unix_nano": start, "end_unix_nano": start + 10**7}]))
        blocks.append(sorted(traces, key=lambda t: t[0]))
    got = {}
    for side in SIDES:
        apps, ports, _ = clusters[side]
        qdb = apps["query"].db
        for traces in blocks:
            qdb.write_block(TENANT, traces, replication_factor=1)
        qdb.poll_now()
        stream = mod(side, "grpcplane.client").streaming_metrics_query_range
        msgs = list(stream(f"127.0.0.1:{ports['query']}", TENANT,
                           "{ } | rate() by (name)", start_s=base - 60,
                           end_s=now_s - 3600, step_s=300))
        assert len(msgs) >= 2, len(msgs)
        final = {tuple(s.labels): np.asarray(s.samples) for s in msgs[-1]}
        assert len(final) == 3
        acc = {}
        for m in msgs[:-1]:
            for s in m:
                acc[tuple(s.labels)] = np.asarray(s.samples)
        assert set(acc) == set(final)
        for k in final:
            np.testing.assert_allclose(acc[k], final[k])
        got[side] = {k: v.tolist() for k, v in final.items()}
    assert got["port"] == got["ref"]


def test_grpc_streaming_search_tags(clusters):
    """The streaming tag names: a diff before the final scopes map, and
    the same final map on both sides."""
    t0 = int((time.time() - 5) * 1e9)
    body = otlp_proto("aa" * 16, t0, name="tag-op")
    got = {}
    for side in SIDES:
        apps, ports, _ = clusters[side]
        _export(ports, body)
        stream = mod(side, "grpcplane.client").streaming_search_tags
        msgs = list(stream(f"127.0.0.1:{ports['query']}", TENANT))
        assert msgs[-1][1] is True and msgs[0][1] is False
        scopes = msgs[-1][0]
        assert "http.status_code" in scopes.get("span", [])
        got[side] = {k: sorted(v) for k, v in scopes.items()}
    assert got["port"] == got["ref"]


def test_grpc_streaming_search_tag_values(clusters):
    """The streaming tag values: the same final list on both sides."""
    t0 = int(time.time() - 5) * 10**9
    body = otlp_proto("bb" * 16, t0, name="tv-op")
    got = {}
    for side in SIDES:
        apps, ports, _ = clusters[side]
        _export(ports, body)
        with grpc.insecure_channel(f"127.0.0.1:{ports['query']}") as ch:
            fn = ch.unary_stream("/tempopb.StreamingQuerier/SearchTagValues")
            msgs = [json.loads(m) for m in fn(
                json.dumps({"name": ".http.status_code"}).encode(),
                timeout=30, metadata=(("x-scope-orgid", TENANT),))]
        assert msgs[-1]["final"] is True and msgs[0]["final"] is False
        assert any(v["value"] == "200" for v in msgs[-1]["tagValues"])
        got[side] = sorted(json.dumps(v, sort_keys=True)
                           for v in msgs[-1]["tagValues"])
    assert got["port"] == got["ref"]
