"""The port's App: config, module wiring, the HTTP API end to end, and a
single-binary differential against the reference's App.

Mirrors `tests/test_app.py` on the CPU with `App(device="cpu")`: config
YAML and env, the unknown key, warnings, target wiring, the HTTP end to
end, tag values from the ingester, malformed and gzip OTLP, Zipkin, the
summary without a generator, the ops drift, the v2 endpoints, the
usage-stats status and the two cache tiers; with them the two reference
tests left for the App, `tests/test_matview.py:591`
(`test_config_check_matview_bounds`) and `tests/test_traceanalytics.py:467`
(`test_quantile_endpoint_serves_latency_shares`).

`test_jaeger_receiver` (`tests/test_app.py:311`) runs on both Apps of
the differential pair. `test_jaeger_agent_udp_receiver` and
`test_jaeger_agent_wired_into_app` are mirrored in
`test_torch_kafka.py`; the agent's datagram decoder is held in
`test_torch_wire_models.py`, with
`test_jaeger_agent_dos_datagram_rejected_fast`.

The differential test pushes the same seeded OTLP protobuf over HTTP
into the reference's App (JAX on the CPU) and the port's, and compares
trace by id and search (equal), a rate and a quantile `query_range`
(equal: both run the same host and plane code over the same rows on the
CPU, so no tolerance is needed there), and the `/metrics` family names
(equal, less a listed set that only one side has).
"""

from __future__ import annotations

import gzip
import json
import os
import re
import socket
import time
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest

from tempo_tpu_torch import matview as tmatview
from tempo_tpu_torch import sched as tsched
from tempo_tpu_torch.app import App, load_config
from tempo_tpu_torch.app.api import serve
from tempo_tpu_torch.app.config import Config
from tempo_tpu_torch.generator.processors import traceanalytics as tta
from tempo_tpu_torch.ops import moments as tmoments
from tempo_tpu_torch.parallel import serving as tserving
from tempo_tpu_torch.registry import pages as tpages
from tempo_tpu_torch.utils import dataquality as tdq
from tempo_tpu_torch.utils import faults as tfaults


def _reset_port():
    tsched.reset()
    tmatview.reset()
    tpages.reset()
    tfaults.reset()
    tmoments.set_query_tier("log2")
    tta.reset_counters()
    tdq.reset_orphan_spans()
    tserving.reset()


@pytest.fixture(autouse=True)
def _singletons():
    """The App configures the port's process singletons (scheduler,
    materializer, page pool, fault points, moments query tier): reset
    around each test (the reference's are reset by tests/conftest.py)."""
    _reset_port()
    yield
    _reset_port()


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def _cfg(tmp_path, **server):
    cfg = Config()
    cfg.storage.backend = "mem"
    cfg.storage.wal_path = str(tmp_path / "d" / "wal")
    cfg.generator.localblocks.data_dir = str(tmp_path / "lb")
    cfg.server.http_listen_port = server.get("port", free_port())
    cfg.ingester.instance.trace_idle_s = 0.1
    return cfg


def _get(url: str):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, json.loads(r.read() or b"{}")


def _post(url: str, body: bytes, ctype="application/json"):
    req = urllib.request.Request(url, data=body,
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=10) as r:
        return r.status, json.loads(r.read() or b"{}")


def _code(fn) -> int:
    try:
        return fn()[0]
    except urllib.error.HTTPError as e:
        return e.code


OTLP = {"resourceSpans": [{
    "resource": {"attributes": [
        {"key": "service.name", "value": {"stringValue": "shop"}}]},
    "scopeSpans": [{"spans": [{
        "traceId": "0102030405060708090a0b0c0d0e0f10",
        "spanId": "0102030405060708",
        "name": "checkout", "kind": 3,
        "startTimeUnixNano": "{t0}",
        "endTimeUnixNano": "{t1}",
        "attributes": [{"key": "http.status_code",
                        "value": {"intValue": "200"}}],
        "status": {"code": 0}}]}]}]}


def _otlp_body(tid: str | None = None) -> bytes:
    t0 = int((time.time() - 5) * 1e9)
    body = json.dumps(OTLP).replace('"{t0}"', str(t0)) \
                           .replace('"{t1}"', str(t0 + 50_000_000))
    if tid is not None:
        body = body.replace("0102030405060708090a0b0c0d0e0f10", tid)
    return body.encode()


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

def test_config_yaml_and_env(monkeypatch, tmp_path):
    monkeypatch.setenv("BUCKET", "my-bucket")
    p = tmp_path / "tempo.yaml"
    p.write_text("""
target: all
server:
  http_listen_port: 9999
storage:
  backend: mem
  cloud: {bucket: "${BUCKET}", region: "${REGION:-us-east1}"}
ingester:
  instance: {max_block_duration_s: 120.0}
frontend:
  target_bytes_per_job: 52428800
""")
    cfg = load_config(str(p))
    assert cfg.server.http_listen_port == 9999
    assert cfg.storage.cloud == {"bucket": "my-bucket", "region": "us-east1"}
    assert cfg.ingester.instance.max_block_duration_s == 120.0
    assert cfg.frontend.target_bytes_per_job == 50 * 1024 * 1024
    assert cfg.check() == []
    from tempo_tpu.app.config import load_config as jload
    import dataclasses
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jload(str(p)))


def test_config_unknown_key_rejected():
    with pytest.raises(ValueError, match="unknown config key"):
        load_config(text="storage: {bukkit: x}")


def test_config_warnings():
    cfg = load_config(text="ingester: {instance: {max_block_duration_s: 5}}")
    assert any("max_block_duration" in w for w in cfg.check())


@pytest.mark.parametrize("text", [
    "", "compactor: {retention_s: 60, backfill_sidecars: 100}",
    "sched: {batch_window_ms: 500, tuning: auto, tuning_window_max_ms: 200}",
    "generator: {spanmetrics: {sketch: bogus, moments_k: 40, kernel: "
    "pallas, compact_state: true}}",
    "mesh: {devices: 3, series_shards: 2}",
    "fleet: {enabled: true, checkpoint_prefix: a/b}",
    "wal: {enabled: true, fsync: never, segment_max_bytes: 1}",
    "selftrace: {enabled: true, endpoint: x, head_sample_rate: 2}",
    "distributor: {jaeger_agent_port: 6831, jaeger_agent_host: 0.0.0.0, "
    "generator_placement: nowhere}",
    "pages: {enabled: true, page_rows: 7}",
    "generator: {traceanalytics: {trace_idle_s: 0, share_min: 0.9, "
    "share_max: 0.1}}",
])
def test_config_defaults_and_warnings_match_reference(text):
    """Every key, default and warning equals the reference's, on the
    default config and on configs that trip each warning group."""
    import dataclasses

    from tempo_tpu.app.config import load_config as jload
    t, j = load_config(text=text), jload(text=text)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.check() == j.check()
    if text:
        assert t.check()


def test_config_check_matview_bounds():
    """`tests/test_matview.py:591`."""
    cfg = Config()
    assert not [w for w in cfg.check() if "matview" in w]
    cfg.matview.window_steps = 1
    cfg.matview.max_staleness_s = 0.0
    cfg.matview.auto_subscribe_after = 0
    warns = "\n".join(cfg.check())
    assert "matview.window_steps < 2" in warns
    assert "matview.max_staleness_s" in warns
    assert "matview.auto_subscribe_after" in warns


def test_main_config_check_and_flags(tmp_path, capsys):
    """`python -m tempo_tpu_torch` with the reference's flags:
    `-config.check` prints the warnings and exits 0 without building
    the App."""
    from tempo_tpu_torch.__main__ import main
    p = tmp_path / "c.yaml"
    p.write_text("ingester: {instance: {max_block_duration_s: 5}}\n")
    assert main(["-config.file", str(p), "-config.check", "-target",
                 "querier", "-server.http-listen-port", "1234"]) == 0
    out = capsys.readouterr()
    assert "config ok" in out.out
    assert "max_block_duration" in out.err


# ---------------------------------------------------------------------------
# wiring
# ---------------------------------------------------------------------------

def test_target_wiring(tmp_path):
    cfg = Config()
    cfg.storage.backend = "mem"
    cfg.storage.wal_path = str(tmp_path / "wal")
    cfg.target = "querier"
    app = App(cfg, device="cpu")
    assert app.querier is not None and app.db is not None
    assert app.distributor is None and app.ingester is None
    assert app.db.device.type == "cpu"
    with pytest.raises(ValueError):
        App(Config(target="bogus"), device="cpu")


def test_all_target_hands_its_device_to_every_module(tmp_path):
    """At target `all` the App builds every module the reference's does,
    on its device: the generator, `TempoDB` (plane and merge) and the
    materializer; the default device is `cuda`, which raises here."""
    import torch

    app = App(_cfg(tmp_path), device="cpu")
    try:
        for mod in ("distributor", "ingester", "generator", "querier",
                    "frontend", "db"):
            assert getattr(app, mod) is not None, mod
        assert app.device.type == "cpu"
        assert app.generator.device.type == "cpu"
        assert app.db.device.type == "cpu"
        assert app.db.planes.device.type == "cpu"
        assert tmatview.materializer() is app.matview
        assert app.matview.device.type == "cpu"
        assert app.mesh is None and app.pages is None
        assert app.distributor.cfg.rf == 1 and app.querier.cfg.rf == 1
    finally:
        app.shutdown()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            App(_cfg(tmp_path))


def _later_cases():
    def wal(c):
        c.wal.enabled = True
        c.wal.dir = os.path.join(os.path.dirname(c.storage.wal_path), "gwal")

    def fleet(c):
        c.fleet.enabled = True

    def mesh(c):
        c.mesh.enabled = True

    def kafka(c):
        c.ingest.enabled = True
        c.ingest.kafka_bootstrap = "127.0.0.1:9092"

    def agent(c):
        c.distributor.jaeger_agent_port = 6831

    def grpc(c):
        c.server.grpc_listen_port = 9095

    def worker(c):
        c.target = "querier"
        c.querier_worker.frontend_address = "grpc://127.0.0.1:9095"

    def selftrace(c):
        c.selftrace.enabled = True

    def endpoint(c):
        c.self_tracing_endpoint = "http://127.0.0.1:4318"

    def grpc_peer(c):
        c.peers.ingesters = {"ingester-1": "grpc://127.0.0.1:9095"}

    # item None: ported (item 12), the App boots, takes a push and shows
    # the part on /status; item "9b": ported with item 9b (the gRPC plane
    # and self-tracing), the App boots and builds the part
    return [(wal, None, False), (fleet, None, False), (mesh, "13", False),
            (kafka, "14", False), (agent, "14", True), (grpc, "9b", True),
            (worker, "9b", True), (selftrace, "9b", True),
            (endpoint, "9b", True), (grpc_peer, "9b", False)]


def _check_ported_surface(cfg):
    """The App builds the part the reference builds for `cfg`: the gRPC
    server, the frontend worker, the self-tracer (loopback or endpoint)
    or the gRPC peer clients."""
    from tempo_tpu_torch.grpcplane import (FrontendWorker,
                                           GrpcIngesterClient)
    from tempo_tpu_torch.utils import tracing

    app = App(cfg, device="cpu")
    try:
        app.start_loops()
        assert app.ready
        if cfg.server.grpc_listen_port:
            assert app.grpc_server is not None and app.grpc_port
        if cfg.querier_worker.frontend_address:
            assert isinstance(app.frontend_worker, FrontendWorker)
        if cfg.selftrace.enabled or cfg.self_tracing_endpoint:
            t = tracing.tracer()
            assert isinstance(t, tracing.SelfTracer)
            assert t.loopback == cfg.selftrace.enabled
        if cfg.peers.ingesters:
            assert isinstance(app.distributor.ingester_clients["ingester-1"],
                              GrpcIngesterClient)
    finally:
        app.shutdown()
    assert isinstance(tracing.tracer(), tracing.NoopTracer)


@pytest.mark.parametrize("patch,item,at_start", _later_cases(),
                         ids=lambda v: getattr(v, "__name__", str(v)))
def test_unported_configurations_raise_naming_their_item(
        tmp_path, patch, item, at_start):
    """The configurations once unported, by the item that brought them
    (the name and the cases are kept from when they raised). `wal` and
    `fleet` (item 12) boot, take a push into the generator and report
    their part on /status; the gRPC plane and self-tracing (9b) boot and
    build their part; the Kafka bus and the Jaeger agent (14) boot and
    carry a push into the generator; the serving mesh (13) boots as a
    1 x 1 mesh over the App's device, shows on /status and the `/metrics`
    gauges, and carries a push."""
    cfg = _cfg(tmp_path)
    patch(cfg)
    if item == "9b":
        if cfg.server.grpc_listen_port:
            cfg.server.grpc_listen_port = free_port()
        return _check_ported_surface(cfg)
    if item is None:
        from tempo_tpu_torch.model.otlp import encode_spans_otlp, synthetic_spans
        app = App(cfg, device="cpu")
        try:
            app.overrides.set_tenant_patch("single-tenant", {
                "generator": {"processors": ["span-metrics"]}})
            app.start_loops()
            spans = synthetic_spans(32, seed=3,
                                    now_ns=int((time.time() - 5) * 1e9))
            assert app.generator.push_otlp(
                "single-tenant", encode_spans_otlp(spans)) == 32
            part = app.generator.wal.status() if cfg.wal.enabled \
                else app.fleet.status()
            assert part["appended_batches" if cfg.wal.enabled
                        else "held_tenants"] >= 1
            assert app.ready
        finally:
            app.shutdown()
        return
    if item == "14":
        return _check_item_14(cfg)
    return _check_item_13(cfg)


def _check_item_13(cfg):
    """`mesh.enabled`: the process mesh over the App's device, its
    /status block and gauges, and a push that lands through it."""
    from tempo_tpu_torch.model.otlp import encode_spans_otlp, synthetic_spans

    app = App(cfg, device="cpu")
    try:
        assert app.mesh is tserving.active()
        assert app.db.planes.mesh is app.mesh.plane_mesh
        app.overrides.set_tenant_patch("single-tenant", {
            "generator": {"processors": ["span-metrics"]}})
        app.start_loops()
        srv = serve(app, block=False)
        base = f"http://127.0.0.1:{cfg.server.http_listen_port}"
        try:
            assert _get(base + "/status")[1]["mesh"] == {
                "devices": 1, "data_shards": 1, "series_shards": 1}
            with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
                assert b"tempo_mesh_series_shards 1" in r.read()
        finally:
            srv.shutdown()
            srv.server_close()
        spans = synthetic_spans(32, seed=3,
                                now_ns=int((time.time() - 5) * 1e9))
        assert app.generator.push_otlp("single-tenant",
                                       encode_spans_otlp(spans)) == 32
        proc = app.generator.instance("single-tenant").processors[
            "span-metrics"]
        app.sched.flush()
        assert proc._mesh is app.mesh
    finally:
        app.shutdown()


def _check_item_14(cfg):
    """The Kafka bus (on the mock broker) and the Jaeger agent receiver
    boot; a push reaches the generator through each."""
    from tempo_tpu_torch.ingest.kafka import KafkaBus
    from tempo_tpu_torch.model.otlp import encode_spans_otlp, synthetic_spans
    from tests.mock_kafka import start_mock_kafka
    from tests.test_app import _agent_datagram

    srv = None
    if cfg.ingest.kafka_bootstrap:
        srv, kport, _ = start_mock_kafka(n_partitions=cfg.ingest.n_partitions)
        cfg.ingest.kafka_bootstrap = f"127.0.0.1:{kport}"
    if cfg.distributor.jaeger_agent_port:
        cfg.distributor.jaeger_agent_port = free_port()
    app = App(cfg, device="cpu")
    try:
        app.overrides.set_tenant_patch("single-tenant", {
            "generator": {"processors": ["span-metrics"]}})
        app.start_loops()
        assert app.ready
        gen = app.generator
        if srv is not None:
            assert isinstance(app.bus, KafkaBus)
            spans = synthetic_spans(16, seed=3,
                                    now_ns=int((time.time() - 5) * 1e9))
            app.distributor.push_otlp("single-tenant",
                                      encode_spans_otlp(spans))
            while gen.consume_bus(app.bus, range(app.bus.n_partitions)):
                pass
            want = 16
        else:
            assert app.jaeger_agent.cfg.host == "127.0.0.1"
            gram = _agent_datagram("agent-svc", [{
                "tid_lo": 7, "tid_hi": 0, "sid": 1, "name": "agent-op",
                "start_us": int((time.time() - 2) * 1e6), "dur_us": 1000,
                "tags": {}}])
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            s.sendto(gram, ("127.0.0.1", app.jaeger_agent.port))
            s.close()
            want = 1
        deadline = time.time() + 5
        while time.time() < deadline and (
                "single-tenant" not in gen.instances or
                gen.instance("single-tenant").spans_received < want):
            time.sleep(0.02)
        assert gen.instance("single-tenant").spans_received == want
    finally:
        app.shutdown()
        if srv is not None:
            srv.shutdown()


def test_http_peer_builds_rpc_clients(tmp_path):
    """Static `http://` peers ride the HTTP RPC clients (`rpc.py`), as in
    the reference."""
    from tempo_tpu_torch.rpc import RemoteGeneratorClient, RemoteIngesterClient
    cfg = _cfg(tmp_path)
    cfg.target = "distributor"
    cfg.peers.ingesters = {"ingester-1": "http://127.0.0.1:1"}
    cfg.peers.generators = {"generator-1": "http://127.0.0.1:2"}
    app = App(cfg, device="cpu")
    try:
        assert isinstance(app.distributor.ingester_clients["ingester-1"],
                          RemoteIngesterClient)
        assert isinstance(app.distributor.generator_clients["generator-1"],
                          RemoteGeneratorClient)
        assert set(app.rings) == {"ingester", "generator"}
    finally:
        app.shutdown()


def test_app_rejects_both_cache_tiers():
    cfg = Config(target="querier")
    cfg.storage.backend = "mem"
    cfg.storage.memcached_addrs = "127.0.0.1:11211"
    cfg.storage.redis_addrs = "127.0.0.1:6379"
    with pytest.raises(ValueError, match="ONE shared cache tier"):
        App(cfg, device="cpu")


@pytest.mark.parametrize("tier", ["memcached", "redis"])
def test_app_shared_cache_tier_serves_its_roles(tier):
    """One shared tier (memcached or redis) takes the configured roles
    in the store's `CacheProvider`; the others stay in-process LRUs."""
    from tempo_tpu_torch.backend.memcached import MemcachedCache, RedisCache
    cfg = Config(target="querier")
    cfg.storage.backend = "mem"
    setattr(cfg.storage, f"{tier}_addrs", "127.0.0.1:1")
    app = App(cfg, device="cpu")
    try:
        cls = MemcachedCache if tier == "memcached" else RedisCache
        for role in cfg.storage.memcached_roles:
            assert isinstance(app.cache_provider.cache_for(role), cls), role
        assert not isinstance(app.cache_provider.cache_for("parquet-page"), cls)
    finally:
        app.shutdown()
        for role in cfg.storage.memcached_roles:
            c = app.cache_provider.cache_for(role)
            if hasattr(c, "close"):
                c.close()


# ---------------------------------------------------------------------------
# the HTTP API on a single-binary App
# ---------------------------------------------------------------------------

@pytest.fixture
def server(tmp_path):
    cfg = _cfg(tmp_path)
    app = App(cfg, device="cpu")
    app.overrides.set_tenant_patch("single-tenant", {
        "generator": {"processors": ["span-metrics", "local-blocks"]}})
    app.start_loops()
    srv = serve(app, block=False)
    base = f"http://127.0.0.1:{cfg.server.http_listen_port}"
    yield app, base
    srv.shutdown()
    app.shutdown()


def test_zipkin_receiver(server):
    app, base = server
    ts = int((time.time() - 3) * 1e6)
    spans = [{"traceId": "cc" * 16, "id": "dd" * 8, "name": "zip-op",
              "kind": "SERVER", "timestamp": ts, "duration": 50_000,
              "localEndpoint": {"serviceName": "zipkin-svc"},
              "tags": {"http.method": "GET"}}]
    req = urllib.request.Request(f"{base}/api/v2/spans",
                                 data=json.dumps(spans).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=10) as r:
        assert r.status == 202
    code, tr = _get(f"{base}/api/traces/{'cc' * 16}")
    assert code == 200 and tr["spans"][0]["name"] == "zip-op"
    assert tr["spans"][0]["service"] == "zipkin-svc"
    assert tr["spans"][0]["attrs"]["http.method"] == "GET"
    from tempo_tpu.model.zipkin import spans_from_zipkin_json as jz
    from tempo_tpu_torch.model.zipkin import spans_from_zipkin_json as tz
    odd = spans + [{"traceId": "1", "id": "zz", "parentId": "02",
                    "kind": "producer", "tags": {"error": "x",
                                                 "service.name": "s"}}]
    assert list(tz(odd)) == list(jz(odd))


def test_http_e2e(server):
    app, base = server
    code, _ = _post(f"{base}/v1/traces", _otlp_body())
    assert code == 200
    with urllib.request.urlopen(f"{base}/ready", timeout=10) as r:
        assert r.status == 200
    code, st = _get(f"{base}/status")
    assert st["target"] == "all" and "distributor" in st["modules"]
    assert st["mesh"] is None and st["fleet"] is None and st["wal"] is None
    code, tr = _get(f"{base}/api/traces/0102030405060708090a0b0c0d0e0f10")
    assert code == 200 and len(tr["spans"]) == 1
    assert tr["spans"][0]["name"] == "checkout"
    code, res = _get(f"{base}/api/search?q=" + urllib.parse.quote(
        '{ resource.service.name = "shop" }'))
    assert code == 200 and len(res["traces"]) == 1
    code, tags = _get(f"{base}/api/search/tags")
    assert "http.status_code" in tags["tagNames"]
    code, tags2 = _get(f"{base}/api/v2/search/tags")
    span_tags = next(s["tags"] for s in tags2["scopes"] if s["name"] == "span")
    assert "http.status_code" in span_tags
    now = time.time()
    code, qr = _get(f"{base}/api/metrics/query_range?q=" +
                    urllib.parse.quote("{ } | rate()") +
                    f"&start={now - 300}&end={now}&step=300")
    assert code == 200
    total = sum(d["value"] for s in qr["series"]
                for d in (s.get("samples") or []) if d["value"] == d["value"])
    assert total > 0
    code, sm = _get(f"{base}/api/metrics/summary?q=" +
                    urllib.parse.quote("{ }") + "&groupBy=name")
    assert code == 200 and sm["summaries"][0]["spanCount"] == 1
    code, _ = _post(f"{base}/api/overrides", json.dumps(
        {"generator": {"collection_interval_s": 30.0}}).encode())
    assert code == 200
    code, ov = _get(f"{base}/api/overrides")
    assert ov["limits"]["generator"]["collection_interval_s"] == 30.0
    with urllib.request.urlopen(f"{base}/metrics", timeout=10) as r:
        text = r.read().decode()
    assert "tempo_distributor_spans_received_total 1" in text


def test_tag_values_includes_ingester_recent_data(server):
    app, base = server
    code, _ = _post(f"{base}/v1/traces", _otlp_body())
    assert code == 200
    code, res = _get(f"{base}/api/search/tag/.http.status_code/values")
    assert code == 200 and "200" in res["tagValues"]
    code, res = _get(
        f"{base}/api/v2/search/tag/resource.service.name/values")
    assert any(v["value"] == "shop" for v in res["tagValues"])


def test_otlp_malformed_and_gzip(server):
    app, base = server
    req = urllib.request.Request(
        f"{base}/v1/traces", data=b"\xff\xfe not proto",
        headers={"Content-Type": "application/x-protobuf"})
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=10)
    assert ei.value.code == 400
    req = urllib.request.Request(
        f"{base}/v1/traces", data=gzip.compress(_otlp_body("ab" * 16)),
        headers={"Content-Type": "application/json",
                 "Content-Encoding": "gzip"})
    with urllib.request.urlopen(req, timeout=10) as r:
        assert r.status == 200
    code, tr = _get(f"{base}/api/traces/{'ab' * 16}")
    assert code == 200 and tr["spans"][0]["name"] == "checkout"
    bad = urllib.request.Request(
        f"{base}/v1/traces", data=b"not gzip",
        headers={"Content-Type": "application/json",
                 "Content-Encoding": "gzip"})
    assert _code(lambda: urllib.request.urlopen(bad, timeout=10).status
                 and (200,)) == 400


def test_metrics_summary_without_generator(tmp_path):
    cfg = Config()
    cfg.storage.backend = "mem"
    cfg.storage.wal_path = str(tmp_path / "wal")
    cfg.target = "query-frontend"
    cfg.server.http_listen_port = free_port()
    app = App(cfg, device="cpu")
    srv = serve(app, block=False)
    base = f"http://127.0.0.1:{cfg.server.http_listen_port}"
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{base}/api/metrics/summary?q=%7B%20%7D",
                                   timeout=10)
        assert ei.value.code == 400
    finally:
        srv.shutdown()
        app.shutdown()


# the names the port's registries lack or add, each with its reason: the
# port compiles no graphs (no jit-compile families), and keeps no gather
# timer for paged rows; it counts its hand-kernel launches and launch
# plans. (The `tempo_mesh_*` gauges came with item 13.)
REF_ONLY = {
    "tempo_jax_jit_compile_seconds_total", "tempo_jax_jit_compile_total",
    "tempo_pages_gather_overhead_seconds_total",
}
PORT_ONLY = {"tempo_torch_k1_launch_plans_total",
             "tempo_torch_kernel_launches_total",
             "tempo_registry_state_lock_wait_seconds_total",
             "tempo_registry_state_lock_contended_total",
             "tempo_metrics_generator_processor_service_graphs_edges",
             "tempo_metrics_generator_processor_service_graphs_expired_edges",
             "tempo_metrics_generator_processor_service_graphs_dropped_spans"}


def test_ops_files_reference_only_emitted_metrics(server):
    """The drift gate (`tests/test_app.py:384`) on the port's registries:
    every `tempo_*` name in `operations/` is registered, except exactly
    the jit-compile names of `REF_ONLY`; the core
    write-path names appear on /metrics after traffic; the bail-cause
    gate holds against the port's `block/device_scan.py`."""
    from tempo_tpu_torch.obs import drift
    from tempo_tpu_torch.obs.runtime import RUNTIME

    app, base = server
    _post(f"{base}/v1/traces", _otlp_body())
    _get(f"{base}/api/search?q=" + urllib.parse.quote("{ }"))
    now = time.time()
    _get(f"{base}/api/metrics/query_range?q=" +
         urllib.parse.quote("{ } | rate()") +
         f"&start={now - 300}&end={now}&step=300")
    ops_dir = os.path.join(os.path.dirname(__file__), "..", "operations")
    assert drift.referenced_metric_names(ops_dir)
    problems = drift.check_drift(ops_dir, [app.obs, RUNTIME])
    missing = {p.split()[0] for p in problems}
    assert missing and missing <= REF_ONLY, missing
    assert all(n.startswith("tempo_jax_") for n in missing)
    assert drift.check_bail_causes(os.path.abspath(ops_dir)) == []
    with urllib.request.urlopen(f"{base}/metrics", timeout=10) as r:
        text = r.read().decode()
    emitted = set(re.findall(r"^(tempo_[a-z_]+)", text, re.M))
    for name in ("tempo_distributor_spans_received_total",
                 "tempo_distributor_bytes_received_total",
                 "tempo_query_frontend_queries_total",
                 "tempo_ingester_live_traces",
                 "tempo_request_duration_seconds_bucket"):
        assert name in emitted, name


def test_drift_default_registries_boot_an_all_target_app():
    """`obs.drift.default_registries` boots the full App (a `mem` store)
    and returns its registry and the process runtime's: the names a
    whole process registers, the CLI gate's input."""
    from tempo_tpu_torch.obs import drift
    from tempo_tpu_torch.obs.runtime import RUNTIME

    regs, app = drift.default_registries(device="cpu")
    try:
        assert regs[0] is app.obs and regs[1] is RUNTIME
        assert app.cfg.target == "all" and app.db is not None
        names = drift.registered_metric_names(regs)
        assert {"tempo_compaction_blocks_total",
                "tempo_distributor_spans_received_total",
                "tempo_usage_stats_reports_written_total"} <= names
        assert not names & REF_ONLY
    finally:
        app.shutdown()


def test_v2_api_endpoints(server):
    app, base = server
    code, _ = _post(f"{base}/v1/traces", _otlp_body())
    assert code == 200
    code, bi = _get(f"{base}/api/status/buildinfo")
    assert code == 200 and bi["version"].startswith("tempo-tpu")
    tid = OTLP["resourceSpans"][0]["scopeSpans"][0]["spans"][0]["traceId"]
    code, tr = _get(f"{base}/api/v2/traces/{tid}")
    assert code == 200 and tr["status"] == "COMPLETE"
    assert tr["trace"]["spans"][0]["name"] == "checkout"
    now = time.time()
    code, qi = _get(f"{base}/api/metrics/query?q=" +
                    urllib.parse.quote("{ } | rate()") +
                    f"&start={now - 300}&end={now}")
    assert code == 200
    assert any(s["value"] == s["value"] and s["value"] >= 0
               for s in qi["series"])


def test_status_usage_stats_endpoint(server):
    app, base = server
    assert app.usage_reporter is not None
    code, rep = _get(f"{base}/status/usage-stats")
    assert code == 200 and "clusterID" in rep and rep["target"] == "all"
    code2, rep2 = _get(f"{base}/status/usage-stats")
    assert rep2["clusterID"] == rep["clusterID"]
    assert app.usage_reporter.report_once()
    assert app.usage_reporter.reports_written == 1
    app.usage_reporter, saved = None, app.usage_reporter
    try:
        assert _code(lambda: _get(f"{base}/status/usage-stats")) == 404
    finally:
        app.usage_reporter = saved


def test_internal_rpc_round_trip(tmp_path):
    """`rpc.py`'s clients against a port App's `/internal/*` routes: an
    ingester target takes a push and answers a find and a search, a
    generator target takes an OTLP push and answers query_range."""
    from tempo_tpu_torch.model.otlp import encode_spans_otlp
    from tempo_tpu_torch.rpc import RemoteGeneratorClient, RemoteIngesterClient
    from tempo_tpu_torch.traceql.engine_metrics import QueryRangeRequest

    apps, srvs = [], []
    try:
        for target in ("ingester", "metrics-generator"):
            cfg = _cfg(tmp_path / target)
            cfg.target = target
            app = App(cfg, device="cpu")
            if target == "metrics-generator":
                app.overrides.set_tenant_patch("t", {"generator": {
                    "processors": ["span-metrics", "local-blocks"]}})
            apps.append(app)
            srvs.append(serve(app, block=False))
        ing = RemoteIngesterClient(
            f"http://127.0.0.1:{apps[0].cfg.server.http_listen_port}")
        gen = RemoteGeneratorClient(
            f"http://127.0.0.1:{apps[1].cfg.server.http_listen_port}")
        now = int(time.time() * 1e9)
        tid = bytes(range(16))
        spans = [{"trace_id": tid, "span_id": bytes([i + 1]) * 8,
                  "parent_span_id": b"", "name": f"op-{i}",
                  "service": "svc", "kind": 2, "status_code": 0,
                  "start_unix_nano": now - 10 ** 9,
                  "end_unix_nano": now - 10 ** 9 + 10 ** 6 * (i + 1)}
                 for i in range(3)]
        assert ing.push("t", [(tid, spans)]) == [None]
        got = ing.find_trace_by_id("t", tid)
        assert sorted(s["name"] for s in got) == ["op-0", "op-1", "op-2"]
        assert ing.search("t", '{ name = "op-1" }')[0].trace_id == tid.hex()
        assert "name" in ing.tag_names("t").get("intrinsic", []) or \
            ing.tag_names("t")
        assert gen.push_otlp("t", encode_spans_otlp(spans)) == 3
        req = QueryRangeRequest(query="{ } | rate()", start_ns=now - 60 * 10 ** 9,
                                end_ns=now, step_ns=60 * 10 ** 9)
        # job-level series (counts a step, before the combiner's final
        # pass), as the reference's generator answers them
        series = gen.query_range("t", req)
        assert sum(float(np.nansum(s.samples)) for s in series) == 3
    finally:
        for s in srvs:
            s.shutdown()
        for a in apps:
            a.shutdown()


def test_quantile_endpoint_serves_latency_shares(tmp_path):
    """`tests/test_traceanalytics.py:467` on the port's App."""
    from tempo_tpu_torch.model.otlp import encode_spans_otlp

    cfg = _cfg(tmp_path)
    app = App(cfg, device="cpu")
    app.overrides.set_tenant_patch("single-tenant", {
        "generator": {"processors": ["trace-analytics"]}})
    srv = serve(app, block=False)
    base = f"http://127.0.0.1:{cfg.server.http_listen_port}"
    try:
        rng = np.random.default_rng(3)
        now_ns = int(time.time() * 1e9)
        tid = rng.bytes(16)
        sids = [rng.bytes(8) for _ in range(6)]
        spans = [dict(trace_id=tid, span_id=sids[i],
                      parent_span_id=b"" if i == 0 else sids[i - 1],
                      name=f"op-{i % 2}", service="svc", kind=2,
                      status_code=0, start_unix_nano=now_ns + i,
                      end_unix_nano=now_ns + (6 - i) * 10**6)
                 for i in range(6)]
        req = urllib.request.Request(
            f"{base}/v1/traces", data=encode_spans_otlp(spans),
            headers={"Content-Type": "application/x-protobuf"})
        with urllib.request.urlopen(req, timeout=10) as r:
            assert r.status == 200
        app.generator.instance("single-tenant").tick(immediate=True)
        code, doc = _get(f"{base}/internal/generator/quantile"
                         "?proc=trace-analytics&q=0.5")
        got = {tuple(tuple(kv) for kv in e["labels"]): e["value"]
               for e in doc["quantiles"]}
        want = app.generator.instance("single-tenant") \
            .processors["trace-analytics"].quantile(0.5)
        assert got and got == {tuple(k): v for k, v in want.items()}
        code, doc = _get(f"{base}/internal/generator/quantile?q=0.5")
        assert doc["quantiles"] == []
    finally:
        srv.shutdown()
        app.shutdown()


# ---------------------------------------------------------------------------
# single-binary differential: the reference's App against the port's
# ---------------------------------------------------------------------------

N_TRACES, SPANS_PER_TRACE = 48, 4
RATE_Q = "{ } | rate() by (resource.service.name)"
QUANT_Q = ("{ } | quantile_over_time(duration, .5, .9) by "
           "(resource.service.name)")


def _seeded_spans(now_ns: int) -> list[dict]:
    rng = np.random.default_rng(20261017)
    spans = []
    for t in range(N_TRACES):
        tid = rng.bytes(16)
        sids = [rng.bytes(8) for _ in range(SPANS_PER_TRACE)]
        t0 = now_ns - int(rng.integers(2, 20)) * 10 ** 9
        for i in range(SPANS_PER_TRACE):
            dur = int(rng.lognormal(16, 1.0))
            spans.append(dict(
                trace_id=tid, span_id=sids[i],
                parent_span_id=b"" if i == 0 else sids[0],
                name=f"op-{int(rng.integers(0, 3))}",
                service=f"svc-{t % 4}", kind=2 if i == 0 else 3,
                status_code=2 if rng.random() < 0.1 else 0,
                start_unix_nano=t0 + i * 1000, end_unix_nano=t0 + i * 1000 + dur,
                attrs={"http.status_code": int(rng.choice([200, 404, 500]))},
                res_attrs={"service.name": f"svc-{t % 4}"}))
    return spans


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """One reference App (JAX on the CPU) and one port App, each serving
    HTTP, each sent the same seeded OTLP protobuf payload through
    `/v1/traces`; the pushes happen here, in set-up, and the tests only
    read."""
    from tempo_tpu.app import App as JApp
    from tempo_tpu.app.api import serve as jserve
    from tempo_tpu.app.config import Config as JConfig
    from tempo_tpu_torch.model.otlp import encode_spans_otlp

    now_ns = int(time.time() * 1e9)
    spans = _seeded_spans(now_ns)
    payload = encode_spans_otlp(spans)
    out = {"spans": spans, "now": now_ns / 1e9}
    for name, A, C, S in (("port", App, Config, serve),
                          ("ref", JApp, JConfig, jserve)):
        root = tmp_path_factory.mktemp(name)
        cfg = C()
        cfg.storage.backend = "mem"
        cfg.storage.wal_path = str(root / "d" / "wal")
        cfg.generator.localblocks.data_dir = str(root / "lb")
        cfg.server.http_listen_port = free_port()
        app = A(cfg, device="cpu") if name == "port" else A(cfg)
        app.overrides.set_tenant_patch("single-tenant", {
            "generator": {"processors": ["span-metrics", "local-blocks"]}})
        app.start_loops()
        srv = S(app, block=False)
        base = f"http://127.0.0.1:{cfg.server.http_listen_port}"
        code, body = _post(f"{base}/v1/traces", payload,
                           "application/x-protobuf")
        assert code == 200 and body == {}, body
        app.sched.flush()
        out[name] = (app, srv, base)
    yield out
    for name in ("port", "ref"):
        app, srv, _ = out[name]
        srv.shutdown()
        app.shutdown()
    _reset_port()


def _both(pair, path):
    return [_get(pair[n][2] + path)[1] for n in ("port", "ref")]


def test_differential_trace_by_id(pair):
    """Trace by id over HTTP: the same spans, field for field."""
    tids = sorted({s["trace_id"] for s in pair["spans"]})[::8]
    for tid in tids:
        t, j = _both(pair, f"/api/traces/{tid.hex()}")
        key = lambda s: s["span_id"]
        assert sorted(t["spans"], key=key) == sorted(j["spans"], key=key)
        assert len(t["spans"]) == SPANS_PER_TRACE


def test_differential_search(pair):
    """Search over HTTP: the same traces and metadata (the ingesters'
    recent window in both)."""
    for q in ('{ resource.service.name = "svc-1" }',
              "{ span.http.status_code >= 500 }", "{ status = error }"):
        path = "/api/search?limit=100&q=" + urllib.parse.quote(q)
        t, j = _both(pair, path)
        key = lambda m: m["traceID"]
        assert t["traces"] and \
            sorted(t["traces"], key=key) == sorted(j["traces"], key=key), q


def test_differential_query_range(pair):
    """A rate and a quantile `query_range` by service over HTTP (the
    generators' local blocks, the recent window): the same series and
    values, bit for bit (both packages run the same engine code over
    the same rows on the CPU; tolerance 0)."""
    now = pair["now"]
    for q in (RATE_Q, QUANT_Q):
        path = (f"/api/metrics/query_range?q={urllib.parse.quote(q)}"
                f"&start={now - 120}&end={now}&step=30")
        t, j = _both(pair, path)
        series = lambda d: sorted(
            (json.dumps(s["labels"], sort_keys=True),
             [(x["timestampMs"], x["value"]) for x in s["samples"]])
            for s in d["series"])
        assert t["series"] and series(t) == series(j), q
    total = sum(x["value"] for s in t["series"] for x in s["samples"]
                if x["value"] == x["value"])
    assert total > 0


def test_differential_metrics_family_names(pair):
    """`/metrics` family names: equal but for `REF_ONLY` (the jit and
    gather families) and `PORT_ONLY` (the port's launch counters)."""
    names = {}
    for n in ("port", "ref"):
        with urllib.request.urlopen(pair[n][2] + "/metrics",
                                    timeout=10) as r:
            text = r.read().decode()
        names[n] = {ln.split()[2] for ln in text.splitlines()
                    if ln.startswith("# TYPE")}
    assert names["ref"] - names["port"] <= REF_ONLY
    assert names["port"] - names["ref"] == PORT_ONLY
    assert "tempo_compaction_blocks_total" in names["port"]
    assert "tempo_distributor_spans_received_total" in names["port"]


def test_differential_metrics_summary(pair):
    """The span-metrics summary by service over HTTP: the same span and
    error counts and the same DDSketch quantiles (bit-identical grids)."""
    t, j = _both(pair, "/api/metrics/summary?q=" +
                 urllib.parse.quote("{ }") + "&groupBy=resource.service.name")
    key = lambda s: json.dumps(s["series"])
    assert sorted(t["summaries"], key=key) == sorted(j["summaries"], key=key)
    assert t["summaries"]


def test_trace_with_links_renders_hex_where_the_reference_answers_500(pair):
    """A deliberate difference (ROADMAP section 3): a span's link ids
    (bytes) render as hex in the port's trace-by-id answer, as the span's
    own ids do; the reference's JSON encoder raises on them, so its route
    answers 500 for any trace with a link."""
    from tempo_tpu_torch.model.otlp import encode_spans_otlp

    now = int(time.time() * 1e9)
    tid, sid = bytes(range(100, 116)), bytes(range(8))
    link = {"trace_id": bytes(16 * [7]), "span_id": bytes(8 * [9])}
    payload = encode_spans_otlp([{
        "trace_id": tid, "span_id": sid, "parent_span_id": b"",
        "name": "linked", "service": "svc", "kind": 2, "status_code": 0,
        "start_unix_nano": now - 10 ** 9, "end_unix_nano": now - 10 ** 8,
        "links": [link]}])
    codes = {}
    for n in ("port", "ref"):
        base = pair[n][2]
        hdr = {"X-Scope-OrgID": "links"}
        req = urllib.request.Request(
            f"{base}/v1/traces", data=payload,
            headers={**hdr, "Content-Type": "application/x-protobuf"})
        with urllib.request.urlopen(req, timeout=10) as r:
            assert r.status == 200
        req = urllib.request.Request(f"{base}/api/traces/{tid.hex()}",
                                     headers=hdr)
        try:
            with urllib.request.urlopen(req, timeout=10) as r:
                codes[n] = (r.status, json.loads(r.read()))
        except urllib.error.HTTPError as e:
            codes[n] = (e.code, json.loads(e.read()))
    assert codes["ref"][0] == 500
    assert "not JSON serializable" in codes["ref"][1]["error"]
    code, doc = codes["port"]
    assert code == 200
    assert doc["spans"][0]["links"] == [{"trace_id": "07" * 16,
                                         "span_id": "09" * 8}]


def test_jaeger_receiver(pair):
    """`tests/test_app.py:311` on both Apps of the pair: a Thrift batch
    through `POST /api/traces` answers 202 and lands with span.kind and
    error tags mapped; the trace, the search and the generator's tee
    agree with the reference's; a malformed batch answers 400."""
    from tests.test_app import _jaeger_batch

    start_us = int((time.time() - 3) * 1e6)
    batch = _jaeger_batch("jaeger-svc", [{
        "tid_lo": 0x0102030405060708, "tid_hi": 0x1112131415161718,
        "sid": 0x0A0B0C0D0E0F1011, "name": "jg-op",
        "start_us": start_us, "dur_us": 75_000,
        "tags": {"span.kind": "server", "http.status_code": 500,
                 "error": True, "peer.address": "10.0.0.9"},
    }])
    hdr = {"X-Scope-OrgID": "jaeger", "Content-Type": "application/x-thrift"}
    tid_hex = "1112131415161718" + "0102030405060708"
    got = {}
    for n in ("port", "ref"):
        app, _, base = pair[n]
        app.overrides.set_tenant_patch("jaeger", {
            "generator": {"processors": ["span-metrics"]}})
        req = urllib.request.Request(f"{base}/api/traces", data=batch,
                                     headers=hdr)
        with urllib.request.urlopen(req, timeout=10) as r:
            assert r.status == 202
        q = {"X-Scope-OrgID": "jaeger"}
        with urllib.request.urlopen(urllib.request.Request(
                f"{base}/api/traces/{tid_hex}", headers=q), timeout=10) as r:
            tr = json.loads(r.read())
        sp = tr["spans"][0]
        assert (sp["name"], sp["service"], sp["kind"], sp["status_code"]) \
            == ("jg-op", "jaeger-svc", 2, 2)
        assert sp["attrs"]["http.status_code"] == 500
        assert sp["attrs"]["peer.address"] == "10.0.0.9"
        assert "span.kind" not in sp["attrs"]
        assert sp["res_attrs"]["hostname"] == "h1"
        assert sp["end_unix_nano"] - sp["start_unix_nano"] == 75_000_000
        app.sched.flush()
        assert app.generator.instance("jaeger").spans_received >= 1
        with urllib.request.urlopen(urllib.request.Request(
                f"{base}/api/search?q=" + urllib.parse.quote(
                    '{ resource.service.name = "jaeger-svc" }'),
                headers=q), timeout=10) as r:
            res = json.loads(r.read())
        assert len(res["traces"]) == 1
        bad = urllib.request.Request(f"{base}/api/traces",
                                     data=b"\x0b\x00\x01", headers=hdr)
        assert _code(lambda: urllib.request.urlopen(bad, timeout=10).status
                     and (200,)) == 400
        got[n] = (tr["spans"], res["traces"])
    assert got["port"] == got["ref"]


@pytest.mark.parametrize("compact", [False, True], ids=["f32", "compact"])
def test_differential_status_pages(tmp_path, compact):
    """With the page pool on (and compact state, K1's compact branch, on
    the reference's interpreted Pallas kernel), `/status` answers 200 on
    both Apps after the same push, and its "pages" object (page rows,
    arena pages, series shards, the totals, every arena and the top
    tenants' bytes) equals the reference's."""
    from tempo_tpu.app import App as JApp
    from tempo_tpu.app import load_config as jload
    from tempo_tpu.app.api import serve as jserve
    from tempo_tpu_torch.model.otlp import encode_spans_otlp

    text = ("pages: {enabled: true, page_rows: 64, arena_slots: 1024}\n"
            "generator: {spanmetrics: {sketch_max_series: 256")
    text += (", compact_state: true, kernel: pallas, pallas_interpret: true"
             if compact else "") + "}}\n"
    payload = encode_spans_otlp(_seeded_spans(int(time.time() * 1e9))[:64])
    got = {}
    for name, A, load, S in (("port", App, load_config, serve),
                             ("ref", JApp, jload, jserve)):
        cfg = load(text=text)
        cfg.storage.backend = "mem"
        cfg.storage.wal_path = str(tmp_path / name / "wal")
        cfg.generator.localblocks.data_dir = str(tmp_path / name / "lb")
        cfg.generator.registry.max_active_series = 256
        cfg.server.http_listen_port = free_port()
        app = A(cfg, device="cpu") if name == "port" else A(cfg)
        srv = S(app, block=False)
        try:
            app.overrides.set_tenant_patch("single-tenant", {"generator": {
                "processors": ["span-metrics"], "max_active_series": 256}})
            base = f"http://127.0.0.1:{cfg.server.http_listen_port}"
            code, _ = _post(f"{base}/v1/traces", payload,
                            "application/x-protobuf")
            assert code == 200
            app.sched.flush()
            code, st = _get(f"{base}/status")
            assert code == 200
            got[name] = st["pages"]
        finally:
            srv.shutdown()
            app.shutdown()
            _reset_port()
    assert got["port"] == got["ref"]
    assert got["port"]["allocated_total"] > 0
    assert got["port"]["series_shards"] == 1
    assert {a["dtype"] for a in got["port"]["arenas"]} >= (
        {"int32", "bfloat16"} if compact else {"float32"})
