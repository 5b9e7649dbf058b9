"""The port's self-tracing against the reference's.

Mirrors `tests/test_selftrace.py` (5 tests) and the two self-tracing
tests of `tests/test_obs.py` (`:369`, `:399`) on the CPU. Each scenario
runs on both packages' `SelfTracer`s (and, for the Apps, on both Apps)
and the outcomes are compared: the exported span names and parentage,
the tail-keep verdicts and the `tempo_selftrace_*` stats. Trace and span
ids are not compared: the reference draws them from `os.urandom`, the
port from its tracer's own `random.Random(seed)` (a deliberate
difference, ROADMAP section 3; `test_seeded_tracer_repeats_ids_and_verdicts`
holds it).
"""

from __future__ import annotations

import json
import logging
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from http.server import HTTPServer

import pytest

from tests.test_selftrace import _FlakyGenHandler
from tests.test_torch_app import free_port, _reset_port
from tests.test_torch_frontend import mod

SIDES = ("port", "ref")



@pytest.fixture(autouse=True)
def _tracers():
    """Both packages' installed tracers are process globals: put the
    Noop tracer back after each test (and the port's singletons)."""
    _reset_port()
    yield
    for side in SIDES:
        tr = mod(side, "utils.tracing")
        cur = tr.tracer()
        if not isinstance(cur, tr.NoopTracer):
            cur.shutdown()
            tr.install(tr.NoopTracer())
    _reset_port()


def _tracer(side, **kw):
    tr = mod(side, "utils.tracing")
    if side == "port":
        kw.setdefault("seed", 7)
    t = tr.SelfTracer(flush_interval_s=3600, **kw)
    tr.install(t)
    return tr, t


def _decoded(side, batches):
    dec = mod(side, "model.otlp").spans_from_otlp_proto
    return [s for b in batches for s in dec(b)]


def _shape(spans):
    """Names, parentage by name and attributes: what both sides must
    agree on, ids (and the random `push_id` attribute) aside."""
    by_id = {s["span_id"]: s["name"] for s in spans}
    return sorted((s["name"], by_id.get(s["parent_span_id"], ""),
                   s["status_code"], json.dumps(
                       {k: v for k, v in s.get("attrs", {}).items()
                        if not k.endswith("_id")},
                       sort_keys=True, default=str)) for s in spans)


def test_tail_keep_slo_and_error_trees_survive_zero_rate():
    """At head_sample_rate 0 only the trees forced past sampling export
    (mark_keep, the SLO-miss hook, and errored spans), on both sides,
    with the same stats."""
    got = {}
    for side in SIDES:
        batches = []
        tracing, tr = _tracer(side, sink=batches.append, head_sample_rate=0.0)
        with tracing.span("root-a"):
            with tracing.span("child-a"):
                pass
            assert tracing.kept_trace_id_hex() is None
        with tracing.span("root-b") as rb:
            with tracing.span("child-b"):
                pass
            tracing.mark_keep()
            assert tracing.kept_trace_id_hex() == rb.trace_id.hex()
        with pytest.raises(ValueError):
            with tracing.span("root-c"):
                raise ValueError("boom")
        assert tr.flush() == 3
        got[side] = (_shape(_decoded(side, batches)), dict(tr.stats))
        tr.shutdown()
        tracing.install(tracing.NoopTracer())
    assert got["port"] == got["ref"]
    names = {n for n, *_ in got["port"][0]}
    assert names == {"root-b", "child-b", "root-c"}
    assert got["port"][1]["kept_traces"] == 2
    assert got["port"][1]["sampled_spans"] == 2
    assert got["port"][1]["dropped_spans"] == 0


def test_late_spans_follow_their_trace_verdict():
    """A span closing after its trace was decided follows the verdict:
    kept traces export it alone, sampled-out ones drop it."""
    got = {}
    for side in SIDES:
        batches = []
        tracing, tr = _tracer(side, sink=batches.append, head_sample_rate=0.0)
        with tracing.span("kept-root") as root:
            tracing.mark_keep()
        tid = root.trace_id
        counts = [tr.flush()]
        with tracing.adopted(f"00-{tid.hex()}-{'ab' * 8}-01"):
            with tracing.span("late-dispatch"):
                pass
        counts.append(tr.flush())
        late = _decoded(side, batches[-1:])
        assert late[0]["name"] == "late-dispatch"
        assert late[0]["trace_id"] == tid
        with tracing.span("dropped-root") as dr:
            pass
        with tracing.adopted(f"00-{dr.trace_id.hex()}-{'cd' * 8}-01"):
            with tracing.span("late-dropped"):
                pass
        counts.append(tr.flush())
        got[side] = (counts, _shape(_decoded(side, batches)), dict(tr.stats))
        tr.shutdown()
        tracing.install(tracing.NoopTracer())
    assert got["port"] == got["ref"]
    assert got["port"][0] == [1, 1, 0]


def test_rpc_push_retry_is_one_logical_tree():
    """A generator push retried under an injected fault and a 503 stays
    one logical tree on both sides: one rpc.push span with retries 2,
    and every wire attempt carries the same push id and traceparent."""
    from tempo_tpu_torch.model.otlp import encode_spans_otlp

    payload = encode_spans_otlp([dict(
        trace_id=b"\x01" * 16, span_id=b"\x02" * 8, name="op",
        service="svc", kind=2, status_code=0,
        start_unix_nano=10**18, end_unix_nano=10**18 + 10**6)])
    got = {}
    for side in SIDES:
        faults = mod(side, "utils.faults")
        _FlakyGenHandler.script = [503]
        _FlakyGenHandler.requests = []
        srv = HTTPServer(("127.0.0.1", 0), _FlakyGenHandler)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        batches = []
        tracing, tr = _tracer(side, sink=batches.append)
        client = mod(side, "rpc").RemoteGeneratorClient(
            f"http://127.0.0.1:{srv.server_address[1]}", timeout_s=10.0)
        try:
            spec = faults.FaultSpec(point="rpc.push", probability=1.0,
                                    count=1)
            with faults.use([spec]):
                with tracing.span("push-root") as root:
                    assert client.push_otlp("t1", payload) == 1
        finally:
            srv.shutdown()
            srv.server_close()
        assert tr.flush() == 2
        spans = _decoded(side, batches)
        pushes = [s for s in spans if s["name"] == "rpc.push"]
        assert len(pushes) == 1 and pushes[0]["trace_id"] == root.trace_id
        reqs = _FlakyGenHandler.requests
        ids = {r.get("X-Push-Id") for r in reqs}
        tps = {r.get("Traceparent") or r.get("traceparent") for r in reqs}
        assert len(reqs) == 2 and len(ids) == 1 and None not in ids
        assert len(tps) == 1 and root.trace_id.hex() in next(iter(tps))
        got[side] = (_shape(spans), pushes[0]["attrs"]["retries"])
        tr.shutdown()
        tracing.install(tracing.NoopTracer())
    assert got["port"] == got["ref"] and got["port"][1] == 2


def test_selftrace_config_check_bounds():
    """The `selftrace:` bounds and the loopback-needs-a-distributor
    warning: the same warnings as the reference's, case for case."""
    got = {}
    for side in SIDES:
        Config = mod(side, "app.config").Config
        cfg = Config(target="all")
        cfg.selftrace.enabled = True
        out = [[w for w in cfg.check() if "selftrace" in w]]
        cfg.selftrace.head_sample_rate = 1.5
        cfg.selftrace.flush_interval_s = 0.0
        cfg.selftrace.max_trace_spans = 1
        cfg.selftrace.endpoint = "http://example:4318"
        out.append([w for w in cfg.check() if w.startswith("selftrace:")])
        cfg2 = Config(target="querier")
        cfg2.selftrace.enabled = True
        out.append([w for w in cfg2.check() if "selftrace" in w])
        got[side] = out
    assert got["port"] == got["ref"]
    ok, bad, querier = got["port"]
    assert ok == [] and len(bad) == 4
    assert any("loopback wins" in w for w in bad)
    assert any("distributor" in w for w in querier)


def _loopback(side, tmp_path):
    """The loopback scenario of `tests/test_selftrace.py:201` on one
    side's App; returns what the two sides must share."""
    tracing = mod(side, "utils.tracing")
    sched = mod(side, "sched")
    Config = mod(side, "app.config").Config
    SLOConfig = mod(side, "frontend.slos").SLOConfig
    LOGGER_NAME = mod(side, "obs.qlog").LOGGER_NAME
    port = free_port()
    cfg = Config(target="all")
    cfg.storage.backend = "mem"
    cfg.storage.wal_path = str(tmp_path / side / "wal")
    cfg.generator.localblocks.data_dir = str(tmp_path / side / "lb")
    cfg.server.http_listen_port = port
    cfg.selftrace.enabled = True
    cfg.selftrace.flush_interval_s = 3600.0
    cfg.overrides_defaults.generator.processors = ("span-metrics",
                                                   "local-blocks")
    assert not any("selftrace" in w for w in cfg.check())
    App = mod(side, "app").App
    app = App(cfg, device="cpu") if side == "port" else App(cfg)
    app.start_loops()
    srv = mod(side, "app.api").serve(app, block=False)
    base = f"http://127.0.0.1:{port}"
    tr = tracing.tracer()
    hdr = {"X-Scope-OrgID": "tempo-self"}
    try:
        assert tr.loopback and tracing.reserved_tenant() == "tempo-self"
        req = urllib.request.Request(
            f"{base}/v1/traces", data=b"{}",
            headers={"Content-Type": "application/json", **hdr})
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=10)
        assert err.value.code == 400
        t0 = int((time.time() - 3) * 1e9)
        otlp = {"resourceSpans": [{"scopeSpans": [{"spans": [{
            "traceId": "ab" * 16, "spanId": "cd" * 8, "name": "user-op",
            "startTimeUnixNano": str(t0),
            "endTimeUnixNano": str(t0 + 50_000_000)}]}]}]}
        urllib.request.urlopen(urllib.request.Request(
            f"{base}/v1/traces", data=json.dumps(otlp).encode(),
            headers={"Content-Type": "application/json"}), timeout=10).close()
        sched.flush()
        app.frontend.qlog.sample_every = 1
        app.frontend.slos.per_op["search"] = SLOConfig(duration_slo_s=1e-9)
        logger = logging.getLogger(LOGGER_NAME)
        records = []

        class _Capture(logging.Handler):
            def emit(self, rec):
                records.append(rec.getMessage())

        h = _Capture()
        prev = logger.level
        logger.setLevel(logging.INFO)
        logger.addHandler(h)
        try:
            app.frontend.search("single-tenant", "{ }", limit=5)
        finally:
            logger.removeHandler(h)
            logger.setLevel(prev)
            app.frontend.slos.per_op.pop("search", None)
        kept = [r for r in map(json.loads, records) if r.get("selfTraceId")]
        assert kept
        self_tid = kept[0]["selfTraceId"]
        before = tr.stats["spans"]
        assert tr.flush() > 0
        sched.flush()
        assert tr.stats["spans"] == before
        assert tr.stats["loopback_batches"] >= 1
        q = urllib.parse.quote('{ resource.service.name = "tempo-tpu" '
                               '&& name =~ "sched.dispatch" }')
        with urllib.request.urlopen(urllib.request.Request(
                f"{base}/api/search?q={q}", headers=hdr), timeout=10) as r:
            found = json.loads(r.read())
        assert found.get("traces"), found
        now = time.time()
        q = urllib.parse.quote("{ } | quantile_over_time(duration, .5)")
        with urllib.request.urlopen(urllib.request.Request(
                f"{base}/api/metrics/query_range?q={q}"
                f"&start={now - 300}&end={now}&step=300", headers=hdr),
                timeout=10) as r:
            qr = json.loads(r.read())
        assert qr.get("series"), qr
        with urllib.request.urlopen(urllib.request.Request(
                f"{base}/api/traces/{self_tid}", headers=hdr),
                timeout=10) as r:
            tree = json.loads(r.read())
        names = {s["name"] for s in tree["spans"]}
        assert "frontend.Search" in names, names
        with urllib.request.urlopen(f"{base}/status", timeout=10) as r:
            status = json.loads(r.read())["selftrace"]
        assert status["loopback"] is True and status["tenant"] == "tempo-self"
        # the self-spans went through the push path into the generator
        app.sched.flush()
        inst = app.generator.instances.get("tempo-self")
        assert inst is not None and inst.spans_received > 0
        with urllib.request.urlopen(f"{base}/metrics", timeout=10) as r:
            text = r.read().decode()
        fams = {ln.split()[0]: float(ln.split()[1]) for ln in text.splitlines()
                if ln.startswith("tempo_selftrace_")
                and not ln.startswith("#")}
        assert fams.get("tempo_selftrace_spans_total", 0) > 0, fams
        return (names, sorted(status), sorted(fams))
    finally:
        srv.shutdown()
        app.shutdown()


def test_loopback_e2e_self_observability(tmp_path):
    """`selftrace.enabled` on a single binary, both sides: the process
    ingests its own spans under the reserved tenant without tracing that
    ingestion, refuses the tenant on the public push, answers TraceQL
    search and metrics over its own spans, returns the SLO-missing
    request's tree by the query log's `selfTraceId`, and counts real
    spans in `tempo_selftrace_*`. The SLO-missing tree's span names, the
    /status keys and the family names equal the reference's."""
    got = {side: _loopback(side, tmp_path) for side in SIDES}
    assert got["port"] == got["ref"]


def test_seeded_tracer_repeats_ids_and_verdicts():
    """The port's deliberate difference: two tracers with one seed hand
    out the same trace and span ids, so the head-sample verdicts (a
    function of the trace id) repeat; other seeds do not."""
    from tempo_tpu_torch.utils import tracing

    runs = []
    for seed in (11, 11, 12):
        batches = []
        tr = tracing.SelfTracer(sink=batches.append, head_sample_rate=0.5,
                                flush_interval_s=3600, seed=seed)
        tracing.install(tr)
        ids, verdicts = [], []
        for i in range(32):
            with tracing.span(f"r{i}") as s:
                with tracing.span("c"):
                    pass
                ids.append(s.trace_id)
                verdicts.append(tracing.kept_trace_id_hex() is not None)
        tr.flush()
        runs.append((ids, verdicts, dict(tr.stats)))
        tr.shutdown()
        tracing.install(tracing.NoopTracer())
    assert runs[0] == runs[1]
    assert runs[0][0] != runs[2][0]
    assert 0 < sum(runs[0][1]) < 32
    assert runs[0][2]["kept_traces"] == sum(runs[0][1])


@pytest.fixture
def obs_server(tmp_path):
    """A port App serving HTTP (`tests/test_obs.py`'s `server`)."""
    from tempo_tpu_torch.app import App
    from tempo_tpu_torch.app.api import serve
    from tempo_tpu_torch.app.config import Config

    cfg = Config(target="all")
    cfg.storage.backend = "mem"
    cfg.storage.wal_path = str(tmp_path / "wal")
    cfg.generator.localblocks.data_dir = str(tmp_path / "lb")
    cfg.server.http_listen_port = free_port()
    app = App(cfg, device="cpu")
    app.start_loops()
    srv = serve(app, block=False)
    yield app, f"http://127.0.0.1:{cfg.server.http_listen_port}"
    srv.shutdown()
    app.shutdown()


def test_slow_request_exemplar_carries_trace_id(obs_server):
    """`tests/test_obs.py:369`: a frontend op that misses its SLO stamps
    the active span's trace id on its histogram observation; an op
    within its SLO does not overwrite it."""
    from tempo_tpu_torch.frontend.slos import SLOConfig
    from tempo_tpu_torch.utils import tracing

    app, _ = obs_server
    tracer = tracing.SelfTracer("http://127.0.0.1:1", flush_interval_s=3600,
                                seed=3)
    app.frontend.slos.per_op["search"] = SLOConfig(duration_slo_s=1e-9)
    try:
        tracing.install(tracer)
        with tracing.span("slow-query") as s:
            app.frontend.search("single-tenant", "{ }", limit=5)
        ex = app.frontend.op_duration.exemplar(("search",))
        assert ex is not None and ex[0] == s.trace_id.hex()
        app.frontend.slos.per_op["search"] = SLOConfig()
        app.frontend.search("single-tenant", "{ }", limit=5)
        assert app.frontend.op_duration.exemplar(("search",))[0] == \
            s.trace_id.hex()
    finally:
        app.frontend.slos.per_op.pop("search", None)
        tracing.install(tracing.NoopTracer())
        tracer.shutdown()


def _dogfood(side, tmp_path):
    tracing = mod(side, "utils.tracing")
    Config = mod(side, "app.config").Config
    port = free_port()
    cfg = Config(target="all")
    cfg.storage.backend = "mem"
    cfg.storage.wal_path = str(tmp_path / side / "wal")
    cfg.generator.localblocks.data_dir = str(tmp_path / side / "lb")
    cfg.server.http_listen_port = port
    cfg.self_tracing_endpoint = f"http://127.0.0.1:{port}"
    App = mod(side, "app").App
    app = App(cfg, device="cpu") if side == "port" else App(cfg)
    app.start_loops()
    srv = mod(side, "app.api").serve(app, block=False)
    try:
        assert not isinstance(tracing.tracer(), tracing.NoopTracer)
        with tracing.span("obs-dogfood-root") as root:
            app.frontend.search("single-tenant", "{ }", limit=5)
            tid_hex = root.trace_id.hex()
        assert tracing.tracer().flush() > 0
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/api/traces/{tid_hex}",
            headers={"X-Scope-OrgID": app.cfg.self_tracing_tenant})
        with urllib.request.urlopen(req, timeout=10) as r:
            got = json.loads(r.read())
        assert got["trace_id"] == tid_hex
        return _shape([dict(s, span_id=bytes.fromhex(s["span_id"]),
                            parent_span_id=bytes.fromhex(
                                s.get("parent_span_id") or ""),
                            attrs={})
                       for s in got["spans"]])
    finally:
        srv.shutdown()
        app.shutdown()


def test_dogfood_spans_queryable_by_trace_id(tmp_path):
    """`tests/test_obs.py:399`: with `self_tracing_endpoint` at its own
    HTTP port, an App's own spans export over OTLP/HTTP into itself and
    read back by trace id under the self-tenant, the same tree (names
    and parentage) as the reference's."""
    got = {side: _dogfood(side, tmp_path) for side in SIDES}
    assert got["port"] == got["ref"]
    names = {n for n, *_ in got["port"]}
    assert {"obs-dogfood-root", "frontend.Search"} <= names
