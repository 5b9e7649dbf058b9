"""HTTP API: the public surface of `pkg/api/http.go:68-84`.

Counterpart of `tempo_tpu/app/api.py`, copied with its imports moved to
the port. `/metrics` renders the App's registry and the port's
process-wide `obs.runtime.RUNTIME`. The Jaeger Thrift collector route
(`POST /api/traces`) decodes with the port's `model/jaeger` and answers
202, as the reference's does.

Paths (Tempo-compatible):
  POST /v1/traces                      OTLP HTTP ingest (json or protobuf)
  GET  /api/traces/{id}                trace by id (json spans)
  GET  /api/v2/traces/{id}             v2: trace + completion status
  GET  /api/search?q=&start=&end=&limit=
  GET  /api/search/tags                v1: flat tagNames
  GET  /api/v2/search/tags[?scope=]    v2: per-scope listing
  GET  /api/search/tag/{name}/values   v1: bare string values
  GET  /api/v2/search/tag/{name}/values  v2: typed values
  GET  /api/metrics/query?q=&start=&end=   instant (one value/series)
  GET  /api/metrics/query_range?q=&start=&end=&step=
  GET  /api/metrics/summary?q=&groupBy=    (span-metrics summary)
  GET  /api/overrides            (+POST)   user-configurable overrides
  GET  /ready /status /metrics /api/echo /api/status/buildinfo

Multi-tenancy: `X-Scope-OrgID` header; without it the fake single tenant
is used (dskit user injection behavior).
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
import urllib.parse
from urllib.parse import parse_qs, urlparse

FAKE_TENANT = "single-tenant"

# exact paths that keep their own route label; anything else normalizes
# to a template (path params stripped) or "other" so unauthenticated
# garbage paths cannot mint unbounded label cardinality
_KNOWN_ROUTES = frozenset({
    "/v1/traces", "/api/v2/spans", "/api/traces", "/api/overrides",
    "/ready", "/metrics", "/usage_metrics", "/api/echo",
    "/api/status/buildinfo", "/api/search", "/api/search/tags",
    "/api/v2/search/tags", "/api/metrics/query",
    "/api/metrics/query_range", "/api/metrics/summary",
    "/debug/threads", "/debug/profile",
    "/internal/ingester/push", "/internal/ingester/push_otlp",
    "/internal/ingester/trace", "/internal/ingester/search",
    "/internal/ingester/tags", "/internal/ingester/tag_values",
    "/internal/generator/push", "/internal/generator/push_otlp",
    "/internal/generator/query_range",
})


def _route_of(path: str) -> str:
    """Low-cardinality route template for the request-duration metric."""
    if path in _KNOWN_ROUTES:
        return path
    if path.startswith("/api/v2/traces/"):
        return "/api/v2/traces/{id}"
    if path.startswith("/api/traces/"):
        return "/api/traces/{id}"
    if path.startswith("/api/v2/search/tag/") and path.endswith("/values"):
        return "/api/v2/search/tag/{name}/values"
    if path.startswith("/api/search/tag/") and path.endswith("/values"):
        return "/api/search/tag/{name}/values"
    if path.startswith("/kv/"):
        return "/kv/{key}"
    if path == "/status" or path.startswith("/status/"):
        return "/status"
    if path.startswith("/internal/"):
        return "/internal/other"
    return "other"


def _hex_bytes(o):
    """JSON for the bytes a span can carry besides its own ids (link ids,
    bytes attributes): hex, as the ids themselves are rendered. The
    reference's encoder raises on them, so its trace route answers 500
    for any trace with a link."""
    if isinstance(o, (bytes, bytearray)):
        return bytes(o).hex()
    raise TypeError(f"Object of type {type(o).__name__} is not JSON "
                    f"serializable")


def _json_bytes(obj) -> bytes:
    return json.dumps(obj, default=_hex_bytes).encode()


MAX_INFLATED_BODY = 64 << 20   # receiver message-size cap, like the
                               # reference's receiver limits


def _gunzip_capped(body: bytes, limit: int = MAX_INFLATED_BODY) -> bytes:
    """Bounded streaming decompress: a gzip bomb hits the cap instead of
    exhausting memory."""
    import gzip
    import io

    with gzip.GzipFile(fileobj=io.BytesIO(body)) as f:
        out = f.read(limit + 1)
    if len(out) > limit:
        raise ValueError(f"inflated body exceeds {limit} bytes")
    return out


class Handler(BaseHTTPRequestHandler):
    app = None  # set by serve()

    # quiet logs
    def log_message(self, fmt, *args):  # noqa: A003
        pass

    # -- helpers -----------------------------------------------------------

    def send_response(self, code, message=None):
        self._obs_status = code       # captured for the duration histogram
        super().send_response(code, message)

    def _observe_request(self, method: str, handler) -> None:
        """Time one request into the App's HTTP duration histogram
        (route template + method + status labels)."""
        hist = getattr(self.app, "http_request_duration", None)
        if hist is None:
            return handler()
        self._obs_status = 0
        t0 = time.perf_counter()
        try:
            handler()
        finally:
            hist.observe(time.perf_counter() - t0,
                         (_route_of(urlparse(self.path).path), method,
                          str(self._obs_status or 500)))

    def _tenant(self) -> str:
        t = self.headers.get("X-Scope-OrgID", "")
        if not t:
            if self.app.cfg.multitenancy_enabled:
                return ""
            return FAKE_TENANT
        return t

    def _reply(self, code: int, body: bytes = b"",
               ctype: str = "application/json") -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _err(self, code: int, msg: str) -> None:
        self._reply(code, _json_bytes({"error": msg}))

    def _q(self) -> dict:
        return {k: v[0] for k, v in
                parse_qs(urlparse(self.path).query).items()}

    # -- ingest ------------------------------------------------------------

    def do_POST(self) -> None:  # noqa: N802
        from tempo_tpu_torch.utils import tracing

        # join the caller's W3C trace context (receiver half of the
        # propagation install, main.go:252-258)
        with tracing.adopted(self.headers.get("traceparent")):
            self._observe_request("POST", self._do_post)

    def _do_post(self) -> None:
        path = urlparse(self.path).path
        tenant = self._tenant()
        if not tenant:
            return self._err(401, "no org id")
        if "|" in tenant and not path.startswith("/kv/"):
            # `a|b` org ids are read-side federation only; writes must name
            # ONE tenant (the reference rejects multi-tenant pushes)
            return self._err(400, "multi-tenant org id not allowed on writes")
        if path in ("/v1/traces", "/api/v2/spans", "/api/traces"):
            from tempo_tpu_torch.utils import tracing
            if tracing.is_reserved(tenant):
                # the loopback ops tenant is written ONLY by the tracer's
                # own sink/RPC plane; public pushes into it would forge
                # self-observability data
                return self._err(400, f"tenant {tenant!r} is reserved "
                                      "for selftrace loopback ingest")
        try:
            if path == "/v1/traces":
                return self._push(tenant)
            if path == "/api/v2/spans":       # zipkin v2 receiver
                return self._push_zipkin(tenant)
            if path == "/api/traces":         # jaeger thrift-http collector
                return self._push_jaeger(tenant)
            if path == "/api/overrides":
                return self._set_overrides(tenant)
            if path.startswith("/internal/"):
                return self._internal_post(tenant, path)
            if path.startswith("/kv/"):
                return self._kv_cas(path[len("/kv/"):])
        except Exception as e:
            return self._err(500, str(e))
        self._err(404, f"unknown path {path}")

    # -- KV service (cross-process ring state; memberlist analog) ----------

    def _kv_store(self):
        """The member store served on /kv/*: the hosted store when this
        process is a KV member, else the in-process store. NOTE: this
        surface mutates ring membership and is unauthenticated — bind the
        server to a cluster-internal interface, like memberlist's port."""
        return getattr(self.app, "kv_host", None) or self.app.kv

    def _kv_get(self, key: str) -> None:
        from tempo_tpu_torch.ring.kv import _value_to_json
        key = urllib.parse.unquote(key)    # clients percent-encode
        ver, val = self._kv_store().get_versioned(key)
        if val is None and ver == 0:
            return self._err(404, f"no key {key}")
        self._reply(200, _json_bytes({"version": ver,
                                      "value": _value_to_json(val)}))

    def _kv_cas(self, key: str) -> None:
        from tempo_tpu_torch.ring.kv import _value_from_json
        key = urllib.parse.unquote(key)
        n = int(self.headers.get("Content-Length", 0))
        d = json.loads(self.rfile.read(n))
        ok, ver = self._kv_store().cas_versioned(
            key, int(d["expect_version"]), _value_from_json(d["value"]))
        if not ok:
            return self._err(409, f"version conflict on {key} (now {ver})")
        self._reply(200, _json_bytes({"version": ver}))

    def _internal_post(self, tenant: str, path: str) -> None:
        """Inter-service RPC surface (the gRPC-plane analog; tempo_tpu_torch.rpc
        clients are the callers)."""
        n = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(n)
        from tempo_tpu_torch.rpc import decode_push_body
        if path == "/internal/ingester/push":
            traces = decode_push_body(body)
            errs = self.app.ingester.push(tenant, traces)
            return self._reply(200, _json_bytes({"errors": errs}))
        if path == "/internal/ingester/push_otlp":
            try:
                errs2 = self.app.ingester.push_otlp(tenant, body)
            except (ValueError, KeyError, TypeError) as e:
                return self._err(400, f"malformed otlp payload: {e}")
            return self._reply(200, _json_bytes({"errors": errs2}))
        if path == "/internal/generator/push":
            traces = decode_push_body(body)
            spans = [s for _tid, group in traces for s in group]
            self.app.generator.push_spans(tenant, spans)
            return self._reply(200, b"{}")
        if path == "/internal/generator/push_otlp":
            try:
                # X-Push-Id: client retry idempotency — a replayed id
                # returns the cached span count without re-scattering
                n_spans = self.app.generator.push_otlp(
                    tenant, body,
                    push_id=self.headers.get("X-Push-Id") or None)
            except (ValueError, KeyError, TypeError) as e:
                return self._err(400, f"malformed otlp payload: {e}")
            return self._reply(200, _json_bytes({"spans": n_spans}))
        if path in ("/internal/matview/subscribe",
                    "/internal/matview/unsubscribe"):
            # explicit materialized-view subscription API (runbook
            # "Materialized query grids"); auto-subscription via qlog
            # recurrence needs no call at all
            if self.app.frontend is None:
                return self._err(404, "no frontend on this target")
            try:
                d = json.loads(body or b"{}")
                query = d["query"]
                step_s = float(d.get("step_s", 60.0))
            except (KeyError, ValueError, TypeError) as e:
                return self._err(400, f"bad subscribe body: {e}")
            if path.endswith("/subscribe"):
                ok, why = self.app.frontend.subscribe_query(
                    tenant, query, step_s)
                code = 200 if ok else 400
                return self._reply(code, _json_bytes(
                    {"subscribed": ok, "reason": why}))
            ok = self.app.frontend.unsubscribe_query(tenant, query, step_s)
            return self._reply(200, _json_bytes({"unsubscribed": ok}))
        if path == "/internal/generator/query_range":
            from tempo_tpu_torch.traceql.engine_metrics import QueryRangeRequest
            d = json.loads(body)
            req = QueryRangeRequest(query=d["query"], start_ns=d["start_ns"],
                                    end_ns=d["end_ns"], step_ns=d["step_ns"])
            series = self.app.generator.query_range(
                tenant, req, clip_start_ns=d.get("clip_start_ns"))
            return self._reply(200, _json_bytes({"series": [
                {"labels": list(s.labels), "samples": list(map(float, s.samples))}
                for s in series]}))
        self._err(404, f"unknown internal path {path}")

    # -- ingest receivers (shared preamble; shim.go:165-171 factory map) ---

    def _ingest_body(self) -> bytes | None:
        """Read + gunzip a receiver body; None when a 400 was already
        sent (shared by every ingest endpoint)."""
        n = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(n)
        if self.headers.get("Content-Encoding", "").lower() == "gzip":
            try:
                body = _gunzip_capped(body)
            except Exception as e:
                self._err(400, f"bad gzip body: {e}")
                return None
        return body

    def _push_decoded(self, tenant: str, spans, ok_status: int,
                      raw_otlp=None, raw_recs=None) -> None:
        """Distributor push + the shared rate-limit/partial-error replies."""
        from tempo_tpu_torch.distributor.distributor import RateLimited
        try:
            errs = self.app.distributor.push_spans(
                tenant, spans, raw_otlp=raw_otlp, raw_recs=raw_recs)
        except RateLimited as e:
            return self._reply_429(e)
        self._reply(ok_status, _json_bytes({"errors": errs} if errs else {}))

    def _reply_retry(self, code: int, retry_after_s: float) -> None:
        """Rejection with an advertised backoff: 429 (rate limit /
        ingest backpressure) and 503 (query shed) share the header
        formatting."""
        self.send_response(code)
        self.send_header("Retry-After",
                         str(max(1, int(round(retry_after_s)))))
        self.send_header("Content-Length", "0")
        self.end_headers()

    def _reply_429(self, e) -> None:
        self._reply_retry(429, getattr(e, "retry_after_s", 1.0))

    def _push(self, tenant: str) -> None:
        if self.app.distributor is None:
            # e.g. a metrics-generator fleet member: spans arrive over
            # the RPC plane (/internal/generator/*) from a distributor
            # process, not the public OTLP surface
            return self._err(404, "no distributor module in target "
                                  f"{self.app.cfg.target!r}")
        body = self._ingest_body()
        if body is None:
            return
        ctype = self.headers.get("Content-Type", "")
        from tempo_tpu_torch.distributor.distributor import (MalformedPayload,
                                                       RateLimited)
        if "json" in ctype:
            from tempo_tpu_torch.model.otlp import spans_from_otlp_json
            try:
                spans = list(spans_from_otlp_json(json.loads(body)))
            except (ValueError, KeyError, TypeError) as e:
                return self._err(400, f"malformed otlp payload: {e}")
            return self._push_decoded(tenant, spans, 200)
        # proto: the columnar path — span dicts only materialize if a
        # configured feature forces the fallback inside push_otlp. ONLY
        # decode-phase errors are the client's fault (OTLP spec: 400);
        # pipeline faults bubble to the 500 handler.
        try:
            errs = self.app.distributor.push_otlp(tenant, body)
        except MalformedPayload as e:
            return self._err(400, f"malformed otlp payload: {e}")
        except RateLimited as e:
            return self._reply_429(e)
        self._reply(200, _json_bytes({"errors": errs} if errs else {}))

    def _push_jaeger(self, tenant: str) -> None:
        """Jaeger collector endpoint (`/api/traces`, TBinaryProtocol Batch)
        — the thrift_http receiver of the reference's jaeger shim. Jaeger
        collectors reply 202 Accepted."""
        body = self._ingest_body()
        if body is None:
            return
        from tempo_tpu_torch.model.jaeger import spans_from_jaeger_thrift
        try:
            spans = spans_from_jaeger_thrift(body)
        except (ValueError, KeyError, TypeError) as e:
            return self._err(400, f"malformed jaeger payload: {e}")
        self._push_decoded(tenant, spans, 202)

    def _push_zipkin(self, tenant: str) -> None:
        body = self._ingest_body()
        if body is None:
            return
        from tempo_tpu_torch.model.zipkin import spans_from_zipkin_json
        try:
            spans = list(spans_from_zipkin_json(json.loads(body)))
        except (ValueError, KeyError, TypeError) as e:
            return self._err(400, f"malformed zipkin payload: {e}")
        self._push_decoded(tenant, spans, 202)   # zipkin replies 202

    def _set_overrides(self, tenant: str) -> None:
        n = int(self.headers.get("Content-Length", 0))
        patch = json.loads(self.rfile.read(n) or b"{}")
        version = self.headers.get("If-Match")
        ver = self.app.overrides.user_configurable.set(tenant, patch, version)
        self._reply(200, _json_bytes({"version": ver}))

    # -- reads -------------------------------------------------------------

    def do_GET(self) -> None:  # noqa: N802
        from tempo_tpu_torch.utils import tracing

        # reads propagate too: frontend → querier shard jobs → tempodb
        # reads all hang off the caller's tree when a context arrives
        with tracing.adopted(self.headers.get("traceparent")):
            self._observe_request("GET", self._do_get)

    def _do_get(self) -> None:
        path = urlparse(self.path).path
        q = self._q()
        try:
            if path == "/ready":
                return self._reply(200 if self.app.ready else 503,
                                   b"ready" if self.app.ready else b"starting",
                                   "text/plain")
            if path == "/api/status/buildinfo":
                # PathBuildInfo (`http.go:76`): prometheus-style build info
                return self._reply(200, _json_bytes({
                    "version": "tempo-tpu-0.4",
                    "revision": "dev", "branch": "main",
                    "goVersion": "n/a (python+torch+cpp)"}))
            if path == "/api/echo":
                return self._reply(200, b"echo", "text/plain")
            if path == "/status" or path.startswith("/status/"):
                return self._status(path)
            if path == "/metrics":
                return self._self_metrics()
            if path == "/debug/threads":
                return self._debug_threads()
            if path == "/debug/profile":
                return self._debug_profile(q)
            if path.startswith("/kv/"):
                return self._kv_get(path[len("/kv/"):])
            if path == "/usage_metrics":
                d = self.app.distributor
                text = d.usage.prometheus_text() if d is not None else ""
                return self._reply(200, text.encode(),
                                   "text/plain; version=0.0.4")
            tenant = self._tenant()
            if not tenant:
                return self._err(401, "no org id")
            if path.startswith("/api/v2/traces/"):
                return self._trace_by_id(tenant, path.split("/")[-1], v2=True)
            if path.startswith("/api/traces/"):
                return self._trace_by_id(tenant, path.split("/")[-1])
            if path == "/api/search":
                return self._search(tenant, q)
            if path == "/api/v2/search/tags":
                return self._tags(tenant, q, v2=True)
            if path == "/api/search/tags":
                return self._tags(tenant, q)
            if (path.startswith("/api/v2/search/tag/")
                    and path.endswith("/values")):
                return self._tag_values(tenant, path.split("/")[-2], q,
                                        v2=True)
            if path.startswith("/api/search/tag/") and path.endswith("/values"):
                return self._tag_values(tenant, path.split("/")[-2], q)
            if path == "/api/metrics/query_range":
                return self._query_range(tenant, q)
            if path == "/api/metrics/query":
                return self._query_instant(tenant, q)
            if path == "/api/metrics/summary":
                return self._metrics_summary(tenant, q)
            if path == "/api/overrides":
                cur = self.app.overrides.user_configurable.get(tenant) or {}
                return self._reply(200, _json_bytes({"limits": cur}))
            if path.startswith("/internal/"):
                return self._internal_get(tenant, path, q)
        except ValueError as e:
            # client errors: bad TraceQL, unsupported multi-tenant shape
            # (frontend.UnsupportedMultiTenant), malformed params → 400
            return self._err(400, str(e))
        except Exception as e:
            from tempo_tpu_torch.sched import QueryBackpressure
            if isinstance(e, QueryBackpressure):
                # device scheduler's query class is saturated: shed the
                # request with an explicit backoff instead of queuing it
                return self._reply_retry(503, e.retry_after_s)
            return self._err(500, str(e))
        self._err(404, f"unknown path {path}")

    def do_DELETE(self) -> None:  # noqa: N802
        self._observe_request("DELETE", self._do_delete)

    def _do_delete(self) -> None:
        path = urlparse(self.path).path
        if path.startswith("/kv/"):
            self._kv_store().delete(
                urllib.parse.unquote(path[len("/kv/"):]))
            return self._reply(204)
        self._err(404, f"unknown path {path}")

    def _internal_get(self, tenant: str, path: str, q: dict) -> None:
        from tempo_tpu_torch.rpc import spans_to_json
        if path == "/internal/ingester/trace":
            spans = self.app.ingester.find_trace_by_id(
                tenant, bytes.fromhex(q["tid"]))
            return self._reply(200, _json_bytes(
                {"spans": spans_to_json(spans) if spans else None}))
        if path == "/internal/ingester/search":
            from tempo_tpu_torch.obs import querystats
            with querystats.scope() as st:   # stats trailer for the caller
                res = self.app.ingester.search(
                    tenant, q.get("q", "{ }"), int(q.get("limit", 20)),
                    float(q.get("start", 0)), float(q.get("end", 0)))
            st.floor_inspected_traces(len(res))
            return self._reply(200, _json_bytes(
                {"traces": [md.to_json() for md in res],
                 "stats": st.to_json()}))
        if path == "/internal/ingester/tags":
            return self._reply(200, _json_bytes(
                {"scopes": self.app.ingester.tag_names(tenant)}))
        if path == "/internal/ingester/tag_values":
            return self._reply(200, _json_bytes(
                {"tagValues": self.app.ingester.tag_values(
                    tenant, q["name"], int(q.get("limit", 1000)))}))
        if path == "/internal/generator/collect":
            # fleet verification surface: this member's registry samples
            # for one tenant at a caller-fixed timestamp (harnesses
            # compare members' post-handoff state against an oracle).
            # peek (never create — a fresh empty instance would
            # resurrect a just-handed-off tenant) + the try_track fence
            # so a concurrent handoff can't release the pages mid-gather
            gen = self.app.generator
            inst = None if gen is None else gen.peek_instance(tenant)
            if inst is None or not inst.try_track():
                return self._reply(200, _json_bytes({"samples": []}))
            try:
                # drain barrier only (no remote-write side effect):
                # queued device batches must land in the collected state
                inst.drain()
                samples = inst.registry.collect(ts_ms=int(q.get("ts_ms", 0)))
            finally:
                inst.untrack()
            return self._reply(200, _json_bytes({"samples": [
                {"name": s.name, "labels": list(s.labels), "value": s.value}
                for s in samples if not s.is_stale_marker]}))
        if path == "/internal/generator/quantile":
            gen = self.app.generator
            inst = None if gen is None else gen.peek_instance(tenant)
            if inst is None or not inst.try_track():
                return self._reply(200, _json_bytes({"quantiles": []}))
            try:
                # ?proc=trace-analytics serves critical-path latency-
                # share quantiles from the structural analytics sidecar
                proc = inst.processors.get(q.get("proc", "span-metrics"))
                if proc is None or not hasattr(proc, "quantile"):
                    return self._reply(200, _json_bytes({"quantiles": []}))
                got = proc.quantile(float(q.get("q", 0.99)))
            finally:
                inst.untrack()
            return self._reply(200, _json_bytes({"quantiles": [
                {"labels": list(k), "value": v} for k, v in got.items()]}))
        self._err(404, f"unknown internal path {path}")

    def _trace_by_id(self, tenant: str, hexid: str,
                     v2: bool = False) -> None:
        tid = bytes.fromhex(hexid)
        spans = self.app.frontend.find_trace(tenant, tid)
        if spans is None:
            return self._err(404, "trace not found")
        out = [{**s,
                "trace_id": s["trace_id"].hex(),
                "span_id": s.get("span_id", b"").hex(),
                "parent_span_id": s.get("parent_span_id", b"").hex()}
               for s in spans]
        if v2:
            # PathTracesV2 (`pkg/api/http.go:88`): TraceByIDResponse shape
            # with trace + status (partial-trace reporting hook)
            return self._reply(200, _json_bytes({
                "trace": {"trace_id": hexid, "spans": out},
                "status": "COMPLETE"}))
        self._reply(200, _json_bytes({"trace_id": hexid, "spans": out}))

    def _search(self, tenant: str, q: dict) -> None:
        from tempo_tpu_torch.obs import querystats

        # request-scoped stats: the frontend (and every shard job under
        # it) records into this scope; the response carries the merged
        # SearchMetrics, like the reference's frontend combiner
        with querystats.scope() as st:
            res = self.app.frontend.search(
                tenant, q.get("q", "{ }"),
                limit=int(q.get("limit", 20)),
                start_s=float(q["start"]) if "start" in q else None,
                end_s=float(q["end"]) if "end" in q else None)
        st.floor_inspected_traces(len(res))
        self._reply(200, _json_bytes({
            "traces": [md.to_json() for md in res],
            "metrics": st.search_metrics()}))

    def _tags(self, tenant: str, q: dict, v2: bool = False) -> None:
        names = self.app.frontend.tag_names(tenant)
        scope = q.get("scope", "")
        if scope:
            names = {scope: names.get(scope, [])}
        if v2:
            # PathSearchTagsV2: per-scope listing (`http.go:87`)
            return self._reply(200, _json_bytes({
                "scopes": [{"name": k, "tags": v}
                           for k, v in names.items()]}))
        # v1: flat names union (`http.go:73` SearchTagsResponse)
        flat = sorted({n for v in names.values() for n in v})
        self._reply(200, _json_bytes({"tagNames": flat}))

    def _tag_values(self, tenant: str, name: str, q: dict,
                    v2: bool = False) -> None:
        # routed through frontend (SLO accounting) or querier directly on
        # frontend-less targets, so ingester recent data is included like
        # /api/search/tags (ADVICE r1)
        limit = int(q.get("limit", 1000))
        if self.app.frontend is not None:
            vals = self.app.frontend.tag_values(tenant, name, limit)
        elif self.app.querier is not None:
            vals = self.app.querier.tag_values(tenant, name, limit)
        else:
            return self._err(400, "no query module on this target")
        if v2:
            # PathSearchTagValuesV2: typed values (`http.go:86`)
            return self._reply(200, _json_bytes({"tagValues": vals}))
        # v1: bare strings (`http.go:74` SearchTagValuesResponse)
        self._reply(200, _json_bytes({
            "tagValues": [str(v.get("value", "")) for v in vals]}))

    def _query_range(self, tenant: str, q: dict) -> None:
        from tempo_tpu_torch.obs import querystats

        with querystats.scope() as st:
            series = self.app.frontend.query_range(
                tenant, q.get("q") or q.get("query", ""),
                start_s=float(q["start"]), end_s=float(q["end"]),
                step_s=float(q.get("step", 60)))
        from tempo_tpu_torch.traceql.engine_metrics import QueryRangeRequest
        req = QueryRangeRequest(
            query=q.get("q") or q.get("query", ""),
            start_ns=int(float(q["start"]) * 1e9),
            end_ns=int(float(q["end"]) * 1e9),
            step_ns=int(float(q.get("step", 60)) * 1e9))
        ts_ms = req.step_timestamps_ms()
        self._reply(200, _json_bytes({
            "series": [s.to_json(ts_ms) for s in series],
            "metrics": st.search_metrics()}))

    def _query_instant(self, tenant: str, q: dict) -> None:
        """PathMetricsQueryInstant (`http.go:80`): one value per series —
        a range query whose single step spans [start, end)."""
        start_s, end_s = float(q["start"]), float(q["end"])
        series = self.app.frontend.query_range(
            tenant, q.get("q") or q.get("query", ""),
            start_s=start_s, end_s=end_s, step_s=max(end_s - start_s, 1e-9))
        def _val(ts) -> "float | None":
            v = float(ts.samples[0]) if len(ts.samples) else 0.0
            return v if v == v else None      # NaN is not RFC-8259 JSON
        self._reply(200, _json_bytes({"series": [
            {"labels": [{"key": k, "value": {"stringValue": str(v)}}
                        for k, v in ts.labels],
             "value": _val(ts)}
            for ts in series]}))

    def _metrics_summary(self, tenant: str, q: dict) -> None:
        if self.app.generator is None:
            return self._err(
                400, "metrics summary requires a generator module "
                     f"(target={self.app.cfg.target} has none)")
        group_by = [g for g in q.get("groupBy", "").split(",") if g]
        res = self.app.generator.get_metrics(tenant, q.get("q", "{ }"),
                                             group_by)
        self._reply(200, _json_bytes({
            "summaries": [s.to_json() for s in res.results()],
            "estimated": res.estimated}))

    def _status(self, path: str) -> None:
        if path == "/status/usage-stats":
            # PathUsageStats (`http.go:77`): the report this cluster would
            # send (leader-elected reporter, pkg/usagestats analog)
            ur = getattr(self.app, "usage_reporter", None)
            if ur is None:
                return self._err(404, "usage-stats reporting not enabled")
            return self._reply(200, _json_bytes(
                ur.build_report(ur.cached_seed())))
        cfg_warnings = self.app.cfg.check()
        from tempo_tpu_torch import sched
        sc = sched.scheduler()
        body = {
            "target": self.app.cfg.target,
            "ready": self.app.ready,
            "warnings": cfg_warnings,
            "modules": [m for m in ("distributor", "ingester", "generator",
                                    "querier", "frontend", "db")
                        if getattr(self.app, m) is not None],
            # device-scheduler fill ratios per priority class — the
            # backpressure signal, also on /metrics as
            # tempo_sched_queue_depth / tempo_sched_queue_limit
            "sched_pressure": sc.pressure() if sc is not None else None,
            # overload controller (1.0 = sampling off; see runbook
            # "Surviving overload")
            "ingest_keep_fraction": sc.keep_fraction()
            if sc is not None else None,
            # serving mesh (runbook "Serving on a mesh"): None =
            # single-device serving
            "mesh": self._mesh_status(),
            # device-time ledger totals + costliest tenants (runbook
            # "Reading the device-time ledger"); full detail on /metrics
            "devtime": self._devtime_status(),
            # online dispatch cost model + tuner state (runbook
            # "Scheduler auto-tuning")
            "cost_model": self._cost_model_status(sc),
            # device page pool (runbook "Sizing the page pool"): None =
            # dense fixed-capacity layout
            "pages": self._pages_status(),
            # per-tenant device state bytes (registry + sketch planes),
            # paged and dense — also tempo_registry_state_bytes on
            # /metrics
            "registry_state_bytes": self._registry_state_status(),
            # ring membership views this process holds (runbook
            # "Operating a generator fleet"): per-member health,
            # ownership fraction, heartbeat age
            "rings": self._rings_status(),
            # fleet controller state (None = fleet mode off)
            "fleet": self._fleet_status(),
            # generator ingest WAL (runbook "Crash recovery and fault
            # injection"): None = WAL disabled
            "wal": self._wal_status(),
            # armed fault points + injected counts (None = disarmed —
            # the only acceptable state outside a chaos run)
            "faults": self._faults_status(),
            # materialized query grids (runbook "Materialized query
            # grids"): None = tier disabled
            "matview": self._matview_status(),
            # self-tracing export health (runbook "Tracing Tempo with
            # Tempo"): None = tracer not installed
            "selftrace": self._selftrace_status(),
        }
        self._reply(200, _json_bytes(body))

    def _selftrace_status(self) -> "dict | None":
        from tempo_tpu_torch.utils import tracing
        return tracing.tracer().status()

    def _matview_status(self) -> "dict | None":
        from tempo_tpu_torch import matview
        mv = matview.materializer()
        return None if mv is None else mv.status()

    def _rings_status(self) -> dict:
        out = {}
        for name, ring in getattr(self.app, "rings", {}).items():
            own = ring.ownership()
            out[name] = {
                "members": [
                    {"id": i.id, "addr": i.addr, "state": i.state,
                     "healthy": ring.healthy(i),
                     "heartbeat_age_s":
                         round(max(0.0, ring.now() - i.heartbeat_ts), 3)
                         if i.heartbeat_ts > 0 else None,
                     "ownership_ratio": round(own.get(i.id, 0.0), 4)}
                    for i in ring.instances()],
                "oldest_heartbeat_age_s":
                    round(ring.oldest_heartbeat_age(), 3),
            }
        return out

    def _fleet_status(self) -> "dict | None":
        fc = getattr(self.app, "fleet", None)
        return None if fc is None else fc.status()

    def _wal_status(self) -> "dict | None":
        gen = getattr(self.app, "generator", None)
        wal = getattr(gen, "wal", None) if gen is not None else None
        return None if wal is None else wal.status()

    def _faults_status(self) -> "dict | None":
        from tempo_tpu_torch.utils import faults
        return faults.stats() if faults.ARMED else None

    def _pages_status(self) -> "dict | None":
        from tempo_tpu_torch.registry import pages
        pool = pages.active()
        return None if pool is None else pool.status()

    def _registry_state_status(self) -> dict:
        gen = getattr(self.app, "generator", None)
        if gen is None:
            return {}
        with gen._lock:   # a concurrent push may be creating a tenant
            insts = dict(gen.instances)
        rows = [(t, gi.state_layout, gi.device_state_bytes())
                for t, gi in insts.items()]
        rows.sort(key=lambda r: -r[2])   # biggest state holders first
        return {t: {"layout": layout, "bytes": b}
                for t, layout, b in rows[:50]}

    def _devtime_status(self) -> dict:
        from tempo_tpu_torch.obs import devtime
        return devtime.LEDGER.status()

    def _cost_model_status(self, sc) -> dict:
        from tempo_tpu_torch.obs import devtime
        out = {
            "tuning": sc.cfg.tuning if sc is not None else None,
            "tuning_active": sc.tuning_active() if sc is not None else False,
            "pairs": devtime.COST_MODEL.status(),
        }
        if sc is not None and sc.cfg.tuning == "auto":
            out["tuned_window_ms"] = {
                k: round(ms, 3) for k, ms in sc._tuner.windows_ms()}
        return out

    def _mesh_status(self) -> "dict | None":
        from tempo_tpu_torch.parallel import serving
        sm = serving.active()
        if sm is None:
            return None
        return {"devices": sm.n_devices, "data_shards": sm.data_shards,
                "series_shards": sm.series_shards}

    def _debug_threads(self) -> None:
        """All thread stacks — the pprof goroutine-dump analog (the
        reference leans on dskit's admin server + Go pprof)."""
        import sys
        import traceback

        names = {t.ident: t.name for t in threading.enumerate()}
        out = []
        for tid, frame in sys._current_frames().items():
            out.append(f"--- thread {names.get(tid, '?')} ({tid}) ---")
            out.extend(line.rstrip() for line in
                       traceback.format_stack(frame))
        self._reply(200, "\n".join(out).encode() + b"\n", "text/plain")

    def _debug_profile(self, q: dict) -> None:
        """Sampling wall-clock profile over ?seconds=N (capped): stacks of
        every thread sampled at ~100Hz, aggregated by frame — the CPU
        pprof analog without native profiler support."""
        import sys
        import time as _t

        seconds = min(float(q.get("seconds", 2)), 30.0)
        hits: dict[str, int] = {}
        samples = 0
        deadline = _t.time() + seconds
        me = threading.get_ident()
        while _t.time() < deadline:
            for tid, frame in sys._current_frames().items():
                if tid == me:
                    continue
                f = frame
                while f is not None:
                    co = f.f_code
                    key = f"{co.co_filename}:{f.f_lineno} {co.co_name}"
                    hits[key] = hits.get(key, 0) + 1
                    f = f.f_back
            samples += 1
            _t.sleep(0.01)
        top = sorted(hits.items(), key=lambda kv: -kv[1])[:100]
        lines = [f"samples: {samples} over {seconds}s", ""]
        lines += [f"{n:>8} {k}" for k, n in top]
        self._reply(200, "\n".join(lines).encode() + b"\n", "text/plain")

    def _self_metrics(self) -> None:
        """Prometheus text exposition, rendered entirely from the obs
        registry (each module registered its own families at wiring time)
        plus the process-wide runtime registry. The API layer no
        longer reaches into module internals."""
        from tempo_tpu_torch.obs.runtime import RUNTIME

        reg = getattr(self.app, "obs", None)
        text = reg.render(extra=(RUNTIME,)) if reg is not None else ""
        self._reply(200, text.encode(), "text/plain; version=0.0.4")


def serve(app, block: bool = True) -> ThreadingHTTPServer:
    # per-server Handler subclass: multiple Apps can serve from one process
    # (tests, scalable-single-binary) without sharing the class attribute
    handler_cls = type("BoundHandler", (Handler,), {"app": app})
    srv = ThreadingHTTPServer(
        (app.cfg.server.http_listen_address, app.cfg.server.http_listen_port),
        handler_cls)
    if block:
        try:
            srv.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            srv.shutdown()
        return srv
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv
