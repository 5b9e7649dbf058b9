"""Inter-service RPC: remote clients for the in-process seams.

Counterpart of `tempo_tpu/rpc.py`, copied with its imports moved to the
port. The App builds these clients for static `http://` peers; `grpc://`
peers get the gRPC plane's clients (`grpcplane/client.py`) instead.

Analog of the reference's gRPC plane (`pkg/tempopb/tempo.proto` services
Pusher / MetricsGenerator / Querier, carried by dskit server): every
service seam in this framework is a small protocol (IngesterClient,
GeneratorClient, IngesterQueryClient), satisfied in-process by the service
objects and here by HTTP clients, so `-target` processes compose into a
microservices deployment with a config change. Trace payloads ride the
ingest-bus record encoding (`ingest/encoding.py` — varint-framed groups),
not JSON, on the hot push path.

Server side: `/internal/*` routes in `app/api.py` dispatch to the local
service objects.
"""

from __future__ import annotations

import json
import random
import time
import urllib.error
import urllib.parse
import urllib.request
import uuid
from typing import Sequence

from tempo_tpu_torch.ingest.encoding import decode_push, encode_push
from tempo_tpu_torch.utils import faults, tracing


def _check_single_record(records: list[bytes]) -> bytes:
    # encode_push splits at max_record_bytes; for RPC we ship one body
    return b"".join(records)


class _BaseClient:
    def __init__(self, base_url: str, timeout_s: float = 30.0) -> None:
        self.base = base_url.rstrip("/")
        self.timeout = timeout_s

    def _post(self, path: str, body: bytes, tenant: str,
              ctype: str = "application/x-tempo-push",
              headers: dict | None = None) -> dict:
        h = {"Content-Type": ctype, "X-Scope-OrgID": tenant}
        # W3C context propagation (`main.go:252-258`): every internal
        # hop carries the caller's traceparent so the receiver's spans
        # join the SAME logical tree across processes
        tp = tracing.tracer().traceparent()
        if tp:
            h["traceparent"] = tp
        if headers:
            h.update(headers)
        req = urllib.request.Request(self.base + path, data=body, headers=h)
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            return json.loads(r.read() or b"{}")

    def _get(self, path: str, tenant: str, params: dict | None = None) -> dict:
        url = self.base + path
        if params:
            url += "?" + urllib.parse.urlencode(params)
        h = {"X-Scope-OrgID": tenant}
        tp = tracing.tracer().traceparent()
        if tp:
            h["traceparent"] = tp
        req = urllib.request.Request(url, headers=h)
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            return json.loads(r.read() or b"{}")


def _push_retryable(e: BaseException) -> bool:
    """Transport failures and gateway-class 5xx are worth retrying; a
    4xx is the payload's fault and retrying re-offers the same bytes."""
    if isinstance(e, urllib.error.HTTPError):
        return e.code in (502, 503, 504)
    return isinstance(e, (urllib.error.URLError, TimeoutError,
                          ConnectionError, OSError))


class RemoteIngesterClient(_BaseClient):
    """IngesterClient + IngesterQueryClient over HTTP (`Pusher.PushBytesV2`
    + `Querier` RPCs)."""

    def push(self, tenant: str,
             traces: Sequence[tuple[bytes, list[dict]]]) -> list[str | None]:
        if faults.ARMED:
            faults.fire("rpc.push")
        body = _check_single_record(encode_push(traces, max_record_bytes=1 << 62))
        res = self._post("/internal/ingester/push", body, tenant)
        return res.get("errors", [None] * len(traces))

    def push_otlp(self, tenant: str, payload: bytes) -> dict[str, str]:
        if faults.ARMED:
            faults.fire("rpc.push")
        res = self._post("/internal/ingester/push_otlp", payload, tenant,
                         ctype="application/x-protobuf")
        return res.get("errors", {})

    def find_trace_by_id(self, tenant: str, trace_id: bytes) -> list[dict] | None:
        res = self._get("/internal/ingester/trace", tenant,
                        {"tid": trace_id.hex()})
        spans = res.get("spans")
        return _json_to_spans(spans) if spans else None

    def search(self, tenant: str, query: str, limit: int = 20,
               start_s: float = 0, end_s: float = 0):
        from tempo_tpu_torch.obs.querystats import QueryStats, absorb
        from tempo_tpu_torch.traceql.engine import TraceSearchMetadata

        res = self._get("/internal/ingester/search", tenant,
                        {"q": query, "limit": limit,
                         "start": start_s, "end": end_s})
        # the remote ingester's per-request stats merge into this
        # process's ambient scope (absent from old-format responses)
        absorb(QueryStats.from_json(res.get("stats")))
        return [TraceSearchMetadata.from_json(t)
                for t in res.get("traces", [])]

    def tag_names(self, tenant: str) -> dict[str, list[str]]:
        return self._get("/internal/ingester/tags", tenant).get("scopes", {})

    def tag_values(self, tenant: str, name: str, limit: int = 1000) -> list[dict]:
        return self._get("/internal/ingester/tag_values", tenant,
                         {"name": name, "limit": limit}).get("tagValues", [])


class RemoteGeneratorClient(_BaseClient):
    """GeneratorClient over HTTP (`MetricsGenerator.PushSpans`)."""

    def push_spans(self, tenant: str, spans: Sequence[dict]) -> None:
        if faults.ARMED:
            faults.fire("rpc.push")
        groups: dict[bytes, list[dict]] = {}
        for s in spans:
            groups.setdefault(s.get("trace_id", b""), []).append(s)
        body = _check_single_record(
            encode_push(list(groups.items()), max_record_bytes=1 << 62))
        self._post("/internal/generator/push", body, tenant)

    def push_otlp(self, tenant: str, data: bytes, retries: int = 2) -> int:
        """Idempotent push: every attempt carries the SAME X-Push-Id, so
        a retry after a lost response (timeout, receiver kill) dedupes
        server-side against the receiver's recent-push window instead of
        double-scattering. Transient transport errors / gateway 5xx
        retry with jittered backoff; the caller (distributor tee)
        re-resolves the ring owner on final failure."""
        push_id = uuid.uuid4().hex
        delay = 0.05
        # ONE span for the whole retry loop: every attempt posts the
        # same traceparent (captured inside this span by _post) AND the
        # same X-Push-Id, so a deduped retry lands in the receiver as
        # the same logical tree — retries widen one span, never fork a
        # second tree
        with tracing.span_for_tenant("rpc.push", tenant,
                                     push_id=push_id) as sp:
            for attempt in range(retries + 1):
                try:
                    if faults.ARMED:
                        faults.fire("rpc.push")
                    res = self._post("/internal/generator/push_otlp", data,
                                     tenant, ctype="application/x-protobuf",
                                     headers={"X-Push-Id": push_id})
                    if sp is not None and attempt:
                        sp.attrs["retries"] = attempt
                    return int(res.get("spans", 0))
                except Exception as e:
                    if attempt >= retries or not _push_retryable(e):
                        raise
                    time.sleep(delay * (0.5 + random.random()))
                    delay = min(delay * 2, 1.0)

    def query_range(self, tenant: str, req, clip_start_ns: int | None = None):
        from tempo_tpu_torch.traceql.engine_metrics import TimeSeries
        import numpy as np

        res = self._post(
            "/internal/generator/query_range",
            json.dumps({"query": req.query, "start_ns": req.start_ns,
                        "end_ns": req.end_ns, "step_ns": req.step_ns,
                        "clip_start_ns": clip_start_ns}).encode(),
            tenant, ctype="application/json")
        return [TimeSeries(labels=tuple((k, v) for k, v in s["labels"]),
                           samples=np.asarray(s["samples"], np.float64))
                for s in res.get("series", [])]


# -- payload helpers (server side uses these too) ---------------------------

def spans_to_json(spans: list[dict]) -> list[dict]:
    out = []
    for s in spans:
        d = dict(s)
        for k in ("trace_id", "span_id", "parent_span_id"):
            if isinstance(d.get(k), bytes):
                d[k] = d[k].hex()
        out.append(d)
    return out


def _json_to_spans(spans: list[dict]) -> list[dict]:
    out = []
    for s in spans:
        d = dict(s)
        for k in ("trace_id", "span_id", "parent_span_id"):
            if isinstance(d.get(k), str):
                d[k] = bytes.fromhex(d[k])
        out.append(d)
    return out


def decode_push_body(body: bytes) -> list[tuple[bytes, list[dict]]]:
    return list(decode_push(body))
