"""Generic per-tenant trace forwarder (tee to external endpoints).

Counterpart of `tempo_tpu/distributor/forwarder.py`, host code copied with its imports
moved to the port.

Analog of `modules/distributor/forwarder` (`forwarder/manager.go:291`):
each tenant may configure named forwarders; matching spans are teed
asynchronously to the forwarder's sink. Sinks are pluggable — an
OTLP-JSON HTTP sink is provided; tests inject callables. Filtering uses
the span-filter policy engine (the OTTL-filter analog).
"""

from __future__ import annotations

import dataclasses
import json
import queue
import threading
import urllib.request
from typing import Callable, Sequence

@dataclasses.dataclass
class ForwarderConfig:
    name: str
    endpoint: str = ""                    # http(s) OTLP-JSON target
    # filter: {"include": {key: value, ...}} and/or {"exclude": {...}} —
    # strict matches on name/service/kind/status_code or span attrs (the
    # OTTL-filter analog, dict-level since the tee runs pre-batching)
    filter: dict = dataclasses.field(default_factory=dict)
    # filter_policies: full pkg/spanfilter-shape policies
    # [{"include": {"match_type": "strict"|"regex",
    #               "attributes": [{"key": ..., "value": ...}]},
    #   "exclude": {...}}, ...] — keys: kind/status/name/span.*/resource.*
    # (the per-tenant OTTL filtering of `modules/distributor/forwarder`)
    filter_policies: list = dataclasses.field(default_factory=list)
    queue_size: int = 1000


# intrinsic string forms (pkg/spanfilter's splitPolicy enum strings)
_KIND_STRS = ("SPAN_KIND_UNSPECIFIED", "SPAN_KIND_INTERNAL",
              "SPAN_KIND_SERVER", "SPAN_KIND_CLIENT",
              "SPAN_KIND_PRODUCER", "SPAN_KIND_CONSUMER")
_STATUS_STRS = ("STATUS_CODE_UNSET", "STATUS_CODE_OK", "STATUS_CODE_ERROR")


def _span_value(span: dict, key: str):
    """Resolve a policy key on a span dict, mirroring the vectorized
    engine's scoping (`utils/spanfilter._match_one`)."""
    if key in ("kind", "span.kind"):
        k = int(span.get("kind", 0) or 0)
        return _KIND_STRS[k] if 0 <= k < len(_KIND_STRS) else _KIND_STRS[0]
    if key in ("status", "span.status", "status.code"):
        c = int(span.get("status_code", 0) or 0)
        return _STATUS_STRS[c] if 0 <= c < 3 else _STATUS_STRS[0]
    if key in ("name", "span.name"):
        return span.get("name", "")
    if key.startswith("resource."):
        return (span.get("res_attrs") or {}).get(key[len("resource."):])
    if key.startswith("span."):
        return (span.get("attrs") or {}).get(key[len("span."):])
    return (span.get("attrs") or {}).get(key)


def _policy_matches(span: dict, pm: dict) -> bool:
    """Every attribute of the PolicyMatch must match (spanfilter.go:53)."""
    import re

    regex = pm.get("match_type") == "regex"
    for am in pm.get("attributes", ()):
        have = _span_value(span, str(am.get("key", "")))
        if have is None:
            return False
        want = str(am.get("value", ""))
        if regex:
            if not re.fullmatch(want, str(have)):
                return False
        elif str(have) != want:
            return False
    return True


def _span_matches(span: dict, wants: dict) -> bool:
    for k, v in wants.items():
        have = span.get(k)
        if have is None:
            have = (span.get("attrs") or {}).get(k)
        if have is None:
            have = (span.get("res_attrs") or {}).get(k)
        if str(have) != str(v):
            return False
    return True


def keep_span(span: dict, flt: dict,
              policies: "Sequence[dict] | None" = None) -> bool:
    inc = flt.get("include") if flt else None
    if inc and not _span_matches(span, inc):
        return False
    exc = flt.get("exclude") if flt else None
    if exc and _span_matches(span, exc):
        return False
    # policy semantics: kept iff for EVERY policy (include absent or
    # matched) and (exclude absent or not matched)
    for p in policies or ():
        pinc = p.get("include")
        if pinc and not _policy_matches(span, pinc):
            return False
        pexc = p.get("exclude")
        if pexc and _policy_matches(span, pexc):
            return False
    return True


def otlp_json_payload(spans: Sequence[dict]) -> dict:
    """Flat span dicts → OTLP-JSON ExportTraceServiceRequest."""
    by_service: dict[str, list[dict]] = {}
    for s in spans:
        by_service.setdefault(s.get("service", ""), []).append(s)
    rss = []
    for svc, group in by_service.items():
        rss.append({
            "resource": {"attributes": [
                {"key": "service.name", "value": {"stringValue": svc}}]},
            "scopeSpans": [{"spans": [{
                "traceId": s.get("trace_id", b"").hex(),
                "spanId": s.get("span_id", b"").hex(),
                "parentSpanId": s.get("parent_span_id", b"").hex(),
                "name": s.get("name", ""),
                "kind": s.get("kind", 0),
                "startTimeUnixNano": str(s.get("start_unix_nano", 0)),
                "endTimeUnixNano": str(s.get("end_unix_nano", 0)),
                "attributes": [
                    {"key": k, "value": _anyvalue(v)}
                    for k, v in (s.get("attrs") or {}).items()],
                "status": {"code": s.get("status_code", 0)},
            } for s in group]}],
        })
    return {"resourceSpans": rss}


def _anyvalue(v) -> dict:
    if isinstance(v, bool):
        return {"boolValue": v}
    if isinstance(v, int):
        return {"intValue": str(v)}
    if isinstance(v, float):
        return {"doubleValue": v}
    return {"stringValue": str(v)}


def http_sink(endpoint: str, timeout_s: float = 10.0
              ) -> Callable[[Sequence[dict]], None]:
    def send(spans: Sequence[dict]) -> None:
        body = json.dumps(otlp_json_payload(spans)).encode()
        req = urllib.request.Request(
            endpoint, data=body, headers={"Content-Type": "application/json"})
        urllib.request.urlopen(req, timeout=timeout_s).read()
    return send


class Forwarder:
    """One tenant's forwarder: bounded queue + worker thread, drop-on-full
    (forwarding is best-effort; it must never block ingest)."""

    def __init__(self, cfg: ForwarderConfig,
                 sink: Callable[[Sequence[dict]], None] | None = None) -> None:
        import re

        self.cfg = cfg
        # validate regex policies at REGISTRATION, where a config error
        # belongs — not per span on the ingest path
        for p in cfg.filter_policies or ():
            for pm in (p.get("include"), p.get("exclude")):
                if pm and pm.get("match_type") == "regex":
                    for am in pm.get("attributes", ()):
                        re.compile(str(am.get("value", "")))
        self.sink = sink or http_sink(cfg.endpoint)
        self._q: queue.Queue = queue.Queue(maxsize=cfg.queue_size)
        self.dropped = 0
        self.forwarded = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def offer(self, spans: Sequence[dict]) -> None:
        if self.cfg.filter or self.cfg.filter_policies:
            try:
                spans = [s for s in spans
                         if keep_span(s, self.cfg.filter,
                                      self.cfg.filter_policies)]
            except Exception:
                # the tee is best-effort and must NEVER fail ingest: a
                # filter blow-up counts the batch as dropped
                self.dropped += len(spans)
                return
        if not spans:
            return
        try:
            self._q.put_nowait(list(spans))
        except queue.Full:
            self.dropped += len(spans)

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                spans = self._q.get(timeout=0.2)
            except queue.Empty:
                continue
            try:
                self.sink(spans)
                self.forwarded += len(spans)
            except Exception:
                self.dropped += len(spans)

    def flush(self, timeout_s: float = 2.0) -> None:
        import time
        deadline = time.time() + timeout_s
        while not self._q.empty() and time.time() < deadline:
            time.sleep(0.01)

    def shutdown(self) -> None:
        self.flush()
        self._stop.set()
        self._thread.join(timeout=2)


class ForwarderManager:
    """Per-tenant forwarder registry driven by overrides/config
    (`forwarder/manager.go`)."""

    def __init__(self) -> None:
        self._by_tenant: dict[str, list[Forwarder]] = {}
        self._lock = threading.Lock()
        self.empty = True   # lock-free hot-path gate (flips once)

    def register(self, tenant: str, fwd: Forwarder) -> None:
        with self._lock:
            self._by_tenant.setdefault(tenant, []).append(fwd)
            self.empty = False

    def for_tenant(self, tenant: str) -> list[Forwarder]:
        with self._lock:
            return list(self._by_tenant.get(tenant, ()))

    def offer(self, tenant: str, spans: Sequence[dict]) -> None:
        if self.empty:
            return
        for fwd in self.for_tenant(tenant):
            fwd.offer(spans)

    def shutdown(self) -> None:
        with self._lock:
            all_fwds = [f for fs in self._by_tenant.values() for f in fs]
        for f in all_fwds:
            f.shutdown()
