"""HTTP API client (`pkg/httpclient` analog) — used by the CLI, vulture,
and tests that drive a live server.

Counterpart of `tempo_tpu/client.py`, host code copied with its imports
moved to the port; it runs no device code of its own.
"""

from __future__ import annotations

import json
import urllib.parse
import urllib.request


class Client:
    def __init__(self, base_url: str, tenant: str = "",
                 timeout_s: float = 30.0) -> None:
        self.base = base_url.rstrip("/")
        self.tenant = tenant
        self.timeout = timeout_s

    def _headers(self) -> dict:
        h = {"Content-Type": "application/json"}
        if self.tenant:
            h["X-Scope-OrgID"] = self.tenant
        return h

    def _get(self, path: str, params: dict | None = None) -> dict:
        url = self.base + path
        if params:
            url += "?" + urllib.parse.urlencode(params)
        req = urllib.request.Request(url, headers=self._headers())
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            return json.loads(r.read() or b"{}")

    def _post(self, path: str, body: bytes,
              ctype: str = "application/json") -> dict:
        h = self._headers()
        h["Content-Type"] = ctype
        req = urllib.request.Request(self.base + path, data=body, headers=h)
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            return json.loads(r.read() or b"{}")

    # -- API surface -------------------------------------------------------

    def push_otlp_json(self, payload: dict) -> dict:
        return self._post("/v1/traces", json.dumps(payload).encode())

    def trace_by_id(self, trace_id_hex: str) -> dict:
        return self._get(f"/api/traces/{trace_id_hex}")

    def search(self, query: str = "{ }", limit: int = 20,
               start_s: float | None = None, end_s: float | None = None) -> dict:
        params: dict = {"q": query, "limit": limit}
        if start_s is not None:
            params["start"] = start_s
        if end_s is not None:
            params["end"] = end_s
        return self._get("/api/search", params)

    def search_tags(self, scope: str = "") -> dict:
        return self._get("/api/search/tags", {"scope": scope} if scope else None)

    def search_tag_values(self, tag: str) -> dict:
        return self._get(f"/api/search/tag/{tag}/values")

    def query_range(self, query: str, start_s: float, end_s: float,
                    step_s: float = 60.0) -> dict:
        return self._get("/api/metrics/query_range", {
            "q": query, "start": start_s, "end": end_s, "step": step_s})

    def metrics_summary(self, query: str = "{ }", group_by: str = "") -> dict:
        return self._get("/api/metrics/summary",
                         {"q": query, "groupBy": group_by})

    def ready(self) -> bool:
        try:
            req = urllib.request.Request(self.base + "/ready")
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return r.status == 200
        except Exception:
            return False
