"""Zipkin v2 JSON receiver decoding.

Counterpart of `tempo_tpu/model/zipkin.py`, copied.

Analog of the zipkin receiver the distributor hosts in-process
(`modules/distributor/receiver/shim.go:165-171`): Zipkin v2 spans
(`POST /api/v2/spans`) map onto the flat span-dict wire form. Kind maps
SERVER/CLIENT/PRODUCER/CONSUMER; `localEndpoint.serviceName` becomes the
resource service; tags become span attrs; timestamps are µs in Zipkin.
"""

from __future__ import annotations

from typing import Any, Iterable

_KIND = {"SERVER": 2, "CLIENT": 3, "PRODUCER": 4, "CONSUMER": 5}


def _pad_id(hexstr: str, nbytes: int) -> bytes:
    h = (hexstr or "").lower()
    try:
        raw = bytes.fromhex(h.zfill(nbytes * 2)[-nbytes * 2:])
    except ValueError:
        return b""
    return raw


def spans_from_zipkin_json(payload: list[dict]) -> Iterable[dict]:
    for z in payload or []:
        ts_us = int(z.get("timestamp") or 0)
        dur_us = int(z.get("duration") or 0)
        tags: dict[str, Any] = dict(z.get("tags") or {})
        svc = ((z.get("localEndpoint") or {}).get("serviceName")
               or tags.pop("service.name", "") or "")
        status_code = 0
        if "error" in tags:
            status_code = 2
        s = {
            "trace_id": _pad_id(z.get("traceId", ""), 16),
            "span_id": _pad_id(z.get("id", ""), 8),
            "parent_span_id": _pad_id(z.get("parentId", ""), 8)
            if z.get("parentId") else b"",
            "name": z.get("name", ""),
            "service": svc,
            "kind": _KIND.get(str(z.get("kind", "")).upper(), 0),
            "status_code": status_code,
            "start_unix_nano": ts_us * 1000,
            "end_unix_nano": (ts_us + dur_us) * 1000,
        }
        if tags:
            s["attrs"] = tags
        if svc:
            s["res_attrs"] = {"service.name": svc}
        yield s
