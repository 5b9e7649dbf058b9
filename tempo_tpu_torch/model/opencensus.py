"""OpenCensus agent trace protocol → span dicts.

The last receiver protocol of the reference's shim
(`modules/distributor/receiver/shim.go:165-171` "opencensus"): legacy OC
libraries stream `opencensus.proto.agent.trace.v1.TraceService/Export`
requests — Node + Resource on the first message of a stream, spans on
every message. Hand-rolled over proto_wire like the other wire models.

Field mapping follows the collector's opencensus translator: OC kind
SERVER/CLIENT → OTel SERVER/CLIENT; Status present with code 0 → OK,
nonzero → ERROR, absent → UNSET; Node.service_info.name + Resource labels
become the resource.

Counterpart of `tempo_tpu/model/opencensus.py`, host code copied with its imports
moved to the port; it runs no device code of its own.
"""

from __future__ import annotations

import struct
from typing import Any

from tempo_tpu_torch.model import proto_wire as pw

# OC SpanKind → OTel span kind
_KIND = {0: 0, 1: 2, 2: 3}


def _trunc_str(buf) -> str:
    """TruncatableString{value=1}."""
    for fnum, wt, val in pw.iter_fields(bytes(buf)):
        if fnum == 1 and wt == 2:
            return bytes(val).decode("utf-8", "replace")
    return ""


def _ts_ns(buf) -> int:
    sec = nanos = 0
    for fnum, wt, val in pw.iter_fields(bytes(buf)):
        if fnum == 1 and wt == 0:
            sec = val
        elif fnum == 2 and wt == 0:
            nanos = val
    return sec * 1_000_000_000 + nanos


def _attr_value(buf) -> Any:
    for fnum, wt, val in pw.iter_fields(bytes(buf)):
        if fnum == 1 and wt == 2:
            return _trunc_str(val)
        if fnum == 2 and wt == 0:
            return val - (1 << 64) if val >= (1 << 63) else val
        if fnum == 3 and wt == 0:
            return bool(val)
        if fnum == 4 and wt == 1:
            return pw.f64(val)
    return ""


def _attributes(buf) -> dict:
    """Attributes{attribute_map=1 (map<string, AttributeValue>)}."""
    out: dict[str, Any] = {}
    for fnum, wt, val in pw.iter_fields(bytes(buf)):
        if fnum != 1 or wt != 2:
            continue
        key, av = "", None
        for efn, ewt, ev in pw.iter_fields(bytes(val)):
            if efn == 1 and ewt == 2:
                key = bytes(ev).decode("utf-8", "replace")
            elif efn == 2 and ewt == 2:
                av = _attr_value(ev)
        if key:
            out[key] = av if av is not None else ""
    return out


def node_service(buf: bytes) -> str:
    """Node{service_info=3 ServiceInfo{name=1}}."""
    for fnum, wt, val in pw.iter_fields(bytes(buf)):
        if fnum == 3 and wt == 2:
            for sfn, swt, sv in pw.iter_fields(bytes(val)):
                if sfn == 1 and swt == 2:
                    return bytes(sv).decode("utf-8", "replace")
    return ""


def resource_labels(buf: bytes) -> dict:
    """Resource{type=1, labels=2 map<string,string>}."""
    out: dict[str, str] = {}
    for fnum, wt, val in pw.iter_fields(bytes(buf)):
        if fnum != 2 or wt != 2:
            continue
        k = v = ""
        for efn, ewt, ev in pw.iter_fields(bytes(val)):
            if efn == 1 and ewt == 2:
                k = bytes(ev).decode("utf-8", "replace")
            elif efn == 2 and ewt == 2:
                v = bytes(ev).decode("utf-8", "replace")
        if k:
            out[k] = v
    return out


def _oc_span(buf, service: str, res_attrs: dict) -> dict:
    f = pw.decode_fields(bytes(buf))
    first = lambda n: bytes(f[n][0]) if f.get(n) else b""
    status_code = 0
    if f.get(13):                         # Status{code=1, message=2}
        code = 0
        for sfn, swt, sv in pw.iter_fields(first(13)):
            if sfn == 1 and swt == 0:
                code = sv
        status_code = 1 if code == 0 else 2
    kind = 0
    for fnum, wt, val in pw.iter_fields(bytes(buf)):
        if fnum == 6 and wt == 0:
            kind = _KIND.get(val, 0)
    span_res = dict(res_attrs)
    span_service = service
    if f.get(14):                         # per-span Resource override
        labels = resource_labels(first(14))
        span_res.update(labels)
        span_service = labels.get("service.name", service)
    span_res.setdefault("service.name", span_service)
    start = _ts_ns(first(7)) if f.get(7) else 0
    end = _ts_ns(first(8)) if f.get(8) else start
    return {
        "trace_id": first(1), "span_id": first(2),
        "parent_span_id": first(4),
        "name": _trunc_str(first(5)) if f.get(5) else "",
        "service": span_service, "kind": kind,
        "status_code": status_code,
        "start_unix_nano": start, "end_unix_nano": end,
        "attrs": _attributes(first(9)) if f.get(9) else {},
        "res_attrs": span_res,
    }


def spans_from_opencensus(data: bytes, service: str = "",
                          res_attrs: "dict | None" = None
                          ) -> tuple[list[dict], str, dict]:
    """Decode one ExportTraceServiceRequest{node=1, spans=2, resource=3}.

    Returns (spans, service, res_attrs) — node/resource persist across a
    stream, so the caller threads the previous values back in for
    messages that omit them. Raises ValueError on malformed bytes.
    """
    try:
        f = pw.decode_fields(data)
        if f.get(1):
            got = node_service(bytes(f[1][0]))
            if got:
                service = got
        res = dict(res_attrs or {})
        if f.get(3):
            res.update(resource_labels(bytes(f[3][0])))
        res.setdefault("service.name", service)
        spans = [_oc_span(b, service, res) for b in f.get(2, [])]
        return spans, service, res
    except (ValueError, struct.error, IndexError, KeyError) as e:
        raise ValueError(f"malformed opencensus payload: {e}") from None


__all__ = ["spans_from_opencensus", "node_service", "resource_labels"]
