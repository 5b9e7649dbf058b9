"""OTLP trace ingest: protobuf → SpanBatch, and the encoder back to bytes.

The receiver-side conversion of the reference's OTel receiver shim
(`modules/distributor/receiver/shim.go:165`), collapsed into one decode
straight into span tensors over the public opentelemetry-proto trace.proto
v1 field numbers. `encode_spans_otlp` is its inverse; tests and the chip
smoke use it to make payloads. `slice_otlp_payload` cuts a payload down
to a subset of its spans from the native scan's wire offsets. The C++
staging route (`model/otlp_batch.py`) is the generator's main path; this
Python decoder is its reference and the route of `otlp_proto_to_batch`.
The OTLP/JSON route (`spans_from_otlp_json`, `otlp_json_to_batch`) is the
reference's, copied, for the HTTP API's JSON pushes.
"""

from __future__ import annotations

import binascii
from typing import Any, Iterable

from tempo_tpu_torch.model import proto_wire as pw
from tempo_tpu_torch.model.span_batch import SpanBatch, SpanBatchBuilder

_KIND_NAMES = {
    "SPAN_KIND_UNSPECIFIED": 0, "SPAN_KIND_INTERNAL": 1, "SPAN_KIND_SERVER": 2,
    "SPAN_KIND_CLIENT": 3, "SPAN_KIND_PRODUCER": 4, "SPAN_KIND_CONSUMER": 5,
}
_STATUS_NAMES = {"STATUS_CODE_UNSET": 0, "STATUS_CODE_OK": 1, "STATUS_CODE_ERROR": 2}


# ---------------------------------------------------------------------------
# OTLP/JSON
# ---------------------------------------------------------------------------

def _json_anyvalue(v: dict[str, Any]) -> Any:
    if "stringValue" in v:
        return v["stringValue"]
    if "intValue" in v:
        return int(v["intValue"])
    if "doubleValue" in v:
        return float(v["doubleValue"])
    if "boolValue" in v:
        return bool(v["boolValue"])
    if "arrayValue" in v:
        return [_json_anyvalue(x) for x in v["arrayValue"].get("values", [])]
    if "kvlistValue" in v:
        return {kv["key"]: _json_anyvalue(kv.get("value", {}))
                for kv in v["kvlistValue"].get("values", [])}
    if "bytesValue" in v:
        return v["bytesValue"]
    return None


def _json_attrs(lst: Iterable[dict] | None) -> dict[str, Any]:
    return {kv["key"]: _json_anyvalue(kv.get("value", {})) for kv in (lst or [])}


def spans_from_otlp_json(payload: dict) -> Iterable[dict]:
    """Yield flat span dicts from an OTLP/JSON ExportTraceServiceRequest."""
    for rs in payload.get("resourceSpans", []):
        res_attrs = _json_attrs(rs.get("resource", {}).get("attributes"))
        service = str(res_attrs.get("service.name", ""))
        for ss in rs.get("scopeSpans", rs.get("instrumentationLibrarySpans", [])):
            for sp in ss.get("spans", []):
                kind = sp.get("kind", 0)
                if isinstance(kind, str):
                    kind = _KIND_NAMES.get(kind, 0)
                status = sp.get("status", {})
                scode = status.get("code", 0)
                if isinstance(scode, str):
                    scode = _STATUS_NAMES.get(scode, 0)
                span = {
                    "trace_id": binascii.unhexlify(sp.get("traceId", "")),
                    "span_id": binascii.unhexlify(sp.get("spanId", "")),
                    "parent_span_id": binascii.unhexlify(sp.get("parentSpanId", "") or ""),
                    "name": sp.get("name", ""),
                    "service": service,
                    "kind": int(kind),
                    "status_code": int(scode),
                    "status_message": status.get("message", ""),
                    "start_unix_nano": int(sp.get("startTimeUnixNano", 0)),
                    "end_unix_nano": int(sp.get("endTimeUnixNano", 0)),
                    "attrs": _json_attrs(sp.get("attributes")),
                    "res_attrs": res_attrs,
                }
                if sp.get("events"):
                    span["events"] = [
                        {"time_unix_nano": int(e.get("timeUnixNano", 0)),
                         "name": e.get("name", "")}
                        for e in sp["events"]]
                if sp.get("links"):
                    span["links"] = [
                        {"trace_id": binascii.unhexlify(
                            ln.get("traceId", "") or ""),
                         "span_id": binascii.unhexlify(
                            ln.get("spanId", "") or "")}
                        for ln in sp["links"]]
                yield span


def otlp_json_to_batch(payload: dict, builder: SpanBatchBuilder | None = None) -> SpanBatch:
    b = SpanBatchBuilder() if builder is None else builder
    for span in spans_from_otlp_json(payload):
        b.append(**span)
    return b.build()




def _pb_anyvalue(buf) -> Any:
    for fnum, _, val in pw.iter_fields(bytes(buf)):
        if fnum == 1:
            return bytes(val).decode("utf-8", "replace")
        if fnum == 2:
            return bool(val)
        if fnum == 3:
            # int64 varint, two's complement
            return val - (1 << 64) if val >= (1 << 63) else val
        if fnum == 4:
            return pw.f64(val)
        if fnum == 5:  # ArrayValue{ repeated AnyValue values = 1 }
            return [_pb_anyvalue(v) for f, _, v in pw.iter_fields(bytes(val)) if f == 1]
        if fnum == 6:  # KeyValueList{ repeated KeyValue values = 1 }
            return _pb_attrs([v for f, _, v in pw.iter_fields(bytes(val)) if f == 1])
        if fnum == 7:
            return bytes(val)
    return None


def _pb_attrs(kvs: Iterable) -> dict[str, Any]:
    out = {}
    for kv in kvs:
        key, val = "", None
        for fnum, _, v in pw.iter_fields(bytes(kv)):
            if fnum == 1:
                key = bytes(v).decode("utf-8", "replace")
            elif fnum == 2:
                val = _pb_anyvalue(v)
        out[key] = val
    return out


def otlp_proto_to_batch(data: bytes, builder: SpanBatchBuilder | None = None) -> SpanBatch:
    """Decode an OTLP protobuf ExportTraceServiceRequest into a SpanBatch.
    An empty builder is falsy (`__len__` is 0), hence the `is None` test:
    the caller's builder carries the tenant's interner."""
    b = builder if builder is not None else SpanBatchBuilder()
    for span in spans_from_otlp_proto(data):
        b.append(**span)
    return b.build()


def spans_from_otlp_proto(data: bytes):
    """Decode OTLP protobuf into flat span dicts."""
    for fnum, _, rs in pw.iter_fields(data):
        if fnum != 1:  # ResourceSpans
            continue
        res_attrs: dict[str, Any] = {}
        scope_bufs = []
        for f2, _, v2 in pw.iter_fields(bytes(rs)):
            if f2 == 1:  # Resource{ repeated KeyValue attributes = 1 }
                res_attrs = _pb_attrs(
                    [v for f, _, v in pw.iter_fields(bytes(v2)) if f == 1])
            elif f2 == 2:  # ScopeSpans
                scope_bufs.append(v2)
        service = str(res_attrs.get("service.name", ""))
        for sbuf in scope_bufs:
            for f3, _, v3 in pw.iter_fields(bytes(sbuf)):
                if f3 != 2:  # Span
                    continue
                span = {
                    "trace_id": b"", "span_id": b"", "parent_span_id": b"",
                    "name": "", "service": service, "kind": 0,
                    "status_code": 0, "status_message": "",
                    "start_unix_nano": 0, "end_unix_nano": 0,
                    "attrs": {}, "res_attrs": res_attrs,
                }
                kvs = []
                for f4, _, v4 in pw.iter_fields(bytes(v3)):
                    if f4 == 1:
                        span["trace_id"] = bytes(v4)
                    elif f4 == 2:
                        span["span_id"] = bytes(v4)
                    elif f4 == 4:
                        span["parent_span_id"] = bytes(v4)
                    elif f4 == 5:
                        span["name"] = bytes(v4).decode("utf-8", "replace")
                    elif f4 == 6:
                        span["kind"] = v4
                    elif f4 == 7:
                        span["start_unix_nano"] = v4
                    elif f4 == 8:
                        span["end_unix_nano"] = v4
                    elif f4 == 9:
                        kvs.append(v4)
                    elif f4 == 11:  # Event{ time=1 fixed64, name=2 }
                        ev = {"time_unix_nano": 0, "name": ""}
                        for f5, _, v5 in pw.iter_fields(bytes(v4)):
                            if f5 == 1:
                                ev["time_unix_nano"] = v5
                            elif f5 == 2:
                                ev["name"] = bytes(v5).decode("utf-8",
                                                              "replace")
                        span.setdefault("events", []).append(ev)
                    elif f4 == 13:  # Link{ trace_id=1, span_id=2 }
                        ln = {"trace_id": b"", "span_id": b""}
                        for f5, _, v5 in pw.iter_fields(bytes(v4)):
                            if f5 == 1:
                                ln["trace_id"] = bytes(v5)
                            elif f5 == 2:
                                ln["span_id"] = bytes(v5)
                        span.setdefault("links", []).append(ln)
                    elif f4 == 15:  # Status{ message=2, code=3 }
                        for f5, _, v5 in pw.iter_fields(bytes(v4)):
                            if f5 == 2:
                                span["status_message"] = bytes(v5).decode("utf-8", "replace")
                            elif f5 == 3:
                                span["status_code"] = v5
                if kvs:
                    span["attrs"] = _pb_attrs(kvs)
                yield span


def synthetic_spans(n: int, *, seed: int, now_ns: int, n_services: int = 64,
                    n_ops: int = 64, kinds: tuple = (1, 2, 3),
                    statuses: tuple = (0, 1, 2),
                    end_spread_s: float = 10.0) -> list[dict]:
    """`n` k6-tracing-like span dicts drawn from `seed`: uniform services,
    operations, kinds and statuses (so n_services * n_ops * kinds *
    statuses label sets), lognormal durations around 24 ms in integer
    nanoseconds, and end times within `end_spread_s` before `now_ns`."""
    import numpy as np

    rng = np.random.default_rng(seed)
    svc = rng.integers(0, n_services, n)
    ops = rng.integers(0, n_ops, n)
    kind = np.asarray(kinds)[rng.integers(0, len(kinds), n)]
    status = np.asarray(statuses)[rng.integers(0, len(statuses), n)]
    dur = np.maximum(rng.lognormal(17.0, 1.5, n), 1.0).astype(np.int64)
    end = now_ns - (rng.random(n) * end_spread_s * 1e9).astype(np.int64)
    ids = rng.integers(0, 256, (n, 24), dtype=np.uint8)
    return [{"trace_id": ids[i, :16].tobytes(), "span_id": ids[i, 16:].tobytes(),
             "name": f"op-{ops[i]}", "service": f"service-{svc[i]}",
             "kind": int(kind[i]), "status_code": int(status[i]),
             "start_unix_nano": int(end[i] - dur[i]),
             "end_unix_nano": int(end[i])} for i in range(n)]


def _enc_anyvalue(v: Any) -> bytes:
    if isinstance(v, bool):
        return pw.enc_field_varint(2, 1 if v else 0)
    if isinstance(v, int):
        return pw.enc_field_varint(3, v & ((1 << 64) - 1))
    if isinstance(v, float):
        return pw.enc_field_double(4, v)
    if isinstance(v, bytes):
        return pw.enc_field_bytes(7, v)
    if isinstance(v, (list, tuple)):      # ArrayValue{ values = 1 }
        return pw.enc_field_msg(5, b"".join(
            pw.enc_field_msg(1, _enc_anyvalue(x)) for x in v))
    if isinstance(v, dict):               # KeyValueList{ values = 1 }
        return pw.enc_field_msg(6, b"".join(
            pw.enc_field_msg(1, pw.enc_field_str(1, k) +
                             pw.enc_field_msg(2, _enc_anyvalue(x)))
            for k, x in v.items()))
    return pw.enc_field_str(1, str(v))


def _enc_attrs(fnum: int, attrs: dict[str, Any] | None) -> bytes:
    if not attrs:
        return b""
    return b"".join(
        pw.enc_field_msg(fnum, pw.enc_field_str(1, k) +
                         pw.enc_field_msg(2, _enc_anyvalue(v)))
        for k, v in attrs.items())


def encode_spans_otlp(spans: Iterable[dict]) -> bytes:
    """Flat span dicts → ExportTraceServiceRequest bytes, the inverse of
    `spans_from_otlp_proto`. Spans are grouped into ResourceSpans by
    res_attrs content."""
    groups: dict[tuple, list[dict]] = {}
    for s in spans:
        ra = s.get("res_attrs") or {}
        if not ra and s.get("service"):
            ra = {"service.name": s["service"]}
        key = tuple(sorted((k, repr(v)) for k, v in ra.items()))
        groups.setdefault(key, []).append(s)
    out = []
    for _, group in groups.items():
        ra = group[0].get("res_attrs") or {}
        if not ra and group[0].get("service"):
            ra = {"service.name": group[0]["service"]}
        span_bufs = []
        for s in group:
            status = b""
            if s.get("status_message"):
                status += pw.enc_field_str(2, s["status_message"])
            if s.get("status_code"):
                status += pw.enc_field_varint(3, int(s["status_code"]))
            b = (pw.enc_field_bytes(1, s.get("trace_id", b"")) +
                 pw.enc_field_bytes(2, s.get("span_id", b"")))
            if s.get("parent_span_id"):
                b += pw.enc_field_bytes(4, s["parent_span_id"])
            b += pw.enc_field_str(5, s.get("name", ""))
            if s.get("kind"):
                b += pw.enc_field_varint(6, int(s["kind"]))
            # fields 7/8 are fixed64 in trace.proto
            b += (pw.enc_field_fixed64(7, int(s.get("start_unix_nano", 0))) +
                  pw.enc_field_fixed64(8, int(s.get("end_unix_nano", 0))) +
                  _enc_attrs(9, s.get("attrs")))
            for ev in s.get("events") or ():
                b += pw.enc_field_msg(11, pw.enc_field_fixed64(
                    1, int(ev.get("time_unix_nano", 0))) +
                    pw.enc_field_str(2, ev.get("name", "")))
            for ln in s.get("links") or ():
                b += pw.enc_field_msg(13, pw.enc_field_bytes(
                    1, ln.get("trace_id", b"")) +
                    pw.enc_field_bytes(2, ln.get("span_id", b"")))
            if status:
                b += pw.enc_field_msg(15, status)
            span_bufs.append(pw.enc_field_msg(2, b))
        rs = (pw.enc_field_msg(1, _enc_attrs(1, ra)) +
              pw.enc_field_msg(2, b"".join(span_bufs)))
        out.append(pw.enc_field_msg(1, rs))
    return b"".join(out)


def slice_otlp_payload(raw: bytes, recs, wire_indices) -> bytes:
    """Rebuild an OTLP payload containing only `wire_indices` spans, by
    concatenating raw wire slices (no re-encoding). `recs` is the native
    scan's SpanRec array over `raw` (span_off/span_len + res_off/res_len
    byte ranges). The per-instance splitter of the generator tee, the
    analog of the per-trace proto re-marshal in `sendToGenerators`."""
    out = []
    cur_res: tuple[int, int] | None = None
    span_bufs: list[bytes] = []

    def flush() -> None:
        if not span_bufs:
            return
        ro, rl = cur_res
        rs = b""
        if ro >= 0:
            rs += pw.enc_field_msg(1, raw[ro:ro + rl])
        rs += pw.enc_field_msg(2, b"".join(span_bufs))
        out.append(pw.enc_field_msg(1, rs))
        span_bufs.clear()

    for i in sorted(wire_indices):
        res = (int(recs["res_off"][i]), int(recs["res_len"][i]))
        if res != cur_res:
            flush()
            cur_res = res
        o, ln = int(recs["span_off"][i]), int(recs["span_len"][i])
        span_bufs.append(pw.enc_field_msg(2, raw[o:o + ln]))
    flush()
    return b"".join(out)
