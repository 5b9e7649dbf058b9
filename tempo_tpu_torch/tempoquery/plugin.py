"""tempo-query: the Jaeger storage gRPC plugin analog.

The reference's `cmd/tempo-query` bridges Jaeger Query (the UI backend)
to Tempo's HTTP API by implementing the `jaeger.storage.v1` SpanReader
gRPC plugin (`cmd/tempo-query/main.go`, tempo/plugin.go). Same bridge
here: a gRPC server exposing

  jaeger.storage.v1.SpanReaderPlugin/ GetTrace | FindTraces |
      GetServices | GetOperations
  jaeger.storage.v1.DependenciesReaderPlugin/ GetDependencies

backed by `tempo_tpu_torch.client.Client` against any tempo_tpu_torch HTTP endpoint.
Requests/responses are the public jaeger proto shapes (storage_v1 +
api_v2 model.proto), hand-rolled on the proto_wire codec like the rest
of the framework's wire layer.

Counterpart of `tempo_tpu/tempoquery/plugin.py`, host code copied with its imports
moved to the port; it runs no device code of its own.
"""

from __future__ import annotations

from concurrent import futures

import grpc

from tempo_tpu_torch.client import Client
from tempo_tpu_torch.model import proto_wire as pw

_SVC = "jaeger.storage.v1.SpanReaderPlugin"
_DEP = "jaeger.storage.v1.DependenciesReaderPlugin"


def _ident(b):
    return b


# -- jaeger api_v2 model encoding (model.proto) -----------------------------

def _ts(ns: int) -> bytes:
    """google.protobuf.Timestamp{seconds=1, nanos=2}."""
    return (pw.enc_field_varint(1, ns // 1_000_000_000) +
            pw.enc_field_varint(2, ns % 1_000_000_000))


def _dur(ns: int) -> bytes:
    return (pw.enc_field_varint(1, ns // 1_000_000_000) +
            pw.enc_field_varint(2, ns % 1_000_000_000))


def _kv_str(key: str, v) -> bytes:
    """jaeger KeyValue{key=1, vType=2, vStr=3|vBool=4|vInt64=5|vFloat64=6}."""
    out = pw.enc_field_str(1, key)
    if isinstance(v, bool):
        out += pw.enc_field_varint(2, 1) + pw.enc_field_varint(4, 1 if v else 0)
    elif isinstance(v, int):
        out += pw.enc_field_varint(2, 2) + pw.enc_field_varint(
            5, v & ((1 << 64) - 1))
    elif isinstance(v, float):
        out += pw.enc_field_varint(2, 3) + pw.enc_field_double(6, v)
    else:
        out += pw.enc_field_str(3, str(v))
    return out


def _jaeger_span(s: dict, tid: bytes) -> bytes:
    """One api_v2 model.Span from a tempo span dict (the inverse of the
    receiver's translation)."""
    start = int(s.get("start_unix_nano", 0))
    dur = max(int(s.get("end_unix_nano", 0)) - start, 0)
    out = (pw.enc_field_bytes(1, tid.rjust(16, b"\0")) +
           pw.enc_field_bytes(2, _hexb(s.get("span_id", ""), 8)) +
           pw.enc_field_str(3, s.get("name", "")) +
           pw.enc_field_msg(6, _ts(start)) +
           pw.enc_field_msg(7, _dur(dur)))
    kind = int(s.get("kind", 0))
    kind_str = {1: "internal", 2: "server", 3: "client",
                4: "producer", 5: "consumer"}.get(kind)
    if kind_str:
        out += pw.enc_field_msg(8, _kv_str("span.kind", kind_str))
    if int(s.get("status_code", 0)) == 2:
        out += pw.enc_field_msg(8, _kv_str("error", True))
    for k, v in (s.get("attrs") or {}).items():
        out += pw.enc_field_msg(8, _kv_str(k, v))
    psid = _hexb(s.get("parent_span_id", ""), 8)
    if psid.strip(b"\0"):
        # references[4]: SpanRef{trace_id=1, span_id=2, ref_type=3}
        out += pw.enc_field_msg(4, pw.enc_field_bytes(1, tid.rjust(16, b"\0"))
                                + pw.enc_field_bytes(2, psid)
                                + pw.enc_field_varint(3, 0))
    # process[10]: Process{service_name=1, tags=2}
    proc = pw.enc_field_str(1, str(s.get("service", "")))
    for k, v in (s.get("res_attrs") or {}).items():
        if k != "service.name":
            proc += pw.enc_field_msg(2, _kv_str(k, v))
    out += pw.enc_field_msg(10, proc)
    return out


def _hexb(v, width: int) -> bytes:
    if isinstance(v, bytes):
        return v.ljust(width, b"\0")[:width]
    try:
        return bytes.fromhex(v).ljust(width, b"\0")[:width]
    except (ValueError, TypeError):
        return b"\0" * width


def _chunk(spans: list[bytes]) -> bytes:
    """SpansResponseChunk{repeated Span spans = 1}."""
    return b"".join(pw.enc_field_msg(1, sp) for sp in spans)


class _Plugin:
    def __init__(self, client: Client):
        self.c = client

    # GetTrace(GetTraceRequest{trace_id=1 bytes}) -> stream chunks
    def get_trace(self, request: bytes, context):
        import urllib.error

        d = pw.decode_fields(request)
        tid = bytes(d.get(1, [b""])[0])
        try:
            trace = self.c.trace_by_id(tid.hex())
        except urllib.error.HTTPError as e:
            if e.code == 404:
                context.abort(grpc.StatusCode.NOT_FOUND, "trace not found")
            raise
        spans = trace.get("spans") or []
        if not spans:
            context.abort(grpc.StatusCode.NOT_FOUND, "trace not found")
        yield _chunk([_jaeger_span(sp, tid) for sp in spans])

    # GetServices() -> {services: repeated string 1}
    def get_services(self, request: bytes, context) -> bytes:
        vals = self.c.search_tag_values("resource.service.name")
        names = sorted({v.get("value", v) if isinstance(v, dict) else v
                        for v in vals.get("tagValues", [])})
        return b"".join(pw.enc_field_str(1, str(n)) for n in names)

    # GetOperations(req{service=1}) -> {operations 2: Operation{name=1}}
    def get_operations(self, request: bytes, context) -> bytes:
        d = pw.decode_fields(request)
        svc = bytes(d[1][0]).decode("utf-8", "replace") if 1 in d else ""
        if svc:
            # per-service operations: names of recent spans of that service
            # (the tag-values endpoint has no service filter)
            res = self.c.search(
                "{ resource.service.name = " + _tql_str(svc) + " }",
                limit=200)
            names = sorted({sp.get("name", "")
                            for md in res.get("traces", [])
                            for ss in md.get("spanSets", [])
                            for sp in ss.get("spans", [])} - {""})
        else:
            vals = self.c.search_tag_values("name")
            names = sorted({v.get("value", v) if isinstance(v, dict) else v
                            for v in vals.get("tagValues", [])})
        out = b""
        for n in names:
            out += pw.enc_field_str(1, str(n))              # operationNames
            out += pw.enc_field_msg(2, pw.enc_field_str(1, str(n)))
        return out

    # FindTraces(FindTracesRequest{query=1 TraceQueryParameters}) -> stream
    def find_traces(self, request: bytes, context):
        d = pw.decode_fields(request)
        q = pw.decode_fields(bytes(d[1][0])) if 1 in d else {}
        # TraceQueryParameters: service_name=1, operation_name=2, tags=3,
        # start_time_min=4, start_time_max=5, duration_min=6, duration_max=7,
        # num_traces=8
        conds = []
        svc = q.get(1)
        if svc and bytes(svc[0]):
            conds.append("resource.service.name = "
                         + _tql_str(bytes(svc[0]).decode("utf-8", "replace")))
        op = q.get(2)
        if op and bytes(op[0]):
            conds.append(
                "name = " + _tql_str(bytes(op[0]).decode("utf-8", "replace")))
        import re as _re

        for tag in q.get(3, ()):       # map<string,string> entries
            td = pw.decode_fields(bytes(tag))
            k = bytes(td.get(1, [b""])[0]).decode("utf-8", "replace")
            v = bytes(td.get(2, [b""])[0]).decode("utf-8", "replace")
            # the KEY is interpolated bare: restrict it to attribute-name
            # characters so UI input cannot alter the query structure.
            # Unsupported keys REJECT the request — silently dropping a
            # filter would return unfiltered results as if they matched.
            if not k:
                continue
            if not _re.fullmatch(r"[\w.\-/:]+", k):
                context.abort(
                    grpc.StatusCode.INVALID_ARGUMENT,
                    f"unsupported characters in tag key {k!r}")
            conds.append(f"span.{k} = " + _tql_str(v))
        if 6 in q:                     # duration_min (Duration msg)
            conds.append(f"duration >= {_dur_ns(bytes(q[6][0]))}ns")
        if 7 in q:
            conds.append(f"duration <= {_dur_ns(bytes(q[7][0]))}ns")
        traceql = "{ " + " && ".join(conds) + " }" if conds else "{ }"
        limit = q.get(8, [20])[0] or 20
        start_s = end_s = None
        if 4 in q:
            t = pw.decode_fields(bytes(q[4][0]))
            start_s = t.get(1, [0])[0] + t.get(2, [0])[0] / 1e9
        if 5 in q:
            t = pw.decode_fields(bytes(q[5][0]))
            end_s = t.get(1, [0])[0] + t.get(2, [0])[0] / 1e9
        import urllib.error

        res = self.c.search(traceql, limit=int(limit),
                            start_s=start_s, end_s=end_s)
        for md in res.get("traces", []):
            tid_hex = md.get("traceID", "")
            try:
                trace = self.c.trace_by_id(tid_hex)
            except urllib.error.HTTPError:
                continue        # vanished between search and fetch
            spans = trace.get("spans") or []
            if spans:
                tid = bytes.fromhex(tid_hex)
                yield _chunk([_jaeger_span(sp, tid)
                              for sp in spans])

    # DependenciesReader: service graph edges are a metrics question here;
    # return the empty set like the reference plugin does
    def get_dependencies(self, request: bytes, context) -> bytes:
        return b""


def _tql_str(s: str) -> str:
    """TraceQL string literal with quote/backslash escaping — Jaeger UI
    input must not be able to break out of the query."""
    return '"' + s.replace("\\", "\\\\").replace('"', '\\"') + '"'


def _dur_ns(buf: bytes) -> int:
    """google.protobuf.Duration → nanoseconds."""
    d = pw.decode_fields(buf)
    return d.get(1, [0])[0] * 1_000_000_000 + d.get(2, [0])[0]


def build_tempo_query_server(tempo_url: str, tenant: str = "",
                             address: str = "127.0.0.1:0",
                             max_workers: int = 8
                             ) -> tuple[grpc.Server, int]:
    """Start the plugin gRPC server; returns (server, bound_port)."""
    plugin = _Plugin(Client(tempo_url, tenant=tenant))
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers))

    def unary(fn):
        return grpc.unary_unary_rpc_method_handler(
            fn, request_deserializer=_ident, response_serializer=_ident)

    def sstream(fn):
        return grpc.unary_stream_rpc_method_handler(
            fn, request_deserializer=_ident, response_serializer=_ident)

    server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(
        _SVC, {
            "GetTrace": sstream(plugin.get_trace),
            "FindTraces": sstream(plugin.find_traces),
            "GetServices": unary(plugin.get_services),
            "GetOperations": unary(plugin.get_operations),
        }),))
    server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(
        _DEP, {"GetDependencies": unary(plugin.get_dependencies)}),))
    port = server.add_insecure_port(address)
    server.start()
    return server, port
