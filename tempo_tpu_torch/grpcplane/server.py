"""gRPC server: generic method handlers bound to an App's modules.

Services registered (mirroring `pkg/tempopb/tempo.proto:9-44` and the OTLP
receiver factory `modules/distributor/receiver/shim.go:165-171`):

- ``opentelemetry.proto.collector.trace.v1.TraceService/Export`` — the real
  OTLP/gRPC protobuf, decoded by the native C++ scanner (fallback: the
  Python wire codec). Stock OTel SDKs exporting OTLP/gRPC land here.
- ``tempopb.Pusher/PushBytesV2`` — distributor→ingester push (varint-framed
  span groups, the ingest-bus record encoding).
- ``tempopb.MetricsGenerator/{PushSpans,QueryRange,GetMetrics}``.
- ``tempopb.Querier/{FindTraceByID,SearchRecent,SearchTags,SearchTagValues}``
  — the ingester-side query surface the querier fans out to.
- ``tempopb.StreamingQuerier/Search`` — server-streaming search with diff
  responses (`tempo.proto:30-38`, `combiner/search.go` diff combiner).
- ``tempopb.Frontend/Process`` — the worker-pull job stream: remote queriers
  dial the frontend and pull job batches (`v1/frontend.go:204-293`,
  `worker/frontend_processor.go:69-195`).

Tenant rides the ``x-scope-orgid`` metadata key, as in the reference's
dskit user injection.

Counterpart of `tempo_tpu/grpcplane/server.py`, host code copied with
its imports moved to the port. Every push route (OTLP `Export`,
Jaeger `PostSpans`, OpenCensus `Export`) ends in the App's
`Distributor`, whose generator tee reaches the span-metrics update
on the App's device (K1 on the card).
"""

from __future__ import annotations

import json
import threading
from concurrent import futures

import grpc

FAKE_TENANT = "single-tenant"

OTLP_EXPORT = "/opentelemetry.proto.collector.trace.v1.TraceService/Export"


def _ident(b):
    return b


def _tenant(context, multitenancy: bool) -> str:
    md = dict(context.invocation_metadata() or ())
    t = md.get("x-scope-orgid", "")
    if not t:
        if multitenancy:
            context.abort(grpc.StatusCode.UNAUTHENTICATED, "no org id")
        return FAKE_TENANT
    return t


def _jload(b: bytes) -> dict:
    return json.loads(b or b"{}")


def _jdump(obj) -> bytes:
    return json.dumps(obj).encode()


class _Services:
    """All unary/stream handlers, bound to one App."""

    def __init__(self, app) -> None:
        self.app = app

    # -- OTLP TraceService --------------------------------------------------

    def otlp_export(self, request: bytes, context) -> bytes:
        tenant = _tenant(context, self.app.cfg.multitenancy_enabled)
        from tempo_tpu_torch.distributor.distributor import (MalformedPayload,
                                                       RateLimited)

        try:
            self.app.distributor.push_otlp(tenant, request)
        except MalformedPayload as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                          f"malformed otlp payload: {e}")
        except RateLimited as e:
            # the reference translates rate limits to ResourceExhausted with
            # RetryInfo so SDK exporters back off (shim.go RetryableError)
            context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(e))
        return b""   # empty ExportTraceServiceResponse = full success

    # -- jaeger api_v2 collector (gRPC reporter protocol) -------------------

    def jaeger_post_spans(self, request: bytes, context) -> bytes:
        """`jaeger.api_v2.CollectorService/PostSpans` — the gRPC half of
        the jaeger receiver (thrift-over-HTTP is in app/api.py); ref
        `modules/distributor/receiver/shim.go:165-171`."""
        tenant = _tenant(context, self.app.cfg.multitenancy_enabled)
        from tempo_tpu_torch.distributor.distributor import RateLimited
        from tempo_tpu_torch.model.jaeger import spans_from_jaeger_proto

        try:
            spans = spans_from_jaeger_proto(request)
        except ValueError as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        try:
            self.app.distributor.push_spans(tenant, spans)
        except RateLimited as e:
            context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(e))
        return b""   # empty PostSpansResponse

    # -- opencensus agent trace service (legacy reporter protocol) ----------

    def opencensus_export(self, request_iterator, context):
        """`opencensus.proto.agent.trace.v1.TraceService/Export` (bidi
        stream): Node/Resource arrive on the first message and persist
        for the stream; spans on every message. Last of the reference
        shim's receiver protocols (`shim.go:165-171`)."""
        tenant = _tenant(context, self.app.cfg.multitenancy_enabled)
        from tempo_tpu_torch.distributor.distributor import RateLimited
        from tempo_tpu_torch.model.opencensus import spans_from_opencensus

        service = ""
        res_attrs: dict = {}
        for request in request_iterator:
            try:
                spans, service, res_attrs = spans_from_opencensus(
                    request, service, res_attrs)
            except ValueError as e:
                context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
            if spans:
                try:
                    self.app.distributor.push_spans(tenant, spans)
                except RateLimited as e:
                    context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED,
                                  str(e))
            yield b""   # empty ExportTraceServiceResponse per message

    # -- Pusher (ingester) --------------------------------------------------

    def push_bytes_v2(self, request: bytes, context) -> bytes:
        tenant = _tenant(context, self.app.cfg.multitenancy_enabled)
        from tempo_tpu_torch.model import tempopb
        from tempo_tpu_torch.rpc import decode_push_body

        errs = self.app.ingester.push(tenant, decode_push_body(request))
        return tempopb.enc_push_response(errs or ())

    def push_otlp_traces(self, request: bytes, context) -> bytes:
        """Raw OTLP wire-slice push from the columnar distributor path;
        sparse per-trace rejection map back."""
        tenant = _tenant(context, self.app.cfg.multitenancy_enabled)
        try:
            errs = self.app.ingester.push_otlp(tenant, request)
        except (ValueError, KeyError, TypeError) as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                          f"malformed otlp payload: {e}")
        return _jdump({"errors": errs})

    # -- MetricsGenerator ---------------------------------------------------

    def generator_push_spans(self, request: bytes, context) -> bytes:
        tenant = _tenant(context, self.app.cfg.multitenancy_enabled)
        from tempo_tpu_torch.rpc import decode_push_body

        spans = [s for _tid, group in decode_push_body(request)
                 for s in group]
        self.app.generator.push_spans(tenant, spans)
        return b"{}"

    def generator_push_otlp(self, request: bytes, context) -> bytes:
        """Raw OTLP ResourceSpans payload — the wire shape of the
        reference's PushSpansRequest — staged by the vectorized scan."""
        tenant = _tenant(context, self.app.cfg.multitenancy_enabled)
        try:
            n = self.app.generator.push_otlp(tenant, request)
        except (ValueError, KeyError, TypeError) as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                          f"malformed otlp payload: {e}")
        return _jdump({"spans": n})

    def generator_query_range(self, request: bytes, context) -> bytes:
        """JSON request (tiny), protobuf TimeSeries response (the heavy
        side; `tempo.proto` QueryRangeResponse)."""
        tenant = _tenant(context, self.app.cfg.multitenancy_enabled)
        from tempo_tpu_torch.model import tempopb
        from tempo_tpu_torch.traceql.engine_metrics import QueryRangeRequest

        d = _jload(request)
        req = QueryRangeRequest(query=d["query"], start_ns=d["start_ns"],
                                end_ns=d["end_ns"], step_ns=d["step_ns"])
        series = self.app.generator.query_range(
            tenant, req, clip_start_ns=d.get("clip_start_ns"))
        return tempopb.enc_query_range_response(series)

    def generator_get_metrics(self, request: bytes, context) -> bytes:
        tenant = _tenant(context, self.app.cfg.multitenancy_enabled)
        d = _jload(request)
        res = self.app.generator.get_metrics(
            tenant, d.get("query", "{ }"), d.get("group_by", []))
        return _jdump({"summaries": [s.to_json() for s in res.results()],
                       "estimated": res.estimated})

    # -- Querier (ingester-side query surface) ------------------------------

    def find_trace_by_id(self, request: bytes, context) -> bytes:
        """Protobuf both ways: TraceByIDRequest in, OTLP trace bytes out
        (`tempopb.Trace` is OTLP-shaped ResourceSpans)."""
        tenant = _tenant(context, self.app.cfg.multitenancy_enabled)
        from tempo_tpu_torch.model import tempopb

        tid = tempopb.dec_trace_by_id_request(request)
        spans = self.app.ingester.find_trace_by_id(tenant, tid)
        return tempopb.enc_trace_by_id_response(spans)

    def search_recent(self, request: bytes, context) -> bytes:
        tenant = _tenant(context, self.app.cfg.multitenancy_enabled)
        from tempo_tpu_torch.model import tempopb
        from tempo_tpu_torch.obs import querystats

        d = tempopb.dec_search_request(request)
        # per-RPC stats scope, serialized into the response's metrics
        # submessage — the gRPC-trailer analog the remote querier merges
        # into its own request scope
        with querystats.scope() as st:
            res = self.app.ingester.search(
                tenant, d.get("q", "{ }"), int(d.get("limit", 20)),
                float(d.get("start", 0)), float(d.get("end", 0)))
        st.floor_inspected_traces(len(res))
        return tempopb.enc_search_response(res, inspected=len(res), stats=st)

    def search_tags(self, request: bytes, context) -> bytes:
        tenant = _tenant(context, self.app.cfg.multitenancy_enabled)
        return _jdump({"scopes": self.app.ingester.tag_names(tenant)})

    def search_tag_values(self, request: bytes, context) -> bytes:
        tenant = _tenant(context, self.app.cfg.multitenancy_enabled)
        d = _jload(request)
        return _jdump({"tagValues": self.app.ingester.tag_values(
            tenant, d["name"], int(d.get("limit", 1000)))})

    # -- StreamingQuerier ---------------------------------------------------

    def _stream_partials(self, context, run_fn, enc_diff, enc_final):
        """Shared server-streaming scaffold (`combiner/*.go` diff shape):
        `run_fn(emit)` executes the frontend call on a worker thread,
        calling `emit(batch)` for each diff the endpoint's filter kept;
        batches are encoded + yielded as they arrive, then the final
        result ends the stream (or the error aborts it)."""
        import queue as _q

        diffs: _q.Queue = _q.Queue()
        out: dict = {}

        def run() -> None:
            try:
                out["res"] = run_fn(diffs.put)
            except Exception as e:  # surfaced as the stream's final state
                out["err"] = e
            diffs.put(None)

        t = threading.Thread(target=run, daemon=True)
        t.start()
        while True:
            batch = diffs.get()
            if batch is None:
                break
            yield enc_diff(batch)
        t.join()
        if "err" in out:
            from tempo_tpu_torch.sched import QueryBackpressure
            if isinstance(out["err"], QueryBackpressure):
                # shed load is RETRYABLE, not a server bug: mirror the
                # HTTP 503 + Retry-After semantics (shim RetryableError)
                context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED,
                              str(out["err"]))
            context.abort(grpc.StatusCode.INTERNAL, str(out["err"]))
        yield enc_final(out.get("res"))

    def streaming_search(self, request: bytes, context):
        """Server-streaming search: partial diff responses while sub-queries
        complete, then the final message (`combiner/search.go` diffs)."""
        tenant = _tenant(context, self.app.cfg.multitenancy_enabled)
        d = _jload(request)
        from tempo_tpu_torch.model import tempopb
        from tempo_tpu_torch.obs import querystats

        sent: set[str] = set()
        stats_box: dict = {}

        def run_fn(emit):
            def on_partial(results) -> None:
                fresh = [md for md in results if md.trace_id not in sent]
                if fresh:
                    sent.update(md.trace_id for md in fresh)
                    emit(fresh)

            # scope opened on the stream's worker thread; the FINAL
            # message carries the merged stats (SearchMetrics trailer)
            with querystats.scope() as st:
                stats_box["st"] = st
                return self.app.frontend.search(
                    tenant, d.get("q", "{ }"), limit=int(d.get("limit", 20)),
                    start_s=float(d["start"]) if "start" in d else None,
                    end_s=float(d["end"]) if "end" in d else None,
                    on_partial=on_partial)

        def enc_final(res) -> bytes:
            st = stats_box.get("st")
            if st is not None:
                # legacy clients read only the scalar `inspected` (field 1
                # == inspected_traces): keep its old len(res) floor even
                # for fully cache-served queries
                st.floor_inspected_traces(len(res or []))
            return tempopb.enc_search_response(
                res or [], inspected=len(res or []), final=True, stats=st)

        yield from self._stream_partials(
            context, run_fn,
            lambda batch: tempopb.enc_search_response(batch, final=False),
            enc_final)

    def streaming_metrics_query_range(self, request: bytes, context):
        """Server-streaming TraceQL metrics: series-DIFF messages as
        sub-results (generator recent window, per-block backend jobs)
        fold in, then the complete final series set
        (`tempo.proto` StreamingQuerier/MetricsQueryRange; diff shape
        mirrors the search stream). Each message carries only series whose
        samples CHANGED since the last message — a high-cardinality
        `by()` no longer buffers the whole set in one response."""
        tenant = _tenant(context, self.app.cfg.multitenancy_enabled)
        d = _jload(request)
        import numpy as np

        from tempo_tpu_torch.model import tempopb

        last: dict = {}

        def run_fn(emit):
            def on_partial(series) -> None:
                fresh = []
                for s in series:
                    sig = np.asarray(s.samples).tobytes()
                    if last.get(s.labels) != sig:
                        last[s.labels] = sig
                        fresh.append(s)
                if fresh:
                    emit(fresh)

            return self.app.frontend.query_range(
                tenant, d["query"], start_s=float(d["start"]),
                end_s=float(d["end"]), step_s=float(d.get("step", 60.0)),
                on_partial=on_partial)

        yield from self._stream_partials(
            context, run_fn, tempopb.enc_query_range_response,
            lambda res: tempopb.enc_query_range_response(res or []))

    def streaming_search_tags(self, request: bytes, context):
        """Server-streaming tag-name autocomplete: scope-diff messages as
        the ingester pass and each contributing backend block merge in,
        then the final scopes map (`StreamingQuerier/SearchTags`)."""
        tenant = _tenant(context, self.app.cfg.multitenancy_enabled)
        last: dict = {}

        def run_fn(emit):
            def on_partial(scopes: dict) -> None:
                fresh = {k: v for k, v in scopes.items()
                         if last.get(k) != v}
                if fresh:
                    last.update(fresh)
                    emit(fresh)

            return self.app.frontend.tag_names(tenant,
                                               on_partial=on_partial)

        yield from self._stream_partials(
            context, run_fn,
            lambda batch: _jdump({"scopes": batch, "final": False}),
            lambda res: _jdump({"scopes": res or {}, "final": True}))

    def streaming_search_tag_values(self, request: bytes, context):
        """Server-streaming tag-value autocomplete: value diffs as the
        ingester pass merges in, then the final list
        (`StreamingQuerier/SearchTagValues`)."""
        tenant = _tenant(context, self.app.cfg.multitenancy_enabled)
        d = _jload(request)
        sent: set = set()

        def run_fn(emit):
            def on_partial(values: list) -> None:
                fresh = [v for v in values
                         if (v.get("type"), v.get("value")) not in sent]
                if fresh:
                    sent.update((v.get("type"), v.get("value"))
                                for v in fresh)
                    emit(fresh)

            return self.app.frontend.tag_values(
                tenant, d["name"], int(d.get("limit", 1000)),
                on_partial=on_partial)

        yield from self._stream_partials(
            context, run_fn,
            lambda batch: _jdump({"tagValues": batch, "final": False}),
            lambda res: _jdump({"tagValues": res or [], "final": True}))

    # -- Frontend worker-pull dispatch --------------------------------------

    def frontend_process(self, request_iterator, context):
        """One connected querier worker: stream job batches out, fold result
        messages back into the pending jobs. The pull direction matches the
        reference (querier dials frontend), so queriers scale out with zero
        frontend-side discovery."""
        fe = self.app.frontend
        pending: dict[int, object] = {}
        plock = threading.Condition()
        next_id = [0]
        done = threading.Event()

        def read_results() -> None:
            try:
                for msg in request_iterator:
                    m = _jload(msg)
                    if m.get("type") == "hello":
                        continue
                    with plock:
                        wj = pending.pop(int(m["job_id"]), None)
                        plock.notify_all()
                    if wj is None:
                        continue
                    try:
                        if m["type"] == "result":
                            wj.result = fe.decode_job_result(
                                wj.spec, m.get("result"))
                            if m.get("stats"):
                                # the worker's serialized per-job stats —
                                # folded into the parent request when the
                                # issuer folds this job's result
                                from tempo_tpu_torch.obs.querystats import \
                                    QueryStats
                                wj.stats.merge(
                                    QueryStats.from_json(m["stats"]))
                        else:
                            wj.error = RuntimeError(
                                m.get("error", "worker error"))
                    except Exception as e:
                        # a malformed result must still complete the job —
                        # the issuer has no other wake-up path once claimed
                        wj.error = e
                    finally:
                        wj.event.set()
            except Exception:
                pass
            finally:
                done.set()
                with plock:
                    plock.notify_all()

        reader = threading.Thread(target=read_results, daemon=True)
        reader.start()
        fe.remote_worker_attached()
        try:
            while context.is_active() and not done.is_set():
                batch = fe.queue.dequeue_batch(fe.cfg.max_batch_size,
                                               timeout_s=0.2)
                jobs = []
                local_jobs = []
                with plock:
                    for wj in batch:
                        if wj.spec is None:     # not remotable: runs local,
                            local_jobs.append(wj)   # AFTER the yield and
                            continue            # outside plock — neither
                        if not wj.try_claim():  # the worker nor the result
                            continue            # reader should wait on it
                        jid = next_id[0]
                        next_id[0] += 1
                        pending[jid] = wj
                        jobs.append({"job_id": jid, "spec": wj.spec})
                if jobs:
                    yield _jdump({"type": "jobs", "jobs": jobs})
                for wj in local_jobs:
                    wj.run()
                if jobs:
                    # one batch in flight per worker stream: wait for this
                    # batch's results before pulling more so concurrent
                    # workers share the queue (the reference's
                    # request-response Process loop has the same effect)
                    with plock:
                        while pending and not done.is_set():
                            plock.wait(timeout=0.2)
                            if not context.is_active():
                                break
        finally:
            fe.remote_worker_detached()
            # worker went away: fail outstanding jobs fast so the query
            # retries/errors instead of hanging (frontend cancels on
            # disconnect in the reference too)
            with plock:
                for wj in pending.values():
                    wj.error = RuntimeError("querier worker disconnected")
                    wj.event.set()
                pending.clear()


def build_grpc_server(app, address: str = "127.0.0.1:0",
                      max_workers: int = 16) -> tuple[grpc.Server, int]:
    """Create + start a grpc server for the App's enabled modules.

    Returns (server, bound_port). Only services whose backing module exists
    on this target are registered — a `-target=ingester` process serves
    Pusher + Querier, a frontend serves StreamingQuerier + Frontend, etc.
    Every handler is timed into the gRPC request-duration histogram
    (method + status labels), the RPC-plane twin of the HTTP histogram.
    """
    import time as _time

    svc = _Services(app)
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers))

    hist = getattr(app, "grpc_request_duration", None)

    def unary(fn, method: str):
        def handler(request, context):
            t0 = _time.perf_counter()
            status = "OK"
            try:
                return fn(request, context)
            except BaseException:          # context.abort raises
                status = "error"
                raise
            finally:
                if hist is not None:
                    hist.observe(_time.perf_counter() - t0,
                                 (method, status))
        return grpc.unary_unary_rpc_method_handler(
            handler, request_deserializer=_ident,
            response_serializer=_ident)

    def _timed_stream(fn, method: str):
        def handler(request, context):
            t0 = _time.perf_counter()
            status = "OK"
            try:
                yield from fn(request, context)
            except BaseException:
                status = "error"
                raise
            finally:
                if hist is not None:
                    hist.observe(_time.perf_counter() - t0,
                                 (method, status))
        return handler

    def sstream(fn, method: str):
        return grpc.unary_stream_rpc_method_handler(
            _timed_stream(fn, method), request_deserializer=_ident,
            response_serializer=_ident)

    def bidi(fn, method: str):
        return grpc.stream_stream_rpc_method_handler(
            _timed_stream(fn, method), request_deserializer=_ident,
            response_serializer=_ident)

    if app.distributor is not None:
        server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(
            "opentelemetry.proto.collector.trace.v1.TraceService",
            {"Export": unary(svc.otlp_export, "TraceService/Export")}),))
        server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(
            "jaeger.api_v2.CollectorService",
            {"PostSpans": unary(svc.jaeger_post_spans,
                                "CollectorService/PostSpans")}),))
        server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(
            "opencensus.proto.agent.trace.v1.TraceService",
            {"Export": bidi(svc.opencensus_export,
                            "OpenCensus.TraceService/Export")}),))
    if app.ingester is not None:
        server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(
            "tempopb.Pusher",
            {"PushBytesV2": unary(svc.push_bytes_v2,
                                  "Pusher/PushBytesV2"),
             "PushOTLP": unary(svc.push_otlp_traces,
                               "Pusher/PushOTLP")}),))
        server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(
            "tempopb.Querier",
            {"FindTraceByID": unary(svc.find_trace_by_id,
                                    "Querier/FindTraceByID"),
             "SearchRecent": unary(svc.search_recent,
                                   "Querier/SearchRecent"),
             "SearchTags": unary(svc.search_tags, "Querier/SearchTags"),
             "SearchTagValues": unary(svc.search_tag_values,
                                      "Querier/SearchTagValues")}),))
    if app.generator is not None:
        server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(
            "tempopb.MetricsGenerator",
            {"PushSpans": unary(svc.generator_push_spans,
                                "MetricsGenerator/PushSpans"),
             "PushOTLP": unary(svc.generator_push_otlp,
                               "MetricsGenerator/PushOTLP"),
             "QueryRange": unary(svc.generator_query_range,
                                 "MetricsGenerator/QueryRange"),
             "GetMetrics": unary(svc.generator_get_metrics,
                                 "MetricsGenerator/GetMetrics")}),))
    if app.frontend is not None:
        server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(
            "tempopb.StreamingQuerier",
            {"Search": sstream(svc.streaming_search,
                               "StreamingQuerier/Search"),
             "MetricsQueryRange": sstream(
                 svc.streaming_metrics_query_range,
                 "StreamingQuerier/MetricsQueryRange"),
             "SearchTags": sstream(svc.streaming_search_tags,
                                   "StreamingQuerier/SearchTags"),
             "SearchTagValues": sstream(
                 svc.streaming_search_tag_values,
                 "StreamingQuerier/SearchTagValues")}),))
        server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(
            "tempopb.Frontend",
            {"Process": bidi(svc.frontend_process, "Frontend/Process")}),))
    port = server.add_insecure_port(address)
    server.start()
    return server, port
