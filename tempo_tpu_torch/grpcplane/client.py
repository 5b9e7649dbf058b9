"""gRPC clients: the remote halves of the service seams.

`GrpcIngesterClient` / `GrpcGeneratorClient` satisfy the same client
protocols as the in-process service objects and the HTTP clients in
`tempo_tpu_torch.rpc`, so a peer address with a ``grpc://`` scheme swaps the
transport without touching the services. `FrontendWorker` is the querier's
side of the worker-pull plane (`modules/querier/worker/frontend_processor.go:69-195`):
it dials the frontend, pulls job batches off the bidi stream, executes them
on the local querier, and streams results back.

Counterpart of `tempo_tpu/grpcplane/client.py`, host code copied with its imports
moved to the port; it runs no device code of its own.
"""

from __future__ import annotations

import json
import queue as _q
import threading
from typing import Sequence

import grpc

from tempo_tpu_torch.ingest.encoding import encode_push


def _jdump(obj) -> bytes:
    return json.dumps(obj).encode()


def _jload(b: bytes) -> dict:
    return json.loads(b or b"{}")


def _one_record(traces) -> bytes:
    return b"".join(encode_push(traces, max_record_bytes=1 << 62))


class _BaseGrpcClient:
    def __init__(self, target: str, timeout_s: float = 30.0) -> None:
        if target.startswith("grpc://"):
            target = target[len("grpc://"):]
        self.channel = grpc.insecure_channel(target)
        self.timeout = timeout_s

    def _call(self, method: str, body: bytes, tenant: str) -> bytes:
        fn = self.channel.unary_unary(method)
        return fn(body, timeout=self.timeout,
                  metadata=(("x-scope-orgid", tenant),))

    def close(self) -> None:
        self.channel.close()


class GrpcIngesterClient(_BaseGrpcClient):
    """IngesterClient + IngesterQueryClient over gRPC (`Pusher.PushBytesV2`
    + the `tempopb.Querier` service)."""

    def push(self, tenant: str,
             traces: Sequence[tuple[bytes, list[dict]]]) -> list[str | None]:
        from tempo_tpu_torch.model import tempopb

        body = self._call("/tempopb.Pusher/PushBytesV2",
                          _one_record(traces), tenant)
        return tempopb.dec_push_response(body, len(traces))

    def push_otlp(self, tenant: str, payload: bytes) -> dict[str, str]:
        import json as _json

        body = self._call("/tempopb.Pusher/PushOTLP", payload, tenant)
        return _json.loads(body or b"{}").get("errors", {})

    def find_trace_by_id(self, tenant: str, trace_id: bytes):
        from tempo_tpu_torch.model import tempopb

        body = self._call("/tempopb.Querier/FindTraceByID",
                          tempopb.enc_trace_by_id_request(trace_id), tenant)
        return tempopb.dec_trace_by_id_response(body)

    def search(self, tenant: str, query: str, limit: int = 20,
               start_s: float = 0, end_s: float = 0):
        from tempo_tpu_torch.model import tempopb
        from tempo_tpu_torch.obs import querystats

        body = self._call(
            "/tempopb.Querier/SearchRecent",
            tempopb.enc_search_request(query, limit, start_s, end_s), tenant)
        mds, _final, _inspected, stats = tempopb.dec_search_response(body)
        # the remote ingester's stats trailer folds into this process's
        # ambient request scope (the gRPC-trailer merge direction)
        querystats.absorb(stats)
        return mds

    def tag_names(self, tenant: str) -> dict[str, list[str]]:
        res = _jload(self._call("/tempopb.Querier/SearchTags", b"{}", tenant))
        return res.get("scopes", {})

    def tag_values(self, tenant: str, name: str, limit: int = 1000):
        res = _jload(self._call("/tempopb.Querier/SearchTagValues",
                                _jdump({"name": name, "limit": limit}),
                                tenant))
        return res.get("tagValues", [])


class GrpcGeneratorClient(_BaseGrpcClient):
    """GeneratorClient over gRPC (`MetricsGenerator` service)."""

    def push_spans(self, tenant: str, spans: Sequence[dict]) -> None:
        groups: dict[bytes, list[dict]] = {}
        for s in spans:
            groups.setdefault(s.get("trace_id", b""), []).append(s)
        self._call("/tempopb.MetricsGenerator/PushSpans",
                   _one_record(list(groups.items())), tenant)

    def push_otlp(self, tenant: str, data: bytes) -> int:
        res = _jload(self._call("/tempopb.MetricsGenerator/PushOTLP",
                                data, tenant))
        return int(res.get("spans", 0))

    def query_range(self, tenant: str, req, clip_start_ns: int | None = None):
        from tempo_tpu_torch.model import tempopb

        body = self._call(
            "/tempopb.MetricsGenerator/QueryRange",
            _jdump({"query": req.query, "start_ns": req.start_ns,
                    "end_ns": req.end_ns, "step_ns": req.step_ns,
                    "clip_start_ns": clip_start_ns}), tenant)
        return tempopb.dec_query_range_response(body)

    def get_metrics(self, tenant: str, query: str, group_by) -> dict:
        return _jload(self._call(
            "/tempopb.MetricsGenerator/GetMetrics",
            _jdump({"query": query, "group_by": list(group_by)}), tenant))


def streaming_search(target: str, tenant: str, query: str, *,
                     limit: int = 20, start_s: float | None = None,
                     end_s: float | None = None, timeout_s: float = 60.0):
    """Client for `tempopb.StreamingQuerier/Search`: yields (traces, final)
    tuples as partial diffs stream in."""
    if target.startswith("grpc://"):
        target = target[len("grpc://"):]
    with grpc.insecure_channel(target) as ch:
        fn = ch.unary_stream("/tempopb.StreamingQuerier/Search")
        body: dict = {"q": query, "limit": limit}
        if start_s is not None:
            body["start"] = start_s
        if end_s is not None:
            body["end"] = end_s
        from tempo_tpu_torch.model import tempopb

        for msg in fn(_jdump(body), timeout=timeout_s,
                      metadata=(("x-scope-orgid", tenant),)):
            mds, final, _inspected, _stats = tempopb.dec_search_response(msg)
            yield mds, final


def streaming_metrics_query_range(target: str, tenant: str, query: str, *,
                                  start_s: float, end_s: float,
                                  step_s: float = 60.0,
                                  timeout_s: float = 60.0):
    """Client for `tempopb.StreamingQuerier/MetricsQueryRange`: yields one
    series list per message — diff batches while sub-results fold in,
    then the complete final set (last message)."""
    if target.startswith("grpc://"):
        target = target[len("grpc://"):]
    from tempo_tpu_torch.model import tempopb

    with grpc.insecure_channel(target) as ch:
        fn = ch.unary_stream("/tempopb.StreamingQuerier/MetricsQueryRange")
        body = {"query": query, "start": start_s, "end": end_s,
                "step": step_s}
        for msg in fn(_jdump(body), timeout=timeout_s,
                      metadata=(("x-scope-orgid", tenant),)):
            yield tempopb.dec_query_range_response(msg)


def streaming_search_tags(target: str, tenant: str, *,
                          timeout_s: float = 60.0):
    """Client for `tempopb.StreamingQuerier/SearchTags`: yields
    (scopes_dict, final) as scope diffs stream in."""
    if target.startswith("grpc://"):
        target = target[len("grpc://"):]
    with grpc.insecure_channel(target) as ch:
        fn = ch.unary_stream("/tempopb.StreamingQuerier/SearchTags")
        for msg in fn(b"{}", timeout=timeout_s,
                      metadata=(("x-scope-orgid", tenant),)):
            d = _jload(msg)
            yield d.get("scopes", {}), bool(d.get("final"))


class FrontendWorker:
    """Querier-side worker: dial the frontend, pull jobs, execute, reply.

    One bidi stream per worker thread (`worker.go` runs `parallelism`
    processors per frontend address). Job specs are executed through the
    local Querier — the worker process shares the object-store backend, so
    a block job only needs the meta + row-group slice.
    """

    def __init__(self, frontend_addr: str, querier, *,
                 worker_id: str = "worker", parallelism: int = 1) -> None:
        if frontend_addr.startswith("grpc://"):
            frontend_addr = frontend_addr[len("grpc://"):]
        self.addr = frontend_addr
        self.querier = querier
        self.worker_id = worker_id
        self.parallelism = parallelism
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self.jobs_executed = 0

    def start(self) -> None:
        for i in range(self.parallelism):
            t = threading.Thread(target=self._run, args=(i,), daemon=True)
            t.start()
            self._threads.append(t)

    def shutdown(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=3)

    # -- internals ----------------------------------------------------------

    def _run(self, idx: int) -> None:
        import time

        while not self._stop.is_set():
            try:
                self._process_stream(idx)
            except grpc.RpcError:
                # frontend down/restarting: back off and redial
                # (`frontend_processor.go` retry loop)
                time.sleep(0.3)
            except Exception:
                time.sleep(0.3)

    def _process_stream(self, idx: int) -> None:
        outbox: _q.Queue = _q.Queue()
        outbox.put(_jdump({"type": "hello",
                           "worker_id": f"{self.worker_id}-{idx}"}))

        def requests():
            while not self._stop.is_set():
                try:
                    yield outbox.get(timeout=0.2)
                except _q.Empty:
                    continue

        with grpc.insecure_channel(self.addr) as ch:
            fn = ch.stream_stream("/tempopb.Frontend/Process")
            for msg in fn(requests()):
                if self._stop.is_set():
                    return
                m = _jload(msg)
                for job in m.get("jobs", []):
                    outbox.put(self._execute(job))

    def _execute(self, job: dict) -> bytes:
        from tempo_tpu_torch.obs import querystats

        jid = job["job_id"]
        try:
            # per-job stats scope: the worker-side half of the stats
            # trailer — serialized into the result message so the
            # frontend can merge shard stats into the parent request
            with querystats.scope() as st:
                result = execute_job_spec(self.querier, job["spec"])
            self.jobs_executed += 1
            return _jdump({"type": "result", "job_id": jid, "result": result,
                           "stats": st.to_json()})
        except Exception as e:
            return _jdump({"type": "error", "job_id": jid, "error": str(e)})


def execute_job_spec(querier, spec: dict):
    """Run one frontend job spec on a local querier; returns JSON-safe
    result (the worker side of `querier.SearchBlock` / query-range jobs)."""
    from tempo_tpu_torch.backend.meta import BlockMeta

    kind = spec["kind"]
    meta = BlockMeta.from_json(spec["meta"]) if spec.get("meta") else None
    rgs = tuple(spec.get("row_groups") or ()) or None
    if kind == "search_block":
        res = querier.search_block(
            spec["tenant"], spec["query"], meta, rgs,
            limit=int(spec.get("limit", 20)),
            start_s=spec.get("start_s"), end_s=spec.get("end_s"))
        return [md.to_json() for md in res]
    if kind == "query_range_block":
        from tempo_tpu_torch.traceql.engine_metrics import QueryRangeRequest

        req = QueryRangeRequest(
            query=spec["query"], start_ns=spec["start_ns"],
            end_ns=spec["end_ns"], step_ns=spec["step_ns"],
            moments=bool(spec.get("moments", False)))
        series = querier.query_range_block(
            spec["tenant"], req, meta, rgs,
            clip_start_ns=spec.get("clip_start_ns"),
            clip_end_ns=spec.get("clip_end_ns"))
        # same shape _encode_series/_decode_series (frontend.py) use —
        # exemplars included, or the remote path degrades results AND the
        # frontend's fold-time cache write persists the degradation
        return [{"labels": [list(kv) for kv in s.labels],
                 "samples": list(map(float, s.samples)),
                 "exemplars": list(getattr(s, "exemplars", []))}
                for s in series]
    raise ValueError(f"unknown job kind {kind!r}")
