"""The query-frontend service: per-endpoint pipelines over a job queue.

Mirrors `modules/frontend/frontend.go:100-224`: each public endpoint
(search, trace-by-id, query-range, tags) shards into jobs, dispatches via
the tenant-fair queue to querier workers (pull model — in-process threads
here, gRPC streams in the reference), and folds partial results through a
combiner with early exit. With no workers started, jobs execute inline
(the single-binary fast path).

Counterpart of `tempo_tpu/frontend/frontend.py`, host code copied over
the port's `Querier` and `TempoDB`: the device work of a query is the
TempoDB's read plane, on that TempoDB's device. The generators'
recent-window leg is `generator_query_range`: pass
`generator.Generator.query_range`, which answers from the tenants'
local-blocks processors (`app.App` passes it, or its fan-out over the
generator ring when peers or a ring KV are configured). A metrics query
is served from the process materializer's standing grid when one
covers it (`tempo_tpu_torch.matview`), and every miss feeds the query
log's recurrence count that auto-subscribes the hot set;
`subscribe_query` / `unsubscribe_query` are the explicit half.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Sequence

from tempo_tpu_torch.db.tempodb import TempoDB
from tempo_tpu_torch.frontend.queue import RequestQueue
from tempo_tpu_torch.frontend.sharders import (
    SearchJob,
    backend_search_jobs,
    prune_blocks_rf,
    query_range_jobs,
    time_windows,
)
from tempo_tpu_torch.frontend.slos import SLOConfig, SLORecorder
from tempo_tpu_torch.model.combine import combine_spans, sort_spans
from tempo_tpu_torch.obs import Registry, exponential_buckets
from tempo_tpu_torch.obs import querystats
from tempo_tpu_torch.obs.qlog import QueryLogger
from tempo_tpu_torch.obs.querystats import QueryStats
from tempo_tpu_torch.overrides import Overrides
from tempo_tpu_torch.querier.querier import Querier
from tempo_tpu_torch.traceql.engine import MetadataCombiner
from tempo_tpu_torch.traceql.engine_metrics import (
    QueryRangeRequest,
    SeriesCombiner,
    TimeSeries,
    metrics_kind,
)


@dataclasses.dataclass
class FrontendConfig:
    target_bytes_per_job: int = 100 * 1024 * 1024
    metrics_target_bytes_per_job: int = 225 * 1024 * 1024
    concurrent_jobs: int = 1000
    max_outstanding_per_tenant: int = 2000
    max_batch_size: int = 5
    query_backend_after_s: float = 15 * 60
    query_ingesters_until_s: float = 30 * 60
    # RF of backend blocks eligible for metrics queries: 1 = generator
    # localblocks / blockbuilder output (the reference's rule); None admits
    # all blocks for single-writer deployments whose blocks are deduped
    metrics_block_rf: int | None = 1
    # historical metrics from sketch sidecars: blocks entirely behind the
    # cutoff whose sidecar can answer the query fold on the request
    # thread (no scan jobs); blocks without a sidecar fall back to jobs
    sidecar_folds: bool = True
    slo: dict[str, SLOConfig] = dataclasses.field(default_factory=dict)
    # structured query log (obs/qlog.py): errors always log; queries over
    # the sketch-estimated `qlog_slow_quantile` latency log as slow;
    # 1-in-`qlog_sample_every` of the rest logs, under a token-bucket cap
    qlog_slow_quantile: float = 0.95
    qlog_sample_every: int = 100
    qlog_rate_limit_per_s: float = 10.0


class _Job:
    __slots__ = ("job", "fn", "spec", "result", "error", "event", "_lock",
                 "_claimed", "enqueued_at", "queue_wait", "stats",
                 "traceparent")

    def __init__(self, job: SearchJob, fn: Callable[[SearchJob], Any],
                 spec: dict | None = None):
        self.job = job
        self.fn = fn
        self.spec = spec      # JSON-safe descriptor for remote workers
        # issuer's trace context, captured at construction: the worker
        # thread (or remote stream executor) re-enters it so querier /
        # tempodb spans join the REQUEST's tree, not the worker's —
        # contextvars do not cross the pool boundary, this string does
        from tempo_tpu_torch.utils import tracing
        self.traceparent = tracing.tracer().traceparent()
        self.result: Any = None
        self.error: Exception | None = None
        self.event = threading.Event()
        self._lock = threading.Lock()
        self._claimed = False
        # queue-wait clock, attached at enqueue: observed at CLAIM time,
        # because remote worker streams claim a job and ship its spec
        # without ever invoking fn — only the claim is common to local
        # workers, remote streams, and the issuer's inline fallback
        self.enqueued_at: float | None = None
        self.queue_wait = None
        # per-job QueryStats: the executor (worker thread, remote stream
        # reader, or inline fallback) records into it; the issuer merges
        # it into the parent request scope at fold time — contextvars do
        # not cross the thread-pool boundary, per-job objects do
        self.stats = QueryStats()

    def try_claim(self) -> bool:
        """Exactly-once execution claim: local workers, remote worker
        streams, and the issuer's inline fallback race for the same queued
        job; whoever claims it runs it, everyone else skips."""
        with self._lock:
            if self._claimed:
                return False
            self._claimed = True
        if self.enqueued_at is not None:
            wait_s = time.perf_counter() - self.enqueued_at
            if self.queue_wait is not None:
                self.queue_wait.observe(wait_s)
            self.stats.add_stage_ns("queue_wait", int(wait_s * 1e9))
        return True

    def run(self) -> None:
        if not self.try_claim():
            return
        self.run_claimed()

    def run_claimed(self) -> None:
        from tempo_tpu_torch.utils import tracing
        try:
            with tracing.adopted(self.traceparent), \
                    querystats.scope(self.stats):
                self.result = self.fn(self.job)
        except Exception as e:  # combiner decides whether partials suffice
            self.error = e
        self.event.set()


class UnsupportedMultiTenant(ValueError):
    """Client error: the endpoint does not support `a|b` org ids
    (→ HTTP 400, like the reference's unsupported middleware)."""


def split_tenants(tenant: str) -> list[str]:
    """`X-Scope-OrgID: a|b` → ["a", "b"] (order-preserving, deduped) —
    the multi-tenant federation split (`modules/frontend/frontend.go:
    113-136` multiTenantMiddleware / pkg tenant.ValidTenantID)."""
    seen: list[str] = []
    for t in tenant.split("|"):
        t = t.strip()
        if t and t not in seen:
            seen.append(t)
    return seen or [tenant]


class Frontend:
    def __init__(self, db: TempoDB, querier: Querier,
                 cfg: FrontendConfig | None = None,
                 overrides: Overrides | None = None,
                 generator_query_range: Callable[..., list[TimeSeries]] | None = None,
                 cache_provider=None,
                 registry: Registry | None = None,
                 now: Callable[[], float] = time.time) -> None:
        self.db = db
        self.querier = querier
        self.cfg = cfg or FrontendConfig()
        self.overrides = overrides or Overrides()
        self.generator_query_range = generator_query_range
        self.now = now
        self.queue = RequestQueue(self.cfg.max_outstanding_per_tenant)
        self.slos = SLORecorder(self.cfg.slo)
        self._workers: list[threading.Thread] = []
        self._remote_lock = threading.Lock()
        self._remote_workers = 0  # connected gRPC worker-pull streams
        self._stop = threading.Event()
        # search-response cache: sub-request results keyed by (block id,
        # query, shard) — blocks are immutable so no invalidation exists
        # (`modules/frontend/frontend.go:101` newFrontendCache +
        # `cache_keys.go` searchJobCacheKey)
        self._job_cache = None
        if cache_provider is not None:
            from tempo_tpu_torch.backend.cache import ROLE_FRONTEND_SEARCH

            self._job_cache = cache_provider.cache_for(ROLE_FRONTEND_SEARCH)
        self.qlog = QueryLogger(
            slow_quantile=self.cfg.qlog_slow_quantile,
            sample_every=self.cfg.qlog_sample_every,
            rate_limit_per_s=self.cfg.qlog_rate_limit_per_s,
            now=now)
        # per-tenant read-cost accounting, fed once per finished request
        # from its merged QueryStats (render-time callback families — the
        # hot path never touches the registry)
        self._tenant_read_lock = threading.Lock()
        self._tenant_read_cost: dict[str, dict[str, int]] = {}
        # requests rejected with 503 under device-scheduler query
        # backpressure, by op (rendered via a callback family below)
        self.shed_requests: dict[str, int] = {}
        # per-op response-cache accounting (the aggregate cache_stats
        # dict cannot say WHICH endpoint is cold): hits/misses counted
        # at job-dispatch time in _run_jobs, keyed by endpoint op
        self._cache_ops: dict[str, dict[str, int]] = {}
        self.obs = registry if registry is not None else Registry()
        self._register_obs(self.obs)

    def _register_obs(self, reg: Registry) -> None:
        reg.counter_func(
            "tempo_query_frontend_queries_total",
            lambda: [(k, v) for k, v in self.slos.total.items()],
            help="Frontend queries, by endpoint op and tenant",
            labels=("op", "tenant"))
        reg.counter_func(
            "tempo_query_frontend_queries_within_slo_total",
            lambda: [(k, v) for k, v in self.slos.within.items()],
            help="Frontend queries that met the latency or throughput SLO",
            labels=("op", "tenant"))
        reg.counter_func(
            "tempo_query_frontend_cache_hits_total",
            lambda: [((), self.cache_stats["hits"])],
            help="Search-response cache hits")
        reg.counter_func(
            "tempo_query_frontend_cache_misses_total",
            lambda: [((), self.cache_stats["misses"])],
            help="Search-response cache misses")
        self.op_duration = reg.histogram(
            "tempo_query_frontend_request_duration_seconds",
            "Frontend query latency by endpoint op; observations over the "
            "op's SLO threshold carry the active trace id as an exemplar",
            labels=("op",))
        self.queue_wait = reg.histogram(
            "tempo_query_frontend_queue_wait_seconds",
            "Time a sharded sub-request spent in the tenant-fair queue "
            "before a worker claimed it")
        self.shard_fanout = reg.histogram(
            "tempo_query_frontend_shard_fanout",
            "Sub-requests one query sharded into",
            buckets=exponential_buckets(1.0, 2.0, 12))

        def read_cost(field):
            def fn():
                with self._tenant_read_lock:
                    return [((t,), c.get(field, 0))
                            for t, c in self._tenant_read_cost.items()]
            return fn

        reg.counter_func(
            "tempo_tpu_query_inspected_bytes_total",
            read_cost("inspected_bytes"),
            help="Bytes of block data inspected by queries, per tenant "
                 "(merged request-scoped QueryStats — read-cost accounting)",
            labels=("tenant",))
        reg.counter_func(
            "tempo_tpu_query_blocks_scanned_total",
            read_cost("blocks_scanned"),
            help="Backend block slices scanned by queries, per tenant",
            labels=("tenant",))
        reg.counter_func(
            "tempo_tpu_query_device_seconds_total",
            lambda: [(labels, ns / 1e9) for labels, ns in
                     read_cost("device_ns")()],
            help="Device-dispatch wall seconds consumed by queries, per "
                 "tenant (device-time-ledger attribution via "
                 "QueryStats.device_ns — the read-side twin of "
                 "tempo_devtime_tenant_device_seconds_total)",
            labels=("tenant",))

        def cache_by_op(field):
            def fn():
                with self._tenant_read_lock:
                    return [((op,), c.get(field, 0))
                            for op, c in self._cache_ops.items()]
            return fn

        reg.counter_func(
            "tempo_tpu_frontend_cache_hits_total", cache_by_op("hits"),
            help="Search-response cache hits by endpoint op (per-op twin "
                 "of tempo_query_frontend_cache_hits_total)",
            labels=("op",))
        reg.counter_func(
            "tempo_tpu_frontend_cache_misses_total", cache_by_op("misses"),
            help="Search-response cache misses by endpoint op (cacheable "
                 "sub-requests that had to execute)",
            labels=("op",))

        def shed():
            with self._tenant_read_lock:
                return [((op,), n) for op, n in self.shed_requests.items()]

        reg.counter_func(
            "tempo_query_frontend_shed_total", shed,
            help="Requests rejected with 503 + Retry-After because the "
                 "device scheduler's query class was saturated, by op",
            labels=("op",))
        reg.counter_func(
            "tempo_query_log_records_total",
            self.qlog.emitted_by_reason,
            help="Query-log emission outcomes (error/slow/sampled lines "
                 "written, suppressed = sampled-out or rate-limited)",
            labels=("reason",))

    def _record_op(self, op: str, tenant: str, latency_s: float,
                   nbytes: int) -> None:
        """SLO accounting + the op latency histogram. A request outside
        its SLO stamps the active self-tracing span's trace id as the
        observation's exemplar, so a p99 spike links to a concrete trace
        in the dogfood tenant."""
        good = self.slos.record(op, tenant, latency_s, nbytes)
        trace_id = None
        if not good:
            from tempo_tpu_torch.utils import tracing
            trace_id = tracing.current_trace_id_hex()
            # tail-keep: an SLO-missing request's WHOLE tree survives
            # head sampling (the exemplar above only named the id; the
            # buffered spans are what make it retrievable)
            tracing.mark_keep()
        self.op_duration.observe(latency_s, (op,), trace_id=trace_id)

    @property
    def cache_stats(self) -> dict:
        """Hit/miss counters straight from the role cache (it counts under
        its own lock; duplicating here would race worker threads)."""
        c = self._job_cache
        return {"hits": getattr(c, "hits", 0),
                "misses": getattr(c, "misses", 0)}

    def cache_hit_ratio(self) -> float:
        s = self.cache_stats
        total = s["hits"] + s["misses"]
        return s["hits"] / total if total else 0.0

    @property
    def remote_workers(self) -> int:
        return self._remote_workers

    def remote_worker_attached(self) -> None:
        with self._remote_lock:
            self._remote_workers += 1

    def remote_worker_detached(self) -> None:
        with self._remote_lock:
            self._remote_workers -= 1

    # -- worker pool (querier pull model) ----------------------------------

    def start_workers(self, n: int = 2) -> None:
        def loop():
            while not self._stop.is_set():
                batch = self.queue.dequeue_batch(self.cfg.max_batch_size,
                                                 timeout_s=0.2)
                for j in batch:
                    j.run()
        self._workers = [threading.Thread(target=loop, daemon=True)
                         for _ in range(n)]
        for t in self._workers:
            t.start()

    def shutdown(self) -> None:
        self._stop.set()
        for t in self._workers:
            t.join(timeout=2)
        self.queue.close()

    def _check_device_pressure(self, op: str) -> None:
        """Shed NEW queries when the device scheduler's query class is
        saturated (503 + Retry-After at the API) — admitted work keeps
        running; backpressure applies at the request boundary, like the
        ingest-side 429 at the distributor. Sheds are counted per op
        (tempo_query_frontend_shed_total) so an operator can see the
        503s the scheduler's own shed counter (which tracks JOBS, not
        requests) does not cover."""
        from tempo_tpu_torch import sched
        sc = sched.scheduler()
        if sc is not None and sc.query_saturated():
            with self._tenant_read_lock:
                self.shed_requests[op] = self.shed_requests.get(op, 0) + 1
            raise sched.QueryBackpressure(sc.cfg.retry_after_s)

    def _note_cache(self, op: str, hits: int = 0, misses: int = 0) -> None:
        with self._tenant_read_lock:
            c = self._cache_ops.setdefault(op, {})
            c["hits"] = c.get("hits", 0) + hits
            c["misses"] = c.get("misses", 0) + misses

    def _run_jobs(self, tenant: str, jobs: Sequence[SearchJob],
                  fn: Callable[[SearchJob], Any],
                  on_result: Callable[[Any], bool],
                  spec_fn: Callable[[SearchJob], dict] | None = None,
                  cache: "tuple | None" = None, op: str = "search") -> int:
        """Dispatch jobs; fold results via on_result (return False = early
        exit, like streaming combiners cancelling remaining work). Raises
        the first job error — a failed sub-query fails the whole query, as
        partial silent results are worse than an error. Keeps at most
        `concurrent_jobs` in flight so wide queries never trip the
        per-tenant outstanding cap. Returns bytes processed (SLO).

        `cache` = (key_fn, encode, decode): the search-response cache ware
        (`frontend.go:101`). Hits are consulted BEFORE dispatch and writes
        happen at fold time, so cached sub-requests are skipped no matter
        who would have executed them — inline, local worker, or remote
        worker stream. key_fn returning None marks a job uncacheable."""
        self.shard_fanout.observe(float(len(jobs)))
        querystats.add(total_jobs=len(jobs))
        key_fn = encode = decode = None
        if cache is not None and self._job_cache is not None:
            key_fn, encode, decode = cache

        hits: dict[int, Any] = {}
        pending: list[tuple[int, "_Job"]] = []
        wrapped: list = []
        n_hit = n_miss = 0
        for idx, j in enumerate(jobs):
            key = key_fn(j) if key_fn else None
            raw = self._job_cache.get(key) if key is not None else None
            if raw is not None:
                hits[idx] = decode(raw)
                wrapped.append(None)
                n_hit += 1
            else:
                if key is not None:
                    n_miss += 1       # cacheable but had to execute
                wj = _Job(j, fn, spec_fn(j) if spec_fn else None)
                wrapped.append(wj)
                pending.append((idx, wj))
        if n_hit or n_miss:
            self._note_cache(op, hits=n_hit, misses=n_miss)

        nbytes = 0

        def fold(idx, job, result) -> bool:
            nonlocal nbytes
            if key_fn and idx not in hits:
                key = key_fn(job)
                if key is not None:
                    try:
                        self._job_cache.put(key, encode(result))
                    except Exception:
                        pass           # cache write is best-effort
            nbytes += _job_bytes(job)
            # shard stats → parent request scope (per-job accumulators for
            # executed jobs; a cache hit inspected nothing this time)
            wj = wrapped[idx]
            if wj is not None:
                querystats.absorb(wj.stats)
            else:
                querystats.add(cache_hits=1)
            querystats.add(completed_jobs=1)
            with querystats.stage("merge"):
                return on_result(result)

        if not self._workers and not self.remote_workers:
            for idx, j in enumerate(jobs):    # inline single-binary path
                if idx in hits:
                    if not fold(idx, j, hits[idx]):
                        break
                    continue
                wj = wrapped[idx]
                wj.run()
                if wj.error is not None:
                    raise wj.error
                if not fold(idx, j, wj.result):
                    break
            return nbytes
        window = max(1, min(self.cfg.concurrent_jobs,
                            self.cfg.max_outstanding_per_tenant - 1))
        for _, wj in pending[:window]:
            self._enqueue_timed(tenant, wj)
        qi = window                 # next pending job to enqueue
        for idx, j in enumerate(jobs):
            if idx in hits:
                if not fold(idx, j, hits[idx]):
                    break
                continue
            wj = wrapped[idx]
            while not wj.event.wait(timeout=0.5):
                if self._stop.is_set():
                    raise RuntimeError("frontend shutting down")
                if not self._workers and not self.remote_workers \
                        and wj.try_claim():
                    # every worker disconnected with this job still queued:
                    # run it inline rather than hanging the query forever
                    wj.run_claimed()
            if qi < len(pending):
                self._enqueue_timed(tenant, pending[qi][1])
                qi += 1
            if wj.error is not None:
                raise wj.error
            if not fold(idx, j, wj.result):
                break
        return nbytes

    def _enqueue_timed(self, tenant: str, wj: "_Job") -> None:
        """Enqueue with the queue-wait clock attached: the wait histogram
        observes enqueue → claim, whoever claims (local worker, remote
        stream, or the issuer's inline fallback)."""
        wj.enqueued_at = time.perf_counter()
        wj.queue_wait = self.queue_wait
        self.queue.enqueue(tenant, wj)

    # -- endpoints ---------------------------------------------------------

    def _finish_query(self, op: str, tenant: str, query: str,
                      duration_s: float, st: QueryStats,
                      error: Exception | None = None,
                      extra: dict | None = None) -> None:
        """Close out one frontend request: per-tenant read-cost counters
        and exactly one structured "query complete" log decision — called
        once per public endpoint invocation, success or failure."""
        from tempo_tpu_torch.utils import tracing

        # normalize the label the same way every per-tenant metric does
        # (' a ' → 'a', 'a|a' → 'a'); a true federation keeps its composite
        # 'a|b' label — merged stats cannot be apportioned per member
        tenant = "|".join(split_tenants(tenant))
        sm = st.search_metrics()
        with self._tenant_read_lock:
            cost = self._tenant_read_cost.setdefault(tenant, {})
            cost["inspected_bytes"] = \
                cost.get("inspected_bytes", 0) + sm["inspectedBytes"]
            cost["blocks_scanned"] = \
                cost.get("blocks_scanned", 0) + sm["blocksScanned"]
            cost["device_ns"] = \
                cost.get("device_ns", 0) + sm["deviceNanos"]
        # overload-sampling exemplar: while the write path is sampling,
        # every emitted query line says so — rates/quantiles in this
        # window describe an upscaled sampled stream, and a reader of a
        # slow line must be able to tell
        from tempo_tpu_torch import sched
        keep = sched.ingest_keep_fraction()
        merged = dict(extra or {})
        if keep < 1.0:
            merged["ingestKeepFraction"] = round(keep, 4)
        # selfTraceId: present ONLY when this request's self-trace tree
        # was (or will be) kept by tail-keep — the line then links
        # directly to a retrievable trace in the ops tenant (runbook
        # "Reading the query log")
        kept = tracing.kept_trace_id_hex()
        if kept:
            merged["selfTraceId"] = kept
        self.qlog.log_query(
            op=op, tenant=tenant, query=query,
            status="error" if error is not None else "ok",
            duration_s=duration_s, stats=st,
            trace_id=tracing.current_trace_id_hex(),
            error=str(error) if error is not None else None,
            extra=merged or None)

    def search(self, tenant: str, query: str, *, limit: int = 20,
               start_s: float | None = None, end_s: float | None = None,
               on_partial: Callable[[list], None] | None = None
               ) -> list:
        """on_partial (optional) receives the combiner's current results
        after each fold — the hook the streaming gRPC endpoint uses to
        emit diff responses (`combiner/search.go`)."""
        from tempo_tpu_torch.utils import tracing
        self._check_device_pressure("search")
        t0 = self.now()
        with tracing.span_for_tenant("frontend.Search", tenant, query=query), \
                querystats.ensure_scope() as st:
            try:
                res = self._search_fanout(tenant, query, limit=limit,
                                          start_s=start_s, end_s=end_s,
                                          on_partial=on_partial)
            except Exception as e:
                self._finish_query("search", tenant, query,
                                   self.now() - t0, st, error=e)
                raise
            self._finish_query("search", tenant, query, self.now() - t0, st)
            return res

    def _search_fanout(self, tenant: str, query: str, *, limit: int,
                       start_s: float | None, end_s: float | None,
                       on_partial: Callable[[list], None] | None) -> list:
        tenants = split_tenants(tenant)
        if len(tenants) == 1:
            # normalized: 'a|a', 'a|', ' a ' all mean tenant 'a'
            return self._search(tenants[0], query, limit=limit,
                                start_s=start_s, end_s=end_s,
                                on_partial=on_partial)
        # multi-tenant federation: fan out per tenant, merge through
        # the same top-N combiner (frontend.go:113-136)
        comb = MetadataCombiner(limit)
        for t in tenants:
            for md in self._search(t, query, limit=limit,
                                   start_s=start_s, end_s=end_s):
                comb.add(md)
            if on_partial is not None:
                on_partial(comb.results())
            if comb.exhausted():
                break               # top-N full: skip remaining tenants
        return comb.results()

    def _search(self, tenant: str, query: str, *, limit: int = 20,
                start_s: float | None = None, end_s: float | None = None,
                on_partial: Callable[[list], None] | None = None) -> list:
        t0 = self.now()
        end_s = end_s if end_s is not None else self.now()
        start_s = start_s if start_s is not None else end_s - 3600.0
        ing_win, be_win = time_windows(
            self.now(), start_s, end_s,
            self.cfg.query_backend_after_s, self.cfg.query_ingesters_until_s)
        combiner = MetadataCombiner(limit)
        nbytes = 0
        if ing_win is not None:
            for md in self.querier.search_recent(tenant, query, limit,
                                                 *ing_win):
                combiner.add(md)
            if on_partial is not None:
                on_partial(combiner.results())
        if be_win is not None and not combiner.exhausted():
            metas = self.db.blocks(tenant, be_win[0], be_win[1])
            querystats.add(total_blocks=len(metas))
            jobs = backend_search_jobs(tenant, metas, be_win[0], be_win[1],
                                       self.cfg.target_bytes_per_job)

            def fold(res) -> bool:
                for md in res:
                    combiner.add(md)
                if on_partial is not None:
                    on_partial(combiner.results())
                return not combiner.exhausted()

            def search_key(j) -> str:
                # times join the key only when the window cuts INTO the
                # block; a fully-covered block's results are window-free
                # (`cache_keys.go` searchJobCacheKey semantics)
                m = j.meta
                tpart = ("" if j.start_s <= m.start_time
                         and j.end_s >= m.end_time
                         else f":{j.start_s}:{j.end_s}")
                return (f"sj:{tenant}:{m.block_id}:{_qhash(query)}:"
                        f"{','.join(map(str, j.row_groups))}:{limit}{tpart}")

            nbytes += self._run_jobs(
                tenant, jobs,
                lambda j: self.querier.search_block(
                    tenant, query, j.meta, j.row_groups, limit,
                    j.start_s, j.end_s),
                fold,
                spec_fn=lambda j: {
                    "kind": "search_block", "tenant": tenant,
                    "query": query, "meta": j.meta.to_json(),
                    "row_groups": list(j.row_groups), "limit": limit,
                    "start_s": j.start_s, "end_s": j.end_s},
                cache=(search_key, _encode_metadata, _decode_metadata),
                op="search")
        self._record_op("search", tenant, self.now() - t0, nbytes)
        return combiner.results()

    def find_trace(self, tenant: str, trace_id: bytes,
                   start_s: float | None = None, end_s: float | None = None
                   ) -> list[dict] | None:
        t0 = self.now()
        spans: list[dict] = []
        for t in split_tenants(tenant):
            got = self.querier.find_trace_by_id(t, trace_id, start_s, end_s)
            if got:
                spans.extend(got)
        self._record_op("traces", tenant, self.now() - t0,
                        len(spans) * 200)
        return sort_spans(combine_spans(spans)) if spans else None

    def query_range(self, tenant: str, query: str, *,
                    start_s: float, end_s: float, step_s: float = 60.0,
                    on_partial: Callable[[list], None] | None = None
                    ) -> list[TimeSeries]:
        """TraceQL metrics: recent window from generators (RF1 local
        blocks), older from backend jobs; job series merge via
        SeriesCombiner then final quantile/rate pass
        (`metrics_query_range_sharder.go` + `combiner/metrics_query_range.go`).

        `on_partial` (optional) receives the current FINALIZED series set
        after each contributing sub-result — the incremental feed behind
        the streaming MetricsQueryRange endpoint (diffed there)."""
        from tempo_tpu_torch.utils import tracing
        tenants = split_tenants(tenant)
        if len(tenants) > 1:
            # the reference mounts newMultiTenantUnsupportedMiddleware on
            # the metrics endpoints (frontend.go:163-175 analog)
            raise UnsupportedMultiTenant(
                "multi-tenant query of the metrics endpoint is not supported")
        self._check_device_pressure("metrics")
        t0 = self.now()
        # the recurring-query identity (obs/queryfp.py) rides every
        # "query complete" line, so the hot set qlog sees and the set
        # the materializer serves are greppably the same thing
        from tempo_tpu_torch.obs.queryfp import query_fingerprint
        fp_extra = {"queryFp": query_fingerprint("metrics", query, step_s)}
        with tracing.span_for_tenant("frontend.QueryRange", tenants[0],
                                     query=query), \
                querystats.ensure_scope() as st:
            try:
                res = self._query_range(tenants[0], query, start_s=start_s,
                                        end_s=end_s, step_s=step_s,
                                        on_partial=on_partial)
            except Exception as e:
                self._finish_query("metrics", tenants[0], query,
                                   self.now() - t0, st, error=e,
                                   extra=fp_extra)
                raise
            self._finish_query("metrics", tenants[0], query,
                               self.now() - t0, st, extra=fp_extra)
            return res

    def _query_range(self, tenant: str, query: str, *,
                     start_s: float, end_s: float, step_s: float = 60.0,
                     on_partial: Callable[[list], None] | None = None
                     ) -> list[TimeSeries]:
        t0 = self.now()
        req = QueryRangeRequest(query=query,
                                start_ns=int(start_s * 1e9),
                                end_ns=int(end_s * 1e9),
                                step_ns=int(step_s * 1e9))
        # materialized-view tier: a subscribed query whose grid covers
        # the window is a slice + final pass — no generator recompute,
        # no backend jobs. Misses feed qlog's recurrence counter, which
        # drives auto-subscription of the hot set.
        from tempo_tpu_torch import matview
        mv = matview.materializer()
        if mv is not None:
            got = mv.read(tenant, req)
            if got is not None:
                comb = SeriesCombiner(metrics_kind(query), req.n_steps)
                comb.add_all(got)
                self._record_op("metrics", tenant, self.now() - t0, 0)
                with querystats.stage("combine"):
                    res = comb.final(req)
                if on_partial is not None:
                    on_partial(res)
                return res
            mv.consider_auto_subscribe(
                tenant, query, step_s,
                self.qlog.note_fingerprint(mv.fingerprint(query, step_s)))
        # single cutoff, not overlapping windows: generators own
        # (cutoff, end], backend RF1 blocks own [start, cutoff] — sub-results
        # keep the full step grid and clip observations to their side, so
        # nothing is counted twice (TrimToBefore/After split,
        # `metrics_query_range_sharder.go:125-190`)
        cutoff_s = self.now() - self.cfg.query_backend_after_s
        cutoff_ns = int(cutoff_s * 1e9)
        # sidecar fold tier (block/sidecar.py): for a fold-eligible
        # rate()/quantile_over_time(duration) query, blocks entirely
        # behind the cutoff that carry a sketch sidecar are answered by
        # folding ~15 floats per series instead of scanning spans. The
        # tier only engages when some block will ACTUALLY fold (meta
        # flags are enough to decide — no sidecar reads yet); quantiles
        # then ride the moments axis END TO END — generator shards, scan
        # fallbacks and folds all emit __moment series, or the combiner
        # would mix them with log2 __bucket partials and emit the
        # ("p", q) output series twice
        plan = (self.db.sidecar_plan(query)
                if self.cfg.sidecar_folds and start_s < cutoff_s else None)
        metas: list = []
        if start_s < cutoff_s:
            metas = prune_blocks_rf(
                self.db.blocks(tenant, start_s, min(end_s, cutoff_s)),
                self.cfg.metrics_block_rf)
        if plan is not None and not any(
                m.sidecar and m.end_time * 1e9 < cutoff_ns for m in metas):
            plan = None
        if plan is not None and plan.quantile:
            req = dataclasses.replace(req, moments=True)
        comb = SeriesCombiner(metrics_kind(query), req.n_steps)
        nbytes = 0
        if end_s > cutoff_s and self.generator_query_range is not None:
            comb.add_all(self.generator_query_range(
                tenant, req, clip_start_ns=cutoff_ns))
            if on_partial is not None:
                on_partial(comb.final(req))
        if start_s < cutoff_s:
            # metrics read ONLY RF1 blocks (generator localblocks /
            # blockbuilder output) — ingester RF3 blocks hold every trace 3x
            # (`blockMetasForSearch(..., rf=1)` sharder :190). Configurable
            # for RF-deduped (compacted single-writer) setups.
            querystats.add(total_blocks=len(metas))
            # folds run inline on the request thread — each is a handful
            # of host flops over sidecar rows; blocks without a usable
            # sidecar (or straddling the moving cutoff) fall back to jobs
            scan_metas = []
            for m in metas:
                got = None
                if plan is not None and m.sidecar \
                        and m.end_time * 1e9 < cutoff_ns:
                    got = self.db.sidecar_series(tenant, req, m, plan,
                                                 clip_end_ns=cutoff_ns)
                if got is None:
                    scan_metas.append(m)
                else:
                    comb.add_all(got)
            if len(scan_metas) != len(metas) and on_partial is not None:
                on_partial(comb.final(req))
            jobs = query_range_jobs(tenant, scan_metas, start_s,
                                    min(end_s, cutoff_s), step_s,
                                    self.cfg.metrics_target_bytes_per_job)

            def fold(res) -> bool:
                comb.add_all(res)
                if on_partial is not None:   # folds run on THIS thread
                    on_partial(comb.final(req))
                return True

            def qr_key(j) -> "str | None":
                # cacheable only when the moving cutoff cannot affect the
                # block (block entirely before it); the clip then drops
                # out of the key and old blocks stay cacheable forever
                m = j.meta
                if m.end_time * 1e9 >= cutoff_ns:
                    return None
                return (f"qj:{tenant}:{m.block_id}:{_qhash(query)}:"
                        f"{','.join(map(str, j.row_groups))}:"
                        f"{req.start_ns}:{req.end_ns}:{req.step_ns}"
                        f"{':m' if req.moments else ''}")

            nbytes += self._run_jobs(
                tenant, jobs,
                lambda j: self.querier.query_range_block(
                    tenant, req, j.meta, j.row_groups,
                    clip_end_ns=cutoff_ns),
                fold,
                spec_fn=lambda j: {
                    "kind": "query_range_block", "tenant": tenant,
                    "query": query, "start_ns": req.start_ns,
                    "end_ns": req.end_ns, "step_ns": req.step_ns,
                    "moments": req.moments,
                    "meta": j.meta.to_json(),
                    "row_groups": list(j.row_groups),
                    "clip_end_ns": cutoff_ns},
                cache=(qr_key, _encode_series, _decode_series),
                op="metrics")
        self._record_op("metrics", tenant, self.now() - t0, nbytes)
        # the cross-shard/cross-job fold happens here (lazily): on the
        # serving mesh, count-exact kinds collapse into one in-mesh
        # reduce (see SeriesCombiner) — stage-timed so qlog shows where
        # combine cost went
        with querystats.stage("combine"):
            return comb.final(req)

    def subscribe_query(self, tenant: str, query: str, step_s: float
                        ) -> "tuple[bool, str]":
        """Explicit materialized-view subscription (the API half of the
        matview tier; the other half is qlog-recurrence auto-subscribe).
        Returns (ok, reason-when-refused)."""
        from tempo_tpu_torch import matview
        mv = matview.materializer()
        if mv is None:
            return False, "matview tier disabled"
        sub, why = mv.subscribe(tenant, query, step_s)
        return sub is not None, why

    def unsubscribe_query(self, tenant: str, query: str,
                          step_s: float) -> bool:
        from tempo_tpu_torch import matview
        mv = matview.materializer()
        return mv is not None and mv.unsubscribe(tenant, query, step_s)

    def decode_job_result(self, spec: dict, result):
        """Decode a remote worker's JSON job result back into the objects
        the fold expects (the inverse of `execute_job_spec`). Shares the
        cache codecs so the remote path and the cache path cannot drift."""
        import json

        if spec["kind"] == "search_block":
            return _decode_metadata(json.dumps(result or []).encode())
        if spec["kind"] == "query_range_block":
            return _decode_series(json.dumps(result or []).encode())
        raise ValueError(f"unknown job kind {spec['kind']!r}")

    def tag_names(self, tenant: str,
                  on_partial: Callable[[dict], None] | None = None
                  ) -> dict[str, list[str]]:
        t0 = self.now()
        merged: dict[str, list[str]] = {}

        def fold(partial: dict[str, list[str]]) -> None:
            for scope, names in partial.items():
                cur = merged.setdefault(scope, [])
                cur.extend(n for n in names if n not in cur)

        def hook(partial: dict[str, list[str]]) -> None:
            # partial snapshots are cumulative; fold dedupes, so re-folding
            # a superset later (the final return) is idempotent
            fold(partial)
            on_partial({k: sorted(v) for k, v in merged.items()})

        for t in split_tenants(tenant):
            fold(self.querier.tag_names(
                t, on_partial=hook if on_partial is not None else None))
        for scope in merged:
            merged[scope] = sorted(merged[scope])
        self._record_op("metadata", tenant, self.now() - t0, 0)
        return merged

    def tag_values(self, tenant: str, name: str, limit: int = 1000,
                   on_partial: Callable[[list], None] | None = None
                   ) -> list[dict]:
        t0 = self.now()
        out: list[dict] = []
        seen: set = set()

        def fold(values: list[dict]) -> None:
            for v in values:
                key = (v.get("type"), v.get("value"))
                if key not in seen:
                    seen.add(key)
                    out.append(v)

        def hook(partial: list[dict]) -> None:
            fold(partial)
            on_partial(out[:limit])

        for t in split_tenants(tenant):
            # each tenant is asked for the FULL limit: cross-tenant
            # duplicates collapse in `seen`, so a smaller ask could
            # starve distinct values hiding behind shared ones
            fold(self.querier.tag_values(
                t, name, limit,
                on_partial=hook if on_partial is not None else None))
        self._record_op("metadata", tenant, self.now() - t0, 0)
        return out[:limit]


def _qhash(query: str) -> str:
    import hashlib

    return hashlib.sha1(query.encode()).hexdigest()[:16]


def _encode_metadata(res) -> bytes:
    import json

    return json.dumps([m.to_json() for m in res]).encode()


def _decode_metadata(raw: bytes):
    import json

    from tempo_tpu_torch.traceql.engine import TraceSearchMetadata

    return [TraceSearchMetadata.from_json(t) for t in json.loads(raw)]


def _encode_series(res) -> bytes:
    import json

    return json.dumps([
        {"labels": [[k, v] for k, v in s.labels],
         "samples": list(map(float, s.samples)),
         "exemplars": s.exemplars} for s in res]).encode()


def _decode_series(raw: bytes):
    import json

    import numpy as np

    return [TimeSeries(labels=tuple((k, v) for k, v in s["labels"]),
                       samples=np.asarray(s["samples"], np.float64),
                       exemplars=list(s.get("exemplars", [])))
            for s in json.loads(raw)]


def _job_bytes(job: SearchJob) -> int:
    if job.meta is None:
        return 0
    n_rg = max(job.meta.row_group_count, 1)
    return int(job.meta.size_bytes * (len(job.row_groups) or n_rg) / n_rg)
