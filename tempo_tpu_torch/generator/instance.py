"""Per-tenant generator instance: processors + registry + remote write.

Counterpart of `tempo_tpu/generator/instance.py`, the analog of the
reference's `modules/generator/instance.go`: `push_batch` fans a span
batch to the enabled processors (`instance.go:398-415`), ingestion-slack
filtering (`instance.go:442-473`) drops spans whose end time is outside
[now - slack, now + slack], and a collection tick drains the registry to
the remote-write client.

The port runs the reference's default processors, `span-metrics` and
`service-graphs`, over paged state when a page pool is active and the
tenant's capacity splits into its pages, over dense state otherwise.
Span-metrics updates ride the process device scheduler when one is
configured and enabled (`tempo_tpu_torch.sched.configure`; the
processor's `use_scheduler`, on by default) and the direct route
otherwise; `drain()` flushes the scheduler and reaps every processor's
staging pipeline behind it, so a collection sees every push accepted
before it.

Wire bytes enter through the C++ staging layer (`tempo_tpu_torch.native`,
`model/otlp_batch.py`), as in the reference: `push_otlp_staged` (OTLP
bytes → `native.otlp_stage` → the span-metrics fast route),
`push_staged_view` (a row view of a decode-once `StagedIngest`: the fast
route for a span-metrics-only instance, the staged SpanBatch columns
through `push_batch` for any other processor mix) and `push_otlp_recs`
(`native.otlp_scan` records with their payload). A tenant with
materialized query grids (`tempo_tpu_torch.matview`) always takes the
SpanBatch route: `push_batch` feeds each batch, after the slack filter
and before the processors, to the process materializer, which evaluates
the grids' queries over the batch columns.

The `local-blocks` processor (`processors/localblocks.py`) keeps the
tenant's recent traces as RF1 blocks on the instance's device and serves
`query_range` and `get_metrics` over them, and the materializer's
backfill reads them; `tick` runs its cut. The `trace-analytics`
processor (`processors/traceanalytics.py`) buffers live traces and, at
each `tick`, analyses the idle ones on the instance's device. A tenant
with either has more than span metrics, so its pushes take the
SpanBatch route (`push_batch`), where span metrics run K1 as on every
route.

The multi-tenant `Generator` (`generator.py`) drives instances through
the reference's push fence (`try_track` / `untrack`, the `detached` flag
a fleet handoff sets, `wait_pushes_idle`) and its idempotent-push window
(`seen_push` / `note_push`, bounded at 512 ids); `needs_attr_columns`
tells the distributor's decode-once staging which attribute matrices the
instance's processors read.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np

from tempo_tpu_torch import sched
from tempo_tpu_torch.device import resolve_device
from tempo_tpu_torch.generator.processors.localblocks import (
    LocalBlocksConfig,
    LocalBlocksProcessor,
)
from tempo_tpu_torch.generator.processors.servicegraphs import (
    ServiceGraphsConfig,
    ServiceGraphsProcessor,
)
from tempo_tpu_torch.generator.processors.spanmetrics import (
    SpanMetricsConfig,
    SpanMetricsProcessor,
)
from tempo_tpu_torch.generator.processors.traceanalytics import (
    TraceAnalyticsConfig,
    TraceAnalyticsProcessor,
)
from tempo_tpu_torch.generator.remote_write import RemoteWriteClient, RemoteWriteConfig
from tempo_tpu_torch.model.otlp_batch import stage_otlp
from tempo_tpu_torch.model.span_batch import SpanBatch
from tempo_tpu_torch.registry import ManagedRegistry, RegistryOverrides


@dataclasses.dataclass
class GeneratorConfig:
    processors: tuple[str, ...] = ("span-metrics", "service-graphs")
    registry: RegistryOverrides = dataclasses.field(default_factory=RegistryOverrides)
    spanmetrics: SpanMetricsConfig = dataclasses.field(default_factory=SpanMetricsConfig)
    servicegraphs: ServiceGraphsConfig = dataclasses.field(
        default_factory=ServiceGraphsConfig)
    traceanalytics: TraceAnalyticsConfig = dataclasses.field(
        default_factory=TraceAnalyticsConfig)
    remote_write: RemoteWriteConfig = dataclasses.field(default_factory=RemoteWriteConfig)
    localblocks: LocalBlocksConfig = dataclasses.field(
        default_factory=LocalBlocksConfig)
    localblocks_flush_writer: "object" = None  # RawWriter for flush_to_storage
    ingestion_time_range_slack_s: float = 30.0


class GeneratorInstance:
    """One tenant's generator on `device` (`cuda` unless `"cpu"` is asked
    for). Its state lives in the active page pool, which must then be on
    the same device, or with no pool (or a capacity the pool's pages do
    not divide) in dense state on `device`."""

    def __init__(self, tenant: str, cfg: GeneratorConfig | None = None,
                 now=time.time, device=None):
        self.device = resolve_device(device)
        self.tenant = tenant
        self.cfg = cfg or GeneratorConfig()
        self.now = now
        self.registry = ManagedRegistry(tenant, self.cfg.registry, now=now,
                                        device=self.device)
        self.remote_write = RemoteWriteClient(self.cfg.remote_write)
        self.processors: dict[str, object] = {}
        self._lock = threading.Lock()
        self.update_processors(self.cfg.processors)
        self.spans_received = 0
        self.spans_filtered_slack = 0
        self._last_purge = 0.0
        # ingest-WAL bookkeeping (generator/wal.py): `wal_watermarks`
        # maps member instance id -> [segment, seq] of the last WAL
        # record covered by restored checkpoints, carried forward through
        # handoffs so a member never replays records a checkpoint holds.
        # `_wal_mark` (set by Generator when its WAL is on) reads this
        # member's live watermark at snapshot time.
        self.wal_watermarks: dict[str, list] = {}
        self._wal_mark = None
        self.checkpointed_wal_seq: "int | None" = None
        # idempotent push dedupe: push id -> span count of recently acked
        # pushes, so a retried push whose response was lost does not
        # scatter twice; WAL replay re-seeds it across a restart
        self._push_ids: dict = {}
        # in-flight pushes and collections (the fleet handoff barrier):
        # a checkpoint cut must not race a push that is still scattering
        self._pushes_inflight = 0
        self._push_cv = threading.Condition()
        # set under _push_cv by Generator.pop_instance: a handler that
        # resolved this instance but has not yet registered in flight
        # re-resolves instead of scattering into a fenced instance
        self.detached = False
        # resolver for this tenant's CURRENT overrides (set by
        # Generator.instance); the materializer fingerprints it to
        # expire and rebuild grids when the tenant's limits change
        self._matview_limits: "object | None" = None

    def drain(self) -> None:
        """The collection barrier: flush the device scheduler and reap
        every processor's ingest pipeline, so every update accepted
        before this call is in device state."""
        sched.flush()
        for proc in list(self.processors.values()):
            fn = getattr(proc, "drain_pipeline", None)
            if fn is not None:
                fn()

    def try_track(self) -> bool:
        """Register an in-flight push or collection unless this instance
        is detached (the fleet handoff fence). A True return must be
        paired with `untrack()`."""
        with self._push_cv:
            if self.detached:
                return False
            self._pushes_inflight += 1
        return True

    def untrack(self) -> None:
        with self._push_cv:
            self._pushes_inflight -= 1
            self._push_cv.notify_all()

    def seen_push(self, push_id: str):
        """A recently seen push id's state: its span count (acked and
        durable), ("pending", count) (scattered, its WAL append not yet
        confirmed: a retry redoes only the append), or None."""
        with self._lock:
            return self._push_ids.get(push_id)

    def note_push(self, push_id: str, result) -> None:
        with self._lock:
            self._push_ids[push_id] = result
            while len(self._push_ids) > 512:   # bounded: FIFO eviction
                self._push_ids.pop(next(iter(self._push_ids)))

    def wait_pushes_idle(self, timeout_s: float = 5.0) -> bool:
        """Block until no push is in flight, at most `timeout_s`; False
        on timeout."""
        deadline = time.monotonic() + timeout_s
        with self._push_cv:
            while self._pushes_inflight > 0:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._push_cv.wait(left)
        return True

    def update_processors(self, desired: tuple[str, ...]) -> None:
        with self._lock:
            for name in list(self.processors):
                if name not in desired:
                    del self.processors[name]
            for name in desired:
                if name in self.processors:
                    continue
                if name == "span-metrics":
                    self.processors[name] = SpanMetricsProcessor(
                        self.registry, self.cfg.spanmetrics)
                elif name == "service-graphs":
                    self.processors[name] = ServiceGraphsProcessor(
                        self.registry, self.cfg.servicegraphs)
                elif name == "local-blocks":
                    self.processors[name] = LocalBlocksProcessor(
                        self.tenant, self.cfg.localblocks,
                        flush_writer=self.cfg.localblocks_flush_writer,
                        now=self.now, device=self.device)
                elif name == "trace-analytics":
                    self.processors[name] = TraceAnalyticsProcessor(
                        self.registry, self.cfg.traceanalytics)
                else:
                    raise ValueError(f"unknown processor {name}")

    # -- ingest ------------------------------------------------------------

    def needs_attr_columns(self) -> tuple[bool, bool]:
        """(span_attrs, res_attrs) the enabled processors read: staging
        skips the matrices no processor asks for. A processor without the
        hook (service graphs: peer attributes) needs both."""
        need_span = need_res = False
        for proc in self.processors.values():
            fn = getattr(proc, "needs_attr_columns", None)
            s, r = fn() if fn is not None else (True, True)
            need_span |= s
            need_res |= r
        return need_span, need_res

    def _fast_spanmetrics(self) -> "SpanMetricsProcessor | None":
        """The single eligible span-metrics processor for the staged fast
        routes, or None when the SpanBatch route is required. A tenant
        with materialized query grids always takes the SpanBatch route:
        the matview appender evaluates TraceQL over the batch columns,
        which the StageRec fast path never builds."""
        from tempo_tpu_torch import matview

        mv = matview.materializer()
        if mv is not None and mv.wants(self.tenant):
            return None
        procs = list(self.processors.values())
        if len(procs) != 1 or not isinstance(procs[0], SpanMetricsProcessor):
            return None
        return procs[0] if procs[0].supports_staged_fast_path() else None

    def push_otlp_recs(self, raw: bytes, recs: np.ndarray) -> "int | None":
        """In-process tee fast route: `native.otlp_scan` records and the
        original payload → fused resolve → device. Returns the span
        count, or None when ineligible (the caller takes the payload
        route)."""
        proc = self._fast_spanmetrics()
        if proc is None:
            return None
        lo, hi = self._slack_bounds()
        got = proc.push_from_recs(raw, recs, lo, hi)
        if got is None:
            return None
        self.spans_received += len(recs)
        self.spans_filtered_slack += got[1]
        return len(recs)

    def push_staged_view(self, view, now_s: "float | None" = None
                         ) -> "int | None":
        """Decode-once consumption: a row view over a shared staging. A
        span-metrics-only instance feeds the StageRec rows straight to
        the fused resolve (no SpanBatch); any other processor mix, or a
        payload whose service.name needs the Python fixup, rides the
        staged SpanBatch columns (`batch_slice`: a gather for a sharded
        view, the shared batch for a full one). None when the staging
        was not made with this tenant's interner.

        Views of an overload-sampled push carry Horvitz-Thompson weights
        (`view.weights()`): span metrics upscale with them, so the
        sampled stream reports the true stream's rates."""
        st = view.staged
        if st.interner is not self.registry.interner:
            return None
        w = view.weights()
        proc = self._fast_spanmetrics()
        if proc is not None and not st.needs_service_fixup:
            spans = view.stage_rows()
            lo, hi = self._slack_bounds(now_s)
            _n_valid, n_filtered = proc.push_staged(spans, lo, hi, weights=w)
            self.spans_received += len(spans)
            self.spans_filtered_slack += n_filtered
            return len(spans)
        sb, sizes = view.batch_slice()
        self.push_batch(sb, span_sizes=sizes, sample_weights=w, now_s=now_s)
        return view.n

    def push_otlp_staged(self, data: bytes, trusted: bool = False
                         ) -> "int | None":
        """Dedicated span-metrics fast route: OTLP bytes → C++ stage →
        fused resolve → device, with no SpanBatch. Returns the span
        count, or None when this instance is not eligible (the caller
        takes the full staging route). Eligibility is checked before any
        row-table change, so a fallback leaves no pending entries."""
        if self._fast_spanmetrics() is None:
            return None
        st = stage_otlp(data, self.registry.interner, trusted=trusted,
                        include_span_attrs=False)
        # a non-string service.name needs the Python stringify fixup
        # (`_batch_from_staged`): such payloads take the full route
        if st.needs_service_fixup:
            return None
        return self.push_staged_view(st.view())

    def _slack_bounds(self, now_s: "float | None" = None) -> tuple[int, int]:
        slack = self.cfg.ingestion_time_range_slack_s
        if slack <= 0:
            return 0, 0
        now_ns = int((self.now() if now_s is None else now_s) * 1e9)
        return now_ns - int(slack * 1e9), now_ns + int(slack * 1e9)

    def push_batch(self, sb: SpanBatch, span_sizes: np.ndarray | None = None,
                   sample_weights: np.ndarray | None = None,
                   now_s: "float | None" = None) -> None:
        self.spans_received += sb.n
        sb = self._apply_slack(sb, now_s)
        # materialized query grids see the batch BEFORE the processor
        # fan: a grid (re)build backfills from local-blocks state, so the
        # backfill must not already hold the batch it then appends
        from tempo_tpu_torch import matview

        mv = matview.materializer()
        if mv is not None and mv.wants(self.tenant):
            mv.observe_batch(self.tenant, sb,
                             lb=self.processors.get("local-blocks"),
                             limits_fn=self._matview_limits)
        for proc in self.processors.values():
            if isinstance(proc, SpanMetricsProcessor):
                proc.push_batch(sb, span_sizes, sample_weights=sample_weights)
            elif isinstance(proc, TraceAnalyticsProcessor):
                proc.push_batch(sb, sample_weights=sample_weights)
            else:
                proc.push_batch(sb)

    def _apply_slack(self, sb: SpanBatch,
                     now_s: "float | None" = None) -> SpanBatch:
        slack = self.cfg.ingestion_time_range_slack_s
        if slack <= 0:
            return sb
        lo, hi = self._slack_bounds(now_s)
        keep = (sb.end_unix_nano >= lo) & (sb.end_unix_nano <= hi)
        dropped = int((sb.valid & ~keep).sum())
        if dropped:
            self.spans_filtered_slack += dropped
            sb = dataclasses.replace(sb, valid=sb.valid & keep)
        return sb

    # -- collection tick ---------------------------------------------------

    def collect_and_push(self, ts_ms: int | None = None) -> int:
        """One collection: purge stale series, gather device state, remote
        write. Returns the number of samples pushed; under
        `remote_write.send_native_histograms` the registry's native
        histograms ride the same write request."""
        self.drain()
        if self.now() - self._last_purge > 60.0:
            self.registry.purge_stale()
            self._last_purge = self.now()
        samples = self.registry.collect(ts_ms)
        native = (self.registry.native_histograms(ts_ms)
                  if self.cfg.remote_write.send_native_histograms else [])
        self.remote_write.send(samples, native)
        return len(samples)

    # -- accounting --------------------------------------------------------

    @property
    def state_layout(self) -> str:
        return "dense" if self.registry.pages is None else "paged"

    def device_state_bytes(self) -> int:
        """Device bytes of this tenant's metric state: registry families
        plus the processors' sketch sidecars (paged: backed pages only;
        dense: whole arenas, trash pages included)."""
        total = self.registry.device_state_bytes()
        for proc in self.processors.values():
            fn = getattr(proc, "device_state_bytes", None)
            if fn is not None:
                total += fn()
        return total

    # -- maintenance -------------------------------------------------------

    def tick(self, immediate: bool = False) -> None:
        """Background maintenance: each processor's cut pass — the
        local-blocks cut/complete/flush pass and the trace-analytics
        idle-trace cut."""
        for proc in list(self.processors.values()):
            fn = getattr(proc, "cut_tick", None)
            if fn is not None:
                fn(immediate=immediate)

    # -- reads (recent-data query entry points) ----------------------------

    def query_range(self, req, clip_start_ns: "int | None" = None):
        """TraceQL metrics over this tenant's local blocks (`QueryRange`
        `instance.go:487-556`); raises, as the reference does, when the
        local-blocks processor is not enabled."""
        lb = self.processors.get("local-blocks")
        if lb is None:
            raise RuntimeError("local-blocks processor not enabled")
        return lb.query_range(req, clip_start_ns=clip_start_ns)

    def get_metrics(self, query: str, group_by, max_series: int = 1000):
        """Span-metrics summary (`GetMetrics` `instance.go:475`); raises
        as `query_range` does without local blocks."""
        lb = self.processors.get("local-blocks")
        if lb is None:
            raise RuntimeError("local-blocks processor not enabled")
        return lb.get_metrics(query, group_by, max_series=max_series)
