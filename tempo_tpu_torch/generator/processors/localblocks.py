"""local-blocks processor: RF1 trace blocks inside the generator.

Analog of `modules/generator/processor/localblocks/processor.go:53-81`:
spans pushed to the generator also land in live traces → head WAL block →
complete RF1 columnar blocks (push/cut/complete/flush/delete loops
`processor.go:151,291,316,336,404,476`), optionally flushed to object
storage. Serves recent-data reads: TraceQL metrics `QueryRange`
(`query_range.go:25`) and the span-metrics summary `GetMetrics`
(`processor.go:494` → `pkg/traceqlmetrics`).

These RF1 blocks are exactly the blocks the frontend's metrics path is
allowed to read (`blockMetasForSearch(..., rf=1)`), which is how historical
TraceQL metrics avoid the RF3 triple-count.

Counterpart of `tempo_tpu/generator/processors/localblocks.py`, host code
over the port's `ingester.instance.TenantInstance` (RF1). `query_range`
runs its evaluator's grids, and stamps its scan views, on the processor's
`device` (`cuda` unless `"cpu"` is asked for: the instance's).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Iterator, Sequence

import numpy as np

from tempo_tpu_torch.backend.raw import RawWriter, block_keypath
from tempo_tpu_torch.device import resolve_device
from tempo_tpu_torch.ingester.instance import InstanceConfig, TenantInstance
from tempo_tpu_torch.model.span_batch import SpanBatch
from tempo_tpu_torch.traceql.memview import view_from_traces
from tempo_tpu_torch.traceql.metrics_summary import MetricsResults, get_metrics


@dataclasses.dataclass
class LocalBlocksConfig:
    data_dir: str = ""                      # empty = temp dir
    max_live_traces: int = 0
    max_block_duration_s: float = 60.0
    max_block_bytes: int = 500_000_000
    trace_idle_s: float = 5.0
    flush_to_storage: bool = False          # processor.go FlushToStorage
    complete_block_timeout_s: float = 3600.0


class LocalBlocksProcessor:
    name = "local-blocks"

    def __init__(self, tenant: str, cfg: LocalBlocksConfig | None = None,
                 flush_writer: RawWriter | None = None,
                 now: Callable[[], float] = time.time, device=None) -> None:
        self.cfg = cfg or LocalBlocksConfig()
        self.tenant = tenant
        self.now = now
        self.device = resolve_device(device)
        self.flush_writer = flush_writer if self.cfg.flush_to_storage else None
        data_dir = self.cfg.data_dir
        if not data_dir:
            import tempfile
            data_dir = tempfile.mkdtemp(prefix="tempo-localblocks-")
        self.inst = TenantInstance(
            tenant,
            wal_dir=os.path.join(data_dir, "wal"),
            local_dir=os.path.join(data_dir, "blocks"),
            cfg=InstanceConfig(
                max_block_duration_s=self.cfg.max_block_duration_s,
                max_block_bytes=self.cfg.max_block_bytes,
                trace_idle_s=self.cfg.trace_idle_s,
                replication_factor=1),
            now=now)
        self.inst.replay()

    # -- ingest ------------------------------------------------------------

    def push_batch(self, sb: SpanBatch) -> None:
        """Group the batch back by trace and append to live traces
        (deterministic, `processor.go:155`)."""
        by_id: dict[bytes, list[dict]] = {}
        for s in sb.to_span_dicts():
            by_id.setdefault(s["trace_id"], []).append(s)
        for tid, spans in by_id.items():
            self.inst.push_trace(tid, spans)

    # -- background ticks --------------------------------------------------

    def cut_tick(self, immediate: bool = False) -> None:
        """One maintenance pass: cut idle traces, maybe seal + complete the
        head block, flush to storage if configured, delete old."""
        self.inst.cut_complete_traces(immediate=immediate)
        sealed = self.inst.cut_block_if_ready(immediate=immediate)
        if sealed is not None and sealed.segments():
            meta = self.inst.complete_block(sealed)
            if self.flush_writer is not None:
                kp = block_keypath(meta.block_id, self.tenant)
                src = self.inst.local_backend
                for name in src.find(kp):
                    self.flush_writer.write(name, kp, src.read(name, kp))
            # mark terminal either way: without flush-to-storage the block's
            # lifecycle ends locally, and the timeout below must reclaim it
            self.inst.mark_flushed(meta.block_id)
        self.inst.delete_old_flushed(self.cfg.complete_block_timeout_s)

    # -- reads -------------------------------------------------------------

    def _views(self, freq=None) -> Iterator[tuple]:
        from tempo_tpu_torch.block.fetch import scan_views
        traces = self.inst.all_recent_traces()
        if traces:
            v = view_from_traces(traces)
            yield v, np.arange(v.n)
        for b in self.inst.complete_blocks():
            yield from scan_views(b, freq, device=self.device)

    def views_for_matview(self) -> Iterator[tuple]:
        """Stored-state scan views for the materialized-view backfill
        (`matview`): a grid (re)build runs the recompute
        evaluator over exactly these views, so a fresh grid cannot
        disagree with `query_range` over the same window. No bloom
        prefilter — rebuilds are rare and must see every span."""
        return self._views(None)

    def query_range(self, req, clip_start_ns: int | None = None,
                    clip_end_ns: int | None = None):
        """TraceQL metrics over recent data (`QueryRange` `query_range.go:25`):
        job-level series on the caller's step grid."""
        from tempo_tpu_torch.traceql.engine import compile_query
        from tempo_tpu_torch.traceql.engine_metrics import MetricsEvaluator

        _, freq = compile_query(req.query, req.start_ns, req.end_ns)
        ev = MetricsEvaluator(req, clip_start_ns, clip_end_ns,
                              device=self.device)
        for view, cand in self._views(freq):
            if len(cand):
                ev.observe(view)
        return ev.results()

    def get_metrics(self, query: str, group_by: Sequence[str],
                    max_series: int = 1000) -> MetricsResults:
        """Span-metrics summary over recent data (`GetMetrics`
        `processor.go:494` → `pkg/traceqlmetrics`)."""
        from tempo_tpu_torch.traceql.engine import compile_query

        _, freq = compile_query(query or "{ }")
        return get_metrics(query, group_by, self._views(freq),
                           max_series=max_series)
