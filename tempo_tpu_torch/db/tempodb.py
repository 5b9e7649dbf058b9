"""tempodb facade: Reader/Writer/Compactor over backend + blocks.

Counterpart of `tempo_tpu/db/tempodb.py`. The read side is ported whole:
search, query_range (the fused device plane with its host fallback),
find_trace_by_id over the blocklist the poller keeps, and the sidecar
fold tier's read half (`sidecar_plan`, `sidecar_series` over sidecars
already in the store), and so is the cold tier: compaction (the merge on
the instance's device, through the scheduler's compaction class),
retention and the sidecar backfill. The device plane lives on the
instance's torch device (`cuda` unless `device="cpu"`), or with
`plane_mesh` over a mesh's 'data' shards (`parallel.mesh.Mesh`; the grid
reduces onto the (0, 0) device). Unlike the reference, a failed device
compaction does not fall back to the host merge: the failure reaches
the compaction loop, which logs it; the host merge runs only under
`compactor.device: false`.

Analog of `tempodb/tempodb.go:74-116` and its loops: block write (ingester
flush target), trace lookup fan-out with time/shard pruning (`Find`
`tempodb.go:624` includeBlock), blocklist polling (`EnablePolling`
`tempodb.go:551`), compaction + retention loops (`EnableCompaction`
`tempodb.go:518`, `compactor.go:79-185`). Loops run as explicit `*_once`
ticks (tests) or daemon threads (services).
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Callable, Iterable, Sequence

from tempo_tpu_torch.backend import meta as bm
from tempo_tpu_torch.backend.raw import RawReader, RawWriter
from tempo_tpu_torch.block.reader import BackendBlock
from tempo_tpu_torch.block.writer import write_block
from tempo_tpu_torch.db import compactor as comp
from tempo_tpu_torch.db.blocklist import List
from tempo_tpu_torch.db.pool import Pool
from tempo_tpu_torch.db.poller import Poller, PollerConfig
from tempo_tpu_torch.model.combine import combine_spans
from tempo_tpu_torch.obs import Registry
from tempo_tpu_torch.obs import querystats

log = logging.getLogger("tempo_tpu_torch.db")


@dataclasses.dataclass
class TempoDBConfig:
    poller: PollerConfig = dataclasses.field(default_factory=PollerConfig)
    compactor: comp.CompactorConfig = dataclasses.field(default_factory=comp.CompactorConfig)
    pool_workers: int = 30
    dedicated_columns: tuple = ()
    row_group_rows: int = 50_000
    # device read plane (block/device_scan.py): per-block resident column
    # cache + fused first pass; LRU under a device-byte budget
    device_plane: bool = True
    plane_budget_bytes: int = 1 << 30
    plane_max_blocks: int = 64
    plane_host_budget_bytes: int = 4 << 30
    # a `parallel.mesh.Mesh` for a sharded read plane (span columns split
    # over its 'data' axis), or None
    plane_mesh: object = None


class TempoDB:
    def __init__(self, r: RawReader, w: RawWriter,
                 cfg: TempoDBConfig | None = None,
                 registry: Registry | None = None,
                 now: Callable[[], float] = time.time,
                 device=None):
        from tempo_tpu_torch.device import resolve_device

        self.device = resolve_device(device)
        self.r = r
        self.w = w
        self.cfg = cfg or TempoDBConfig()
        self.now = now
        self.blocklist = List()
        self.poller = Poller(r, w, self.cfg.poller, now=now)
        self.pool = Pool(self.cfg.pool_workers)
        self.selector = comp.TimeWindowBlockSelector(self.cfg.compactor)
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._block_cache: dict[tuple[str, str], BackendBlock] = {}
        self.planes = None
        if self.cfg.device_plane:
            from tempo_tpu_torch.db.plane_cache import PlaneCache

            self.planes = PlaneCache(self.cfg.plane_budget_bytes,
                                     self.cfg.plane_max_blocks,
                                     self.cfg.plane_host_budget_bytes,
                                     mesh=self.cfg.plane_mesh,
                                     device=self.device)
        # read-plane routing counters: how many block scans took the fused
        # device path vs the host engine (tests + /metrics)
        self.plane_stats = {"fused_metric_blocks": 0, "host_metric_blocks": 0}
        # device cold tier: compaction + sidecar-fold counters (tests,
        # /metrics and the smoke read these)
        self.compaction_stats = {
            "blocks": 0,             # input blocks through the device route
            "spans": 0,              # spans merged/deduped on device
            "device_seconds": 0.0,   # wall time inside the merge dispatch
            "sidecars_written": 0,   # compaction outputs + backfills
            "sidecar_folds": 0,      # historical blocks answered by folds
            "sidecar_fallbacks": 0,  # fold-eligible blocks that re-scanned
        }
        self.obs = registry if registry is not None else Registry()
        self._register_obs(self.obs)

    def _register_obs(self, reg: Registry) -> None:
        reg.counter_func(
            "tempo_read_plane_fused_metric_blocks_total",
            lambda: [((), self.plane_stats["fused_metric_blocks"])],
            help="Metrics blocks answered by the fused device plane")
        reg.counter_func(
            "tempo_read_plane_host_metric_blocks_total",
            lambda: [((), self.plane_stats["host_metric_blocks"])],
            help="Metrics blocks answered by the host engine")
        reg.counter_func(
            "tempo_read_plane_fallback_total",
            lambda: [((k[len("fallback_"):],), v)
                     for k, v in self.plane_stats.items()
                     if k.startswith("fallback_")],
            help="Host-engine fallbacks by cause (query_shape, predicate, "
                 "group, value, grid_size, window, times, disabled)",
            labels=("cause",))

        def plane_stat(key):
            def fn():
                if self.planes is None:
                    return []
                return [((), self.planes.stats()[key])]
            return fn

        for key in ("entries", "device_bytes", "host_bytes",
                    "device_budget_bytes", "host_budget_bytes"):
            reg.gauge_func(f"tempo_read_plane_cache_{key}", plane_stat(key),
                           help=f"Device read-plane cache {key.replace('_', ' ')}")
        reg.counter_func("tempo_read_plane_cache_hits_total",
                         plane_stat("hits"),
                         help="Device read-plane cache hits")
        reg.counter_func("tempo_read_plane_cache_misses_total",
                         plane_stat("misses"),
                         help="Device read-plane cache misses")
        self.compaction_duration = reg.histogram(
            "tempo_compactor_cycle_duration_seconds",
            "One per-tenant compaction sweep (selection + block rewrites)")

        def comp_stat(key):
            return lambda: [((), self.compaction_stats[key])]

        for key, hlp in (
                ("blocks", "Input blocks compacted via the device route"),
                ("spans", "Spans merged/deduped/re-sorted on device"),
                ("device_seconds",
                 "Wall seconds inside device compaction-merge dispatches"),
                ("sidecars_written",
                 "Sketch sidecars written (compaction outputs, block cuts, "
                 "backfills)"),
                ("sidecar_folds",
                 "Historical query blocks answered by sidecar folds"),
                ("sidecar_fallbacks",
                 "Fold-eligible blocks that fell back to the host scan")):
            reg.counter_func(f"tempo_compaction_{key}_total", comp_stat(key),
                             help=hlp)

    # -- writer ------------------------------------------------------------

    def write_block(self, tenant: str, traces: Iterable[tuple[bytes, list[dict]]],
                    *, block_id: str | None = None,
                    replication_factor: int = 3) -> bm.BlockMeta:
        meta = write_block(
            self.w, tenant, traces, block_id=block_id,
            dedicated_columns=list(self.cfg.dedicated_columns),
            row_group_rows=self.cfg.row_group_rows,
            replication_factor=replication_factor)
        self.blocklist.update(tenant, add=[meta])
        return meta

    # -- reader ------------------------------------------------------------

    def backend_block(self, meta: bm.BlockMeta) -> BackendBlock:
        key = (meta.tenant_id, meta.block_id)
        b = self._block_cache.get(key)
        if b is None or b.meta.size_bytes != meta.size_bytes:
            # size change means the object was rewritten; otherwise refresh
            # the meta reference and keep the parsed parquet footer
            b = self._block_cache[key] = BackendBlock(self.r, meta)
        else:
            b.meta = meta
        return b

    def _evict_dead_blocks(self, tenant: str) -> None:
        live = {m.block_id for m in self.blocklist.metas(tenant)}
        for key in [k for k in self._block_cache
                    if k[0] == tenant and k[1] not in live]:
            del self._block_cache[key]
        if self.planes is not None:
            self.planes.drop_dead(tenant, live)

    def scan_source(self, meta: bm.BlockMeta, req,
                    row_groups: Sequence[int] | None = None,
                    cached_only: bool = False):
        """(view, candidate_rows) stream for one block: the plane cache's
        fused device first pass when enabled, else a direct parquet scan.
        The shared read path behind search, query_range, and tag
        autocomplete. `cached_only` serves from the cache ONLY when the
        block is already resident — metadata endpoints must not pay
        full-block reads (or thrash the LRU) for a miss when a projected
        one-column scan suffices."""
        from tempo_tpu_torch.block.fetch import scan_views

        if self.planes is not None:
            if cached_only:
                entry = self.planes.peek(meta.tenant_id, meta.block_id)
                if entry is not None:
                    return entry.scan(req, row_groups)
            else:
                return self.planes.get(self.backend_block(meta)).scan(
                    req, row_groups)
        return scan_views(self.backend_block(meta), req,
                          row_groups=row_groups, device=self.device)

    def blocks(self, tenant: str, start_s: float | None = None,
               end_s: float | None = None,
               shard_bounds: tuple[bytes, bytes] | None = None) -> list[bm.BlockMeta]:
        """Blocklist pruned by time overlap and trace-id shard bounds
        (includeBlock `tempodb.go:624`)."""
        lo = shard_bounds[0].hex() if shard_bounds else None
        hi = shard_bounds[1].hex() if shard_bounds else None
        out = []
        metas = self.blocklist.metas(tenant)
        for m in metas:
            if start_s is not None and m.end_time < start_s:
                continue
            if end_s is not None and m.start_time > end_s:
                continue
            if lo is not None and m.max_trace_id and m.max_trace_id < lo:
                continue
            if hi is not None and m.min_trace_id and m.min_trace_id > hi:
                continue
            out.append(m)
        # time/shard prunes into the ambient query scope (no-op outside a
        # request — poll and compaction loops call this too)
        querystats.add(blocks_skipped=len(metas) - len(out))
        return out

    def find_trace_by_id(self, tenant: str, trace_id: bytes,
                         start_s: float | None = None,
                         end_s: float | None = None) -> list[dict] | None:
        """Fan out across candidate blocks on the worker pool, combine spans
        (RF dedup via combine_spans)."""
        metas = self.blocks(tenant, start_s, end_s)
        if not metas:
            return None
        results, errors = self.pool.run_jobs(
            metas, lambda m: self.backend_block(m).find_trace_by_id(trace_id))
        if errors and not results:
            raise errors[0]
        found = [spans for spans in results if spans]
        return combine_spans(*found) if found else None

    def search(self, tenant: str, query: str, *, limit: int = 20,
               start_s: float | None = None, end_s: float | None = None,
               metas: Sequence[bm.BlockMeta] | None = None,
               row_groups: Sequence[int] | None = None):
        """TraceQL search over backend blocks (`tempodb.Search/Fetch`
        `tempodb.go:368,481`): compile once, stream row-group views from
        every candidate block through the engine. The first pass rides the
        device plane cache when enabled (one fused dispatch per block)."""
        from tempo_tpu_torch.traceql.engine import compile_query, execute_search

        q, req = compile_query(query,
                               int((start_s or 0) * 1e9), int((end_s or 0) * 1e9))
        if metas is None:
            metas = self.blocks(tenant, start_s, end_s)
        views = (v for m in metas
                 for v in self.scan_source(m, req, row_groups))
        return execute_search(q, views, limit=limit,
                              start_ns=int((start_s or 0) * 1e9),
                              end_ns=int((end_s or 0) * 1e9))

    def query_range(self, tenant: str, req, *,
                    metas: Sequence[bm.BlockMeta] | None = None,
                    row_groups: Sequence[int] | None = None,
                    clip_start_ns: int | None = None,
                    clip_end_ns: int | None = None):
        """TraceQL metrics over backend blocks: the raw MetricsEvaluator
        path (`engine_metrics.go:802`); returns job-level TimeSeries for a
        frontend combiner (or final series when used standalone). The clip
        bounds restrict observation without changing the step grid.

        Blocks whose query shape the device plane supports run the WHOLE
        aggregation — mask, clip, step bucketing, group-by, metric scatter,
        including the log2 histogram axis behind quantile_over_time — as
        one fused dispatch per resident block; unsupported blocks/shapes
        fall back to the host engine, and both merge through the job-level
        series combiner (sums/min/max — the same tensor-add combine the
        frontend applies across jobs)."""
        from tempo_tpu_torch.traceql import ast as A
        from tempo_tpu_torch.traceql.engine import compile_query
        from tempo_tpu_torch.traceql.engine_metrics import (MetricsEvaluator,
                                                      SeriesCombiner,
                                                      grid_series)

        _, freq = compile_query(req.query, req.start_ns, req.end_ns)
        if metas is None:
            metas = self.blocks(tenant, req.start_ns / 1e9, req.end_ns / 1e9)
        ev = MetricsEvaluator(req, clip_start_ns, clip_end_ns, batched=True,
                              device=self.device)
        # the fused path is exact only when the pushdown IS the filter:
        # a single filter pipeline that is pure-AND (all_conditions, the
        # optimize() precondition of engine_metrics.go:885) or a pure OR
        # of pushed compares (the OR mask of exact terms is exact —
        # round 5), and no compare() stage
        fusable = (self.planes is not None
                   and (ev.fetch_req.all_conditions
                        or ev.fetch_req.pure_disjunction)
                   and all(isinstance(s, A.SpansetFilter) for s in ev.q.stages)
                   and ev.m.kind != A.MetricsKind.COMPARE)
        preds = [c for c in ev.fetch_req.conditions if c.op is not None]
        # phase 1: LAUNCH every supported block's fused grid (async — the
        # dispatches pipeline their device round trips) and run the host
        # engine over unsupported blocks meanwhile
        handles: list = []
        fused_blocks: list = []
        fused_parts: list = []
        MAX_INFLIGHT = 8   # bound live device grids (hist grids are big)

        from tempo_tpu_torch.obs.runtime import kernel_timer

        def drain(to: int) -> None:
            while len(handles) > to:
                t0 = time.perf_counter_ns()
                with kernel_timer("plane_metrics_grid", self.device), \
                        querystats.stage("device_scan"):
                    labels, main, cnt, vcnt = handles.pop(0).fetch()
                querystats.add(kernel_wall_ns=time.perf_counter_ns() - t0)
                fused_parts.append(grid_series(ev.m, labels, main, cnt,
                                               vcnt, moments=ev._moments))

        for m in metas:
            handle = cb = bail_cause = None
            if fusable:
                cb = self.planes.get(self.backend_block(m))
                handle, bail_cause = cb.plane.metrics_grid(
                    ev.m, preds, ev.fetch_req.all_conditions,
                    req.start_ns, req.end_ns, req.step_ns,
                    clip_start_ns, clip_end_ns, row_groups,
                    moments=ev._moments)
            if handle is not None:
                self.plane_stats["fused_metric_blocks"] += 1
                # the fused path never surfaces row bytes to the host —
                # charge the block slice's stored size as inspected
                n_rg = max(m.row_group_count, 1)
                frac = (len(row_groups) / n_rg) if row_groups else 1.0
                querystats.add(inspected_bytes=int(m.size_bytes * frac))
                handles.append(handle)
                fused_blocks.append(cb)
                drain(MAX_INFLIGHT - 1)   # pipeline, bounded residency
            else:
                self.plane_stats["host_metric_blocks"] += 1
                # distinguish WHY (round-4 weak #4: a float-attr workload
                # silently lost the fused win with no visible cause). The
                # cause rides metrics_grid's RETURN — never read back off
                # shared plane state, where a concurrent query bailing on
                # the same cached plane could overwrite it (ADVICE r5 #2)
                cause = (bail_cause or "unknown") if fusable \
                    else ("disabled" if self.planes is None
                          else "query_shape")
                k = f"fallback_{cause}"
                self.plane_stats[k] = self.plane_stats.get(k, 0) + 1
                for view, cand in self.scan_source(m, freq, row_groups):
                    if len(cand):
                        ev.observe(view)
        drain(0)
        if not fused_parts:
            return ev.results()
        comb = SeriesCombiner(ev.m.kind, req.n_steps)
        comb.add_all(ev.results())
        for part in fused_parts:
            comb.add_all(part)
        out = list(comb.series.values())
        self._fused_exemplars(out, ev, fused_blocks, req)
        return out

    def _fused_exemplars(self, series, ev, fused_blocks, req) -> None:
        """Best-effort exemplars for the fused path (the grid kernel keeps
        no row identities): sample a few matching rows from the first
        cached view and attach trace-id exemplars to their group's series,
        like `MetricsEvaluator._note_exemplars`."""
        import numpy as np

        from tempo_tpu_torch.block.fetch import condition_mask
        from tempo_tpu_torch.traceql.engine_metrics import _fmt_label
        from tempo_tpu_torch.traceql.eval import eval_expr

        if req.exemplars <= 0 or not fused_blocks:
            return
        budget = req.exemplars - sum(len(s.exemplars) for s in series)
        if budget <= 0:
            return
        cb = fused_blocks[0]
        if not cb.views:
            return
        view = cb.views[0]
        tid = view.col("trace:id")
        st = view.col("__startTime")
        if tid is None or st is None:
            return
        # sample only rows inside the step window AND the observation clip,
        # like the host path (observe() filters before _note_exemplars)
        mask = condition_mask(view, ev.fetch_req)
        ts = st.values
        mask = mask & (ts >= ev.clip_start_ns) & (ts < ev.clip_end_ns)
        rows = np.flatnonzero(mask)[:min(8, budget)]
        if len(rows) == 0:
            return
        gcol = eval_expr(view, ev.m.by[0]) if ev.m.by else None
        gname = str(ev.m.by[0]) if ev.m.by else None
        dur = view.col("duration")
        by_group: dict = {}
        for s in series:
            d = dict(s.labels)
            key = d.get(gname) if gname is not None else ""
            by_group.setdefault(key, s)
        for r in rows:
            if gcol is not None:
                if not gcol.exists[r]:
                    continue
                key = _fmt_label(gcol.values[r], gcol.t)
            else:
                key = ""
            target = by_group.get(key)
            if target is None or len(target.exemplars) >= 2:
                continue
            target.exemplars.append({
                "traceId": str(tid.values[r]),
                "value": float(dur.values[r]) if dur is not None else 0.0,
                "timestampMs": int(st.values[r] / 1e6),
            })

    # -- polling -----------------------------------------------------------

    def poll_now(self) -> None:
        metas, compacted = self.poller.do()
        self.blocklist.apply_poll_results(metas, compacted)
        for tenant in {k[0] for k in self._block_cache}:
            self._evict_dead_blocks(tenant)

    def enable_polling(self, interval_s: float | None = None) -> None:
        self._spawn(self._poll_loop, interval_s or self.cfg.poller.poll_interval_s)

    # -- compaction / retention -------------------------------------------

    def compact_tenant_once(self, tenant: str,
                            owns: Callable[[str], bool] = lambda key: True) -> int:
        """One compaction sweep for a tenant; `owns` is the ring-ownership
        predicate keyed like `modules/compactor/compactor.go:190`."""
        t0 = time.perf_counter()
        metas = self.blocklist.metas(tenant)
        jobs = self.selector.blocks_to_compact(metas)
        done = 0
        for group in jobs:
            key = f"{tenant}-{group[0].block_id}"
            if not owns(key):
                continue
            out = self._compact_group(tenant, group)
            self.blocklist.update(
                tenant, add=out, remove=group,
                compacted_add=[bm.CompactedBlockMeta(m, self.now()) for m in group])
            # compacted-away inputs must not serve stale cached state:
            # drop their parquet handles, device planes, AND any cached
            # sidecar-fold results immediately (not at the next poll)
            for m in group:
                self._block_cache.pop((tenant, m.block_id), None)
                if self.planes is not None:
                    self.planes.drop(tenant, m.block_id)
            done += 1
        self.compaction_duration.observe(time.perf_counter() - t0)
        return done

    def _compact_group(self, tenant: str, group: list) -> list:
        """Compaction of one input group: the device route (the merge on
        this instance's device) unless `compactor.device` is off. Its
        failure propagates; the reference's host fallback is not kept."""
        cfg = self.cfg.compactor
        if cfg.device:
            return comp.compact_device(
                self.r, self.w, tenant, group, cfg,
                stats=self.compaction_stats,
                dispatch=self._compaction_dispatch(tenant),
                device=self.device)
        return comp.compact(self.r, self.w, tenant, group, cfg)

    def _compaction_dispatch(self, tenant: str):
        """Compaction-class admission to the shared device scheduler:
        merge dispatches queue BEHIND ingest/query work (and behind the
        anti-starvation floor, sched.compaction_min_share)."""
        from tempo_tpu_torch import sched

        return lambda fn: sched.run(fn, kernel="compaction_merge",
                                    priority=sched.PRIO_COMPACTION,
                                    tenant=tenant)

    def retention_once(self, tenant: str) -> tuple[list, list]:
        marked, deleted = comp.do_retention(
            self.r, self.w, tenant, self.blocklist.metas(tenant),
            self.blocklist.compacted_metas(tenant), self.cfg.compactor, self.now)
        self.blocklist.update(
            tenant, remove=marked,
            compacted_add=[bm.CompactedBlockMeta(m, self.now()) for m in marked],
            compacted_remove=[c for c in self.blocklist.compacted_metas(tenant)
                              if c.meta.block_id in set(deleted)])
        return marked, deleted

    def enable_compaction(self, interval_s: float = 30.0,
                          owns: Callable[[str], bool] = lambda key: True) -> None:
        self._spawn(self._compaction_loop, interval_s, owns)

    # -- sketch sidecars: historical folds --------------------------------

    def sidecar_plan(self, query: str):
        """FoldPlan when `query` is answerable from sidecars, else None."""
        from tempo_tpu_torch.block import sidecar as sdc

        return sdc.eligible_plan(query)

    def sidecar_series(self, tenant: str, req, meta, plan,
                       clip_end_ns: int | None = None):
        """One historical block answered from its sidecar: job-level
        TimeSeries for the frontend combiner, or None → caller re-scans
        (missing/unreadable/domain-mismatched sidecar). Fold results ride
        the plane cache keyed by (block, query window) and are evicted
        with the block."""
        from tempo_tpu_torch.block import sidecar as sdc

        fkey = (req.query, req.start_ns, req.end_ns, req.step_ns,
                clip_end_ns or 0)
        if self.planes is not None:
            hit = self.planes.fold_get(tenant, meta.block_id, fkey)
            if hit is not None:
                self.compaction_stats["sidecar_folds"] += 1
                return hit
        sc = sdc.read_sidecar(self.r, tenant, meta.block_id)
        series = None if sc is None else sdc.fold_series(
            sc, meta, req, plan, clip_end_ns)
        if series is None:
            self.compaction_stats["sidecar_fallbacks"] += 1
            return None
        self.compaction_stats["sidecar_folds"] += 1
        if self.planes is not None:
            self.planes.fold_put(tenant, meta.block_id, fkey, series)
        return series

    def backfill_sidecars_once(self, tenant: str,
                               limit: int | None = None) -> int:
        """Attach sidecars to up to `limit` existing blocks without one
        (low-priority compaction-class work; the compactor service calls
        this each sweep so history converges to fold-served)."""
        cfg = self.cfg.compactor
        if limit is None:
            limit = cfg.backfill_sidecars
        if limit <= 0 or not cfg.sidecars:
            return 0
        run = self._compaction_dispatch(tenant)
        done = 0
        for m in self.blocklist.metas(tenant):
            if done >= limit:
                break
            if m.sidecar:
                continue
            if run(lambda m=m: comp.backfill_sidecar(
                    self.r, self.w, tenant, m, self.compaction_stats,
                    device=self.device)):
                done += 1
        return done

    # -- loops -------------------------------------------------------------

    def _spawn(self, fn, *args) -> None:
        t = threading.Thread(target=fn, args=args, daemon=True)
        t.start()
        self._threads.append(t)

    def _poll_loop(self, interval_s: float) -> None:
        while not self._stop.wait(interval_s):
            try:
                self.poll_now()
            except Exception:
                log.exception("poll cycle failed")

    def _compaction_loop(self, interval_s: float, owns) -> None:
        while not self._stop.wait(interval_s):
            for tenant in self.blocklist.tenants():
                try:
                    self.compact_tenant_once(tenant, owns)
                    self.retention_once(tenant)
                except Exception:
                    log.exception("compaction cycle failed (tenant=%s)", tenant)

    def shutdown(self) -> None:
        self._stop.set()
        self.pool.shutdown()
