"""spanmetrics processor: OTel-standard RED metrics from span batches.

Counterpart of `tempo_tpu/generator/processors/spanmetrics.py`, with the
reference semantics of `modules/generator/processor/spanmetrics/
spanmetrics.go`:

- metric families (`spanmetrics.go:27-31`): `traces_spanmetrics_calls_total`,
  `traces_spanmetrics_latency` (histogram, seconds),
  `traces_spanmetrics_size_total` (bytes), `traces_target_info` (gauge 1);
- intrinsic dimensions service / span_name / span_kind / status_code
  (+ status_message opt), custom dimensions from span and resource
  attributes (`spanmetrics.go:158-268`);
- filter policies include/exclude, span multiplier, exemplars = trace ids.

One host staging pass builds the interned label-id rows [N, L] and
resolves series slots; then one fused device update adds calls,
latency histogram, size and the quantile sidecars together, in place
(`ops.pages.fused_step` → the paged fused update, K1: the CUDA kernel on
the card, its plain version on the host). Paged state (a page pool is
active and `max_active_series` splits into its pages) is updated in the
pool's arenas through the planes' page tables; dense state, the
reference's default, through identity page tables over the dense
families' and sidecars' own trash-paged arenas (`_dense_fused`). The
reference's dense step, `_fused_update_impl`, is kept here as composed
PyTorch scatters: the tests and the chip smoke hold K1 against it, and
no write path runs it.

Quantile sidecars (`sketch`): "dd", the ~1,269-bucket DDSketch plane;
"moments", the ~15-float moments row of `ops/moments.py`, answered by
the host maxent solver (failed solves fall back to the classic latency
histogram); "both", moments answers with DDSketch fallback.
`compact_state` stores counts and bucket grids as int32 and the latency
sum as a bf16 Kahan pair (the reference's documented ~1% envelope for
that sum). The reference runs compact state only on its Pallas tier and
otherwise warns and stays f32; the port's only paged route is its K1
kernel, which carries the compact semantics, so compact always applies
to paged state. Dense state has no compact tier: asking for it raises
`ValueError` (the reference warns and stays f32).

Routes (`use_scheduler`, on by default as in the reference): with a
process device scheduler configured and enabled (`tempo_tpu_torch.sched.
configure`), a push resolves its slots on the host and submits its rows
to the scheduler (`_submit_rows`), whose coalescer merges the pushes of a
batch window into one packed [4, bucket] matrix per processor (pad rows
carry slot -1, which K1 drops) and dispatches it on its worker thread:
one host-to-device copy and one K1 launch per merged window, on dense
and paged state alike. With the flag off, or no scheduler configured or
a disabled one, the push takes the direct route unchanged: one packed
batch and one K1 launch per push. Quantile reads flush the scheduler
first.

The staged fast route (`push_staged`, `push_from_recs`; the default
config's intrinsic dimensions only, see `supports_staged_fast_path`)
skips the SpanBatch: the C++ resolve (`native.spanmetrics_resolve` over
`otlp_stage` records, or `native.spanmetrics_from_recs` over `otlp_scan`
records and the payload) builds the label rows, resolves them in the
native row table, applies the ingestion-slack filter and stamps
`last_seen` in one pass, leaving slots and the packed [3, cap] rows of
durations and sizes; only new series come back to Python
(`SeriesTable.apply_misses`). On the direct route a push is then one
host [4, cap] matrix (those rows and the weight row: ones, or the
sampled Horvitz-Thompson weights), one copy and one K1 launch; on the
scheduler route the trimmed rows are submitted as above, staged in the
buffer ring of the ingest pipeline (`generator/pipeline.py`) when
`SchedConfig.pipeline_depth` > 0.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from tempo_tpu_torch import native
from tempo_tpu_torch import sched as sched_mod
from tempo_tpu_torch.generator.pipeline import IngestPipeline
from tempo_tpu_torch.model.interner import INVALID_ID
from tempo_tpu_torch.model.span_batch import SpanBatch, _pad_rows
from tempo_tpu_torch.ops import cuda_kernels, moments
from tempo_tpu_torch.ops import pages as op
from tempo_tpu_torch.ops import sketches
from tempo_tpu_torch.parallel import serving
from tempo_tpu_torch.parallel.mesh import (gather_rows, plane_width,
                                           scatter_rows)
from tempo_tpu_torch.registry import metrics as m
from tempo_tpu_torch.registry.pages import PagedPlane
from tempo_tpu_torch.registry.registry import (DEFAULT_HISTOGRAM_EDGES,
                                               ManagedRegistry, _pad_len,
                                               _state_bytes)
from tempo_tpu_torch.utils import tracing
from tempo_tpu_torch.utils.spanfilter import FilterPolicy, compile_policies

_LOG = logging.getLogger("tempo_tpu_torch.spanmetrics")

# roles of the fused step (`_paged_planes`, `_dense_views`) the reads take
_BUCKETS, _DD_ZEROS, _DD_COUNTS, _MOMENTS = 4, 5, 6, -1

_KIND_STRS = ("SPAN_KIND_UNSPECIFIED", "SPAN_KIND_INTERNAL", "SPAN_KIND_SERVER",
              "SPAN_KIND_CLIENT", "SPAN_KIND_PRODUCER", "SPAN_KIND_CONSUMER")
_STATUS_STRS = ("STATUS_CODE_UNSET", "STATUS_CODE_OK", "STATUS_CODE_ERROR")


@dataclasses.dataclass
class SpanMetricsConfig:
    """Subset of `modules/generator/processor/spanmetrics/config.go`.

    `kernel` ("xla" | "pallas") and `pallas_interpret` are the reference's
    update-tier knobs, accepted with the values its tier resolver takes
    so reference configs load unchanged; any other value raises. They
    select nothing here: on the card every value runs K1 (the CUDA
    kernel `ops.cuda_kernels.paged_fused_update`), and state on the host
    runs K1's plain PyTorch version."""

    histogram_buckets: tuple[float, ...] = DEFAULT_HISTOGRAM_EDGES
    intrinsic_dimensions: tuple[str, ...] = ("service", "span_name", "span_kind",
                                             "status_code")
    dimensions: tuple[str, ...] = ()          # extra span/resource attr keys
    enable_target_info: bool = False
    filter_policies: tuple[FilterPolicy, ...] = ()
    span_multiplier_key: str = ""             # attr holding a weight multiplier
    enable_quantile_sketch: bool = True       # quantile sidecar per series
    # quantile sketch tier: "dd" (DDSketch, ≤1% relative error), "moments"
    # (the moments row, maxent quantiles) or "both" (moments answers,
    # DDSketch fallback)
    sketch: str = "dd"
    moments_k: int = 12                       # moment count (2..16)
    kernel: str = "xla"                       # the reference's update tier
    pallas_interpret: bool = False            # the reference's parity switch
    # int32 counts and bucket grids, bf16 Kahan-pair latency sums
    compact_state: bool = False
    sketch_rel_err: float = 0.01              # DDSketch relative-error budget
    sketch_min_s: float = 1e-6                # 1µs .. ~28h latency range
    sketch_max_s: float = 1e5
    sketch_max_series: int = 16384            # device bound for the sketch plane
    subprocessors: tuple[str, ...] = ("count", "latency", "size")
    # route fused updates through the process device scheduler
    # (tempo_tpu_torch.sched): many small pushes coalesce into one padded
    # pow-2 dispatch. The direct route is taken whenever this is off or
    # no scheduler is configured.
    use_scheduler: bool = True


def _fused_update_impl(calls, latency, sizes, dd, mom, slots, dur_s,
                       size_bytes, weights):
    """The reference's dense step (`tempo_tpu/generator/processors/
    spanmetrics.py:104`) as composed PyTorch scatters in its op order:
    counter, histogram, size counter, DDSketch (masked spans to row 0 with
    weight 0) and moments row, each updating its state in place. `dd` /
    `mom` may be None. Slots int [N] (negative = discard), the rest f32
    [N], on the states' device or the host."""
    dev = calls.values.device
    slots = torch.as_tensor(slots, device=dev).to(torch.int64)
    dur_s, size_bytes, weights = (
        torch.as_tensor(x, dtype=torch.float32, device=dev)
        for x in (dur_s, size_bytes, weights))
    m.counter_update(calls, slots, weights)
    m.histogram_update(latency, slots, dur_s, weights)
    m.counter_update(sizes, slots, size_bytes * weights)
    if dd is not None:
        keep = (slots >= 0) & (slots < dd.counts.shape[0])
        sketches.dd_update(dd, torch.where(keep, slots, 0), dur_s, mask=keep,
                           weights=weights)
    if mom is not None:
        mkeep = (slots >= 0) & (slots < mom.data.shape[0])
        moments.moments_update(mom, slots, dur_s, mask=mkeep, weights=weights)
    return calls, latency, sizes, dd, mom


class SpanMetricsProcessor:
    def __init__(self, registry: ManagedRegistry,
                 config: SpanMetricsConfig | None = None):
        self.cfg = cfg = config or SpanMetricsConfig()
        if cfg.sketch not in ("dd", "moments", "both"):
            raise ValueError(f"unknown sketch tier {cfg.sketch!r} (use dd | "
                             "moments | both)")
        if cfg.kernel not in ("xla", "pallas"):
            raise ValueError(f"unknown kernel tier {cfg.kernel!r} (use xla | "
                             "pallas)")
        if not isinstance(cfg.pallas_interpret, bool):
            raise ValueError(f"pallas_interpret must be a bool, not "
                             f"{cfg.pallas_interpret!r}")
        self.registry = registry
        sm = serving.active()
        if sm is not None:
            # dense shard windows must be whole pages (`_serving_mesh`)
            cap = registry.overrides.max_active_series
            registry.shard_dense_pages(
                (cap, min(cap, cfg.sketch_max_series)), sm.series_shards)
        dims = [d for d in cfg.intrinsic_dimensions] + [
            _sanitize(d) for d in cfg.dimensions]
        self._labels = tuple(dims)
        self._pool = registry.pages
        self._paged = self._pool is not None
        self.device = registry.device
        # dense families raise on compact state (no compact tier there)
        self._compact = compact = bool(cfg.compact_state)
        self.calls = registry.new_counter("traces_spanmetrics_calls_total",
                                          self._labels, compact=compact)
        self.latency = registry.new_histogram(
            "traces_spanmetrics_latency", self._labels,
            edges=cfg.histogram_buckets, compact=compact)
        # latency and size share the calls table so all three stay
        # slot-aligned (the shared table's backing adopts their planes)
        self.latency.share_table(self.calls)
        # sizes stay f32 under compact: byte sums overflow int32 at
        # 2 GB per series
        self.sizes = registry.new_counter("traces_spanmetrics_size_total",
                                          self._labels)
        self.sizes.share_table(self.calls)
        dd_on = cfg.enable_quantile_sketch and cfg.sketch in ("dd", "both")
        mom_on = cfg.enable_quantile_sketch and \
            cfg.sketch in ("moments", "both")
        self._mom_meta = None
        if mom_on:
            mk = max(2, min(int(cfg.moments_k), 16))
            if mk != cfg.moments_k:
                _LOG.warning("spanmetrics %s: moments_k %d clamped to %d "
                             "(supported range 2..16)", registry.tenant,
                             cfg.moments_k, mk)
            self._mom_meta = moments.moments_params(mk, cfg.sketch_min_s,
                                                    cfg.sketch_max_s)
        # the quantile sidecars: paged planes (`_pdd`, `_pmom`) or dense
        # states (`dd`, `mom`), over the first dd_rows slots
        self._pdd = self._pmom = self.dd = self.mom = None
        cap = registry.overrides.max_active_series
        dd_rows = min(cap, cfg.sketch_max_series)
        self._dd_on = dd_on
        self._sketch_rows = dd_rows if dd_on or mom_on else 0
        gamma, nb = sketches.dd_params(cfg.sketch_rel_err, cfg.sketch_min_s,
                                       cfg.sketch_max_s)
        if self._paged:
            pr = self._pool.page_rows
            plane_rows = -(-dd_rows // pr) * pr  # page-aligned cover
            if dd_on:
                dd_dt = "int32" if compact else "float32"
                ddc = PagedPlane(self._pool, dd_dt, nb, plane_rows,
                                 registry.tenant,
                                 role="traces_spanmetrics_latency/ddsketch")
                ddz = PagedPlane(self._pool, dd_dt, 1, plane_rows,
                                 registry.tenant,
                                 role="traces_spanmetrics_latency/ddzeros")
                self.calls.table.backing.add_plane(ddc, dd_rows)
                self.calls.table.backing.add_plane(ddz, dd_rows)
                self._pdd = (ddc, ddz, gamma, cfg.sketch_min_s, dd_rows)
            if mom_on:
                mk, mlo, mhi = self._mom_meta
                mp = PagedPlane(self._pool, "float32", moments.n_cols(mk),
                                plane_rows, registry.tenant,
                                role="traces_spanmetrics_latency/moments")
                self.calls.table.backing.add_plane(mp, dd_rows)
                self._pmom = (mp, mk, mlo, mhi, dd_rows)
        else:
            dense = dict(device=self.device,
                         page_rows=registry.dense_page_rows)
            if dd_on:
                self.dd = sketches.dd_init(dd_rows, cfg.sketch_rel_err,
                                           cfg.sketch_min_s, cfg.sketch_max_s,
                                           **dense)
            if mom_on:
                self.mom = moments.moments_init(
                    dd_rows, self._mom_meta[0], cfg.sketch_min_s,
                    cfg.sketch_max_s, **dense)
            # K1 addresses dense state through identity page tables over
            # each view's trash-paged arena; both fixed for the
            # processor's life, so one launch plan serves every push
            pr = registry.dense_page_rows
            views = self._dense_views()
            self._dense_arenas = tuple(op.arena_of(v, pr) for v in views)
            self._dense_tables = op.identity_tables(
                [v.shape[0] for v in views], pr, self.device)
            self._dense_shift = pr.bit_length() - 1
        if dd_on or mom_on:
            # eviction clears the sketch rows with the family rows: a
            # reused slot must not inherit another series' latencies
            self.calls.evict_hooks.append(self._zero_sketch_slots)
        self._step_kw = dict(
            edges=tuple(cfg.histogram_buckets),
            gamma=gamma if dd_on else 1.0,
            min_value=cfg.sketch_min_s if dd_on else 0.0,
            dd_rows=dd_rows if dd_on else 0,
            mom_rows=dd_rows if mom_on else 0, mom_meta=self._mom_meta)
        self.target_info = (registry.new_gauge("traces_target_info", ("service",))
                            if cfg.enable_target_info else None)
        self._policies = compile_policies(cfg.filter_policies)
        self.spans_discarded = 0
        # the one fused update of this layout, and its devtime ledger /
        # coalescer kernel name (K1 is the port's only tier)
        self._update = self._paged_fused if self._paged \
            else self._dense_fused
        self._sched_kernel = "spanmetrics_fused_update"
        self._tables_key: "tuple | None" = None
        self._tables: "torch.Tensor | None" = None
        # K1's compact working memory on the card, made once (all zero
        # between dispatches; logical-row indexed, so page-map changes
        # need nothing); the host's plain version needs none
        self._scratch: "torch.Tensor | None" = None
        # the staged route's label-code and LUT arrays, made at first use
        # and published as one tuple (pushes from several threads may race
        # to make them)
        self._staged_luts: "tuple | None" = None
        # the staging-buffer ring (generator/pipeline.py), made at first
        # use on the scheduler route
        self._pipe = None
        # the serving mesh (parallel/serving.py), resolved at first use;
        # dense state's per-shard K1 operands, and the paged state's
        # localized tables per page-map version
        self._mesh = None
        self._mesh_checked = False
        self._mesh_plan = None
        self._pool_plan: "tuple | None" = None

    def name(self) -> str:
        return "span-metrics"

    # -- the fused update ---------------------------------------------------

    def _packed(self) -> bool:
        """Slot ids ride the f32 packed matrix exactly below 2^24."""
        return self.calls.table.capacity < (1 << 24)

    def _direct_update(self, slots, dur_s, sizes, weights) -> None:
        """The direct route's fused update of one push, with the batch as
        `ops.pages.fused_step` takes it: below the 2^24 capacity gate one
        packed [4, n] f32 matrix (one host-to-device copy), above it four
        vectors."""
        if self._packed():
            mat = np.empty((4, len(slots)), np.float32)
            mat[0] = slots
            mat[1] = dur_s
            mat[2] = sizes
            mat[3] = weights
            self._dispatch_packed(mat)
        else:
            self._update((np.ascontiguousarray(slots, np.int32),
                          np.asarray(dur_s, np.float32),
                          np.asarray(sizes, np.float32),
                          np.asarray(weights, np.float32)))

    def _dispatch_packed(self, mat: np.ndarray) -> None:
        """One fused update from a packed [4, n] f32 host matrix: a direct
        push's, or the coalescer's merged window on the scheduler's
        thread. The copy from pageable memory has read `mat` when `.to`
        returns, and it is ordered before K1's launch on this thread's
        current stream."""
        self._update(torch.from_numpy(mat).to(self.device))

    def _dispatch_vec(self, slots, dur_s, sizes, weights) -> None:
        """The merged window as four vectors (capacity >= 2^24)."""
        self._update((slots, dur_s, sizes, weights))

    # -- device-scheduler route (tempo_tpu_torch.sched) ---------------------

    def _sched(self):
        """The process scheduler when this processor's fused updates
        should ride it (config flag, default on), else None: the caller
        then takes the direct route unchanged."""
        if not self.cfg.use_scheduler:
            return None
        sc = sched_mod.scheduler()
        return sc if sc is not None and sc.cfg.enabled else None

    def _submit_rows(self, sc, slots: np.ndarray, dur_s: np.ndarray,
                     sizes: np.ndarray, weights: np.ndarray):
        """Enqueue one push's rows; the merge key is this processor (its
        state), so one merged window is one fused update. Below the 2^24
        gate the window ships as the coalescer's one packed [4, bucket]
        f32 matrix."""
        sm = self._serving_mesh()
        packed = self._packed()
        arrays = (np.asarray(slots, np.float32 if packed else np.int32),
                  np.asarray(dur_s, np.float32),
                  np.asarray(sizes, np.float32),
                  np.asarray(weights, np.float32))
        # on the serving mesh the coalescer aligns the window to the
        # 'data' shard count, so each data shard's K1 takes an equal chunk
        with tracing.span("sched.submit", rows=len(slots)):
            return sc.submit_rows(
                self._sched_kernel, self, arrays, len(slots),
                self._dispatch_packed if packed else self._dispatch_vec,
                pads=(-1.0, 0.0, 0.0, 0.0) if packed
                else (-1, 0.0, 0.0, 0.0),
                tenant=self.registry.tenant, pack=packed,
                align=sm.data_shards if sm is not None else 1,
                shards=sm.data_shards if sm is not None else 0)

    def _pipeline(self, sc):
        """The staging pipeline riding scheduler `sc`, or None when the
        decode/update overlap ring is off (no scheduler, or
        `pipeline_depth` 0: every push then allocates fresh staging)."""
        if sc is None or sc.cfg.pipeline_depth <= 0:
            return None
        if self._pipe is None or self._pipe.depth != sc.cfg.pipeline_depth:
            self._pipe = IngestPipeline(sc.cfg.pipeline_depth)
        return self._pipe

    def drain_pipeline(self, timeout_s: float = 30.0) -> None:
        """Reap the staging ring behind the `sched.flush()` barrier (the
        collection tick's drain before it collects)."""
        if self._pipe is not None:
            self._pipe.drain(timeout_s)

    def _dense_views(self) -> tuple:
        """Dense state's role-aligned planes, in `_paged_planes` order:
        tensors, or on the serving mesh `parallel.mesh.ShardedPlane`s."""
        lat = self.latency.state
        views = (self.calls.state.values, lat.sums, lat.counts,
                 self.sizes.state.values, lat.bucket_counts)
        if self.dd is not None:
            views += (self.dd.zeros, self.dd.counts)
        if self.mom is not None:
            views += (self.mom.data,)
        return views

    # -- serving-mesh route (tempo_tpu_torch.parallel.serving) -------------

    def _serving_mesh(self):
        """The process serving mesh this processor's dense state is
        sharded over, or None (single-device dispatch). Resolved ONCE at
        first use: the placement builds each series shard's K1 operands
        under the state_lock, and the processor stays on that mesh for
        its lifetime. Paged state shards at the pool instead (its
        arenas split page-aligned over 'series')."""
        if self._paged:
            return None
        if self._mesh_checked:
            return self._mesh
        sm = serving.active()
        if sm is not None:
            with self.registry.state_lock:
                if not serving.place_spanmetrics_state(self, sm):
                    sm = None
        self._mesh = sm
        self._mesh_checked = True
        return sm

    def _dense_fused(self, batch) -> None:
        """One fused update of dense state, in place under the registry's
        lock: K1 over the identity tables (one launch on the card), or on
        the serving mesh K1 once per shard over its arenas."""
        sm = self._serving_mesh()
        with self.registry.state_lock:
            if sm is not None:
                sm.fused_update(self._mesh_plan, batch, **self._step_kw)
                return
            op.fused_step(self._dense_arenas, self._dense_tables, batch,
                          page_shift=self._dense_shift, **self._step_kw)

    def _paged_planes(self):
        """Role-aligned planes of the fused step: (calls, hist_sums,
        hist_counts, sizes, hist_buckets[, dd_zeros, dd_counts][,
        moments])."""
        lat = self.latency
        planes = (self.calls.values, lat.sums, lat.counts,
                  self.sizes.values, lat.buckets)
        if self._pdd is not None:
            planes += (self._pdd[1], self._pdd[0])
        if self._pmom is not None:
            planes += (self._pmom[0],)
        return planes

    def _stacked_tables(self, planes) -> torch.Tensor:
        """The [R, P] stacked page tables on the device, refreshed in place
        only when a plane's page map changed: one tensor for the
        processor's life (each plane's `n_lpages` is fixed), so K1's
        launch plan, keyed on it, outlives page-map changes. Caller holds
        the pool lock."""
        key = tuple(p.version for p in planes)
        if key != self._tables_key:
            p_pages = max(p.n_lpages for p in planes)
            host = np.full((len(planes), p_pages), -1, np.int32)
            for r, p in enumerate(planes):
                host[r, :p.n_lpages] = p.page_map
            if self._tables is None:
                self._tables = torch.from_numpy(host).to(self.device)
            else:   # stream-ordered after the dispatches that read it
                self._tables.copy_(torch.from_numpy(host))
            self._tables_key = key
        return self._tables

    def _paged_fused(self, batch) -> None:
        """One fused paged update, in place under the pool lock."""
        planes = self._paged_planes()
        with self.registry.state_lock:
            arenas = tuple(p.data for p in planes)
            tables = self._stacked_tables(planes)
            mesh = self._pool.mesh
            if mesh is not None:
                plan = self._pool_shards(arenas, tables)
                if self._compact and self._scratch is None \
                        and self.device.type == "cuda":
                    # one working memory a device: the shards on it
                    # launch in turn and each leaves it all zero
                    self._scratch = {}
                    for t, a in zip(plan.tables, plan.arenas):
                        if a[0].device not in self._scratch:
                            self._scratch[a[0].device] = \
                                self._compact_scratch(t, a)
                mesh.fused_update(plan, batch, compact=self._compact,
                                  scratch=self._scratch, **self._step_kw)
                return
            if self._compact and self._scratch is None \
                    and self.device.type == "cuda":
                self._scratch = self._compact_scratch(tables, arenas)
            op.fused_step(arenas, tables, batch,
                          page_shift=self._pool.page_shift,
                          compact=self._compact, scratch=self._scratch,
                          **self._step_kw)

    def _compact_scratch(self, tables, arenas) -> torch.Tensor:
        return cuda_kernels.compact_scratch(
            tables, arenas, page_rows=self._pool.page_rows,
            edges=self._step_kw["edges"], dd_rows=self._step_kw["dd_rows"])

    def _pool_shards(self, arenas, tables):
        """Each series shard's K1 operands over the mesh-split pool: its
        arena of every role (`arenas` are the pool's
        `parallel.mesh.ShardedPlane`s) and the stacked tables localized to
        its pages, refreshed in place when a page map changed (the
        tensors live as long as the processor). Caller holds the pool
        lock."""
        from tempo_tpu_torch.parallel.mesh import pool_plan

        key = self._tables_key
        if self._pool_plan is not None and self._pool_plan[0] == key:
            return self._pool_plan[1]
        plan = pool_plan(self._pool.mesh.registry_mesh, arenas, tables,
                         self._pool._arena_pages, self._pool.page_rows)
        if self._pool_plan is not None:
            old = self._pool_plan[1]
            for t_old, t_new in zip(old.tables, plan.tables):
                t_old.copy_(t_new)
            plan = old
        self._pool_plan = (key, plan)
        return plan

    def scratch_bytes(self) -> int:
        """Device bytes of K1's compact working memory (not state: it is
        all zero between dispatches)."""
        if self._scratch is None:
            return 0
        got = self._scratch.values() if isinstance(self._scratch, dict) \
            else (self._scratch,)
        return sum(t.numel() * t.element_size() for t in got)

    # -- the staged fast route (dedicated span-metrics generators) --------

    _DIM_CODES = {"service": 0, "span_name": 1, "span_kind": 2,
                  "status_code": 3}

    def needs_attr_columns(self) -> tuple[bool, bool]:
        """(span_attrs, res_attrs) this processor reads: custom
        dimensions, filter policies and the span multiplier read
        attributes; intrinsic dimensions do not."""
        c = self.cfg
        need = bool(c.dimensions or c.filter_policies
                    or c.span_multiplier_key)
        return need, need

    def supports_staged_fast_path(self) -> bool:
        """True when a push can go StageRec → device directly: intrinsic
        dimensions only (the default config), no policies, multiplier or
        target_info. Anything else needs the SpanBatch route."""
        c = self.cfg
        return (not c.dimensions and not c.filter_policies
                and not c.span_multiplier_key and not c.enable_target_info
                and all(d in self._DIM_CODES for d in c.intrinsic_dimensions))

    def _staged_dims(self):
        got = self._staged_luts
        if got is None:
            it = self.registry.interner
            got = self._staged_luts = (
                np.asarray([self._DIM_CODES[d]
                            for d in self.cfg.intrinsic_dimensions], np.int32),
                np.asarray(it.intern_many(_KIND_STRS), np.int32),
                np.asarray(it.intern_many(_STATUS_STRS), np.int32))
        return got

    def push_staged(self, spans: np.ndarray, slack_lo: int, slack_hi: int,
                    weights: "np.ndarray | None" = None) -> tuple[int, int]:
        """One fused pass: staged StageRec[:n] → slots, durations and sizes
        in C++ (label build, row-table resolve, slack filter, last_seen
        stamp) → one device update. `weights` (len n) are sampling
        upscale factors. Returns (n_valid, n_filtered)."""
        n = len(spans)
        with tracing.span("processor.span-metrics", spans=n):
            cap = _pad_rows(max(n, 1))
            dims, klut, slut = self._staged_dims()
            now = self.registry.now()
            sc = self._sched()
            pipe = self._pipeline(sc)
            bufs = self._ring_buffers(pipe, cap, len(dims))
            with tracing.span("spanmetrics.resolve", spans=n) as sp:
                got = native.spanmetrics_resolve(
                    self.calls.table._nat, spans, dims, klut, slut,
                    slack_lo, slack_hi, now, self.calls.table.last_seen,
                    cap, out=bufs)
                self._apply_misses(got, now, sp)
            return self._push_resolved(got, spans["trace_id"], n, now,
                                       sc=sc, pipe=pipe, bufs=bufs,
                                       weights=weights)

    def push_from_recs(self, raw: bytes, recs: np.ndarray, slack_lo: int,
                       slack_hi: int) -> "tuple[int, int] | None":
        """The in-process tee route: `native.otlp_scan` records and the
        ORIGINAL payload bytes go straight to slots, with no second
        protobuf walk and no payload re-encode for sharded subsets. None
        when the payload needs the Python service.name fixup."""
        n = len(recs)
        with tracing.span("processor.span-metrics", spans=n):
            cap = _pad_rows(max(n, 1))
            dims, klut, slut = self._staged_dims()
            now = self.registry.now()
            sc = self._sched()
            pipe = self._pipeline(sc)
            bufs = self._ring_buffers(pipe, cap, len(dims))
            with tracing.span("spanmetrics.resolve", spans=n) as sp:
                got = native.spanmetrics_from_recs(
                    self.calls.table._nat,
                    self.registry.interner.native_handle()._h, raw, recs,
                    dims, klut, slut, slack_lo, slack_hi, now,
                    self.calls.table.last_seen, cap, out=bufs)
                if got is not None:
                    self._apply_misses(got, now, sp)
            if got is None:
                if pipe is not None:
                    pipe.release(bufs)   # fixup bail: the full route re-stages
                return None
            return self._push_resolved(got, recs["trace_id"], n, now,
                                       sc=sc, pipe=pipe, bufs=bufs)

    @staticmethod
    def _ring_buffers(pipe, cap: int, n_labels: int):
        """The staging ring's next resolve buffers (waiting, when every
        one is in flight, for the oldest job to land), or None without a
        ring."""
        if pipe is None:
            return None
        with tracing.span("pipeline.acquire"):
            return pipe.acquire(cap, n_labels)

    def _apply_misses(self, got, now: float, sp) -> None:
        """Series for the resolve's misses: new rows in the calls table
        (or dropped past the series budget)."""
        slots, _packed, rows, valid, miss = got[:5]
        if miss.size:
            self.calls.table.apply_misses(rows, slots, miss, valid, now)
        if sp is not None:
            sp.attrs["misses"] = int(miss.size)

    def _push_resolved(self, got, trace_ids, n: int, now: float,
                       sc=None, pipe=None, bufs=None,
                       weights=None) -> tuple[int, int]:
        """Land one resolved push. `weights` (len n, optional) are
        per-span Horvitz-Thompson upscale factors from the distributor's
        overload sampling: they multiply calls and sizes and weight the
        histogram and sketches, so rates and quantiles describe the true
        stream; None means weight 1."""
        slots, packed, _rows, _valid, _miss, n_valid, n_filtered = got
        ts_ms = int(now * 1000)
        if sc is not None:
            # trimmed to the real rows (filtered rows carry slot -1 and
            # drop on the card; the coalescer pads the merged window to
            # its pow-2 bucket) and enqueued for the next window
            job = None
            if n:
                w = np.ones(n, np.float32) if weights is None \
                    else np.asarray(weights[:n], np.float32)
                job = self._submit_rows(sc, slots[:n], packed[1][:n],
                                        packed[2][:n], w)
            # exemplars read slots/packed BEFORE the buffers go to the
            # ring: track() makes them reclaimable once the job lands
            # (inline on the shed path), and a concurrent push's
            # acquire() could overwrite them mid-read
            self._exemplars(slots[:n], trace_ids, packed[1], ts_ms)
            if pipe is not None:
                if job is not None:
                    pipe.track(job, bufs)
                else:
                    pipe.release(bufs)
            return n_valid, n_filtered
        # direct route: one host matrix (slots, the packed rows, the
        # weight row), one copy to the device, one K1 launch
        wfull = np.ones(len(slots), np.float32)
        if weights is not None:
            wfull[:n] = weights[:n]
        self._direct_update(slots, packed[1], packed[2], wfull)
        self._exemplars(slots[:n], trace_ids, packed[1], ts_ms)
        return n_valid, n_filtered

    def _exemplars(self, slots, trace_ids, dur_s, ts_ms: int) -> None:
        with tracing.span("spanmetrics.exemplars"):
            self.calls.note_exemplars(slots, trace_ids, dur_s, ts_ms)
            self.latency.exemplars = self.calls.exemplars

    # -- staging -----------------------------------------------------------

    def _label_rows(self, sb: SpanBatch) -> np.ndarray:
        it = self.registry.interner
        cols = []
        for dim in self.cfg.intrinsic_dimensions:
            if dim == "service":
                cols.append(sb.service_id)
            elif dim == "span_name":
                cols.append(sb.name_id)
            elif dim == "span_kind":
                lut = it.intern_many(_KIND_STRS)
                cols.append(lut[np.clip(sb.kind, 0, 5)])
            elif dim == "status_code":
                lut = it.intern_many(_STATUS_STRS)
                cols.append(lut[np.clip(sb.status_code, 0, 2)])
            elif dim == "status_message":
                cols.append(np.where(sb.status_message_id >= 0, sb.status_message_id,
                                     it.intern("")))
            else:
                raise ValueError(f"unknown intrinsic dimension {dim}")
        empty = it.intern("")
        for key in self.cfg.dimensions:
            col = sb.attr_sval_column(key)
            rcol = sb.attr_sval_column(key, scope="resource")
            col = np.where(col != INVALID_ID, col, rcol)
            cols.append(np.where(col != INVALID_ID, col, empty))
        return np.stack(cols, axis=1).astype(np.int32)

    def push_batch(self, sb: SpanBatch, span_sizes: np.ndarray | None = None,
                   sample_weights: np.ndarray | None = None) -> None:
        """Aggregate one batch. `span_sizes` ≈ proto bytes per span;
        `sample_weights` (len ≤ capacity) are overload-sampling upscale
        factors, composed multiplicatively with the span multiplier."""
        if sb.interner is not self.registry.interner:
            raise ValueError(
                "SpanBatch must be built with the tenant registry's interner "
                "(id spaces are shared between batch staging and series labels)")
        with tracing.span("processor.span-metrics", spans=sb.n):
            valid = sb.valid.copy()
            if self._policies:
                keep = self._policies(sb)
                self.spans_discarded += int((valid & ~keep).sum())
                valid &= keep
            with tracing.span("spanmetrics.resolve", spans=sb.n):
                rows = self._label_rows(sb)
                slots = self.calls.resolve_slots(rows, valid=valid)
            # durations in f32 seconds, computed on the host as the
            # reference does, before the copy to the device
            dur_s = (sb.duration_ns / 1e9).astype(np.float32)
            if span_sizes is None:
                span_sizes = np.zeros(sb.capacity, np.float32)
            weights = np.ones(sb.capacity, np.float32)
            if self.cfg.span_multiplier_key:
                mult = _attr_fval(sb, self.cfg.span_multiplier_key)
                weights = np.where(mult > 0, mult, 1.0).astype(np.float32)
            if sample_weights is not None:
                sw = np.ones(sb.capacity, np.float32)
                sw[:len(sample_weights)] = sample_weights
                weights = weights * sw
            sc = self._sched()
            if sc is not None:
                self._submit_rows(sc, slots, dur_s,
                                  span_sizes.astype(np.float32), weights)
            else:
                self._direct_update(slots, dur_s,
                                    span_sizes.astype(np.float32), weights)
            self._exemplars(slots, sb.trace_id, dur_s,
                            int(self.registry.now() * 1000))
            if self.target_info is not None:
                svc_rows = np.unique(sb.service_id[sb.valid])[:, None]
                self.target_info.set_batch(
                    svc_rows, np.ones(svc_rows.shape[0], np.float32))

    # -- sketch quantiles ---------------------------------------------------

    def _zero_sketch_slots(self, padded: np.ndarray) -> None:
        """Purge hook (under the state lock): zero the evicted slots'
        sketch rows; slots past the sketch planes are ignored."""
        if self._paged:
            s = np.where(padded < self._sketch_rows, padded, -1)
            for plane in self._sketch_planes():
                plane.zero_slots(s)
            return
        for state in (self.dd, self.mom):
            if state is not None:
                m.zero_slots(state, padded)

    def _sketch_planes(self) -> tuple:
        return ((self._pdd[0], self._pdd[1]) if self._pdd else ()) + \
            ((self._pmom[0],) if self._pmom else ())

    # -- fleet checkpoint/restore (fleet/checkpoint.py) ---------------------

    def _sketch_rows_dev(self, slots: np.ndarray, role: int) -> torch.Tensor:
        """The slots' rows of a sketch role on the device: indexed in dense
        state (gathered shard by shard on the serving mesh), gathered
        through the plane's page table in paged state (real rows only,
        no padding)."""
        if not self._paged:
            return gather_rows(self._dense_views()[role], slots, self.device)
        return self._paged_planes()[role].gather_dev(slots.astype(np.int32))

    def sketch_checkpoint(self, slots: np.ndarray) -> tuple[dict | None, dict]:
        """(meta, rows) of the sketch sidecars of the given calls-table
        slots: the movable half of a tenant checkpoint, rows left on the
        device for the checkpoint's batched fetch. `*_sel` arrays index
        into `slots` (the sketch planes cover a prefix of the series
        table). Caller holds the registry state lock."""
        meta: dict = {"tier": self.cfg.sketch, "dd": None, "mom": None}
        rows: dict = {}
        sel = np.flatnonzero(slots < self._sketch_rows)
        ss = slots[sel]
        if self._dd_on:
            nb = (self._pdd[0].width if self._paged
                  else plane_width(self.dd.counts))
            meta["dd"] = {"gamma": float(self._step_kw["gamma"]),
                          "min_value": float(self._step_kw["min_value"]),
                          "nb": int(nb)}
            rows["dd_sel"] = sel.astype(np.int64)
            rows["dd_counts"] = self._sketch_rows_dev(ss, _DD_COUNTS)
            rows["dd_zeros"] = self._sketch_rows_dev(ss, _DD_ZEROS)
        if self._mom_meta is not None:
            mk, mlo, mhi = self._mom_meta
            meta["mom"] = {"k": int(mk), "lo": float(mlo), "hi": float(mhi)}
            rows["mom_sel"] = sel.astype(np.int64)
            rows["mom_rows"] = self._sketch_rows_dev(ss, _MOMENTS)
        if meta["dd"] is None and meta["mom"] is None:
            return None, {}
        return meta, rows

    def sketch_meta_check(self, meta: dict) -> None:
        """Validate a checkpoint's sketch metadata against this
        processor's planes through the ValueError-raising merge guards,
        before any restore row is written."""
        dd = meta.get("dd")
        if (dd is not None) != self._dd_on:
            raise ValueError(
                f"fleet restore: dd-sketch tier mismatch (checkpoint "
                f"{'has' if dd else 'lacks'} a DDSketch plane, live "
                f"instance {'has' if self._dd_on else 'lacks'} one)")
        if dd is not None:
            nb = (self._pdd[0].width if self._paged
                  else plane_width(self.dd.counts))
            sketches._merge_check(
                "fleet_restore/dd",
                ("gamma", self._step_kw["gamma"],
                 "min_value", self._step_kw["min_value"]),
                ("gamma", dd["gamma"], "min_value", dd["min_value"]),
                (int(nb),), (int(dd["nb"]),))
        mom = meta.get("mom")
        live_mom = self._mom_meta is not None
        if (mom is not None) != live_mom:
            raise ValueError(
                f"fleet restore: moments tier mismatch (checkpoint "
                f"{'has' if mom else 'lacks'} a moments plane, live "
                f"instance {'has' if live_mom else 'lacks'} one)")
        if mom is not None:
            mk, mlo, mhi = self._mom_meta
            moments.merge_meta_check(
                moments.MomentsSketch(
                    data=np.zeros((1, moments.n_cols(mk)), np.float32),
                    k=mk, lo=mlo, hi=mhi),
                moments.MomentsSketch(
                    data=np.zeros((1, moments.n_cols(int(mom["k"]))),
                                  np.float32),
                    k=int(mom["k"]), lo=float(mom["lo"]),
                    hi=float(mom["hi"])))

    def _sketch_target(self, ls: np.ndarray, role: int):
        """(plane, host rows) a restore merges a sketch role into: the
        dense plane at the slots, or the pool's arena at the physical
        rows of the plane's host page map."""
        from tempo_tpu_torch.fleet.checkpoint import _paged_phys

        if self._paged:
            plane = self._paged_planes()[role]
            return plane.data, _paged_phys(plane, ls)
        return self._dense_views()[role], ls.astype(np.int64)

    def sketch_restore(self, meta: dict, live_slots: np.ndarray,
                       ok: np.ndarray, rows: dict) -> None:
        """Merge checkpointed sketch rows into the live planes on the
        device: `index_add_` for the DDSketch grid and zeros and the
        moments count and sums, `scatter_reduce_` amax for the two
        moments bound columns (the cross-shard combine), each row merged
        on its owner shard on the serving mesh. Caller holds the registry
        state lock; `sketch_meta_check` already ran."""
        for key, sel_key, roles in (("dd", "dd_sel", ((_DD_COUNTS,
                                                        "dd_counts"),
                                                       (_DD_ZEROS,
                                                        "dd_zeros"))),
                                    ("mom", "mom_sel", ((_MOMENTS,
                                                         "mom_rows"),))):
            if meta.get(key) is None or sel_key not in rows:
                continue
            sel = rows[sel_key].astype(np.int64)
            keep = ok[sel]
            ls = live_slots[sel][keep]
            within = ls < self._sketch_rows
            ls = ls[within]
            if not ls.size:
                continue
            mk = self._mom_meta[0] if self._mom_meta is not None else 0
            for role, name in roles:
                data, idx = self._sketch_target(ls, role)
                vals = rows[name][keep][within]
                scatter_rows(data, idx, vals, (
                    lambda t, i, v: moments.moments_merge_into(t, i, v, mk))
                    if role == _MOMENTS else
                    (lambda t, i, v: t.index_add_(0, i, v)))

    def device_state_bytes(self) -> int:
        """Device bytes of the processor-owned sketch sidecars (paged:
        backed pages only; dense: whole arenas, trash pages included); the
        registry families report their own."""
        if self._paged:
            return sum(p.device_state_bytes() for p in self._sketch_planes())
        return sum(_state_bytes(st, self.registry.dense_page_rows)
                   for st in (self.dd, self.mom) if st is not None)

    def quantile(self, q: float) -> dict[tuple[tuple[str, str], ...], float]:
        """Per-series latency quantile from the configured sketch tier."""
        return self.quantiles((q,))[0]

    def quantiles(self, qs) -> list[dict[tuple[tuple[str, str], ...], float]]:
        """One {labels: value} map per q in `qs`, from one read of the
        sketch rows: the moments tier solves each row's CDF once for all
        q's; the DDSketch tier gathers the rows once."""
        qs = tuple(float(q) for q in qs)
        if self._mom_meta is not None:
            return self._moments_quantiles(qs)
        return self.dd_quantiles(qs)

    def _sketch_slots(self) -> np.ndarray:
        """Active slots that own sketch rows. Caller holds the lock."""
        slots = self.calls.table.active_slots()
        return slots[slots < self._sketch_rows]

    def _rows(self, slots: np.ndarray, role: int) -> torch.Tensor:
        """The slots' rows of a role of the fused step on the device:
        indexed in dense state (shard by shard on the serving mesh),
        gathered through a paged plane's table."""
        if not self._paged:
            return gather_rows(self._dense_views()[role], slots, self.device)
        plane = self._paged_planes()[role]
        return plane.gather_dev(_padded(slots))[:slots.size]

    def dd_quantiles(self, qs) -> list[dict]:
        """DDSketch tier: one {labels: value} map per q."""
        # a quantile read must see every update accepted before it
        sched_mod.flush()
        if not self._dd_on:
            return [{} for _ in qs]
        with self.registry.state_lock:
            slots = self._sketch_slots()
            if not slots.size:
                return [{} for _ in qs]
            vals = self._dd_quantiles(qs, slots)
        return [{self.calls.labels_of(int(s)): float(v[i])
                 for i, s in enumerate(slots.tolist())} for v in vals]

    def _dd_quantiles(self, qs, slots: np.ndarray) -> list[np.ndarray]:
        """DDSketch quantiles of the slots' rows, computed on the device
        (int32 compact grids upcast there, exactly). Caller holds the
        state lock."""
        sk = sketches.DDSketch(self._rows(slots, _DD_COUNTS).float(),
                               self._rows(slots, _DD_ZEROS).float(),
                               self._step_kw["gamma"],
                               self._step_kw["min_value"])
        return [sketches.dd_quantile(sk, q).cpu().numpy() for q in qs]

    def _moments_quantiles(self, qs) -> list[dict]:
        """Moments tier: gather the active slots' ~15-float rows, run the
        host maxent solver once per distinct row (cached), and fill any
        row whose solve failed from the bucket sketches ("both": the
        DDSketch value; "moments": the classic latency histogram)."""
        mk, mlo, mhi = self._mom_meta
        sched_mod.flush()
        with self.registry.state_lock:
            slots = self._sketch_slots()
            if not slots.size:
                return [{} for _ in qs]
            rows = self._rows(slots, _MOMENTS).cpu().numpy()
        vals, failed = moments.quantiles_for_rows(rows, mk, mlo, mhi, qs)
        out = []
        for j, q in enumerate(qs):
            v = vals[:, j]
            if failed.any():
                v = self._sketch_fallback(q, slots, v, failed)
            out.append({self.calls.labels_of(int(s)): float(v[i])
                        for i, s in enumerate(slots.tolist())})
        return out

    def _sketch_fallback(self, q: float, slots: np.ndarray, vals: np.ndarray,
                         failed: np.ndarray) -> np.ndarray:
        """Fill failed moments solves from the bucket sketches."""
        idx = np.flatnonzero(failed)
        with self.registry.state_lock:
            if self._dd_on:
                vals[idx] = self._dd_quantiles((q,), slots[idx])[0]
                return vals
            # moments-only tier: interpolate the classic latency histogram
            bc = self._rows(slots[idx], _BUCKETS).cpu().numpy()
        edges = np.asarray(self.cfg.histogram_buckets, np.float64)
        cum = np.cumsum(np.asarray(bc, np.float64), axis=1)
        total = cum[:, -1]
        target = np.maximum(q * total, 1e-12)
        b = np.minimum((cum < target[:, None]).sum(axis=1), cum.shape[1] - 1)
        prev = np.where(b > 0, cum[np.arange(len(b)), np.maximum(b - 1, 0)],
                        0.0)
        inb = bc[np.arange(len(b)), b]
        frac = np.where(inb > 0, (target - prev) / np.maximum(inb, 1e-30), 1.0)
        lo = np.where(b > 0, edges[np.minimum(np.maximum(b - 1, 0),
                                              len(edges) - 1)], 0.0)
        hi = edges[np.minimum(b, len(edges) - 1)]
        vals[idx] = np.where(total > 0, lo + (hi - lo) * frac, 0.0)
        return vals


def _padded(slots: np.ndarray) -> np.ndarray:
    """Slots padded to a pow-2 length with -1 (paged gathers read 0)."""
    out = np.full(_pad_len(slots.size), -1, np.int32)
    out[:slots.size] = slots
    return out


def _sanitize(k: str) -> str:
    out = "".join(c if c.isalnum() else "_" for c in k)
    return "__" + out if out and out[0].isdigit() else out


def _attr_fval(sb: SpanBatch, key: str) -> np.ndarray:
    kid = sb.interner.get(key)
    out = np.zeros(sb.capacity, np.float32)
    if kid == INVALID_ID or sb.span_attr_key.shape[1] == 0:
        return out
    hit = sb.span_attr_key == kid
    has = hit.any(axis=1)
    idx = hit.argmax(axis=1)
    out[has] = sb.span_attr_fval[np.arange(sb.capacity), idx][has]
    return out
