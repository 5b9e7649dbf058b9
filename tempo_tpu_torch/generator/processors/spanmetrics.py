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
latency histogram, size and the DDSketch sidecar together, in place, in
the page pool's arenas (`ops.pages.fused_step` → the CUDA kernel on the
card, its plain version on the host).

This slice runs the paged layout with the `sketch: dd` f32 state on the
direct route. The dense layout, the moments sketch tiers, the compact
state tier, the scheduler route and the staged native fast paths come
with later slices and raise `NotImplementedError` here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tempo_tpu_torch.model.interner import INVALID_ID
from tempo_tpu_torch.model.span_batch import SpanBatch
from tempo_tpu_torch.ops import pages as op
from tempo_tpu_torch.ops import sketches
from tempo_tpu_torch.registry.pages import PagedPlane
from tempo_tpu_torch.registry.registry import (DEFAULT_HISTOGRAM_EDGES,
                                               ManagedRegistry, _pad_len)
from tempo_tpu_torch.utils.spanfilter import FilterPolicy, compile_policies

_KIND_STRS = ("SPAN_KIND_UNSPECIFIED", "SPAN_KIND_INTERNAL", "SPAN_KIND_SERVER",
              "SPAN_KIND_CLIENT", "SPAN_KIND_PRODUCER", "SPAN_KIND_CONSUMER")
_STATUS_STRS = ("STATUS_CODE_UNSET", "STATUS_CODE_OK", "STATUS_CODE_ERROR")


@dataclasses.dataclass
class SpanMetricsConfig:
    """Subset of `modules/generator/processor/spanmetrics/config.go`.

    The reference's `kernel` / `pallas_interpret` knobs have no
    counterpart: the port runs its CUDA kernel for state on the card and
    the plain version for state on the host, with no tier to pick."""

    histogram_buckets: tuple[float, ...] = DEFAULT_HISTOGRAM_EDGES
    intrinsic_dimensions: tuple[str, ...] = ("service", "span_name", "span_kind",
                                             "status_code")
    dimensions: tuple[str, ...] = ()          # extra span/resource attr keys
    enable_target_info: bool = False
    filter_policies: tuple[FilterPolicy, ...] = ()
    span_multiplier_key: str = ""             # attr holding a weight multiplier
    enable_quantile_sketch: bool = True       # DDSketch sidecar per series
    # quantile sketch tier: only "dd" in this slice ("moments" and "both"
    # raise NotImplementedError)
    sketch: str = "dd"
    compact_state: bool = False               # raises: a later slice
    sketch_rel_err: float = 0.01              # DDSketch relative-error budget
    sketch_min_s: float = 1e-6                # 1µs .. ~28h latency range
    sketch_max_s: float = 1e5
    sketch_max_series: int = 16384            # device bound for the sketch plane
    subprocessors: tuple[str, ...] = ("count", "latency", "size")
    # the device-scheduler route comes with a later slice; asking for it
    # raises instead of quietly taking the direct route
    use_scheduler: bool = False


class SpanMetricsProcessor:
    def __init__(self, registry: ManagedRegistry,
                 config: SpanMetricsConfig | None = None):
        self.cfg = cfg = config or SpanMetricsConfig()
        if cfg.sketch in ("moments", "both"):
            raise NotImplementedError(
                f"sketch: {cfg.sketch} (the moments sketch tier) comes with "
                "a later slice of the port (K1's moments variant)")
        if cfg.sketch != "dd":
            raise ValueError(f"unknown sketch tier {cfg.sketch!r} (use dd)")
        if cfg.compact_state:
            raise NotImplementedError(
                "compact_state (int32 counts, bf16 Kahan-pair sums) comes "
                "with a later slice of the port (K1's compact variant)")
        if cfg.use_scheduler:
            raise NotImplementedError(
                "the device-scheduler route comes with a later slice of the "
                "port; use the direct route (use_scheduler=False)")
        self.registry = registry
        dims = [d for d in cfg.intrinsic_dimensions] + [
            _sanitize(d) for d in cfg.dimensions]
        self._labels = tuple(dims)
        self._pool = registry.pages
        self.device = self._pool.device
        self.calls = registry.new_counter("traces_spanmetrics_calls_total",
                                          self._labels)
        self.latency = registry.new_histogram(
            "traces_spanmetrics_latency", self._labels,
            edges=cfg.histogram_buckets)
        # latency and size share the calls table so all three stay
        # slot-aligned (the shared table's backing adopts their planes)
        self.latency.share_table(self.calls)
        self.sizes = registry.new_counter("traces_spanmetrics_size_total",
                                          self._labels)
        self.sizes.share_table(self.calls)
        self._pdd = None
        if cfg.enable_quantile_sketch:
            cap = registry.overrides.max_active_series
            dd_rows = min(cap, cfg.sketch_max_series)
            pr = self._pool.page_rows
            plane_rows = -(-dd_rows // pr) * pr  # page-aligned cover
            gamma, nb = sketches.dd_params(cfg.sketch_rel_err, cfg.sketch_min_s,
                                           cfg.sketch_max_s)
            ddc = PagedPlane(self._pool, "float32", nb, plane_rows,
                             registry.tenant,
                             role="traces_spanmetrics_latency/ddsketch")
            ddz = PagedPlane(self._pool, "float32", 1, plane_rows,
                             registry.tenant,
                             role="traces_spanmetrics_latency/ddzeros")
            self.calls.table.backing.add_plane(ddc, dd_rows)
            self.calls.table.backing.add_plane(ddz, dd_rows)
            self._pdd = (ddc, ddz, gamma, cfg.sketch_min_s, dd_rows)
            # eviction clears the sketch rows with the family rows: a
            # reused slot must not inherit another series' latencies
            self.calls.evict_hooks.append(self._zero_sketch_slots)
        self.target_info = (registry.new_gauge("traces_target_info", ("service",))
                            if cfg.enable_target_info else None)
        self._policies = compile_policies(cfg.filter_policies)
        self.spans_discarded = 0
        self._tables_key: "tuple | None" = None
        self._tables: "torch.Tensor | None" = None

    def name(self) -> str:
        return "span-metrics"

    # -- paged route (registry/pages.py + ops/pages.py) --------------------

    def _paged_planes(self):
        """Role-aligned planes of the fused step: (calls, hist_sums,
        hist_counts, sizes, hist_buckets[, dd_zeros, dd_counts])."""
        lat = self.latency
        planes = (self.calls.values, lat.sums, lat.counts,
                  self.sizes.values, lat.buckets)
        if self._pdd is not None:
            planes += (self._pdd[1], self._pdd[0])
        return planes

    def _stacked_tables(self, planes) -> torch.Tensor:
        """The [R, P] stacked page tables on the device, rebuilt only when
        a plane's page map changed. Caller holds the pool lock."""
        key = tuple(p.version for p in planes)
        if key != self._tables_key:
            p_pages = max(p.n_lpages for p in planes)
            host = np.full((len(planes), p_pages), -1, np.int32)
            for r, p in enumerate(planes):
                host[r, :p.n_lpages] = p.page_map
            self._tables = torch.from_numpy(host).to(self.device)
            self._tables_key = key
        return self._tables

    def _paged_update(self, slots, dur_s, sizes, weights) -> None:
        """One fused paged update, in place under the pool lock. Below the
        2^24 capacity gate the batch ships as one packed [4, n] f32
        matrix (one host-to-device copy); above it, as four vectors."""
        if self.calls.table.capacity < (1 << 24):
            mat = np.empty((4, len(slots)), np.float32)
            mat[0] = slots
            mat[1] = dur_s
            mat[2] = sizes
            mat[3] = weights
            batch = torch.from_numpy(mat).to(self.device)
        else:
            batch = (np.ascontiguousarray(slots, np.int32),
                     np.asarray(dur_s, np.float32),
                     np.asarray(sizes, np.float32),
                     np.asarray(weights, np.float32))
        planes = self._paged_planes()
        dd_rows = self._pdd[4] if self._pdd is not None else 0
        gamma = self._pdd[2] if self._pdd is not None else 1.0
        minv = self._pdd[3] if self._pdd is not None else 0.0
        with self.registry.state_lock:
            op.fused_step(tuple(p.data for p in planes),
                          self._stacked_tables(planes), batch,
                          edges=tuple(self.cfg.histogram_buckets),
                          gamma=gamma, min_value=minv, dd_rows=dd_rows,
                          page_shift=self._pool.page_shift)

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
        valid = sb.valid.copy()
        if self._policies:
            keep = self._policies(sb)
            self.spans_discarded += int((valid & ~keep).sum())
            valid &= keep
        rows = self._label_rows(sb)
        slots = self.calls.resolve_slots(rows, valid=valid)
        # durations in f32 seconds, computed on the host as the reference
        # does, before the copy to the device
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
        self._paged_update(slots, dur_s, span_sizes.astype(np.float32), weights)
        ts_ms = int(self.registry.now() * 1000)
        self.calls.note_exemplars(slots, sb.trace_id, dur_s, ts_ms)
        self.latency.exemplars = self.calls.exemplars
        if self.target_info is not None:
            svc_rows = np.unique(sb.service_id[sb.valid])[:, None]
            self.target_info.set_batch(svc_rows, np.ones(svc_rows.shape[0], np.float32))

    # -- sketch quantiles ---------------------------------------------------

    def _zero_sketch_slots(self, padded: np.ndarray) -> None:
        """Purge hook (under the state lock): zero the evicted slots'
        DDSketch rows; slots past the sketch plane are ignored."""
        dd_rows = self._pdd[4]
        s = np.where(padded < dd_rows, padded, -1)
        self._pdd[0].zero_slots(s)
        self._pdd[1].zero_slots(s)

    def device_state_bytes(self) -> int:
        """Device bytes of the processor-owned sketch sidecar (backed pages
        only); the registry families report their own."""
        if self._pdd is None:
            return 0
        return self._pdd[0].device_state_bytes() + self._pdd[1].device_state_bytes()

    def quantile(self, q: float) -> dict[tuple[tuple[str, str], ...], float]:
        """Per-series latency quantile from the DDSketch plane: the active
        slots' rows are gathered through the page table on the device and
        run through `dd_quantile` there."""
        if self._pdd is None:
            return {}
        ddc, ddz, gamma, minv, dd_rows = self._pdd
        with self.registry.state_lock:
            slots = self.calls.table.active_slots()
            slots = slots[slots < dd_rows]
            if not slots.size:
                return {}
            padded = np.full(_pad_len(slots.size), -1, np.int32)
            padded[:slots.size] = slots
            vals = sketches.dd_quantile(
                sketches.DDSketch(ddc.gather_dev(padded), ddz.gather_dev(padded),
                                  gamma, minv), q).cpu().numpy()
        return {self.calls.labels_of(int(s)): float(vals[i])
                for i, s in enumerate(slots.tolist())}


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
