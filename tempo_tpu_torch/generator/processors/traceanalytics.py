"""trace-analytics processor: streaming critical-path + error propagation.

Counterpart of `tempo_tpu/generator/processors/traceanalytics.py`. Each
cut runs the port's `ops/structure.analyze` (torch ops on the registry's
device) and attributes on the host; the counter planes and the
latency-share moments sidecar are the port's registry families and
torch tensors (dense state) or `PagedPlane`s (paged state). The share
sketch stays float32, as the write path's moments do.

The structural tier the per-span planes can't express: which service
actually BOUNDS each request's latency, and which service ROOT-CAUSED
each cascading failure. Spans buffer per live trace (same idle-cut
completion signal as localblocks); each cut concatenates every idle
trace into one pow-2 padded batch and runs `ops/structure.py` —
sorted-id parent resolution, lexicographic bounding-child argmax,
log-depth pointer jumping — producing per-span critical-path membership
and per-errored-span root-cause attribution in one device dispatch.

Results land in standard registry planes, so paging, eviction, sched
coalescing and remote write apply unchanged (the fleet checkpoint calls
the `aux_*` methods and WAL replay calls `push_batch` the same way):

- ``tempo_critical_path_seconds_total{service, operation}`` — per-span
  self-time on the path bounding its trace's end-to-end latency;
- ``tempo_error_root_cause_total{service, root_service}`` — errored
  spans attributed to the deepest errored span reachable along
  latest-finishing errored children;
- a moments sidecar plane keyed to the critical-path family's slots,
  sketching each series' share of trace duration (``quantile(q)``).

Corrupt structure degrades to SIGNAL, never to a hang or a skew:
parent cycles terminate at the pointer-jumping iteration cap and count
into ``tempo_traceanalytics_cycle_spans_total``; unresolvable parents
count into ``tempo_dataquality_orphan_spans_total`` and orphan their
subtree off the path; spans arriving after their trace's cut (within
``late_window_s``) count into ``tempo_traceanalytics_late_spans_total``
instead of silently re-opening an already-attributed trace.

The ``tempo_*`` names above are also registered process-wide on RUNTIME
(module import, callback families over the per-tenant totals below) so
local ``/metrics`` scrapes and the dashboard/alert drift gate see them
even though the authoritative planes live in per-tenant registries that
only surface via remote write.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time

import numpy as np
import torch

from tempo_tpu_torch.model.span_batch import STATUS_ERROR, SpanBatch, void_keys
from tempo_tpu_torch.obs.runtime import RUNTIME, kernel_timer
from tempo_tpu_torch.obs.registry import exponential_buckets
from tempo_tpu_torch.ops import moments, structure
from tempo_tpu_torch.parallel.mesh import ShardedPlane, scatter_rows
from tempo_tpu_torch.registry.registry import ManagedRegistry
from tempo_tpu_torch.utils.dataquality import note_orphan_spans

# ---------------------------------------------------------------------------
# process-wide operational counters (RUNTIME callback families)
# ---------------------------------------------------------------------------

_stats_lock = threading.Lock()
_late_spans: dict[str, float] = {}         # tenant -> spans past their cut
_cut_traces: dict[str, float] = {}         # tenant -> traces analyzed
_cut_spans: dict[str, float] = {}          # tenant -> spans analyzed
_cycle_spans: dict[str, float] = {}        # tenant -> spans on parent cycles
# low-cardinality mirrors of the per-tenant planes for local scrapes:
# (tenant, service, operation) -> seconds / (tenant, service, root) -> count
_cp_mirror: dict[tuple[str, str, str], float] = {}
_rc_mirror: dict[tuple[str, str, str], float] = {}
_MIRROR_MAX = 20_000    # new label sets beyond this stop mirroring (the
                        # authoritative per-tenant planes are unaffected)


def _bump(d: dict[str, float], tenant: str, n: float) -> None:
    if n:
        with _stats_lock:
            d[tenant] = d.get(tenant, 0.0) + float(n)


def _mirror_add(d: dict, key: tuple, v: float) -> None:
    with _stats_lock:
        if key in d or len(d) < _MIRROR_MAX:
            d[key] = d.get(key, 0.0) + float(v)


def _snap1(d: dict[str, float]):
    with _stats_lock:
        return [((t,), v) for t, v in d.items() if v]


def _snap3(d: dict):
    with _stats_lock:
        return [(k, v) for k, v in d.items() if v]


def reset_counters() -> None:
    """Test hook: the callback families are process-wide and monotonic."""
    with _stats_lock:
        for d in (_late_spans, _cut_traces, _cut_spans, _cycle_spans,
                  _cp_mirror, _rc_mirror):
            d.clear()


RUNTIME.counter_func(
    "tempo_critical_path_seconds_total",
    lambda: _snap3(_cp_mirror),
    help="Critical-path self-time attributed per (service, operation): "
         "seconds each series spent bounding its traces' end-to-end "
         "latency (trace-analytics processor)",
    labels=("tenant", "service", "operation"))
RUNTIME.counter_func(
    "tempo_error_root_cause_total",
    lambda: _snap3(_rc_mirror),
    help="Errored spans by (owning service, root-cause service): the "
         "root cause is the deepest errored span reachable along "
         "latest-finishing errored children",
    labels=("tenant", "service", "root_service"))
RUNTIME.counter_func(
    "tempo_traceanalytics_late_spans_total", lambda: _snap1(_late_spans),
    help="Spans that arrived after their trace's analytics cut (within "
         "late_window_s) — counted, never silently re-attributed",
    labels=("tenant",))
RUNTIME.counter_func(
    "tempo_traceanalytics_cut_traces_total", lambda: _snap1(_cut_traces),
    help="Traces cut and structurally analyzed", labels=("tenant",))
RUNTIME.counter_func(
    "tempo_traceanalytics_spans_total", lambda: _snap1(_cut_spans),
    help="Spans analyzed at cut time", labels=("tenant",))
RUNTIME.counter_func(
    "tempo_traceanalytics_cycle_spans_total", lambda: _snap1(_cycle_spans),
    help="Spans on parent-pointer cycles (corrupt traces): excluded from "
         "path and root-cause attribution", labels=("tenant",))
ANALYSIS_SECONDS = RUNTIME.histogram(
    "tempo_traceanalytics_analysis_seconds",
    "Wall time of one structural analysis cut (kernel + host attribution)",
    labels=("tenant",),
    buckets=exponential_buckets(1e-4, 4.0, 10))


# ---------------------------------------------------------------------------
# processor
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TraceAnalyticsConfig:
    trace_idle_s: float = 5.0        # localblocks-style completion signal
    late_window_s: float = 30.0      # post-cut window counting late spans
    max_live_traces: int = 50_000    # buffer cap; oldest cut early beyond
    max_spans_per_trace: int = 4096  # per-trace cap; excess counts late
    use_scheduler: bool = True
    enable_latency_share_sketch: bool = True
    moments_k: int = 8
    sketch_max_series: int = 1 << 15
    share_min: float = 1e-4          # moments domain for path shares
    share_max: float = 1.0


@dataclasses.dataclass
class _LiveTrace:
    chunks: list            # (push cols dict, a, b) deferred slices
    n_spans: int
    last_seen: float


_CHUNK_COLS = ("span_id", "parent_id", "service", "name", "start", "end",
               "err", "w")


class TraceAnalyticsProcessor:
    def __init__(self, registry: ManagedRegistry,
                 config: TraceAnalyticsConfig | None = None):
        self.cfg = config or TraceAnalyticsConfig()
        self.registry = registry
        self.cp = registry.new_counter("tempo_critical_path_seconds_total",
                                       ("service", "operation"))
        self.rc = registry.new_counter("tempo_error_root_cause_total",
                                       ("service", "root_service"))
        # latency-share moments sidecar, keyed to the cp family's slots
        # (paged tenants ride the shared backing exactly like the
        # spanmetrics sketch planes; dense tenants a plain device array)
        self._pool = registry.pages
        self._paged = self._pool is not None and hasattr(self.cp, "planes")
        self._pmom = None
        self.mom = None
        if self.cfg.enable_latency_share_sketch:
            mk = max(2, min(int(self.cfg.moments_k), 16))
            self._mom_meta = moments.moments_params(
                mk, self.cfg.share_min, self.cfg.share_max)
            mk, mlo, mhi = self._mom_meta
            cap = registry.overrides.max_active_series
            rows = min(cap, self.cfg.sketch_max_series)
            if self._paged:
                from tempo_tpu_torch.registry.pages import PagedPlane
                pr = self._pool.page_rows
                plane_rows = -(-rows // pr) * pr
                mp = PagedPlane(
                    self._pool, "float32", moments.n_cols(mk), plane_rows,
                    registry.tenant,
                    role="tempo_critical_path_seconds_total/share_moments")
                self.cp.table.backing.add_plane(mp, rows)
                self._pmom = (mp, mk, mlo, mhi, rows)
            else:
                self.mom = moments.MomentsSketch(
                    data=torch.zeros((rows, moments.n_cols(mk)),
                                     dtype=torch.float32,
                                     device=registry.device),
                    k=mk, lo=mlo, hi=mhi)
            # slot reuse must not inherit another series' share history
            self.cp.evict_hooks.append(self._zero_share_slots)
        else:
            self._mom_meta = None
        # live-trace buffer: 24-byte trace key -> buffered column slices
        self._live: "dict[bytes, _LiveTrace]" = {}
        # recently-cut traces: key -> cut wall time, TTL-ordered
        self._recent: dict[bytes, float] = {}
        self._recent_ttl: collections.deque = collections.deque()
        self.spans_buffered = 0

    def name(self) -> str:
        return "trace-analytics"

    def needs_attr_columns(self) -> tuple[bool, bool]:
        return False, False

    def _sched(self):
        """The process scheduler when cut dispatches should ride it
        (config flag, default on), else None — same gate as spanmetrics."""
        if not self.cfg.use_scheduler:
            return None
        from tempo_tpu_torch import sched as sched_mod
        sc = sched_mod.scheduler()
        return sc if sc is not None and sc.cfg.enabled else None

    # -- ingest ------------------------------------------------------------

    def push_batch(self, sb: SpanBatch,
                   sample_weights: np.ndarray | None = None) -> None:
        if sb.interner is not self.registry.interner:
            raise ValueError(
                "SpanBatch must be built with the tenant registry's interner")
        now = self.registry.now()
        idx = np.flatnonzero(sb.valid)
        if idx.size == 0:
            return
        # group the push by trace in ONE vectorized pass: void trace
        # keys, stable sort, boundary scan — the python loop below runs
        # per TRACE (array slices), never per span
        keys = void_keys(sb.trace_id)[idx]
        # run boundaries in ARRIVAL order: exporters emit a trace's spans
        # contiguously, so on the common path the runs already are the
        # per-trace groups and the stable sort + column gathers below are
        # skipped entirely (the ingest-path cost the bench gate guards)
        bnd = np.flatnonzero(
            np.concatenate([[True], keys[1:] != keys[:-1], [True]]))
        run_keys = keys[bnd[:-1]]
        contiguous = idx.size == int(idx[-1]) - int(idx[0]) + 1
        if contiguous and len(np.unique(run_keys)) == len(run_keys):
            sk, bounds = keys, bnd
            lo, hi = int(idx[0]), int(idx[-1]) + 1
            cols = {
                "span_id": sb.span_id[lo:hi],
                "parent_id": sb.parent_span_id[lo:hi],
                "service": sb.service_id[lo:hi], "name": sb.name_id[lo:hi],
                "start": sb.start_unix_nano[lo:hi],
                "end": sb.end_unix_nano[lo:hi],
                "err": sb.status_code[lo:hi] == STATUS_ERROR,
                "w": (np.ones(hi - lo, np.float32)
                      if sample_weights is None
                      else np.asarray(sample_weights, np.float32)[lo:hi])}
        else:
            # interleaved (or hole-punched) push: one stable sort + 8
            # bulk gathers for the WHOLE push — never per trace
            order = np.argsort(keys, kind="stable")
            sk = keys[order]
            bounds = np.flatnonzero(
                np.concatenate([[True], sk[1:] != sk[:-1], [True]]))
            sel_all = idx[order]
            cols = {
                "span_id": sb.span_id[sel_all],
                "parent_id": sb.parent_span_id[sel_all],
                "service": sb.service_id[sel_all],
                "name": sb.name_id[sel_all],
                "start": sb.start_unix_nano[sel_all],
                "end": sb.end_unix_nano[sel_all],
                "err": sb.status_code[sel_all] == STATUS_ERROR,
                "w": (np.ones(len(sel_all), np.float32)
                      if sample_weights is None
                      else np.asarray(sample_weights, np.float32)[sel_all])}
        cap = self.cfg.max_spans_per_trace
        for a, b in zip(bounds[:-1], bounds[1:]):
            key = sk[a].item()
            n_new = int(b - a)
            if key in self._recent:
                _bump(_late_spans, self.registry.tenant, n_new)
                continue
            lt = self._live.get(key)
            if lt is None:
                lt = self._live[key] = _LiveTrace([], 0, now)
            if lt.n_spans + n_new > cap:
                over = lt.n_spans + n_new - cap
                _bump(_late_spans, self.registry.tenant, over)
                n_new = max(n_new - over, 0)
                if n_new == 0:
                    lt.last_seen = now
                    continue
            # slicing is DEFERRED to cut time: a chunk is (cols, a, b)
            # into the shared per-push columns (views pin only the 8
            # referenced arrays for at most the idle window)
            lt.chunks.append((cols, int(a), int(a) + n_new))
            lt.n_spans += n_new
            lt.last_seen = now
            self.spans_buffered += n_new
        if len(self._live) > self.cfg.max_live_traces:
            # over budget: cut the oldest quarter early in one batch
            # (amortized — never one device dispatch per overflow trace)
            n_cut = max(len(self._live) - self.cfg.max_live_traces,
                        self.cfg.max_live_traces // 4)
            by_age = sorted(self._live, key=lambda k: self._live[k].last_seen)
            self._cut(by_age[:n_cut], now)

    # -- cut + analyze -----------------------------------------------------

    def cut_tick(self, immediate: bool = False) -> None:
        """Maintenance pass (instance.tick): analyze idle traces, expire
        the late-span window."""
        now = self.registry.now()
        ready = [k for k, lt in self._live.items()
                 if immediate or now - lt.last_seen >= self.cfg.trace_idle_s]
        self._cut(ready, now)
        while self._recent_ttl and self._recent_ttl[0][0] <= now:
            _, key = self._recent_ttl.popleft()
            t_cut = self._recent.get(key)
            if t_cut is not None and t_cut + self.cfg.late_window_s <= now:
                del self._recent[key]

    def _cut(self, keys: list, now: float) -> None:
        if not keys:
            return
        from tempo_tpu_torch.sched import bucket_rows
        cols: dict[str, list] = {c: [] for c in _CHUNK_COLS}
        grp_parts: list[np.ndarray] = []
        for t, key in enumerate(keys):
            lt = self._live.pop(key)
            self.spans_buffered -= lt.n_spans
            for ch_cols, a, b in lt.chunks:
                for c in _CHUNK_COLS:
                    cols[c].append(ch_cols[c][a:b])
                grp_parts.append(np.full(b - a, t, np.int32))
            self._recent[key] = now
            self._recent_ttl.append((now + self.cfg.late_window_s, key))
        grp = np.concatenate(grp_parts)
        cat = {c: np.concatenate(cols[c]) for c in _CHUNK_COLS}
        n, nt = len(grp), len(keys)
        tenant = self.registry.tenant
        t0 = time.perf_counter()
        dev = self.registry.device
        with kernel_timer("traceanalytics_structure", dev):
            res = structure.analyze(
                grp, cat["span_id"], cat["parent_id"], cat["end"],
                cat["err"], nt, bucket_rows(n, lo=256),
                bucket_rows(nt, lo=16), device=dev)
        self._attribute(grp, cat, res, nt)
        ANALYSIS_SECONDS.observe(time.perf_counter() - t0, (tenant,))

    def _attribute(self, grp, cat, res, nt: int) -> None:
        """Host half of a cut: exact int64 self-times, per-trace spans,
        counter rows — then one sched job (or direct update) per plane."""
        tenant = self.registry.tenant
        n = len(grp)
        start, end, w = cat["start"], cat["end"], cat["w"]
        svc, op, err = cat["service"], cat["name"], cat["err"]
        _bump(_cut_traces, tenant, nt)
        _bump(_cut_spans, tenant, n)
        _bump(_cycle_spans, tenant, int(res["cyclic"].sum()))
        note_orphan_spans(tenant,
                          int((res["parent_row"] == structure.ORPHAN).sum()))
        # critical-path self-times (int64 ns, exact) and trace spans
        self_ns = structure.self_times_ns(start, end, res)
        t_end = np.full(nt, np.iinfo(np.int64).min, np.int64)
        t_start = np.full(nt, np.iinfo(np.int64).max, np.int64)
        np.maximum.at(t_end, grp, end.astype(np.int64))
        np.minimum.at(t_start, grp, start.astype(np.int64))
        t_dur = np.maximum(t_end - t_start, 1)
        sel = np.flatnonzero(res["on_path"])
        if sel.size:
            rows = np.stack([svc[sel], op[sel]], axis=1).astype(np.int32)
            secs = (self_ns[sel].astype(np.float64) / 1e9)
            vals = (secs * w[sel]).astype(np.float32)
            share = (self_ns[sel].astype(np.float64)
                     / t_dur[grp[sel]]).astype(np.float32)
            self._emit(self.cp, "traceanalytics_cp", self._dispatch_cp,
                       rows, (vals, share, w[sel].astype(np.float32)))
            self._mirror(_cp_mirror, tenant, svc[sel], op[sel], secs * w[sel])
        # error root cause: only spans whose fixed point really settled
        # (cycles / iteration-cap leftovers are counted, not attributed)
        rcc = np.clip(res["rc"], 0, n - 1)
        ok = err & ~res["cyclic"] & (res["ebc"][rcc] < 0)
        sel = np.flatnonzero(ok)
        if sel.size:
            root_svc = svc[rcc[sel]]
            rows = np.stack([svc[sel], root_svc], axis=1).astype(np.int32)
            vals = w[sel].astype(np.float32)
            self._emit(self.rc, "traceanalytics_rc", self._dispatch_rc,
                       rows, (vals,))
            self._mirror(_rc_mirror, tenant, svc[sel], root_svc,
                         w[sel].astype(np.float64))

    def _mirror(self, d: dict, tenant: str, a_ids, b_ids, vals) -> None:
        pair = np.stack([a_ids, b_ids], axis=1)
        uniq, inv = np.unique(pair, axis=0, return_inverse=True)
        sums = np.zeros(len(uniq), np.float64)
        np.add.at(sums, inv.ravel(), vals)
        it = self.registry.interner
        for (ai, bi), v in zip(uniq.tolist(), sums.tolist()):
            _mirror_add(d, (tenant, it.lookup(int(ai)) or "",
                            it.lookup(int(bi)) or ""), v)

    def _emit(self, fam, kernel: str, dispatch, rows: np.ndarray,
              extra: tuple) -> None:
        """Resolve slots on this thread (series admission is host state),
        then route ONE job per plane per cut: the sched's merged batch
        pads to the same pow-2 bucket the direct route uses, so the two
        routes stay bit-identical."""
        from tempo_tpu_torch.sched import bucket_rows
        k = rows.shape[0]
        slots = fam.resolve_slots(rows)
        sc = self._sched()
        if sc is not None:
            sc.submit_rows(kernel=kernel, merge_key=(id(self), kernel),
                           arrays=(slots,) + extra, n_rows=k,
                           dispatch=dispatch, tenant=self.registry.tenant)
            return
        cap = bucket_rows(max(k, 1), lo=16)
        pslots = np.full(cap, -1, np.int32)
        pslots[:k] = slots
        padded = []
        for a in extra:
            p = np.zeros(cap, a.dtype)
            p[:k] = a
            padded.append(p)
        dispatch(pslots, *padded)

    # -- device dispatches (sched worker thread or inline) -----------------

    def _dispatch_cp(self, slots, vals, shares, weights) -> None:
        with self.registry.state_lock:
            self.cp.add_slots(np.asarray(slots, np.int32),
                              np.asarray(vals, np.float32))
            self._share_update(np.asarray(slots, np.int32),
                               np.asarray(shares, np.float32),
                               np.asarray(weights, np.float32))

    def _dispatch_rc(self, slots, vals) -> None:
        with self.registry.state_lock:
            self.rc.add_slots(np.asarray(slots, np.int32),
                              np.asarray(vals, np.float32))

    def _share_update(self, slots, shares, weights) -> None:
        if self._pmom is not None:
            mp, mk, mlo, mhi, lim = self._pmom
            # full padded batch with invalid slots mapped to -1: same
            # shape AND same row order as the dense layout, so the
            # scatter is bit-identical across layouts
            shift = self._pool.page_shift
            safe = np.clip(slots, 0, mp.capacity - 1)
            pages = mp.page_map[safe >> shift].astype(np.int64)
            ok = (slots >= 0) & (slots < lim) & (pages >= 0)
            phys = np.where(
                ok, (pages << shift) | (safe & (self._pool.page_rows - 1)),
                -1).astype(np.int32)
            # on a mesh-split pool, once a series shard over its arena
            # with the rows it does not own at -1
            parts = mp.data.split(phys) if isinstance(mp.data, ShardedPlane) \
                else [(mp.data, phys)]
            for data, rows in parts:
                sk = moments.MomentsSketch(data=data, k=mk, lo=mlo, hi=mhi)
                moments.moments_update(sk, rows, shares, weights=weights)
        elif self.mom is not None:
            lim = self.mom.data.shape[0]
            s = np.where((slots >= 0) & (slots < lim), slots, -1)
            moments.moments_update(self.mom, s, shares, weights=weights)

    def _zero_share_slots(self, padded: np.ndarray) -> None:
        """Evict hook (registry state lock held): clear the evicted cp
        slots' share-sketch rows; slots past the sketch plane — and the
        capacity-valued padding — drop on device."""
        if self._pmom is not None:
            s = np.where(padded < self._pmom[4], padded, -1)
            self._pmom[0].zero_slots(s)
        elif self.mom is not None:
            moments.moments_zero_slots(self.mom, padded)

    # -- reads -------------------------------------------------------------

    def quantile(self, q: float) -> dict[tuple, float]:
        """Critical-path latency-share quantile per (service, operation)
        series: {label tuple -> share}. Drains the sched first so every
        accepted cut is in the sketch."""
        if self._mom_meta is None:
            return {}
        from tempo_tpu_torch import sched
        sched.flush()
        mk, mlo, mhi = self._mom_meta
        with self.registry.state_lock:
            slots = self.cp.table.active_slots()
            lim = self._pmom[4] if self._pmom is not None \
                else self.mom.data.shape[0]
            slots = slots[slots < lim]
            if slots.size == 0:
                return {}
            if self._pmom is not None:
                from tempo_tpu_torch.registry.registry import _pad_len
                padded = np.full(_pad_len(slots.size), -1, np.int32)
                padded[:slots.size] = slots
                rows = np.asarray(self._pmom[0].gather(padded))[:slots.size]
            else:
                rows = self._dense_rows(slots)
            labels = [self.cp.labels_of(int(s)) for s in slots]
        vals, _failed = moments.quantiles_for_rows(rows, mk, mlo, mhi, [q])
        return {lab: float(v) for lab, v in zip(labels, vals[:, 0])
                if np.isfinite(v)}

    def _dense_rows(self, slots: np.ndarray) -> np.ndarray:
        """Host copy of the dense share rows of `slots` (in range)."""
        idx = torch.from_numpy(np.ascontiguousarray(slots, np.int64))
        return self.mom.data[idx.to(self.mom.data.device)].cpu().numpy()

    # -- fleet checkpoint/restore (fleet/checkpoint.py) ---------------------

    def aux_family(self):
        return self.cp

    def aux_checkpoint(self, slots: np.ndarray) -> tuple[dict | None, dict]:
        """(meta, rows) for the share-sketch rows of the given cp-table
        slots, host arrays (one copy of the selected rows). Caller holds
        the registry state lock. Live (un-cut) traces are NOT state here:
        they ride the ingest WAL, exactly like local-blocks live traces."""
        if self._mom_meta is None:
            return None, {}
        mk, mlo, mhi = self._mom_meta
        lim = self._pmom[4] if self._pmom is not None \
            else self.mom.data.shape[0]
        sel = np.flatnonzero(slots < lim)
        ss = slots[sel]
        if self._pmom is not None:
            mrows = self._pmom[0].gather(ss.astype(np.int32))
        else:
            mrows = self._dense_rows(ss)
        meta = {"mom": {"k": int(mk), "lo": float(mlo), "hi": float(mhi)}}
        return meta, {"mom_sel": sel.astype(np.int64), "mom_rows": mrows}

    def aux_meta_check(self, meta: dict) -> None:
        """Validate BEFORE any restore write (probe-sketch merge guard)."""
        mom = meta.get("mom")
        live = self._mom_meta is not None
        if (mom is not None) != live:
            raise ValueError(
                f"fleet restore: trace-analytics share-sketch mismatch "
                f"(checkpoint {'has' if mom else 'lacks'} a moments plane, "
                f"live instance {'has' if live else 'lacks'} one)")
        if mom is None:
            return
        mk, mlo, mhi = self._mom_meta
        moments.merge_meta_check(
            moments.MomentsSketch(
                data=np.zeros((1, moments.n_cols(mk)), np.float32),
                k=mk, lo=mlo, hi=mhi),
            moments.MomentsSketch(
                data=np.zeros((1, moments.n_cols(int(mom["k"]))), np.float32),
                k=int(mom["k"]), lo=float(mom["lo"]), hi=float(mom["hi"])))

    def aux_restore(self, meta: dict, live_slots: np.ndarray,
                    ok: np.ndarray, rows: dict) -> None:
        """Merge checkpointed share rows: ADD count+moment sums, MAX the
        bound columns — the moments cross-shard combine. State lock held;
        `aux_meta_check` already passed."""
        if meta.get("mom") is None or "mom_sel" not in rows:
            return
        mk = self._mom_meta[0]
        sel = rows["mom_sel"].astype(np.int64)
        keep = ok[sel]
        ls = live_slots[sel][keep]
        mrows = rows["mom_rows"][keep].astype(np.float32)
        lim = self._pmom[4] if self._pmom is not None \
            else self.mom.data.shape[0]
        within = ls < lim
        ls, mrows = ls[within], mrows[within]
        if not ls.size:
            return
        if self._pmom is not None:
            from tempo_tpu_torch.fleet.checkpoint import _paged_phys

            mp = self._pmom[0]
            idx, data = _paged_phys(mp, ls), mp.data
        else:
            idx, data = ls.astype(np.int64), self.mom.data
        # each row on its owner shard of a mesh-split pool
        scatter_rows(data, idx, mrows,
                     lambda t, i, v: moments.moments_merge_into(t, i, v, mk))

    # -- accounting --------------------------------------------------------

    def device_state_bytes(self) -> int:
        if self._pmom is not None:
            return self._pmom[0].device_state_bytes()
        if self.mom is not None:
            d = self.mom.data
            return d.numel() * d.element_size()
        return 0


__all__ = ["TraceAnalyticsConfig", "TraceAnalyticsProcessor",
           "reset_counters"]
