"""Materialized query grids: dashboard-scale reads from streaming planes.

Counterpart of `tempo_tpu/matview/materializer.py`: the grids are torch
tensors on the materializer's device (`configure(..., device=)`: `cuda`
unless `"cpu"` is asked for), each batch's slots go up to that device,
and the append is torch ops (an `index_fill_` of the expired ring
columns, then the evaluator's shared scatters). Every drop the
reference leaves to JAX's out-of-bounds scatter semantics — the batch's
padding, slots past the series budget, the column zeroer's sentinel —
is made on the host before the scatter: an out-of-range index raises on
the CPU and writes into another row on the card. The moments grid is
float64, as the port's evaluator grows it, so a grid built from the
evaluator and then appended to keeps one dtype; the count and bucket
grids are float32, whose integer sums are exact below 2^24.

Every `query_range` today recomputes from registry/block state, so 10k
dashboards polling the same handful of queries at 10s intervals costs
O(queries × state). This module materializes the hot recurring queries
instead: for each subscription the generator appends every ingest
batch's contribution to a standing device-resident grid — a ring of
step columns shaped exactly like the per-request evaluator's grids
(`traceql/engine_metrics.py`):

    rate / count_over_time          [series, steps]       count grid
    quantile / histogram (log2)     [series, steps, 64]   bucket grid
    quantile (moments tier)         [series, steps, k+1]  moment grid
                                    + two [series, steps] bound planes

Appends ride the shared device scheduler as ingest-class jobs (the same
coalescer/ledger path as the spanmetrics fused updates) and reuse the
engine's scatter ops in place, so a steady-state append allocates no
new grid tensor. Reads become a host slice of an already-built grid (memoized
between appends — 10k pollers between two batches share one D2H copy)
plus the normal combiner/final pass: the maxent solve for moments
quantiles, log2 interpolation for bucket grids, rate division for
counts. Answers are bit-identical to the recompute path for dd/count
kinds (integer f32 sums are order-independent below 2^24); moments sums
are float64 add-order class.

Grid↔truth consistency:

- subscriptions are built (and REBUILT, e.g. when a tenant's overrides
  change) by running the real `MetricsEvaluator` over the local-blocks
  views and remapping its linear grid into ring columns — the backfill
  IS the recompute path, so a fresh grid cannot disagree with it;
- appends evaluate the same parsed query with the same shared helpers
  (`matching_rows` / `group_slots`) over a vectorized view of the
  ingest batch (`batchview.py`);
- reads are served only when the grid covers the request window, the
  request is step-aligned, and the grid saw a batch within the
  staleness bound — everything else falls through to the recompute
  path, surfaced per-reason in `tempo_matview_reads_total`.

Process-wide singleton like sched/pages/serving: `configure()` from the
app config, `materializer()` everywhere else, `reset()` in tests.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Callable

import numpy as np

import torch

from tempo_tpu_torch.device import resolve_device
from tempo_tpu_torch.obs.runtime import RUNTIME, record_device_put
from tempo_tpu_torch.obs.queryfp import query_fingerprint
from tempo_tpu_torch.ops import moments as msk
from tempo_tpu_torch.traceql import ast as A
from tempo_tpu_torch.traceql.conditions import extract_conditions
from tempo_tpu_torch.traceql.engine_metrics import (
    HBUCKETS,
    _LABEL_BUCKET,
    _LABEL_MOMENT,
    MetricsEvaluator,
    QueryRangeRequest,
    SeriesIndex,
    TimeSeries,
    _pad_pow2,
    _scatter_add2,
    _scatter_add3,
    _scatter_moments,
    group_slots,
    log2_bucket_np,
    matching_rows,
)
from tempo_tpu_torch.traceql.eval import NUM, eval_expr
from tempo_tpu_torch.traceql.parser import parse


@dataclasses.dataclass
class MatViewConfig:
    """The `matview:` app-config block (bounds in `config.check()`)."""

    enabled: bool = True
    # process-wide subscription budget; explicit subscribes past it are
    # refused, auto-subscribes silently stop
    max_subscriptions: int = 1024
    # per-grid series budget: groups past it are dropped (counted) —
    # a by() explosion must not eat HBM
    max_series: int = 4096
    # ring depth: step columns retained per grid. window_steps × step is
    # the furthest-back a materialized read can reach
    window_steps: int = 128
    min_step_s: float = 1.0
    max_step_s: float = 3600.0
    # serve-from-grid bound: a grid that saw no ingest batch for this
    # long falls back to the recompute path (and the gauge shows why)
    max_staleness_s: float = 60.0
    # auto-subscribe: queries whose fingerprint recurs this many times
    # within qlog's sliding window get a grid without an explicit call
    auto_subscribe: bool = True
    auto_subscribe_after: int = 32
    # auto-subscribed grids nobody read for this long are dropped
    idle_expire_s: float = 3600.0
    # how often a tenant's resolved overrides are re-fingerprinted on
    # the push path (change → expire + rebuild that tenant's grids)
    overrides_check_interval_s: float = 10.0


# kinds a grid can hold. min/max rings would need ±inf column recycling
# and sum/avg accumulate floats whose merge order is visible — those
# kinds stay on the recompute path by design.
_KINDS = (A.MetricsKind.RATE, A.MetricsKind.COUNT_OVER_TIME,
          A.MetricsKind.QUANTILE_OVER_TIME,
          A.MetricsKind.HISTOGRAM_OVER_TIME)

# intrinsics a per-batch view can answer (batchview.py); anything
# trace-structural needs the whole trace and is refused at subscribe
_SUPPORTED_INTRINSICS = {
    A.Intrinsic.NONE, A.Intrinsic.DURATION, A.Intrinsic.NAME,
    A.Intrinsic.STATUS, A.Intrinsic.STATUS_MESSAGE, A.Intrinsic.KIND,
    A.Intrinsic.SPAN_START_TIME, A.Intrinsic.TRACE_ID,
    A.Intrinsic.SPAN_ID, A.Intrinsic.PARENT_ID,
}
_SUPPORTED_SCOPES = (A.Scope.NONE, A.Scope.SPAN, A.Scope.RESOURCE)


def query_supported(query: str) -> "tuple[bool, str]":
    """(materializable, reason). A query qualifies when its kind has a
    grid layout and every referenced column exists on a single-batch
    view — trace-structural features (nested set, roots, spanset
    combines, scalar filters) need the stored trace and fall through to
    the recompute path."""
    try:
        q = parse(query)
    except Exception as e:
        return False, f"parse: {e}"
    if q.metrics is None:
        return False, "not a metrics query"
    if q.metrics.kind not in _KINDS:
        return False, f"kind {q.metrics.kind.value} not materializable"
    for stage in q.stages:
        if not isinstance(stage, A.SpansetFilter):
            return False, "pipeline stage needs whole-trace evaluation"
    bad = _unsupported_attr(q)
    if bad:
        return False, f"attribute {bad} needs whole-trace evaluation"
    return True, ""


def _unsupported_attr(node) -> "str | None":
    if isinstance(node, A.Attribute):
        if node.parent or node.scope not in _SUPPORTED_SCOPES \
                or node.intrinsic not in _SUPPORTED_INTRINSICS:
            return str(node)
        return None
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        for f in dataclasses.fields(node):
            v = getattr(node, f.name)
            for x in (v if isinstance(v, (list, tuple)) else (v,)):
                bad = _unsupported_attr(x)
                if bad:
                    return bad
    return None


# ---------------------------------------------------------------------------
# device ops (the shared scatters come from engine_metrics; the only new
# ones are the ring-advance column zeroer and the row grow)
# ---------------------------------------------------------------------------

def _zero_cols(grid: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Zero recycled ring columns in place (rank-agnostic). `cols` holds
    in-range columns only: the reference's out-of-range sentinel is never
    made."""
    return grid.index_fill_(1, cols, 0.0)


def _grow_rows(grid: torch.Tensor, need: int) -> torch.Tensor:
    g = torch.zeros((need,) + tuple(grid.shape[1:]), dtype=grid.dtype,
                    device=grid.device)
    g[: grid.shape[0]] = grid
    return g


def _up(arr: np.ndarray, device) -> torch.Tensor:
    """One host array onto the grids' device (counted H2D)."""
    record_device_put(int(arr.nbytes), "matview")
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


# ---------------------------------------------------------------------------
# subscription: one standing grid
# ---------------------------------------------------------------------------

class Subscription:
    """One materialized query: parsed pipeline + series index + a ring
    of device step columns. All mutation happens under `lock`."""

    def __init__(self, tenant: str, query: str, step_s: float, fp: str,
                 cfg: MatViewConfig, origin: str, device=None) -> None:
        self.device = resolve_device(device)
        self.tenant = tenant
        self.query = query
        self.step_ns = int(round(step_s * 1e9))
        self.step_s = step_s
        self.fp = fp
        self.cfg = cfg
        self.origin = origin                 # "explicit" | "auto"
        self.q = parse(query)
        self.m = self.q.metrics
        self.kind = self.m.kind
        self.fetch_req = extract_conditions(self.q)   # no time clamp:
        # the ring covers a moving window; coverage clips at read time
        self.need_second_pass = not (
            self.fetch_req.all_conditions
            and self.kind in (A.MetricsKind.RATE,
                              A.MetricsKind.COUNT_OVER_TIME))
        self.moments = False                 # captured at (re)build
        self.lock = threading.Lock()
        # serializes the needs_build check-then-build: two concurrent
        # pushes must not both run build_from (the second would discard
        # the first's just-appended batch — its backfill predates it)
        self.build_lock = threading.Lock()
        self.series = SeriesIndex()
        self.grids: dict[str, torch.Tensor] = {}
        self.cap = 0
        self.hi_step: "int | None" = None    # newest absolute step seen
        self.lo_valid: "int | None" = None   # build floor (absolute)
        self.needs_build = True
        self.version = 0                     # bumped per append (D2H memo)
        self._host: "tuple[int, dict] | None" = None
        # wall clocks (materializer's now())
        self.created_wall = 0.0
        self.last_batch_wall = 0.0
        self.last_read_wall = 0.0
        # counters
        self.appends = 0
        self.append_spans = 0
        self.late_dropped = 0
        self.overflow_dropped = 0

    # -- layout -------------------------------------------------------------

    def _grid_names(self) -> tuple:
        if self.kind in (A.MetricsKind.RATE, A.MetricsKind.COUNT_OVER_TIME):
            return ("count",)
        if self.moments:
            return ("mmt", "mhi", "mlo")
        return ("hist",)

    def _tail_shape(self, name: str) -> tuple:
        if name == "hist":
            return (HBUCKETS,)
        if name == "mmt":
            return (msk.QUERY_K + 1,)
        return ()

    @staticmethod
    def _dtype(name: str) -> torch.dtype:
        # the moment sums accumulate in float64, as the evaluator's do
        return torch.float64 if name == "mmt" else torch.float32

    def _ensure_grids(self, need_series: int) -> None:
        need = min(_pad_pow2(max(need_series, 1), 64),
                   _pad_pow2(max(self.cfg.max_series, 1), 64))
        if need <= self.cap and self.grids:
            return
        w = self.cfg.window_steps
        for name in self._grid_names():
            g = self.grids.get(name)
            if g is None:
                self.grids[name] = torch.zeros(
                    (need, w) + self._tail_shape(name),
                    dtype=self._dtype(name), device=self.device)
            elif g.shape[0] < need:
                self.grids[name] = _grow_rows(g, need)
        self.cap = need

    def state_bytes(self) -> int:
        return sum(g.numel() * g.element_size() for g in self.grids.values())

    # -- build / rebuild (the recompute path IS the backfill) ---------------

    def build_from(self, views_iter, now_s: float, cause: str) -> None:
        """(Re)initialize the ring from stored local-blocks state: run
        the per-request evaluator over the full ring window and remap
        its linear step axis onto ring columns. `views_iter` None (no
        local-blocks processor) starts an empty grid whose coverage
        floor is *now* — reads miss until the window refills."""
        w = self.cfg.window_steps
        cur = int(now_s * 1e9) // self.step_ns
        start_step = cur - w + 1
        with self.lock:
            self.series = SeriesIndex()
            self.grids = {}
            self.cap = 0
            self._host = None
            self.version += 1
            self.moments = (self.kind == A.MetricsKind.QUANTILE_OVER_TIME
                            and msk.query_moments_active())
            self.hi_step = cur
            self.lo_valid = start_step if views_iter is not None else cur
            self.needs_build = False
            if views_iter is None:
                return
            req = QueryRangeRequest(
                query=self.query, start_ns=start_step * self.step_ns,
                end_ns=(cur + 1) * self.step_ns, step_ns=self.step_ns,
                exemplars=0)
            ev = MetricsEvaluator(req, device=self.device)
            for view, cand in views_iter:
                if len(cand):
                    ev.observe(view)
            nseries = len(ev.series)
            if nseries == 0:
                return
            self.series = ev.series
            self._ensure_grids(nseries)
            # linear step j holds absolute step start+j; ring column r
            # holds the abs step ≡ r (mod w) — one gather per grid. The
            # evaluator's last row is its trash row (pad rows land
            # there): it stays behind
            inv = _up((np.arange(w, dtype=np.int64) - start_step) % w,
                      self.device)
            for name in self._grid_names():
                src = ev._grids.get(name)
                if src is None:
                    continue
                g = self.grids[name]
                r = min(src.shape[0] - 1, g.shape[0])
                g[:r] = src[:r].index_select(1, inv).to(g.dtype)

    # -- append -------------------------------------------------------------

    def observe(self, view, now_s: float) -> None:
        """Evaluate the subscription over one ingest-batch view and
        scatter the contribution into the ring (device work rides the
        scheduler as ONE ingest-class job: advance + scatter)."""
        self.last_batch_wall = now_s
        rows = matching_rows(self.q, self.fetch_req,
                             self.need_second_pass, view)
        if len(rows) == 0:
            return
        st = view.col("__startTime")
        if st is None:
            return
        with self.lock:
            self._observe_locked(view, rows, st)

    def _observe_locked(self, view, rows, st) -> None:
        w = self.cfg.window_steps
        ts = st.values[rows]
        abs_step = np.floor_divide(ts, self.step_ns).astype(np.int64)
        new_hi = int(abs_step.max()) if self.hi_step is None \
            else max(self.hi_step, int(abs_step.max()))
        cover_lo = new_hi - w + 1
        fresh = abs_step >= cover_lo
        self.late_dropped += int((~fresh).sum())
        rows, abs_step = rows[fresh], abs_step[fresh]
        if len(rows) == 0:
            return
        grouped = group_slots(self.m.by, self.series, view, rows)
        if grouped is None:
            slots = np.zeros(len(rows), np.int32)
            self.series.lookup([()])
        else:
            keep, slots = grouped
            rows, abs_step = rows[keep], abs_step[keep]
            if len(rows) == 0:
                return
        vals = None
        if self.m.attr is not None:
            c = eval_expr(view, self.m.attr)
            if c.t != NUM:
                return
            vex = c.exists[rows]
            rows, abs_step, slots = rows[vex], abs_step[vex], slots[vex]
            if len(rows) == 0:
                return
            vals = c.values[rows].astype(np.float64)
        self._ensure_grids(len(self.series))
        # over-budget slots are dropped HERE, on the host: the scatters
        # below are fed in-bounds rows only (no padding rows either)
        inb = slots < self.cap
        self.overflow_dropped += int(len(slots) - inb.sum())
        if not inb.all():
            abs_step, slots = abs_step[inb], slots[inb]
            vals = vals[inb] if vals is not None else None
        n = len(slots)
        names = self._grid_names()
        jidx = jz = jz2 = None
        if n:
            # one int64 upload: slots, ring columns (and log2 buckets)
            cols = [slots.astype(np.int64), abs_step % w]
            if names == ("hist",):
                cols.append(log2_bucket_np(vals).astype(np.int64))
            elif names != ("count",):
                z = np.log(np.clip(vals, math.exp(msk.QUERY_LO),
                                   math.exp(msk.QUERY_HI))
                           ).astype(np.float32)
                jz2 = _up(z, self.device)
            jidx = _up(np.stack(cols), self.device)
        advance = self.hi_step is not None and new_hi > self.hi_step
        if advance:
            gap = new_hi - self.hi_step
            if gap >= w:
                zcols = np.arange(w, dtype=np.int64)
            else:
                zcols = np.arange(self.hi_step + 1, new_hi + 1) % w
            jz = _up(zcols.astype(np.int64), self.device)
        grids = self.grids

        def dispatch():
            if advance:
                for name in names:
                    _zero_cols(grids[name], jz)
            if not n:
                return
            ones = torch.ones(n, dtype=torch.float32, device=jidx.device)
            if names == ("count",):
                _scatter_add2(grids["count"], jidx[0], jidx[1], ones)
            elif names == ("hist",):
                _scatter_add3(grids["hist"], jidx[0], jidx[1], jidx[2], ones)
            else:
                _scatter_moments(grids["mmt"], grids["mhi"], grids["mlo"],
                                 jidx[0], jidx[1], jz2)

        from tempo_tpu_torch import sched
        sched.run(dispatch, kernel="matview_append",
                  priority=sched.PRIO_INGEST, tenant=self.tenant)
        self.hi_step = new_hi
        self.version += 1
        self._host = None
        self.appends += 1
        self.append_spans += len(rows)

    # -- read ---------------------------------------------------------------

    @staticmethod
    def _served_lo(lo_valid, hi, w: int) -> "int | None":
        """Oldest absolute step the grid can serve: the build floor,
        clipped by the ring window once appends advanced past it. THE
        coverage rule — read() admission and slice_series share it."""
        if lo_valid is None:
            return None
        if hi is None:
            return lo_valid
        return max(lo_valid, hi - w + 1)

    def covers(self, first_abs: int) -> bool:
        """Locked admission check: can a request starting at absolute
        step `first_abs` be served entirely from this grid?"""
        with self.lock:
            lo = self._served_lo(self.lo_valid, self.hi_step,
                                 self.cfg.window_steps)
        return lo is not None and first_abs >= lo

    def _host_grids(self) -> dict:
        """Host mirror of the device grids, memoized per append version
        — consecutive polls between two ingest batches share one D2H."""
        if self._host is not None and self._host[0] == self.version:
            return self._host[1]
        host = {name: g.cpu().numpy() for name, g in self.grids.items()}
        self._host = (self.version, host)
        return host

    def slice_series(self, req: QueryRangeRequest) -> list:
        """Raw job-level TimeSeries for the request window, shaped
        exactly like `MetricsEvaluator.results()` so the combiner/final
        pass downstream cannot tell the difference."""
        w = self.cfg.window_steps
        with self.lock:
            host = self._host_grids()
            keys = list(self.series.keys)
            hi, lo_valid = self.hi_step, self.lo_valid
        n = req.n_steps
        first = req.start_ns // self.step_ns
        steps_abs = first + np.arange(n, dtype=np.int64)
        served_lo = self._served_lo(lo_valid, hi, w)
        if served_lo is None or hi is None:
            valid = np.zeros(n, bool)
        else:
            valid = (steps_abs >= served_lo) & (steps_abs <= hi)
        cols = (steps_abs % w).astype(np.int64)

        def window(g: np.ndarray, i: int) -> np.ndarray:
            out = np.zeros((n,) + g.shape[2:], np.float64)
            if valid.any():
                out[valid] = g[i, cols[valid]]
            return out

        out: list[TimeSeries] = []
        if not keys:
            return out
        if self.kind in (A.MetricsKind.RATE, A.MetricsKind.COUNT_OVER_TIME):
            g = host.get("count")
            for i, key in enumerate(keys):
                if g is None or i >= g.shape[0]:
                    break
                s = window(g, i)
                if s.any():
                    out.append(TimeSeries(key, s))
            return out
        if self.moments:
            mmt, mhi, mlo = (host.get("mmt"), host.get("mhi"),
                             host.get("mlo"))
            for i, key in enumerate(keys):
                if mmt is None or i >= mmt.shape[0]:
                    break
                m = window(mmt, i)
                if not m[:, 0].any():
                    continue
                for j in range(msk.QUERY_K + 1):
                    if m[:, j].any():
                        out.append(TimeSeries(
                            key + ((_LABEL_MOMENT, str(j)),), m[:, j]))
                out.append(TimeSeries(key + ((_LABEL_MOMENT, "hi"),),
                                      window(mhi, i)))
                out.append(TimeSeries(key + ((_LABEL_MOMENT, "lo"),),
                                      window(mlo, i)))
            return out
        g = host.get("hist")
        for i, key in enumerate(keys):
            if g is None or i >= g.shape[0]:
                break
            s = window(g, i)             # [n, HBUCKETS]
            for b in range(HBUCKETS):
                if s[:, b].any():
                    out.append(TimeSeries(
                        key + ((_LABEL_BUCKET, 2.0 ** b / 1e9),), s[:, b]))
        return out

    def staleness_s(self, now_s: float) -> float:
        if not self.last_batch_wall:
            return float("inf")
        return max(now_s - self.last_batch_wall, 0.0)


# ---------------------------------------------------------------------------
# the process-wide materializer
# ---------------------------------------------------------------------------

class Materializer:
    """The process's standing grids, on `device` (`cuda` unless `"cpu"`
    is asked for)."""

    def __init__(self, cfg: MatViewConfig | None = None,
                 overrides=None,
                 now: Callable[[], float] = time.time,
                 device=None) -> None:
        self.device = resolve_device(device)
        self.cfg = cfg or MatViewConfig()
        self.overrides = overrides
        self.now = now
        self._lock = threading.Lock()
        self._subs: dict[tuple, Subscription] = {}
        self._by_tenant: dict[str, list] = {}
        self._tenants: frozenset = frozenset()   # lock-free wants()
        self._ovr_fp: dict[str, str] = {}
        self._ovr_checked: dict[str, float] = {}
        # counters (snapshot via *_snapshot() — the render lambdas and
        # status() must never iterate a dict a writer is growing)
        self.reads: dict[str, int] = {}
        self.rebuilds: dict[str, int] = {}
        self.auto_subscribed = 0
        self.refused: dict[str, int] = {}
        self._last_sweep = 0.0

    # -- subscription management -------------------------------------------

    def wants(self, tenant: str) -> bool:
        """Cheap push-path gate: does any grid want this tenant?"""
        return tenant in self._tenants

    def fingerprint(self, query: str, step_s: float) -> str:
        return query_fingerprint("metrics", query, step_s)

    def subscribe(self, tenant: str, query: str, step_s: float,
                  origin: str = "explicit"
                  ) -> "tuple[Subscription | None, str]":
        """Register a standing grid; returns (sub, "") or (None, why).
        The grid builds (backfills from local-blocks state) on the next
        ingest batch for the tenant."""
        if not self.cfg.enabled:
            return None, "matview disabled"
        if not (self.cfg.min_step_s <= step_s <= self.cfg.max_step_s):
            return None, (f"step {step_s}s outside "
                          f"[{self.cfg.min_step_s}, {self.cfg.max_step_s}]")
        ok, why = query_supported(query)
        if not ok:
            with self._lock:
                self.refused[why[:60]] = self.refused.get(why[:60], 0) + 1
            return None, why
        fp = self.fingerprint(query, step_s)
        with self._lock:
            got = self._subs.get((tenant, fp))
            if got is not None:
                return got, "exists"
            if len(self._subs) >= self.cfg.max_subscriptions:
                return None, "subscription budget exhausted"
            sub = Subscription(tenant, query, step_s, fp, self.cfg, origin,
                               device=self.device)
            sub.created_wall = sub.last_read_wall = self.now()
            self._subs[(tenant, fp)] = sub
            self._by_tenant.setdefault(tenant, []).append(sub)
            self._tenants = frozenset(self._by_tenant)
            return sub, ""

    def unsubscribe(self, tenant: str, query: str, step_s: float) -> bool:
        fp = self.fingerprint(query, step_s)
        with self._lock:
            sub = self._subs.pop((tenant, fp), None)
            if sub is None:
                return False
            lst = self._by_tenant.get(tenant, [])
            if sub in lst:
                lst.remove(sub)
            if not lst:
                self._by_tenant.pop(tenant, None)
            self._tenants = frozenset(self._by_tenant)
            return True

    def consider_auto_subscribe(self, tenant: str, query: str,
                                step_s: float, recurrences: int) -> None:
        """Auto-subscribe hook, fed by the frontend after every metrics
        request with qlog's fingerprint-recurrence count."""
        if not self.cfg.enabled or not self.cfg.auto_subscribe:
            return
        from tempo_tpu_torch.utils import tracing
        if tracing.is_reserved(tenant):
            # the selftrace loopback tenant must never grow query-driven
            # state: a grid over self-spans would emit spans of its own
            # on every observe_batch, re-entering the loop it observes
            return
        if recurrences < self.cfg.auto_subscribe_after:
            return
        sub, why = self.subscribe(tenant, query, step_s, origin="auto")
        if sub is not None and why == "":     # freshly created, not found
            with self._lock:
                self.auto_subscribed += 1

    # -- push-path hook ------------------------------------------------------

    def observe_batch(self, tenant: str, sb, lb=None,
                      limits_fn=None) -> None:
        """Feed one ingest batch (post-slack SpanBatch) to every grid of
        the tenant. `lb` (the tenant's local-blocks processor, if any)
        is the backfill source for builds/rebuilds; `limits_fn` resolves
        the tenant's current overrides for the expiry fingerprint."""
        subs = self._tenant_subs(tenant)
        if not subs:
            return
        now_s = self.now()
        self._check_overrides(tenant, subs, now_s, limits_fn)
        self._expire_idle(tenant, subs, now_s)
        subs = self._tenant_subs(tenant)
        if not subs:
            return
        view = None
        for sub in subs:
            if sub.needs_build:
                with sub.build_lock:         # double-checked: exactly
                    if sub.needs_build:      # one concurrent push builds
                        views = lb.views_for_matview() \
                            if lb is not None else None
                        sub.build_from(views, now_s, cause="build")
            if view is None:
                from tempo_tpu_torch.matview.batchview import view_from_span_batch
                view = view_from_span_batch(sb)
            sub.observe(view, now_s)

    def _tenant_subs(self, tenant: str) -> list:
        with self._lock:
            return list(self._by_tenant.get(tenant, ()))

    def _check_overrides(self, tenant: str, subs, now_s: float,
                         limits_fn) -> None:
        src = limits_fn or (
            (lambda: self.overrides.for_tenant(tenant))
            if self.overrides is not None else None)
        if src is None:
            return
        last = self._ovr_checked.get(tenant, 0.0)
        if now_s - last < self.cfg.overrides_check_interval_s:
            return
        self._ovr_checked[tenant] = now_s
        fp = repr(src())
        old = self._ovr_fp.get(tenant)
        self._ovr_fp[tenant] = fp
        if old is not None and old != fp:
            for sub in subs:
                sub.needs_build = True
            with self._lock:
                self.rebuilds["overrides"] = \
                    self.rebuilds.get("overrides", 0) + len(subs)

    def _expire_idle(self, tenant: str, subs, now_s: float) -> None:
        for sub in subs:
            if sub.origin == "auto" and \
                    now_s - max(sub.last_read_wall, sub.created_wall) \
                    > self.cfg.idle_expire_s:
                self.unsubscribe(tenant, sub.query, sub.step_s)

    def _maybe_sweep(self, now_s: float) -> None:
        """Rate-limited whole-process idle sweep: a tenant whose ingest
        stopped (or moved to another fleet member) never triggers
        observe_batch again, so its auto grids must also expire from
        the read/scrape paths or their device arrays leak forever."""
        if now_s - self._last_sweep < 60.0:
            return
        self._last_sweep = now_s
        for sub in self.subscriptions():
            if sub.origin == "auto" and \
                    now_s - max(sub.last_read_wall, sub.created_wall) \
                    > self.cfg.idle_expire_s:
                self.unsubscribe(sub.tenant, sub.query, sub.step_s)

    # -- read path -----------------------------------------------------------

    def read(self, tenant: str, req: QueryRangeRequest
             ) -> "list | None":
        """Serve a query_range from its grid, or None (fall through to
        the recompute path). Every outcome lands in
        tempo_matview_reads_total{result}."""
        if not self.cfg.enabled:
            return None
        step_s = req.step_ns / 1e9
        fp = self.fingerprint(req.query, step_s)
        with self._lock:
            sub = self._subs.get((tenant, fp))
        if sub is None:
            return self._miss("unsubscribed")
        now_s = self.now()
        if sub.needs_build:
            return self._miss("unbuilt")
        if sub.kind == A.MetricsKind.QUANTILE_OVER_TIME and \
                sub.moments != msk.query_moments_active():
            sub.needs_build = True        # tier flipped: rebuild lazily
            return self._miss("tier_changed")
        if sub.staleness_s(now_s) > self.cfg.max_staleness_s:
            return self._miss("stale")
        if req.start_ns % req.step_ns != 0:
            return self._miss("unaligned")
        if not sub.covers(req.start_ns // sub.step_ns):
            return self._miss("coverage")
        series = sub.slice_series(req)
        sub.last_read_wall = now_s
        self._maybe_sweep(now_s)
        with self._lock:
            self.reads["hit"] = self.reads.get("hit", 0) + 1
        return series

    def _miss(self, reason: str) -> None:
        with self._lock:
            key = f"miss_{reason}"
            self.reads[key] = self.reads.get(key, 0) + 1
        return None

    # -- introspection -------------------------------------------------------

    def subscriptions(self) -> list:
        with self._lock:
            return list(self._subs.values())

    def reads_snapshot(self) -> dict:
        with self._lock:
            return dict(self.reads)

    def rebuilds_snapshot(self) -> dict:
        with self._lock:
            return dict(self.rebuilds)

    def status(self) -> dict:
        now_s = self.now()
        self._maybe_sweep(now_s)
        subs = self.subscriptions()
        return {
            "enabled": self.cfg.enabled,
            "subscriptions": len(subs),
            "grids_built": sum(1 for s in subs if not s.needs_build),
            "series": sum(len(s.series) for s in subs),
            "state_bytes": sum(s.state_bytes() for s in subs),
            "reads": self.reads_snapshot(),
            "rebuilds": self.rebuilds_snapshot(),
            "auto_subscribed": self.auto_subscribed,
            "max_staleness_s": max(
                (s.staleness_s(now_s) for s in subs
                 if not s.needs_build and s.last_batch_wall),
                default=0.0),
            "subscribed": [
                {"tenant": s.tenant, "query": s.query, "step_s": s.step_s,
                 "fp": s.fp, "origin": s.origin, "series": len(s.series),
                 "built": not s.needs_build, "appends": s.appends,
                 "staleness_s": (round(s.staleness_s(now_s), 3)
                                 if s.last_batch_wall else None)}
                for s in subs[:64]],
        }


# ---------------------------------------------------------------------------
# process-wide singleton (sched/pages/serving pattern)
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_default: "Materializer | None" = None


def configure(cfg: MatViewConfig | None = None, overrides=None,
              now: Callable[[], float] = time.time, device=None
              ) -> "Materializer | None":
    """Install the process materializer from app config, its grids on
    `device` (`cuda` unless `"cpu"` is asked for); None when the tier is
    disabled (every hook no-ops)."""
    global _default
    with _lock:
        if cfg is not None and not cfg.enabled:
            _default = None
        else:
            _default = Materializer(cfg, overrides=overrides, now=now,
                                    device=device)
        return _default


def materializer() -> "Materializer | None":
    return _default


def reset() -> None:
    """Drop the process materializer (tests)."""
    global _default
    with _lock:
        _default = None


# ---------------------------------------------------------------------------
# obs: matview families in the process-wide runtime registry
# ---------------------------------------------------------------------------

def _mv_subs():
    mv = _default
    if mv is None:
        return []
    by_origin: dict[str, int] = {}
    for s in mv.subscriptions():
        by_origin[s.origin] = by_origin.get(s.origin, 0) + 1
    return [((o,), float(n)) for o, n in by_origin.items()]


def _mv_sum(field):
    def fn():
        mv = _default
        if mv is None:
            return []
        return [((), float(sum(getattr(s, field)
                               for s in mv.subscriptions())))]
    return fn


RUNTIME.gauge_func(
    "tempo_matview_subscriptions", _mv_subs,
    help="Materialized-query subscriptions by origin (explicit API vs "
         "qlog-recurrence auto-subscribe)", labels=("origin",))
RUNTIME.gauge_func(
    "tempo_matview_grids",
    lambda: [((), float(sum(1 for s in _default.subscriptions()
                            if not s.needs_build)))] if _default else [],
    help="Materialized grids currently built (serving-eligible; "
         "subscriptions pending their first backfill are excluded)")
RUNTIME.gauge_func(
    "tempo_matview_series",
    lambda: [((), float(sum(len(s.series)
                            for s in _default.subscriptions())))]
    if _default else [],
    help="Series rows across all materialized grids")
RUNTIME.gauge_func(
    "tempo_matview_state_bytes",
    lambda: [((), float(sum(s.state_bytes()
                            for s in _default.subscriptions())))]
    if _default else [],
    help="Device bytes held by materialized query grids")
RUNTIME.counter_func(
    "tempo_matview_appends_total", _mv_sum("appends"),
    help="Ingest-batch contributions scattered into materialized grids "
         "(each rides the device scheduler as one ingest-class job)")
RUNTIME.counter_func(
    "tempo_matview_append_spans_total", _mv_sum("append_spans"),
    help="Spans accumulated into materialized grids")


def _mv_dropped():
    mv = _default
    if mv is None:
        return []
    subs = mv.subscriptions()
    return [(("late",), float(sum(s.late_dropped for s in subs))),
            (("series_overflow",),
             float(sum(s.overflow_dropped for s in subs)))]


RUNTIME.counter_func(
    "tempo_matview_dropped_spans_total", _mv_dropped,
    help="Matched spans a grid could not hold: 'late' = older than the "
         "ring window, 'series_overflow' = past the per-grid series "
         "budget (matview.max_series)", labels=("reason",))
RUNTIME.counter_func(
    "tempo_matview_reads_total",
    lambda: [((k,), float(v))
             for k, v in _default.reads_snapshot().items()]
    if _default else [],
    help="query_range reads consulting the materialized tier, by "
         "outcome (hit = served from a grid; miss_* fall through to "
         "the recompute path)", labels=("result",))
RUNTIME.counter_func(
    "tempo_matview_rebuilds_total",
    lambda: [((k,), float(v))
             for k, v in _default.rebuilds_snapshot().items()]
    if _default else [],
    help="Grid expiry/rebuild cycles by cause (overrides = tenant "
         "limits changed; the rebuild backfills from local-blocks "
         "state through the recompute evaluator)", labels=("cause",))
RUNTIME.counter_func(
    "tempo_matview_auto_subscribed_total",
    lambda: [((), float(_default.auto_subscribed))] if _default else [],
    help="Grids created by qlog-recurrence auto-subscription")


def _mv_staleness():
    mv = _default
    if mv is None:
        return []
    now_s = mv.now()
    by_tenant: dict[str, float] = {}
    for s in mv.subscriptions():
        if s.needs_build or not s.last_batch_wall:
            continue
        age = s.staleness_s(now_s)
        by_tenant[s.tenant] = max(by_tenant.get(s.tenant, 0.0), age)
    return [((t,), v) for t, v in by_tenant.items()]


RUNTIME.gauge_func(
    "tempo_matview_staleness_seconds", _mv_staleness,
    help="Worst-case materialized-grid staleness per tenant (wall time "
         "since the tenant's last ingest batch reached the grid); reads "
         "past matview.max_staleness_s fall back to the recompute path",
    labels=("tenant",))


__all__ = ["MatViewConfig", "Materializer", "Subscription", "configure",
           "materializer", "reset", "query_supported"]
