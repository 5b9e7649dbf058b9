"""TraceQL metrics engine: `query_range` aggregation on device grids.

Counterpart of `tempo_tpu/traceql/engine_metrics.py`. Its grids are torch
tensors on the evaluator's device; the reference's `.at[...]` scatters in
`mode="drop"` become `index_add_` (adds) and `scatter_reduce_` (min/max)
over the flat view of a grid that carries ONE trash row past its last
series: pad and rejected rows aim there, and every read slices it off. No
scatter selects with a boolean mask or reads a value back to the host.

Reference: `pkg/traceql/engine_metrics.go`. The reference's aggregator stack
(`GroupingAggregator` → per-series `StepAggregator` → `VectorAggregator`,
engine_metrics.go:332-537) walks spans one at a time; here each batch of
matching spans becomes three aligned vectors (series slot, step index,
value) and ONE scatter op updates a `[series, steps]` (or
`[series, steps, 64]` for histograms) device grid:

    rate/count_over_time  → grid.at[slot, step].add(w)
    min/max_over_time     → grid.at[slot, step].min/max(v)
    sum/avg_over_time     → add grids (+ count grid for avg)
    quantile/histogram    → grid.at[slot, step, log2bucket(v)].add(w)

Job-level results are raw series (AggregateModeSum); the frontend combiner
sums them and computes quantiles from log2 buckets with linear interpolation
— `Log2Quantile` (engine_metrics.go:1402-1468) — so cross-shard merges stay
pure tensor adds (psum-able across a mesh).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable

import numpy as np
import torch

from tempo_tpu_torch.obs import querystats
from tempo_tpu_torch.ops import moments as msk
from tempo_tpu_torch.traceql import ast as A
from tempo_tpu_torch.traceql.conditions import extract_conditions
from tempo_tpu_torch.traceql.eval import (NUM, ColumnView, eval_expr,
                                          evaluate_pipeline)
from tempo_tpu_torch.traceql.parser import parse

# log2 histogram geometry (shared with `pkg/traceqlmetrics` 64-bucket layout)
HBUCKETS = 64
# bucket b holds values in (2^(b-1), 2^b] nanoseconds; b=0 holds <=1ns
_LABEL_BUCKET = "__bucket"
_LABEL_META = "__meta_type"
# moments tier (`spanmetrics.sketch: moments`, ops/moments.py): instead
# of 64 `__bucket` series per group, quantile_over_time ships k+1 moment
# series (label value "0".."k": count + Chebyshev log-moment sums, merge
# = ADD) plus two support-bound series ("hi"/"lo": shifted running
# maxes, merge = MAX) — ~15 series of plain tensor-adds per group, the
# psum-only combine of the moments sketch
_LABEL_MOMENT = "__moment"


def _moment_labels(labels) -> bool:
    for k, _v in labels:
        if k == _LABEL_MOMENT:
            return True
    return False


def _moment_bound_labels(labels) -> bool:
    """True for the two max-merged support-bound series of a moments
    quantile group (every other series in a combine sums)."""
    for k, v in labels:
        if k == _LABEL_MOMENT:
            return v in ("hi", "lo")
    return False


def log2_bucket_np(values_ns: np.ndarray) -> np.ndarray:
    v = np.maximum(values_ns.astype(np.float64), 1.0)
    return np.clip(np.ceil(np.log2(v)), 0, HBUCKETS - 1).astype(np.int32)


def log2_quantile(q: float, buckets: np.ndarray) -> float:
    """Interpolated quantile from a [HBUCKETS] count vector; returns seconds.

    Mirrors `Log2Quantile` (engine_metrics.go:1402): find the bucket holding
    the q-th sample, then interpolate within its (2^(b-1), 2^b] range.
    """
    total = buckets.sum()
    if total <= 0:
        return 0.0
    target = max(q * total, 1e-12)  # q=0 → lower edge of first nonempty bucket
    csum = np.cumsum(buckets)
    b = int(np.searchsorted(csum, target, side="left"))
    b = min(b, HBUCKETS - 1)
    prev = csum[b - 1] if b > 0 else 0.0
    inbucket = buckets[b]
    frac = (target - prev) / inbucket if inbucket > 0 else 0.0
    lo = 0.0 if b == 0 else 2.0 ** (b - 1)
    hi = 2.0 ** b
    return (lo + (hi - lo) * frac) / 1e9


def _fold_cumulative(g: np.ndarray) -> np.ndarray:
    """The per-series cumulative-count fold of a [steps, B] bucket grid
    — factored out so `log2_quantiles_multi` provably runs it ONCE for
    any number of requested q's (tests count invocations)."""
    return np.cumsum(g, axis=1)


def log2_quantiles_multi(qs, g: np.ndarray) -> np.ndarray:
    """Every requested quantile of a [steps, HBUCKETS] grid from ONE
    cumulative fold: returns [len(qs), steps] seconds. Exactly the
    per-step `log2_quantile` math, vectorized over steps and evaluated
    for all q's off the shared cumulative counts (a multi-param
    `quantile_over_time(duration, .5, .9, .99)` used to refold the
    summed grid once per parameter)."""
    g = np.asarray(g, np.float64)
    cum = _fold_cumulative(g)
    total = cum[:, -1]
    steps = np.arange(g.shape[0])
    out = np.zeros((len(qs), g.shape[0]), np.float64)
    for qi, q in enumerate(qs):
        target = np.maximum(q * total, 1e-12)
        b = np.minimum((cum < target[:, None]).sum(axis=1), HBUCKETS - 1)
        prev = np.where(b > 0, cum[steps, np.maximum(b - 1, 0)], 0.0)
        inbucket = g[steps, b]
        frac = np.where(inbucket > 0, (target - prev) / np.maximum(
            inbucket, 1e-300), 0.0)
        lo = np.where(b == 0, 0.0, np.exp2(b - 1.0))
        hi = np.exp2(b.astype(np.float64))
        out[qi] = np.where(total > 0, (lo + (hi - lo) * frac) / 1e9, 0.0)
    return out


@dataclasses.dataclass
class QueryRangeRequest:
    query: str
    start_ns: int
    end_ns: int
    step_ns: int
    exemplars: int = 100
    # force the moments aggregation axis for this request regardless of
    # the process-global tier: the frontend sets it when the sidecar fold
    # path serves part of the window, so generator + scan-fallback shards
    # emit __moment series that combine with the folds instead of log2
    # __bucket series that would double-count the ("p", q) output
    moments: bool = False

    @property
    def n_steps(self) -> int:
        # exact integer ceiling: float64 division can round the quotient
        # and disagree with the device grid's integer math on huge windows
        return max(-(-(self.end_ns - self.start_ns) // self.step_ns), 1)

    def step_timestamps_ms(self) -> list[int]:
        # samples are stamped at interval END, like IntervalOfMs consumers
        return [int((self.start_ns + (i + 1) * self.step_ns) / 1e6)
                for i in range(self.n_steps)]


@dataclasses.dataclass
class TimeSeries:
    labels: tuple            # ((name, value), ...)
    samples: np.ndarray      # [n_steps] float64
    exemplars: list = dataclasses.field(default_factory=list)

    def key(self) -> tuple:
        return self.labels

    def to_json(self, ts_ms: list[int]) -> dict:
        return {
            "labels": [{"key": k, "value": {"stringValue": str(v)}}
                       for k, v in self.labels],
            "samples": [{"timestampMs": str(t), "value": float(v)}
                        for t, v in zip(ts_ms, self.samples)],
            "exemplars": self.exemplars,
        }


# ---------------------------------------------------------------------------
# device kernels (jit-cached per (capacity, steps) shape bucket)
# ---------------------------------------------------------------------------

def _cells(grid: torch.Tensor, slots: torch.Tensor, steps: torch.Tensor):
    """Flat cell index of (slot, step) in a [rows, steps, ...] grid."""
    return slots.long() * grid.shape[1] + steps.long()


def _scatter_add2(grid, slots, steps, w):
    grid.view(-1).index_add_(0, _cells(grid, slots, steps), w)
    return grid


def _scatter_min2(grid, slots, steps, v):
    grid.view(-1).scatter_reduce_(0, _cells(grid, slots, steps), v, "amin",
                                  include_self=True)
    return grid


def _scatter_max2(grid, slots, steps, v):
    grid.view(-1).scatter_reduce_(0, _cells(grid, slots, steps), v, "amax",
                                  include_self=True)
    return grid


def _scatter_add3(grid, slots, steps, buckets, w):
    flat = _cells(grid, slots, steps) * grid.shape[2] + buckets.long()
    grid.view(-1).index_add_(0, flat, w)
    return grid


def _scatter_moments(mmt, mhi, mlo, slots, steps, z):
    """ONE dispatch for the whole moments-tier observation: the clipped
    log values `z` [n] ride a single H2D (vs shipping the [n, k+1]
    basis matrix), the Chebyshev basis recurrence runs on device, and
    all three grids (moment sums + the two support-bound planes) update
    together, in place. The moment sums accumulate in float64, so the
    order the card's atomics add them in moves a sum by ~1e-16 of its
    size, not by f32 rounding the maxent solve would amplify."""
    from tempo_tpu_torch.ops import moments as _msk
    f32 = dict(dtype=torch.float32, device=z.device)
    c0 = torch.tensor((_msk.QUERY_LO + _msk.QUERY_HI) / 2.0, **f32)
    h0 = torch.tensor((_msk.QUERY_HI - _msk.QUERY_LO) / 2.0, **f32)
    s = torch.clamp((z - c0) / h0, -1.0, 1.0)
    basis = torch.stack(_msk.chebyshev_basis(s, _msk.QUERY_K), dim=-1)
    cells = _cells(mmt, slots, steps)
    mmt.view(-1, mmt.shape[2]).index_add_(0, cells, basis.to(mmt.dtype))
    mhi.view(-1).scatter_reduce_(
        0, cells, z - torch.tensor(_msk.QUERY_LO, **f32), "amax",
        include_self=True)
    mlo.view(-1).scatter_reduce_(
        0, cells, torch.tensor(_msk.QUERY_HI, **f32) - z, "amax",
        include_self=True)
    return mmt, mhi, mlo


def _add_dense(grid, delta):
    """grid[:cap] += delta — the dense-delta flush (the trash row stays)."""
    grid[:delta.shape[0]] += delta
    return grid


def _sched_scatter(fn, *args, kernel: str = "engine_metrics_scatter"):
    """Run one grid-scatter dispatch through the shared device scheduler
    (query class): ingest batches order ahead, the dispatch is counted,
    and an idle scheduler adds zero latency (inline fast path). Direct
    call when no scheduler is configured. `kernel` names the devtime
    ledger class — the batched flush dispatches under its own name so
    the cost model learns its (much larger) bucket sizes separately."""
    from tempo_tpu_torch import sched

    return sched.run(lambda: fn(*args), kernel=kernel)


def _pad_pow2(n: int, lo: int = 256) -> int:
    # the ONE shape-bucket policy, shared with the device scheduler's
    # coalescer (sched.bucket_rows) so the jit shape cache can't split
    from tempo_tpu_torch.sched import bucket_rows

    return bucket_rows(n, lo)


class SeriesIndex:
    """Host-side series table: group-key tuple → dense slot (the string side
    of `GroupingAggregator`; device arrays never see strings). Shared by
    the per-request evaluator below and the standing materialized-view
    grids (`tempo_tpu_torch.matview`), which must mint identical label keys."""

    def __init__(self):
        self.slots: dict[tuple, int] = {}
        self.keys: list[tuple] = []

    def lookup(self, keys: list[tuple]) -> np.ndarray:
        out = np.empty(len(keys), np.int32)
        for i, k in enumerate(keys):
            s = self.slots.get(k)
            if s is None:
                s = self.slots[k] = len(self.keys)
                self.keys.append(k)
            out[i] = s
        return out

    def __len__(self) -> int:
        return len(self.keys)


def matching_rows(q: A.Pipeline, fetch_req, need_second_pass: bool,
                  view: ColumnView) -> np.ndarray:
    """Row indices of `view` matched by the query's filter stages —
    pushdown mask when the conditions cover the query, full pipeline
    evaluation otherwise. Shared by `MetricsEvaluator` and the matview
    appender so a materialized grid can never disagree with the
    recompute path about which spans count."""
    if not need_second_pass:
        from tempo_tpu_torch.block.fetch import condition_mask

        mask = condition_mask(view, fetch_req)
        if mask.all():   # unfiltered scan: arange beats the mask walk
            return np.arange(len(mask), dtype=np.int64)
        return np.flatnonzero(mask)
    stripped = A.Pipeline(q.stages)  # pipeline minus metrics stage
    spansets = evaluate_pipeline(stripped, view)
    if not spansets:
        return np.empty(0, np.int64)
    return np.unique(np.concatenate([ss.rows for ss in spansets]))


# composed-key bincount ceiling: beyond this unique-combo product the
# dense count array would dwarf the row vectors and np.unique wins
_COMPOSE_BINCOUNT_CAP = 1 << 22


def group_slots(by, series: SeriesIndex, view: ColumnView,
                rows: np.ndarray):
    """(keep_mask, slots[int32]) or None when there's no by().

    Vectorized: each group column factorizes to integer codes, codes
    compose into one key per row, and only UNIQUE combos build Python
    label tuples — the per-span tuple loop of `GroupingAggregator`
    becomes O(distinct series) host work. Shared with the matview
    appender (same label formatting → same series keys)."""
    if not by:
        return None
    cols = [(str(e), eval_expr(view, e)) for e in by]
    keep = np.ones(len(rows), bool)
    for _, c in cols:
        # spans missing a group key are dropped; fully-present columns
        # (the common case for intrinsics) skip the per-row gather
        if not c.exists.all():
            keep &= c.exists[rows]
    kept = rows if keep.all() else rows[keep]
    if len(kept) == 0:
        return keep, np.zeros(0, np.int32)
    if len(cols) == 1 and cols[0][1].codes is not None \
            and cols[0][1].code_values is not None:
        # single dictionary-coded key (the dominant group shape): map
        # dict id → series slot through one LUT — two O(n) passes
        # (bincount + gather), no compose round trip
        name, c = cols[0]
        ck = c.codes if len(kept) == len(c.codes) else c.codes[kept]
        cv = c.code_values
        u_ids = np.flatnonzero(np.bincount(ck, minlength=len(cv)))
        uslots = series.lookup(
            [((name, _fmt_label(cv[cid], c.t)),) for cid in u_ids.tolist()])
        slot_lut = np.zeros(len(cv), np.int32)
        slot_lut[u_ids] = uslots
        return keep, slot_lut[ck]
    codes: list[np.ndarray] = []
    uniqs: list[tuple[str, np.ndarray, str]] = []
    for name, c in cols:
        if c.codes is not None and c.code_values is not None:
            # dictionary/interner sidecar: factorize int32 codes instead
            # of converting the object column to unicode per query. The
            # ids are already dense in [0, len(code_values)), so a
            # bincount + LUT gather (all O(n), no sort) replaces
            # np.unique's argsort; flatnonzero yields the same ascending
            # id order unique would. Any code→string mapping yields
            # identical series keys (SeriesIndex dedupes by key tuple).
            ck = c.codes if len(kept) == len(c.codes) else c.codes[kept]
            cv = c.code_values
            u_ids = np.flatnonzero(np.bincount(ck, minlength=len(cv)))
            lut = np.zeros(len(cv), np.int64)
            lut[u_ids] = np.arange(len(u_ids))
            u = np.empty(len(u_ids), object)
            for k, cid in enumerate(u_ids.tolist()):
                u[k] = cv[cid]
            codes.append(lut[ck])
            uniqs.append((name, u, c.t))
            continue
        vals = c.values[kept]
        if vals.dtype == object:    # python-object compares are O(n) py
            vals = vals.astype("U")
        u, inv = np.unique(vals, return_inverse=True)
        codes.append(inv.astype(np.int64))
        uniqs.append((name, u, c.t))
    comp = codes[0]
    prod = len(uniqs[0][1])
    for code, (_, u, _) in zip(codes[1:], uniqs[1:]):
        comp = comp * len(u) + code
        prod *= len(u)
    if prod <= _COMPOSE_BINCOUNT_CAP:
        # composed codes are bounded by the per-column unique-count
        # product: when that fits, the same bincount + LUT trick avoids
        # the O(n log n) unique over 1M-row scans. Each unique combo
        # decomposes back into per-column unique indices by division
        # (the mixed-radix inverse of the compose above).
        ucomp = np.flatnonzero(np.bincount(comp, minlength=prod))
        lut = np.zeros(prod, np.int64)
        lut[ucomp] = np.arange(len(ucomp))
        inv = lut[comp]
        tuples = []
        for v in ucomp.tolist():
            parts = []
            for _, u, _ in reversed(uniqs[1:]):
                v, ci = divmod(v, len(u))
                parts.append(ci)
            parts.append(v)
            parts.reverse()
            tuples.append(tuple(
                (name, _fmt_label(u[ci], t))
                for (name, u, t), ci in zip(uniqs, parts)))
    else:
        ucomp, first, inv = np.unique(comp, return_index=True,
                                      return_inverse=True)
        tuples = [
            tuple((name, _fmt_label(u[codes[k][fi]], t))
                  for k, (name, u, t) in enumerate(uniqs))
            for fi in first.tolist()
        ]
    uslots = series.lookup(tuples)
    return keep, uslots[inv].astype(np.int32)


class MetricsEvaluator:
    """Raw (storage-level) evaluator: observe batches, hold device grids.

    `CompileMetricsQueryRange` analog (engine_metrics.go:802): one instance
    per job; `observe(view)` per scan batch; `results()` → job-level series.
    """

    def __init__(self, req: QueryRangeRequest,
                 clip_start_ns: int | None = None,
                 clip_end_ns: int | None = None,
                 batched: bool = False, device=None):
        from tempo_tpu_torch.device import resolve_device

        self.req = req
        self.device = resolve_device(device)
        # batched observation (the host-fallback path of db/tempodb.py):
        # observe() stages each view's (slots, steps, vals) vectors on
        # host and flush() issues ONE padded scatter dispatch per grid
        # over the concatenation — per-view H2D + dispatch becomes a
        # single device round per query. compare() keeps its per-view
        # dispatches (its series mint per (attr, value) row-wise).
        self._batched = bool(batched)
        self._staged: list[tuple] = []
        # observation clip: sub-requests (backend jobs vs generator window)
        # keep the FULL step grid but only observe spans inside their slice,
        # so combiner tensor-adds line up and the cutoff dedupes sources
        # (the TrimToBefore/After split, metrics_query_range_sharder.go:178)
        self.clip_start_ns = max(req.start_ns, clip_start_ns or req.start_ns)
        self.clip_end_ns = min(req.end_ns, clip_end_ns or req.end_ns)
        self.q = parse(req.query)
        if self.q.metrics is None:
            raise ValueError("not a metrics query: " + req.query)
        self.m = self.q.metrics
        self.fetch_req = extract_conditions(self.q, req.start_ns, req.end_ns)
        self.series = SeriesIndex()
        self.n_steps = req.n_steps
        self._cap = 0
        # each grid has `_cap + 1` rows: the last is the trash row that
        # pad rows hit (the reference's out-of-range `mode="drop"` index)
        self._grids: dict[str, torch.Tensor] = {}
        self._exemplars: dict[int, list] = {}
        self._ex_total = 0
        k = self.m.kind
        # moments query tier: quantile_over_time accumulates
        # [series, steps, k+1] moment grids + two bound planes instead
        # of the [series, steps, 64] log2 grid (histogram_over_time
        # keeps buckets — its OUTPUT is the buckets)
        self._moments = (k == A.MetricsKind.QUANTILE_OVER_TIME
                         and (msk.query_moments_active()
                              or getattr(req, "moments", False)))
        self._hist = k in (A.MetricsKind.QUANTILE_OVER_TIME,
                           A.MetricsKind.HISTOGRAM_OVER_TIME) \
            and not self._moments
        self._is_compare = k == A.MetricsKind.COMPARE
        # `| rate()` with a single filter needs no second pass when the
        # pushdown covers it (optimize() engine_metrics.go:885)
        self._need_second_pass = not (
            self.fetch_req.all_conditions
            and k in (A.MetricsKind.RATE, A.MetricsKind.COUNT_OVER_TIME)
            and not self._is_compare)

    # -- state management ---------------------------------------------------

    def _ensure_capacity(self) -> None:
        need = _pad_pow2(max(len(self.series), 1))
        if need <= self._cap:
            return
        old, self._cap = self._grids, need

        def grow(name, fill, shape_tail=(), dtype=torch.float32):
            g = torch.full((need + 1, self.n_steps) + shape_tail, fill,
                           dtype=dtype, device=self.device)
            if name in old:
                o = old[name]
                g[: o.shape[0] - 1] = o[:-1]
            self._grids[name] = g

        k = self.m.kind
        if self._moments:
            grow("mmt", 0.0, (msk.QUERY_K + 1,), torch.float64)
            grow("mhi", 0.0)   # max(log v − QUERY_LO): 0 == no data
            grow("mlo", 0.0)   # max(QUERY_HI − log v)
        elif self._hist:
            grow("hist", 0.0, (HBUCKETS,))
        elif k in (A.MetricsKind.RATE, A.MetricsKind.COUNT_OVER_TIME):
            grow("count", 0.0)
        elif k == A.MetricsKind.MIN_OVER_TIME:
            grow("min", math.inf)
        elif k == A.MetricsKind.MAX_OVER_TIME:
            grow("max", -math.inf)
        elif k == A.MetricsKind.SUM_OVER_TIME:
            grow("sum", 0.0)
        elif k == A.MetricsKind.AVG_OVER_TIME:
            grow("sum", 0.0)
            grow("count", 0.0)
        elif self._is_compare:
            grow("sel", 0.0)
            grow("base", 0.0)

    # -- observation --------------------------------------------------------

    def observe(self, view: ColumnView) -> None:
        with querystats.stage("engine_eval"):
            self._observe(view)

    def _observe(self, view: ColumnView) -> None:
        rows = self._matching_rows(view)
        querystats.add(inspected_spans=len(rows))
        if len(rows) == 0:
            return
        st = view.col("__startTime")
        if st is None:
            return
        # all-true masks skip their gathers: a resident scan observing a
        # covering window would otherwise pay several 1M-row boolean
        # gathers that move nothing (the .all() probe is ~10× cheaper)
        ts = st.values if len(rows) == len(st.values) else st.values[rows]
        # floor (not truncate): step >= 0 must mean ts >= start exactly,
        # so the ts bound checks below can be skipped when they are
        # implied by the step bounds
        step = np.floor((ts - self.req.start_ns) /
                        self.req.step_ns).astype(np.int32)
        inside = (step >= 0) & (step < self.n_steps)
        # the ts bounds only cut when the clip window is narrower than
        # the step grid itself (sharded sub-requests); the unclipped
        # case skips two more 1M-row comparison passes
        grid_end = self.req.start_ns + self.n_steps * self.req.step_ns
        if self.clip_start_ns > self.req.start_ns or self.clip_end_ns < grid_end:
            inside &= (ts >= self.clip_start_ns) & (ts < self.clip_end_ns)
        if not inside.all():
            rows, step = rows[inside], step[inside]
        if len(rows) == 0:
            return

        if self._is_compare:
            self._observe_compare(view, rows, step)
            return

        # group-by key columns → host series slots
        grouped = self._group_slots(view, rows)
        if grouped is None:
            slots = np.zeros(len(rows), np.int32)
            self.series.lookup([()])
        else:
            keep, slots = grouped
            if not keep.all():
                rows, step = rows[keep], step[keep]
            if len(rows) == 0:
                return

        vals = None
        if self.m.attr is not None:
            c = eval_expr(view, self.m.attr)
            if c.t != NUM:
                return
            vexists = c.exists[rows]
            if not vexists.all():
                rows, step, slots = (rows[vexists], step[vexists],
                                     slots[vexists])
            if len(rows) == 0:
                return
            vals = c.values[rows].astype(np.float64)
            # duration intrinsics aggregate in SECONDS (reference converts
            # ns→s before the vector aggregators); histogram buckets keep ns
            # since log2 geometry is scale-consistent (labels divide by 1e9)
            # — the moments grids keep ns the same way (the final solve
            # divides by 1e9, mirroring log2_quantile)
            if not self._hist and not self._moments \
                    and _is_duration_attr(self.m.attr):
                vals = vals / 1e9

        if self._batched:
            # stage and return: slot ids are already minted (series
            # capacity only grows), so the flush pass can concatenate
            # across views and pad against the FINAL capacity
            self._staged.append((slots, step, vals))
            self._note_exemplars(view, rows, slots)
            return
        self._dispatch(slots, step, vals)
        self._note_exemplars(view, rows, slots)

    def flush(self) -> None:
        """Drain batched staging: concatenate every staged view's
        (slots, steps, vals) vectors and issue ONE dispatch per grid
        (`results()` calls this, so explicit use is only needed for
        mid-query grid reads).

        Add-mergeable kinds (count/rate/sum/avg/histogram) fold the
        concatenation into a DENSE grid-shaped delta with one host
        bincount pass — grid + delta is the scatter, so the device round
        ships [cap, steps(, buckets)] floats instead of row vectors and
        the dispatch cost no longer scales with row count at all.
        Order-insensitive min/max and the moments recurrence keep the
        padded row scatter, still one dispatch per grid per flush."""
        if not self._staged:
            return
        staged, self._staged = self._staged, []
        with querystats.stage("engine_eval"):
            if self._flush_dense(staged):
                return
            slots = np.concatenate([s for s, _, _ in staged])
            step = np.concatenate([t for _, t, _ in staged])
            vals = (np.concatenate([v for _, _, v in staged])
                    if staged[0][2] is not None else None)
            self._dispatch(slots, step, vals, kernel_suffix="_batched")

    def _flush_dense(self, staged: list[tuple]) -> bool:
        """Dense-delta flush for the add-merge kinds: fold each staged
        chunk into the grid-shaped delta (no 1M-row concatenation) and
        ship it in one device add per grid. False → caller falls back
        to the padded row scatter."""
        k = self.m.kind
        if self._moments or k in (A.MetricsKind.MIN_OVER_TIME,
                                  A.MetricsKind.MAX_OVER_TIME):
            return False
        want_sum = k in (A.MetricsKind.SUM_OVER_TIME,
                         A.MetricsKind.AVG_OVER_TIME)
        want_count = k in (A.MetricsKind.RATE, A.MetricsKind.COUNT_OVER_TIME,
                           A.MetricsKind.AVG_OVER_TIME)
        if not (self._hist or want_sum or want_count):
            return False
        self._ensure_capacity()
        cap, S = self._cap, self.n_steps
        deltas: dict[str, np.ndarray] = {}

        def fold(name, m, flat, weights=None):
            d = deltas.get(name)
            if d is None:
                d = deltas[name] = np.zeros(m, np.float64)
            d += np.bincount(flat, weights=weights, minlength=m)

        for slots, step, vals in staged:
            flat = slots * np.int32(S) + step  # int32: cap*S is tiny
            if self._hist:
                b = log2_bucket_np(vals).astype(np.int64)
                fold("hist", cap * S * HBUCKETS,
                     flat.astype(np.int64) * HBUCKETS + b)
            if want_sum:
                fold("sum", cap * S, flat, vals)
            if want_count:
                fold("count", cap * S, flat)
        shape = (cap, S, HBUCKETS) if self._hist else (cap, S)
        for name, d in deltas.items():
            self._grids[name] = _sched_scatter(
                _add_dense, self._grids[name],
                self._up(d.astype(np.float32).reshape(shape)),
                kernel="engine_metrics_scatter_batched")
        return True

    def _dispatch(self, slots: np.ndarray, step: np.ndarray,
                  vals, kernel_suffix: str = "") -> None:
        """One padded scatter round per grid over row-aligned update
        vectors — the shared tail of the per-view and batched paths."""
        self._ensure_capacity()
        n = len(slots)
        # pad update vectors to pow2 sizes: a small closed set of shapes.
        # Padding rows use slot index == capacity, the grids' trash row
        # (the reference's out-of-range `mode="drop"` index).
        size = _pad_pow2(n, 64)
        pad = size - n
        jslots = self._up(np.pad(slots, (0, pad), constant_values=self._cap))
        jsteps = self._up(np.pad(step.astype(np.int32), (0, pad)))
        ones = self._up(np.pad(np.ones(n, np.float32), (0, pad)))
        jvals = (self._up(np.pad(vals.astype(np.float32), (0, pad)))
                 if vals is not None else None)
        _scatter = lambda fn, *args: _sched_scatter(
            fn, *args, kernel="engine_metrics_scatter" + kernel_suffix)
        k = self.m.kind
        if self._moments:
            # ~15 floats per (series, step) instead of 64 buckets: ship
            # the clipped log values ONCE ([n] f32 — not the [n, k+1]
            # basis), compute the Chebyshev recurrence on device, and
            # update moment sums + both support-bound planes in a
            # single dispatch. Padding rows carry slot == capacity and
            # land in the trash row, like every other grid scatter here;
            # their z value is arbitrary.
            z = np.log(np.clip(vals, math.exp(msk.QUERY_LO),
                               math.exp(msk.QUERY_HI))).astype(np.float32)
            jz = self._up(np.pad(z, (0, pad), constant_values=msk.QUERY_LO))
            (self._grids["mmt"], self._grids["mhi"],
             self._grids["mlo"]) = _scatter(
                _scatter_moments, self._grids["mmt"], self._grids["mhi"],
                self._grids["mlo"], jslots, jsteps, jz)
        elif self._hist:
            b = self._up(np.pad(log2_bucket_np(vals), (0, pad)))
            self._grids["hist"] = _scatter(
                _scatter_add3, self._grids["hist"], jslots, jsteps, b, ones)
        elif k in (A.MetricsKind.RATE, A.MetricsKind.COUNT_OVER_TIME):
            self._grids["count"] = _scatter(
                _scatter_add2, self._grids["count"], jslots, jsteps, ones)
        elif k == A.MetricsKind.MIN_OVER_TIME:
            self._grids["min"] = _scatter(
                _scatter_min2, self._grids["min"], jslots, jsteps, jvals)
        elif k == A.MetricsKind.MAX_OVER_TIME:
            self._grids["max"] = _scatter(
                _scatter_max2, self._grids["max"], jslots, jsteps, jvals)
        elif k == A.MetricsKind.SUM_OVER_TIME:
            self._grids["sum"] = _scatter(
                _scatter_add2, self._grids["sum"], jslots, jsteps, jvals)
        elif k == A.MetricsKind.AVG_OVER_TIME:
            self._grids["sum"] = _scatter(
                _scatter_add2, self._grids["sum"], jslots, jsteps, jvals)
            self._grids["count"] = _scatter(
                _scatter_add2, self._grids["count"], jslots, jsteps, ones)

    def _up(self, arr: np.ndarray) -> torch.Tensor:
        """One host vector onto the evaluator's device (counted H2D)."""
        from tempo_tpu_torch.obs.runtime import record_device_put

        record_device_put(int(arr.nbytes), "engine_metrics")
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _grid(self, name: str, nseries: int) -> np.ndarray:
        """Rows [0, nseries) of a grid on the host (the trash row and the
        padding rows stay behind)."""
        return self._grids[name][:nseries].cpu().numpy()

    def _matching_rows(self, view: ColumnView) -> np.ndarray:
        return matching_rows(self.q, self.fetch_req,
                             self._need_second_pass, view)

    def _group_slots(self, view: ColumnView, rows: np.ndarray):
        return group_slots(self.m.by, self.series, view, rows)

    def _observe_compare(self, view: ColumnView, rows: np.ndarray,
                         step: np.ndarray) -> None:
        sel_mask = eval_expr(view, self.m.compare_filter).bool_mask()[rows]
        # count by (attr, value) across a default set of comparison columns:
        # status + every span attribute present (approximation of the
        # reference's dynamic attr diff, engine_metrics_compare.go)
        self._ensure_capacity()
        for which, m in (("selection", sel_mask), ("baseline", ~sel_mask)):
            r, s = rows[m], step[m]
            if len(r) == 0:
                continue
            status = view.col("status")
            keys = [((_LABEL_META, which), ("status", _fmt_label(status.values[x], "status")))
                    for x in r]
            slots = self.series.lookup(keys)
            self._ensure_capacity()
            size = _pad_pow2(len(r), 64)
            pad = size - len(r)
            g = "sel" if which == "selection" else "base"
            self._grids[g] = _sched_scatter(
                _scatter_add2, self._grids[g],
                self._up(np.pad(slots, (0, pad), constant_values=self._cap)),
                self._up(np.pad(s.astype(np.int32), (0, pad))),
                self._up(np.pad(np.ones(len(r), np.float32), (0, pad))))

    def _note_exemplars(self, view, rows, slots) -> None:
        if self.req.exemplars <= 0 or self._ex_total >= self.req.exemplars:
            return
        tid = view.col("trace:id")
        dur = view.col("duration")
        if tid is None:
            return
        for r, s in zip(rows[:8], slots[:8]):
            lst = self._exemplars.setdefault(int(s), [])
            if len(lst) < 2 and self._ex_total < self.req.exemplars:
                lst.append({
                    "traceId": str(tid.values[r]),
                    "value": float(dur.values[r]) if dur is not None else 0.0,
                    "timestampMs": int(view.col("__startTime").values[r] / 1e6),
                })
                self._ex_total += 1

    # -- results ------------------------------------------------------------

    def results(self) -> list[TimeSeries]:
        """Job-level series (AggregateModeSum — raw sums, no rate division;
        the frontend applies final math after combining)."""
        self.flush()
        out: list[TimeSeries] = []
        nseries = len(self.series)
        if nseries == 0:
            return out
        # series minted with no value ever dispatched (the measured
        # attribute missing or non-numeric on every matching span) read
        # zero grids, as the fused plane's do; the reference raises
        # KeyError here (ROADMAP section 3)
        self._ensure_capacity()
        k = self.m.kind
        if self._moments:
            # one series per moment column (merge = add) + the two
            # support bounds (merge = max): ≤ k+3 series per group vs
            # up to 64 bucket series — the combine-payload shrink
            mmt = self._grid("mmt", nseries)
            mhi = self._grid("mhi", nseries)
            mlo = self._grid("mlo", nseries)
            for i, key in enumerate(self.series.keys):
                if not mmt[i, :, 0].any():
                    continue
                for j in range(msk.QUERY_K + 1):
                    col = mmt[i, :, j]
                    if col.any():
                        out.append(TimeSeries(
                            key + ((_LABEL_MOMENT, str(j)),),
                            col.astype(np.float64),
                            self._exemplars.get(i, []) if j == 0 else []))
                out.append(TimeSeries(key + ((_LABEL_MOMENT, "hi"),),
                                      mhi[i].astype(np.float64)))
                out.append(TimeSeries(key + ((_LABEL_MOMENT, "lo"),),
                                      mlo[i].astype(np.float64)))
            return out
        if self._hist:
            hist = self._grid("hist", nseries)
            for i, key in enumerate(self.series.keys):
                for b in range(HBUCKETS):
                    col = hist[i, :, b]
                    if col.any():
                        labels = key + ((_LABEL_BUCKET, 2.0 ** b / 1e9),)
                        out.append(TimeSeries(labels, col.astype(np.float64),
                                              self._exemplars.get(i, [])))
            return out
        if self._is_compare:
            for g, which in (("sel", "selection"), ("base", "baseline")):
                grid = self._grid(g, nseries)
                for i, key in enumerate(self.series.keys):
                    if dict(key).get(_LABEL_META) != which:
                        continue
                    if grid[i].any():
                        out.append(TimeSeries(key, grid[i].astype(np.float64)))
            return out
        name = {A.MetricsKind.RATE: "count", A.MetricsKind.COUNT_OVER_TIME: "count",
                A.MetricsKind.MIN_OVER_TIME: "min", A.MetricsKind.MAX_OVER_TIME: "max",
                A.MetricsKind.SUM_OVER_TIME: "sum", A.MetricsKind.AVG_OVER_TIME: "sum"}[k]
        grid = self._grid(name, nseries)
        counts = (self._grid("count", nseries)
                  if k == A.MetricsKind.AVG_OVER_TIME else None)
        for i, key in enumerate(self.series.keys):
            samples = grid[i].astype(np.float64)
            ts = TimeSeries(key, samples, self._exemplars.get(i, []))
            out.append(ts)
            if counts is not None:
                out.append(TimeSeries(key + (("__meta", "count"),),
                                      counts[i].astype(np.float64)))
        return out


def grid_series(m: A.MetricsAggregate, labels: list, main: np.ndarray,
                cnt: np.ndarray, vcnt: np.ndarray,
                moments: bool = False) -> list[TimeSeries]:
    """Device metrics grids → job-level TimeSeries, with the exact emission
    semantics of `MetricsEvaluator.results()`: a series exists iff its
    group matched the filter at least once (obs cnt row nonzero — even
    when the measured attribute was missing on every matching span, like
    the host registry); histogram kinds emit one series per nonzero log2
    bucket; avg emits the companion `__meta: count` series counting VALUED
    spans (vcnt). With `moments` (the moments query tier), quantile's
    `main` is the fused [G, steps, k+3] moment grid and emission follows
    the evaluator's moments branch: group gated on a nonzero weighted
    count (moment column 0), per-column gating, bounds unconditional.
    Labels ride pre-formatted from the plane's factorization (same
    `_fmt_label` path)."""
    group_names = tuple(str(e) for e in m.by)
    k = m.kind
    mom = moments and k == A.MetricsKind.QUANTILE_OVER_TIME
    hist = not mom and k in (A.MetricsKind.QUANTILE_OVER_TIME,
                             A.MetricsKind.HISTOGRAM_OVER_TIME)
    out: list[TimeSeries] = []
    for gi, lbl in enumerate(labels):
        if mom:
            if not main[gi, :, 0].any():
                continue
        elif not cnt[gi].any():
            continue
        if not group_names:
            key = ()
        elif len(group_names) == 1:
            key = ((group_names[0], lbl),)
        else:   # multi-key: lbl is a value tuple in by() order
            key = tuple(zip(group_names, lbl))
        if mom:
            k1 = main.shape[2] - 2     # k+1 moment cols, then hi, lo
            for j in range(k1):
                col = main[gi, :, j]
                if col.any():
                    out.append(TimeSeries(key + ((_LABEL_MOMENT, str(j)),),
                                          col.astype(np.float64)))
            out.append(TimeSeries(key + ((_LABEL_MOMENT, "hi"),),
                                  main[gi, :, k1].astype(np.float64)))
            out.append(TimeSeries(key + ((_LABEL_MOMENT, "lo"),),
                                  main[gi, :, k1 + 1].astype(np.float64)))
        elif hist:
            for b in range(HBUCKETS):
                col = main[gi, :, b]
                if col.any():
                    out.append(TimeSeries(
                        key + ((_LABEL_BUCKET, 2.0 ** b / 1e9),),
                        col.astype(np.float64)))
        elif k == A.MetricsKind.AVG_OVER_TIME:
            out.append(TimeSeries(key, main[gi].astype(np.float64)))
            out.append(TimeSeries(key + (("__meta", "count"),),
                                  vcnt[gi].astype(np.float64)))
        else:
            out.append(TimeSeries(key, main[gi].astype(np.float64)))
    return out


def _is_duration_attr(attr) -> bool:
    return isinstance(attr, A.Attribute) and attr.intrinsic in (
        A.Intrinsic.DURATION, A.Intrinsic.TRACE_DURATION)


def _fmt_label(v, t: str) -> str:
    if t == "status":
        return A.STATUS_NAMES.get(int(v), "unset")
    if t == "kind":
        return A.KIND_NAMES.get(int(v), "unspecified")
    if t == NUM or t == "num":
        f = float(v)
        return str(int(f)) if f.is_integer() else repr(f)
    if t == "bool":
        return "true" if v else "false"
    return str(v)


# ---------------------------------------------------------------------------
# combiner + final pass (frontend level)
# ---------------------------------------------------------------------------

# metric kinds whose cross-shard merge is EXACT in f32 — integer-valued
# counts (the engine's rate/count/compare/histogram grids accumulate
# weight-1 observations) and min/max (pmin/pmax of f32-origin grid
# values). Only these ride the in-mesh combine, and sum kinds
# additionally fall back to the host f64 fold when the worst-case
# reduced sum (max contribution magnitude x widest per-key contribution
# count) could reach f32's 2^24 integer-exact ceiling; sum/avg_over_time
# accumulate float values and always keep the host fold.
_MESH_MERGE_OPS = {
    A.MetricsKind.RATE: "sum",
    A.MetricsKind.COUNT_OVER_TIME: "sum",
    A.MetricsKind.QUANTILE_OVER_TIME: "sum",
    A.MetricsKind.HISTOGRAM_OVER_TIME: "sum",
    A.MetricsKind.COMPARE: "sum",
    A.MetricsKind.MIN_OVER_TIME: "min",
    A.MetricsKind.MAX_OVER_TIME: "max",
}
_MESH_FILL = {"sum": 0.0, "min": np.inf, "max": -np.inf}


class SeriesCombiner:
    """Cross-job series merge: tensor adds (min/max for those aggregates),
    the `SimpleAggregator`/`HistogramAggregator` combine step
    (engine_metrics.go:1124,1287).

    Sub-results accumulate LAZILY and merge on first read (`series` /
    `final()`). On a single device the merge is the per-series numpy
    fold; under the serving mesh (`parallel.serving.active()`) the fold
    of count-exact kinds collapses into ONE in-mesh reduce — every key's
    contributions stack into a [series, contribs, steps] tensor split
    over 'series', each shard reduces its rows on its device, and the
    merged series leave the mesh once instead of per (job, series)."""

    def __init__(self, kind: A.MetricsKind, n_steps: int):
        self.kind = kind
        self.n_steps = n_steps
        self._series: dict[tuple, TimeSeries] = {}
        self._pending: list[list[TimeSeries]] = []

    @property
    def series(self) -> dict:
        self._flush()
        return self._series

    def add_all(self, series: Iterable[TimeSeries]) -> None:
        lst = series if isinstance(series, list) else list(series)
        if lst:
            self._pending.append(lst)

    # -- merge -------------------------------------------------------------

    def _flush(self) -> None:
        if not self._pending:
            return
        pend, self._pending = self._pending, []
        op = _MESH_MERGE_OPS.get(self.kind)
        if op is not None:
            from tempo_tpu_torch.parallel import serving
            sm = serving.active()
            if sm is not None and \
                    sum(len(x) for x in pend) * self.n_steps >= \
                    sm.cfg.combine_min_elements:
                if self.kind == A.MetricsKind.QUANTILE_OVER_TIME:
                    # moments tier: the whole __moment family peels onto
                    # the host f64 fold — the bounds merge by MAX, and
                    # the fractional moment sums would break the mesh
                    # gate's exactness invariant (amax*cmax < 2^24 only
                    # guarantees integer-count payloads; a fractional
                    # sum rounds in f32 at ANY magnitude, making the
                    # answer depend on which route the combine took).
                    # The tier's combine win is the PAYLOAD shrink
                    # (~15 series/group vs 64 bucket series), which the
                    # host fold keeps; log2 bucket grids still ride the
                    # in-mesh reduce below.
                    mom = [[ts for ts in lst if _moment_labels(ts.labels)]
                           for lst in pend]
                    pend = [[ts for ts in lst
                             if not _moment_labels(ts.labels)]
                            for lst in pend]
                    for lst in mom:
                        if lst:
                            self._merge_host(lst)
                    pend = [lst for lst in pend if lst]
                if pend:
                    self._merge_mesh(sm, pend, op)
                return
        for lst in pend:
            self._merge_host(lst)

    def _merge_host(self, series: list) -> None:
        take_min = self.kind == A.MetricsKind.MIN_OVER_TIME
        take_max = self.kind == A.MetricsKind.MAX_OVER_TIME
        quantile = self.kind == A.MetricsKind.QUANTILE_OVER_TIME
        for ts in series:
            cur = self._series.get(ts.key())
            if cur is None:
                self._series[ts.key()] = TimeSeries(
                    ts.labels, ts.samples.copy(), list(ts.exemplars))
            else:
                if take_min:
                    cur.samples = np.minimum(cur.samples, ts.samples)
                elif take_max or (quantile
                                  and _moment_bound_labels(ts.labels)):
                    # moments support bounds combine like the sketch's
                    # bound columns: running max, not sum
                    cur.samples = np.maximum(cur.samples, ts.samples)
                else:
                    cur.samples = cur.samples + ts.samples
                cur.exemplars.extend(ts.exemplars)

    def _merge_mesh(self, sm, pend: list, op: str) -> None:
        """The in-mesh fold: stack every key's contributions (including
        its already-merged value, if any) and reduce once on the mesh.
        Keys with a single fresh contribution and no prior value skip
        the device entirely (nothing to combine)."""
        groups: dict[tuple, list[TimeSeries]] = {}
        order: list[tuple] = []
        for lst in pend:
            for ts in lst:
                k = ts.key()
                if k not in groups:
                    groups[k] = []
                    order.append(k)
                groups[k].append(ts)
        if op == "sum":
            # exactness gate: f32 addition of integer counts is exact
            # only while the REDUCED sum stays below 2^24, so bound the
            # worst case — max contribution magnitude times the widest
            # per-key contribution count — and let the host f64 fold
            # take over past it. Min/max stay exact at any magnitude
            # (values originate from f32 grids).
            amax, cmax = 0.0, 1
            for k, lst in groups.items():
                cur = self._series.get(k)
                contribs = ([cur] if cur is not None else []) + lst
                if len(contribs) > cmax:
                    cmax = len(contribs)
                for ts in contribs:
                    a = float(np.max(np.abs(ts.samples), initial=0.0))
                    if a > amax:
                        amax = a
            if amax * cmax >= float(1 << 24):
                for lst in pend:
                    self._merge_host(lst)
                return
        multi = [k for k in order if len(groups[k]) > 1 or k in self._series]
        for k in order:
            if len(groups[k]) == 1 and k not in self._series:
                ts = groups[k][0]
                self._series[k] = TimeSeries(ts.labels, ts.samples.copy(),
                                             list(ts.exemplars))
        if not multi:
            return
        n_contrib = max(len(groups[k]) + (1 if k in self._series else 0)
                        for k in multi)
        # pad both dims to stable pow-2-ish shapes: K to a multiple of
        # the series shards rounded to pow2, C to pow2
        K = max(len(multi), sm.series_shards)
        K = 1 << (K - 1).bit_length()
        C = 1 << (n_contrib - 1).bit_length()
        fill = _MESH_FILL[op]
        mat = np.full((K, C, self.n_steps), fill, np.float32)
        for i, k in enumerate(multi):
            j = 0
            if k in self._series:
                mat[i, 0] = self._series[k].samples
                j = 1
            for ts in groups[k]:
                mat[i, j] = ts.samples
                j += 1
        out = sm.combine(mat, op).astype(np.float64)
        for i, k in enumerate(multi):
            cur = self._series.get(k)
            if cur is None:
                base = groups[k][0]
                cur = self._series[k] = TimeSeries(base.labels, out[i], [])
            else:
                cur.samples = out[i]
            for ts in groups[k]:
                cur.exemplars.extend(ts.exemplars)

    def final(self, req: QueryRangeRequest) -> list[TimeSeries]:
        """Final pass: rate division, avg division, quantiles from buckets."""
        q = parse(req.query)
        kind = q.metrics.kind
        out: list[TimeSeries] = []
        if kind == A.MetricsKind.RATE:
            step_s = req.step_ns / 1e9
            for ts in self.series.values():
                out.append(TimeSeries(ts.labels, ts.samples / step_s, ts.exemplars))
            return out
        if kind == A.MetricsKind.AVG_OVER_TIME:
            sums = {k: v for k, v in self.series.items()
                    if dict(k).get("__meta") != "count"}
            for key, ts in sums.items():
                ckey = key + (("__meta", "count"),)
                cnt = self.series.get(ckey)
                with np.errstate(invalid="ignore", divide="ignore"):
                    vals = (ts.samples / cnt.samples) if cnt is not None else ts.samples
                out.append(TimeSeries(ts.labels, np.nan_to_num(vals), ts.exemplars))
            return out
        if kind == A.MetricsKind.QUANTILE_OVER_TIME:
            return self._quantile_series(q.metrics.params, req)
        if kind == A.MetricsKind.MIN_OVER_TIME:
            for ts in self.series.values():
                s = np.where(np.isfinite(ts.samples), ts.samples, 0.0)
                out.append(TimeSeries(ts.labels, s, ts.exemplars))
            return out
        if kind == A.MetricsKind.MAX_OVER_TIME:
            for ts in self.series.values():
                s = np.where(np.isfinite(ts.samples), ts.samples, 0.0)
                out.append(TimeSeries(ts.labels, s, ts.exemplars))
            return out
        return list(self.series.values())

    def _quantile_series(self, qs: tuple, req: QueryRangeRequest) -> list[TimeSeries]:
        # regroup by base labels: `__bucket` series → [steps, HBUCKETS]
        # grids (the log2 tier), `__moment` series → [steps, k+3] moment
        # rows (the moments tier; sketch-row layout of ops/moments.py)
        grids: dict[tuple, np.ndarray] = {}
        moment_rows: dict[tuple, np.ndarray] = {}
        exemplars: dict[tuple, list] = {}
        kc = msk.QUERY_K
        for ts in self.series.values():
            labels = dict(ts.labels)
            if _LABEL_MOMENT in labels:
                mv = labels.pop(_LABEL_MOMENT)
                base = tuple(sorted(labels.items()))
                rows = moment_rows.setdefault(
                    base, np.zeros((req.n_steps, msk.n_cols(kc))))
                if mv == "hi":
                    rows[:, kc + 1] = np.maximum(rows[:, kc + 1], ts.samples)
                elif mv == "lo":
                    rows[:, kc + 2] = np.maximum(rows[:, kc + 2], ts.samples)
                else:
                    rows[:, int(mv)] += ts.samples
                exemplars.setdefault(base, []).extend(ts.exemplars)
                continue
            if _LABEL_BUCKET not in labels:
                continue
            le = float(labels.pop(_LABEL_BUCKET))
            b = int(np.clip(round(math.log2(max(le * 1e9, 1.0))), 0, HBUCKETS - 1))
            base = tuple(sorted(labels.items()))
            g = grids.setdefault(base, np.zeros((req.n_steps, HBUCKETS)))
            g[:, b] += ts.samples
            exemplars.setdefault(base, []).extend(ts.exemplars)
        out = []
        for base, g in grids.items():
            # ONE cumulative fold per series; every requested q reads
            # off it (a 3-param quantile_over_time used to refold per q)
            by_q = log2_quantiles_multi(qs, g)
            for qi, qv in enumerate(qs):
                labels = base + (("p", qv),)
                out.append(TimeSeries(labels, by_q[qi],
                                      exemplars.get(base, [])))
        for base, rows in moment_rows.items():
            # all q's per step come off ONE solved CDF (monotone in q);
            # non-converged steps fall back to the support midpoint and
            # count into tempo_moments_solver_fallback_total
            vals, failed = msk.quantiles_for_rows(
                rows, kc, msk.QUERY_LO, msk.QUERY_HI, qs)
            if failed.any():
                zmax = msk.QUERY_LO + rows[:, kc + 1]
                zmin = msk.QUERY_HI - rows[:, kc + 2]
                mid = np.exp((np.minimum(zmin, zmax)
                              + np.maximum(zmin, zmax)) / 2.0)
                vals = np.where(np.isnan(vals), mid[:, None], vals)
            vals = vals / 1e9   # ns → seconds, like log2_quantile
            for qi, qv in enumerate(qs):
                labels = base + (("p", qv),)
                out.append(TimeSeries(labels, vals[:, qi].astype(np.float64),
                                      exemplars.get(base, [])))
        return out


def metrics_kind(query: str) -> A.MetricsKind:
    """Metrics stage kind of a query, without building an evaluator."""
    q = parse(query)
    if q.metrics is None:
        raise ValueError("not a metrics query: " + query)
    return q.metrics.kind


def query_range(req: QueryRangeRequest,
                view_iter: Iterable[tuple[ColumnView, np.ndarray]],
                device=None) -> list[TimeSeries]:
    """Single-node convenience: evaluate + combine + final in one call."""
    ev = MetricsEvaluator(req, batched=True, device=device)
    for view, cand in view_iter:
        if len(cand) == 0:
            continue
        ev.observe(view)
    comb = SeriesCombiner(ev.m.kind, req.n_steps)
    comb.add_all(ev.results())
    return comb.final(req)
