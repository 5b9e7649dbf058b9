"""Device-time ledger + online dispatch cost model.

Counterpart of `tempo_tpu/obs/devtime.py`, with the reference's
semantics: a dispatch's wall time is the host time around the
scheduler's dispatch call, with no device synchronisation added (a sync
per window would serialise the host and the card), so on the card it is
the host cost of building and launching a merged batch, not the kernel's
device time.

Every nanosecond the device spends belongs to some (kernel, shape
bucket, priority class, mesh shard-width) — and, through the jobs that
rode the batch, to some tenant. The scheduler already measured dispatch
wall time (`tempo_sched_dispatch_duration_seconds`) but threw the
structure away; this module is the process-wide **ledger** every sched
dispatch records into, and the substrate two consumers build on:

- **Attribution.** Per-tenant device-seconds (each merged batch's wall
  split across its jobs' tenants proportionally to submitted rows) ride
  `/metrics`, `/status`, and — through `QueryStats.device_ns` — the
  qlog "query complete" line, so a read-cost investigation never needs
  a metrics join. The attribution invariant (tenant shares sum to the
  batch wall, within float rounding) is what the bench soak stage gates
  on.
- **Prediction.** An online per-(kernel, bucket) **affine cost model**
  (cost ≈ a + b·rows) fit from the ledger stream with exponentially
  decayed least squares and winsorized residuals (one GC pause must not
  poison the fit — the "TpuGraphs" observation that dispatch cost is a
  learnable function of shape, reduced to the two coefficients this
  scheduler actually needs). `DeviceScheduler` `tuning: auto` consults
  it to pick batch-window deadlines; `/status cost_model` and the
  `tempo_sched_cost_model_*` families expose the fit, and the
  `TempoSchedCostModelStale` alert fires when tuning is live but the
  model has stopped learning.

Both singletons (`LEDGER`, `COST_MODEL`) are process-wide like the
scheduler that feeds them; `reset()` drops state between tests. The hot
path is one lock + a handful of dict updates per MERGED BATCH (not per
row, not per span) — the exposition renders through callback families,
so scrapes never block dispatch.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Callable

from tempo_tpu_torch.obs.runtime import RUNTIME
from tempo_tpu_torch.obs.registry import exponential_buckets

# priority-class names duplicated from tempo_tpu_torch.sched to avoid an
# import cycle (sched imports this module for the ledger hooks)
_CLASS_NAMES = ("ingest", "query", "compaction")


class _Cell:
    """One ledger accumulator row (all monotonic counters)."""

    __slots__ = ("wall_ns", "batches", "rows", "padded_rows",
                 "queue_wait_ns", "h2d_bytes")

    def __init__(self) -> None:
        self.wall_ns = 0
        self.batches = 0
        self.rows = 0
        self.padded_rows = 0
        self.queue_wait_ns = 0
        self.h2d_bytes = 0


class DeviceTimeLedger:
    """Where every device-nanosecond goes, keyed
    (kernel, shape bucket, priority class, mesh shard-width).

    `shard` is the dispatch's 'data'-shard width as a string ("" for
    single-device dispatches): a mesh dispatch occupies every shard for
    its wall time, so the wall is a per-mesh — not per-chip — figure,
    the same convention the sched occupancy families use.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._cells: dict[tuple, _Cell] = {}
        self._tenant_ns: dict[str, int] = {}

    # -- recording ---------------------------------------------------------

    def record_batch(self, *, kernel: str, bucket: int, prio: int,
                     shards: int, wall_ns: int, rows: int,
                     padded_rows: int, queue_wait_ns: int,
                     h2d_bytes: int,
                     tenant_rows: "dict[str, int] | None" = None) -> None:
        """One dispatched batch (merged row batch, or a fn job with
        bucket 0 / rows 0). `tenant_rows` maps tenant → submitted rows
        for the jobs that rode this batch; the batch wall splits across
        them proportionally (padding is overhead shared the same way),
        so per-tenant device-seconds sum to total device time."""
        cls = _CLASS_NAMES[prio] if 0 <= prio < len(_CLASS_NAMES) \
            else str(prio)
        key = (kernel, int(bucket), cls, str(shards) if shards else "")
        wall_ns = max(int(wall_ns), 0)
        with self._lock:
            c = self._cells.get(key)
            if c is None:
                c = self._cells[key] = _Cell()
            c.wall_ns += wall_ns
            c.batches += 1
            c.rows += max(int(rows), 0)
            c.padded_rows += max(int(padded_rows), 0)
            c.queue_wait_ns += max(int(queue_wait_ns), 0)
            c.h2d_bytes += max(int(h2d_bytes), 0)
            if tenant_rows:
                total = sum(tenant_rows.values())
                if total > 0:
                    for t, r in tenant_rows.items():
                        self._tenant_ns[t] = self._tenant_ns.get(t, 0) \
                            + wall_ns * r // total
                else:
                    # fn jobs carry no rows: split the wall evenly
                    share = wall_ns // len(tenant_rows)
                    for t in tenant_rows:
                        self._tenant_ns[t] = \
                            self._tenant_ns.get(t, 0) + share
            else:
                # no tenant on the job (deep read-path kernels launch
                # below the tenant boundary): keep the sum invariant
                # exact with an explicit bucket — "how much device time
                # is not tenant-attributable" is itself a signal
                self._tenant_ns["_unattributed"] = \
                    self._tenant_ns.get("_unattributed", 0) + wall_ns

    # -- reading -----------------------------------------------------------

    def total_device_ns(self) -> int:
        with self._lock:
            return sum(c.wall_ns for c in self._cells.values())

    def tenant_device_ns(self) -> dict[str, int]:
        with self._lock:
            return dict(self._tenant_ns)

    def snapshot(self) -> dict[tuple, dict]:
        """{(kernel, bucket, class, shard) -> counters dict} (tests and
        /status)."""
        with self._lock:
            return {k: {s: getattr(c, s) for s in _Cell.__slots__}
                    for k, c in self._cells.items()}

    def _rows(self, field: str) -> list:
        with self._lock:
            return [((k[0], str(k[1]), k[2], k[3]), float(getattr(c, field)))
                    for k, c in self._cells.items()]

    def status(self, top_tenants: int = 10) -> dict:
        """The /status "devtime" object: totals plus the costliest
        tenants (full per-tenant detail is on /metrics)."""
        with self._lock:
            total = sum(c.wall_ns for c in self._cells.values())
            queue = sum(c.queue_wait_ns for c in self._cells.values())
            rows = sum(c.rows for c in self._cells.values())
            padded = sum(c.padded_rows for c in self._cells.values())
            tenants = sorted(self._tenant_ns.items(),
                             key=lambda kv: -kv[1])[:top_tenants]
        out = {
            "device_seconds_total": round(total / 1e9, 6),
            "queue_wait_seconds_total": round(queue / 1e9, 6),
            "rows_total": rows,
            "padded_rows_total": padded,
            "top_tenant_device_seconds": {
                t: round(ns / 1e9, 6) for t, ns in tenants},
        }
        # the paged layout's HBM cost, attributed next to device time:
        # arena bytes held per tenant (page ownership × page bytes)
        from tempo_tpu_torch.registry import pages
        pool = pages.active()
        if pool is not None:
            top = sorted(pool.tenant_bytes().items(),
                         key=lambda kv: -kv[1])[:top_tenants]
            out["top_tenant_arena_bytes"] = dict(top)
        return out


class _PairFit:
    """Decayed least-squares state for one (kernel, bucket) pair: EWMA
    moments of (rows, cost) solve the 2x2 normal equations for
    cost ≈ a + b·rows."""

    __slots__ = ("n", "m_r", "m_r2", "m_y", "m_ry", "err", "err_med",
                 "med_y", "last_t")

    def __init__(self) -> None:
        self.n = 0
        self.m_r = self.m_r2 = self.m_y = self.m_ry = 0.0
        self.err = 0.0          # EWMA of |pred - actual| / actual
        # streaming MEDIAN of the same relative error (constant-step
        # sign update): per-sample jitter visibility — on a contended
        # host individual dispatch walls swing ±50% with GIL/scheduler
        # noise no shape model can predict
        self.err_med = 0.0
        # streaming median of the RAW observed cost (relative-step sign
        # update): the "typical dispatch cost" the tuner actually plans
        # on; prediction vs this median is the soak's accuracy gate
        self.med_y = 0.0
        self.last_t = 0.0

    def coeffs(self) -> "tuple[float, float] | None":
        """(a, b) seconds / seconds-per-row, or None while degenerate
        (single rows value seen: fall back to a pure mean — b = 0).
        Dispatch cost is monotone in rows: a negative fitted slope is
        always contention noise, collapse it to the mean."""
        if self.n == 0:
            return None
        var = self.m_r2 - self.m_r * self.m_r
        if var <= 1e-12 * max(self.m_r2, 1.0):
            return (self.m_y, 0.0)
        b = (self.m_ry - self.m_r * self.m_y) / var
        if b < 0:
            return (self.m_y, 0.0)
        a = self.m_y - b * self.m_r
        return (a, b)


class CostModel:
    """Online affine dispatch-cost model, per (kernel, shape bucket).

    - `observe()` is called by the scheduler once per merged dispatch
      with the REAL rows and the measured wall seconds.
    - Robustness: once a pair is warm, an observation is winsorized into
      [pred/clip, pred*clip] before it updates the moments — a one-off
      stall (GC, XLA re-trace, a neighbor hogging the chip) shifts the
      fit by at most the clip factor instead of poisoning it.
    - `predict()` answers in seconds; None until the pair has
      `min_samples` observations (the scheduler's static-window
      fallback condition).
    """

    def __init__(self, *, alpha: float = 0.05, min_samples: int = 50,
                 clip: float = 4.0,
                 now: Callable[[], float] = time.time) -> None:
        self.alpha = float(alpha)
        self.min_samples = int(min_samples)
        self.clip = float(clip)
        self.now = now
        self._lock = threading.Lock()
        self._pairs: dict[tuple[str, int], _PairFit] = {}

    # -- learning ----------------------------------------------------------

    def observe(self, kernel: str, bucket: int, rows: int,
                seconds: float) -> None:
        if seconds < 0 or rows < 0:
            return
        key = (kernel, int(bucket))
        with self._lock:
            p = self._pairs.get(key)
            if p is None:
                p = self._pairs[key] = _PairFit()
            y = float(seconds)
            if p.n == 0:
                p.med_y = y
            else:
                step = max(abs(p.med_y) * 0.05, 1e-7)
                p.med_y = max(p.med_y + (step if y > p.med_y else -step),
                              0.0)
            c = p.coeffs()
            if c is not None and p.n >= self.min_samples:
                pred = max(c[0] + c[1] * rows, 1e-9)
                x = abs(pred - y) / max(y, 1e-9)
                p.err += self.alpha * (x - p.err)
                p.err_med = max(
                    p.err_med + (0.02 if x > p.err_med else -0.02), 0.0)
                y = min(max(y, pred / self.clip), pred * self.clip)
            elif p.n >= 3:
                # not warm enough to predict, but already robust: clip
                # against the pair's own running mean so one early
                # scheduling stall (tenant-creation phase, a GC pause)
                # cannot seed the moments orders of magnitude high
                ref = max(p.m_y, 1e-12)
                y = min(max(y, ref / self.clip), ref * self.clip)
            # debiased warm-up: behave as a plain running mean until the
            # sample count overtakes 1/alpha, THEN decay exponentially —
            # a fixed small alpha would keep early outliers alive for
            # ~1/alpha more observations
            a = max(self.alpha, 1.0 / (p.n + 1))
            r = float(rows)
            p.m_r += a * (r - p.m_r)
            p.m_r2 += a * (r * r - p.m_r2)
            p.m_y += a * (y - p.m_y)
            p.m_ry += a * (r * y - p.m_ry)
            p.n += 1
            p.last_t = self.now()

    # -- prediction --------------------------------------------------------

    def warm(self, kernel: str, bucket: int) -> bool:
        with self._lock:
            p = self._pairs.get((kernel, int(bucket)))
            return p is not None and p.n >= self.min_samples

    def warm_pairs(self, kernel: "str | None" = None) -> list:
        with self._lock:
            return [k for k, p in self._pairs.items()
                    if p.n >= self.min_samples
                    and (kernel is None or k[0] == kernel)]

    def predict(self, kernel: str, bucket: int,
                rows: "int | None" = None) -> "float | None":
        """Predicted dispatch seconds for `rows` real rows in `bucket`
        (rows defaults to the bucket itself), or None while cold. When
        the exact bucket is cold but a neighbor bucket of the same
        kernel is warm, extrapolates from the nearest warm bucket — the
        tuner must be able to score a window it has never closed at."""
        key = (kernel, int(bucket))
        r = float(bucket if rows is None else rows)
        with self._lock:
            p = self._pairs.get(key)
            if p is None or p.n < self.min_samples:
                near = None
                for (k, b), q in self._pairs.items():
                    if k != kernel or q.n < self.min_samples:
                        continue
                    if near is None or abs(math.log2(max(b, 1))
                                           - math.log2(max(bucket, 1))) < \
                            abs(math.log2(max(near[0], 1))
                                - math.log2(max(bucket, 1))):
                        near = (b, q)
                if near is None:
                    return None
                p = near[1]
            c = p.coeffs()
        if c is None:
            return None
        return max(c[0] + c[1] * r, 0.0)

    def rel_error(self, kernel: str, bucket: int) -> "float | None":
        """EWMA (mean) relative prediction error for a warm pair, or
        None while cold. Outlier-sensitive by design: a rising mean
        with a flat median means stalls, not a bad fit."""
        with self._lock:
            p = self._pairs.get((kernel, int(bucket)))
            if p is None or p.n <= self.min_samples:
                return None
            return p.err

    def rel_error_median(self, kernel: str, bucket: int) -> "float | None":
        """Streaming median of the PER-SAMPLE relative prediction error
        (dispatch jitter visibility), or None while cold."""
        with self._lock:
            p = self._pairs.get((kernel, int(bucket)))
            if p is None or p.n <= self.min_samples:
                return None
            return p.err_med

    def typical_error(self, kernel: str, bucket: int) -> "float | None":
        """|predicted − observed-median| / observed-median for a warm
        pair — prediction accuracy against the TYPICAL dispatch cost
        (what the window tuner plans on), immune to the per-dispatch
        GIL/scheduling jitter no shape model can predict. The bench
        soak gates this ≤ 0.25 on warm pairs. None while cold."""
        with self._lock:
            p = self._pairs.get((kernel, int(bucket)))
            if p is None or p.n < self.min_samples or p.med_y <= 0:
                return None
            c = p.coeffs()
            if c is None:
                return None
            pred = max(c[0] + c[1] * p.m_r, 0.0)
            return abs(pred - p.med_y) / p.med_y

    # -- exposition --------------------------------------------------------

    def status(self) -> list[dict]:
        """The /status "cost_model" array: one entry per pair, warm
        first, coefficients in engineering units."""
        now = self.now()
        with self._lock:
            items = sorted(self._pairs.items(),
                           key=lambda kv: (-kv[1].n, kv[0]))
            out = []
            for (kernel, bucket), p in items:
                c = p.coeffs()
                typical = None
                if c is not None and p.med_y > 0:
                    typical = abs(max(c[0] + c[1] * p.m_r, 0.0)
                                  - p.med_y) / p.med_y
                out.append({
                    "kernel": kernel, "bucket": bucket, "samples": p.n,
                    "warm": p.n >= self.min_samples,
                    "a_us": round(c[0] * 1e6, 3) if c else None,
                    "b_ns_per_row": round(c[1] * 1e9, 3) if c else None,
                    "typical_cost_us": round(p.med_y * 1e6, 3),
                    "typical_error": round(typical, 4)
                    if typical is not None else None,
                    "rel_error": round(p.err, 4),
                    "rel_error_median": round(p.err_med, 4),
                    "age_s": round(max(now - p.last_t, 0.0), 3),
                })
        return out

    def _gauge_rows(self, what: str) -> list:
        now = self.now()
        with self._lock:
            out = []
            for (kernel, bucket), p in self._pairs.items():
                c = p.coeffs()
                if c is None:
                    continue
                if what == "typical":
                    if p.med_y <= 0:
                        continue
                    v = abs(max(c[0] + c[1] * p.m_r, 0.0)
                            - p.med_y) / p.med_y
                else:
                    v = {"a": c[0], "b": c[1], "err": p.err,
                         "err_med": p.err_med,
                         "age": max(now - p.last_t, 0.0)}[what]
                out.append(((kernel, str(bucket)), float(v)))
        return out


# ---------------------------------------------------------------------------
# process-wide singletons + test reset
# ---------------------------------------------------------------------------

LEDGER = DeviceTimeLedger()
COST_MODEL = CostModel()


def reset() -> None:
    """Drop ledger + model state (test isolation — mirrors sched.reset;
    the singletons keep their identity so registered callback families
    stay valid)."""
    with LEDGER._lock:
        LEDGER._cells.clear()
        LEDGER._tenant_ns.clear()
    with COST_MODEL._lock:
        COST_MODEL._pairs.clear()


# ---------------------------------------------------------------------------
# /metrics families (process-wide RUNTIME registry, callback-backed:
# scrapes snapshot the ledger, dispatch never touches the registry)
# ---------------------------------------------------------------------------

_LEDGER_LABELS = ("kernel", "bucket", "class", "shard")

RUNTIME.counter_func(
    "tempo_devtime_device_seconds_total",
    lambda: [(k, v / 1e9) for k, v in LEDGER._rows("wall_ns")],
    help="Device-dispatch wall seconds by kernel, shape bucket, priority "
         "class, and mesh shard-width (shard=\"\" = single-device) — the "
         "device-time ledger's primary axis",
    labels=_LEDGER_LABELS)
RUNTIME.counter_func(
    "tempo_devtime_batches_total",
    lambda: LEDGER._rows("batches"),
    help="Dispatched batches recorded in the device-time ledger",
    labels=_LEDGER_LABELS)
RUNTIME.counter_func(
    "tempo_devtime_submitted_rows_total",
    lambda: LEDGER._rows("rows"),
    help="Real (caller-submitted) rows dispatched, by ledger key — "
         "with padded_rows, the shape-bucket padding overhead split "
         "the tuner is minimizing against",
    labels=_LEDGER_LABELS)
RUNTIME.counter_func(
    "tempo_devtime_padded_rows_total",
    lambda: LEDGER._rows("padded_rows"),
    help="Padding rows dispatched beyond real rows, by ledger key",
    labels=_LEDGER_LABELS)
RUNTIME.counter_func(
    "tempo_devtime_queue_wait_seconds_total",
    lambda: [(k, v / 1e9) for k, v in LEDGER._rows("queue_wait_ns")],
    help="Seconds jobs waited between enqueue and dispatch start, "
         "summed per ledger key (queue-wait share of device latency)",
    labels=_LEDGER_LABELS)
RUNTIME.counter_func(
    "tempo_devtime_h2d_bytes_total",
    lambda: LEDGER._rows("h2d_bytes"),
    help="Host-to-device bytes shipped by dispatched batches, by ledger "
         "key (padded tensors, post-coalescing)",
    labels=_LEDGER_LABELS)
RUNTIME.counter_func(
    "tempo_devtime_tenant_device_seconds_total",
    lambda: [((t,), ns / 1e9)
             for t, ns in LEDGER.tenant_device_ns().items()],
    help="Device wall seconds attributed per tenant (each batch's wall "
         "split across its jobs' tenants by submitted rows; sums to "
         "tempo_devtime_device_seconds_total within rounding)",
    labels=("tenant",))
# enqueue → landed latency per ROW JOB (not per batch): the quantity
# `tuning: auto` minimizes and the soak stage's tuned-vs-static p99
# gate reads — window wait + queue wait + dispatch wall, the moment a
# push's rows became visible in device state
INGEST_LATENCY = RUNTIME.histogram(
    "tempo_devtime_ingest_visible_latency_seconds",
    "Enqueue to merged-dispatch-landed latency per coalesced row job, "
    "by kernel: the ingest-visible device latency the batch-window "
    "tuner minimizes (window wait + queue wait + dispatch wall)",
    labels=("kernel",),
    buckets=exponential_buckets(1e-4, 1.6, 24))


def quantile_from_counts(edges, counts, q: float) -> float:
    """Interpolated q-quantile from histogram bucket counts (len(edges)+1,
    last = overflow). Geometric interpolation inside a bucket — right for
    the exponential bucket layouts every histogram here uses. Returns 0.0
    on an empty histogram; the top edge when the quantile falls in the
    overflow bucket (a floor, not an estimate)."""
    total = sum(counts)
    if total <= 0:
        return 0.0
    target = max(q * total, 1e-12)
    cum = 0.0
    for i, c in enumerate(counts):
        cum += c
        if cum < target:
            continue
        if i >= len(edges):
            return float(edges[-1])
        hi = float(edges[i])
        lo = float(edges[i - 1]) if i > 0 else hi / 16.0
        frac = (target - (cum - c)) / c if c else 1.0
        return lo * (hi / lo) ** frac
    return float(edges[-1])


RUNTIME.gauge_func(
    "tempo_sched_cost_model_coeff_a_seconds",
    lambda: COST_MODEL._gauge_rows("a"),
    help="Fixed per-dispatch cost (intercept a of cost ≈ a + b·rows) "
         "fit online per (kernel, shape bucket)",
    labels=("kernel", "bucket"))
RUNTIME.gauge_func(
    "tempo_sched_cost_model_coeff_b_seconds_per_row",
    lambda: COST_MODEL._gauge_rows("b"),
    help="Marginal per-row cost (slope b of cost ≈ a + b·rows) fit "
         "online per (kernel, shape bucket)",
    labels=("kernel", "bucket"))
RUNTIME.gauge_func(
    "tempo_sched_cost_model_rel_error",
    lambda: COST_MODEL._gauge_rows("err"),
    help="EWMA (mean) relative prediction error of the dispatch cost "
         "model per (kernel, shape bucket); outlier-sensitive — "
         "compare against the median family to separate stalls from "
         "a bad fit",
    labels=("kernel", "bucket"))
RUNTIME.gauge_func(
    "tempo_sched_cost_model_rel_error_median",
    lambda: COST_MODEL._gauge_rows("err_med"),
    help="Streaming median of the per-sample relative prediction error "
         "per (kernel, shape bucket) — dispatch jitter the shape model "
         "cannot (and should not) absorb",
    labels=("kernel", "bucket"))
RUNTIME.gauge_func(
    "tempo_sched_cost_model_typical_error",
    lambda: COST_MODEL._gauge_rows("typical"),
    help="Prediction vs the observed MEDIAN dispatch cost per (kernel, "
         "shape bucket) — the tuner plans on typical costs; the soak "
         "gate holds warm pairs under 0.25",
    labels=("kernel", "bucket"))
RUNTIME.gauge_func(
    "tempo_sched_cost_model_age_seconds",
    lambda: COST_MODEL._gauge_rows("age"),
    help="Seconds since the cost model last observed a dispatch for "
         "this (kernel, bucket) — TempoSchedCostModelStale fires when "
         "tuning is active but every pair has gone quiet",
    labels=("kernel", "bucket"))


__all__ = ["DeviceTimeLedger", "CostModel", "LEDGER", "COST_MODEL",
           "INGEST_LATENCY", "quantile_from_counts", "reset"]
