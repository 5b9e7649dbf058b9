"""Process-wide device-execution scheduler: continuous micro-batching.

Counterpart of `tempo_tpu/sched/scheduler.py`, with the reference's
semantics. Many small span-metrics pushes, from any tenant, are queued
and merged into one padded power-of-two dispatch per processor and batch
window (the mergeable-sketch updates commute, so concatenation is exact
for the counts); on the card that is one packed `[4, bucket]` host-to-
device copy and one launch of the paged fused update (K1) per merged
window, instead of one per push.

- **Bounded per-priority-class queues** (live-ingest > query >
  compaction) with load shedding: an over-full class never queues
  unboundedly; excess jobs execute inline on the caller (shed) and are
  counted. `ingest_retry_after()` / `keep_fraction()` are the admission
  and overload-sampling signals a distributor consults.
- **A coalescer** that merges same-kernel jobs targeting the same state
  (same `merge_key`) into ONE padded tensor per array role, or with
  `pack=True` one row-major f32 matrix `[n_roles, bucket]`. Padding rows
  carry slot -1 / weight 0 and are dropped by the kernels.
- **Power-of-two shape bucketing**: merged batches pad to the next power
  of two (floor `min_bucket_rows`). K1's launch plan does not depend on
  the batch size, so a bucket costs no plan (`tempo_torch_k1_launch_
  plans_total` stays flat); `bucket_warmups` counts first-seen buckets as
  the reference does.
- **An adaptive batch window**: a merge group closes when its occupancy
  reaches `occupancy_target * max_batch_rows` OR when `batch_window_ms`
  elapses since its first job, whichever comes first. Query-class jobs
  never wait on the window.

Every dispatch records into the device-time ledger (`obs/devtime.py`)
and feeds the online dispatch cost model that `tuning: auto` consults
(`WindowTuner`). The `tempo_sched_*` families register in the process
`obs.runtime.RUNTIME` registry under the reference's names.

The dispatch runs on the worker thread (or inline on a shedding
producer); a failed dispatch lands on each of its jobs' `Job.error` and
in `dispatch_errors`, never on a fallback. Under the serving mesh,
`submit_rows(align=, shards=)` rounds the merged bucket up to the mesh's
'data' shard count and records occupancy and padding per shard.
The scheduler is config-gated (`SchedConfig.enabled`); callers keep
their synchronous direct route, taken when it is off or absent.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import math
import threading
import time
from collections import OrderedDict, deque
from typing import Callable, Sequence

import numpy as np

from tempo_tpu_torch.utils import faults

from tempo_tpu_torch.obs import devtime
from tempo_tpu_torch.utils import tracing

_LOG = logging.getLogger("tempo_tpu_torch.sched")

# priority classes, best first (live ingest must never starve behind an
# expensive analytical scan; compaction yields to both)
PRIO_INGEST, PRIO_QUERY, PRIO_COMPACTION = 0, 1, 2
CLASS_NAMES = ("ingest", "query", "compaction")


class QueryBackpressure(RuntimeError):
    """The query class is saturated: the frontend rejects NEW requests
    (503 + Retry-After) instead of queuing them unboundedly — already
    admitted work still runs (shed executes inline)."""

    def __init__(self, retry_after_s: float = 1.0) -> None:
        super().__init__("device scheduler query queue saturated")
        self.retry_after_s = retry_after_s


@dataclasses.dataclass
class SchedConfig:
    """Knobs for the shared device-execution scheduler (`sched:` in the
    app YAML)."""

    enabled: bool = True
    # bounded submission queues per priority class (jobs, not rows)
    max_queue_ingest: int = 1024
    max_queue_query: int = 512
    max_queue_compaction: int = 256
    # adaptive batch window: a merge group closes on occupancy target or
    # deadline, whichever first
    batch_window_ms: float = 2.0
    occupancy_target: float = 0.75
    max_batch_rows: int = 16384          # coalesced rows per dispatch
    min_bucket_rows: int = 64            # smallest pow-2 shape bucket
    retry_after_s: float = 1.0           # advertised on 429/503 rejections
    # ingest staging pipeline depth: how many decoded-but-undispatched
    # batches a producer may run AHEAD of the device (the staging-buffer
    # ring is depth+1 deep). 0 disables the decode/update overlap ring —
    # submissions still coalesce, but every push allocates fresh staging.
    # The ring serves the staged native push paths, which come with the
    # port's C++ host layer; the SpanBatch route never uses it, so the
    # port behaves as the reference does at depth 0 whatever this says.
    pipeline_depth: int = 2
    # graceful-overload sampling (the pressure → keep-fraction
    # controller): when the live-ingest queue fills past
    # `sampling_start_pressure` of its bound, the distributor's span
    # sampler shrinks the per-push keep fraction linearly from 1.0 down
    # to `sampling_min_fraction` at full saturation — overload degrades
    # to a representative sampled stream FIRST; the hard 429 (which
    # still fires at depth == limit) becomes the escalation of last
    # resort. Below the start pressure the fraction is exactly 1.0 and
    # the sampling stage is bypassed entirely (bit-identical path).
    # Per-tenant policy/floors live in overrides (`sampling:` limits).
    sampling_enabled: bool = True
    sampling_start_pressure: float = 0.5
    sampling_min_fraction: float = 0.05
    # EWMA time constant for the published fraction: pressure is spiky
    # push to push; the controller must ramp, not flap. 0 = unsmoothed.
    sampling_smoothing_s: float = 2.0
    # scheduler tuning mode: "static" keeps the fixed batch_window_ms /
    # occupancy close; "auto" lets the scheduler pick per-kernel batch
    # windows (and pow-2 bucket close targets) that minimize PREDICTED
    # ingest latency using the online dispatch cost model fit from the
    # device-time ledger (obs/devtime.py). Auto falls back to the static
    # window per kernel until the model is warm, and is HARD-BOUNDED:
    # the tuned window stays inside [tuning_window_min_ms,
    # tuning_window_max_ms], the tuned close target never exceeds the
    # static occupancy close, and flush()/backpressure semantics are
    # untouched (force-drain ignores windows; queue bounds are not
    # tuned).
    tuning: str = "static"
    tuning_window_min_ms: float = 0.25
    tuning_window_max_ms: float = 8.0
    tuning_interval_s: float = 0.5      # how often a kernel's choice refits
    # compaction-class minimum dispatch share: compaction jobs normally
    # run only when ingest/query are fully idle, which under SUSTAINED
    # load is NEVER — the cold tier would starve forever. With share s,
    # after ceil(1/s) consecutive drain cycles that skipped a waiting
    # compaction job, one is force-dispatched (so compaction gets at
    # least ~s of drain cycles under saturation). 0 restores pure
    # idle-only dispatch. Bounded (0, 0.5] by config.check().
    compaction_min_share: float = 0.05


def fraction_for_pressure(pressure: float, start: float,
                          floor: float) -> float:
    """Pure pressure → keep-fraction control law (the testable core of
    the overload controller): 1.0 at or below `start`, then a linear
    ramp down to `floor` at full saturation (pressure 1.0). Exactly 1.0
    below the threshold — the distributor bypasses its sampling stage
    entirely there, keeping the unpressured path bit-identical."""
    if pressure <= start:
        return 1.0
    if start >= 1.0:
        return 1.0
    span = 1.0 - start
    frac = 1.0 - (min(pressure, 1.0) - start) / span * (1.0 - floor)
    return max(min(frac, 1.0), floor)


def bucket_rows(n: int, lo: int = 64, hi: int | None = None) -> int:
    """Power-of-two shape bucket for a row count: next pow2 >= max(n, lo)
    (capped at `hi` when given). The whole point of bucketing is a SMALL
    closed set of shapes reaching the kernels."""
    b = max(int(lo), 1)
    while b < n:
        b <<= 1
    if hi is not None:
        b = min(b, hi)
    return b


class WindowTuner:
    """`tuning: auto`: per-kernel batch-window deadlines and bucket
    close targets chosen to minimize PREDICTED ingest latency.

    Model (the testable core): rows arrive at a measured rate λ (EWMA of
    the kernel's submit stream). A window of length w accumulates ≈ λ·w
    rows, pads to the pow-2 bucket B(λ·w), and pays the cost model's
    predicted dispatch wall c(B, λ·w). The first row of the window
    observes ≈ w + c latency — the window-driven ingest tail — so the
    tuner picks, over a geometric candidate grid inside the configured
    bounds, the w minimizing w + c subject to FEASIBILITY c ≤ w (the
    device must drain one window's batch within the window, or the
    queue grows without bound and backpressure fires). If no candidate
    is feasible the device is saturated regardless of windowing: the
    largest window wins (maximum amortization). While the cost model is
    cold for a kernel the answer is None and the scheduler keeps its
    static window — warm-up is observable as
    tempo_sched_tuning_active=0.

    The hard guard lives in the CALLER (`_group_close_params`): tuned
    windows are clamped to the configured bounds and the tuned close
    target can only LOWER the static occupancy close, so backpressure
    and flush semantics are exactly the static mode's.
    """

    N_CANDIDATES = 9

    def __init__(self, now: Callable[[], float] = time.monotonic) -> None:
        self.now = now
        self._lock = threading.Lock()
        # kernel -> [rows accumulated since last refit, refit wall t,
        #            EWMA rows/s, (window_s, target_rows) | None]
        self._state: dict[str, list] = {}

    def note_rows(self, kernel: str, rows: int) -> None:
        """Per-submit arrival accounting (called under no other lock)."""
        with self._lock:
            st = self._state.get(kernel)
            if st is None:
                self._state[kernel] = [rows, self.now(), 0.0, None]
            else:
                st[0] += rows

    def choice(self, kernel: str, cfg: SchedConfig
               ) -> "tuple[float, int] | None":
        """(window_seconds, bucket_target_rows) for a kernel, or None
        while the cost model is cold (static fallback). Cached; refits
        at most every cfg.tuning_interval_s."""
        now = self.now()
        with self._lock:
            st = self._state.get(kernel)
            if st is None:
                st = self._state[kernel] = [0, now, 0.0, None]
            dt = now - st[1]
            if dt < cfg.tuning_interval_s:
                # cache None picks too: a cold model must not turn
                # every submit into a full grid refit under _cond, nor
                # reset the arrival accumulator before it has seen a
                # full interval of traffic
                return st[3]
            if dt > 0:
                rate = st[0] / dt
                # EWMA over refit intervals: the arrival rate swings
                # push to push, the window choice should not
                st[2] = rate if st[2] == 0.0 else st[2] + 0.3 * (rate - st[2])
            st[0], st[1] = 0, now
            rate = st[2]
        lo = max(cfg.tuning_window_min_ms, 1e-3) / 1e3
        hi = max(cfg.tuning_window_max_ms, cfg.tuning_window_min_ms) / 1e3
        best = None          # (latency, window, target)
        fallback = None      # largest window with any prediction
        step = (hi / lo) ** (1.0 / max(self.N_CANDIDATES - 1, 1))
        w = lo
        for _ in range(self.N_CANDIDATES):
            exp_rows = max(rate * w, 1.0)
            bucket = bucket_rows(int(math.ceil(exp_rows)),
                                 cfg.min_bucket_rows, cfg.max_batch_rows)
            cost = devtime.COST_MODEL.predict(kernel, bucket,
                                              min(exp_rows, bucket))
            if cost is not None:
                latency = w + cost
                fallback = (latency, w, bucket)
                if cost <= w and (best is None or latency < best[0]):
                    best = (latency, w, bucket)
            w *= step
        pick = best or fallback
        out = (pick[1], pick[2]) if pick is not None else None
        with self._lock:
            st = self._state.get(kernel)
            if st is not None:
                st[3] = out
        return out

    def windows_ms(self) -> list:
        """[(kernel, tuned window ms), ...] for the exposition gauge."""
        with self._lock:
            return [(k, st[3][0] * 1e3) for k, st in self._state.items()
                    if st[3] is not None]


class Job:
    """One unit of device work. Row jobs (`arrays` set) are coalescible:
    same-merge_key jobs concatenate into one padded tensor per array
    role. Fn jobs (`fn` set) execute as-is in priority order."""

    __slots__ = ("priority", "kernel", "merge_key", "arrays", "pads",
                 "n_rows", "dispatch", "fn", "tenant", "enqueue_t",
                 "event", "result", "error", "stats", "wait_s",
                 "traceparent")

    def __init__(self, *, priority: int, kernel: str, merge_key=None,
                 arrays: "tuple | None" = None,
                 pads: "tuple | None" = None, n_rows: int = 0,
                 dispatch: "Callable | None" = None,
                 fn: "Callable | None" = None, tenant: str = "",
                 stats=None) -> None:
        self.priority = priority
        self.kernel = kernel
        self.merge_key = merge_key
        self.arrays = arrays
        self.pads = pads
        self.n_rows = n_rows
        self.dispatch = dispatch
        self.fn = fn
        self.tenant = tenant
        self.enqueue_t = 0.0
        self.event = threading.Event()
        self.result = None
        self.error: "BaseException | None" = None
        self.stats = stats     # caller's QueryStats, adopted by the worker
        self.wait_s = 0.0      # enqueue → execution-start (set by worker)
        # submitter's trace context: the dispatch span LINKS the whole
        # coalesced batch back to each contributing request's tree
        # (fn jobs re-enter it so device work parents under the query)
        self.traceparent = tracing.tracer().traceparent()

    def wait(self, timeout: "float | None" = None) -> bool:
        """Block until dispatched; re-raises the dispatch error, if any."""
        ok = self.event.wait(timeout)
        if ok and self.error is not None:
            raise self.error
        return ok


class _MergeGroup:
    """Pending coalescible jobs sharing one merge_key: one state plane,
    one dispatch closure, one eventual padded tensor."""

    __slots__ = ("kernel", "pads", "dispatch", "jobs", "rows", "first_t",
                 "pack", "align", "shards")

    def __init__(self, kernel: str, pads: tuple, dispatch: Callable,
                 first_t: float, pack: bool = False, align: int = 1,
                 shards: int = 0) -> None:
        self.kernel = kernel
        self.pads = pads
        self.dispatch = dispatch
        self.jobs: list[Job] = []
        self.rows = 0
        self.first_t = first_t
        self.pack = pack
        self.align = align
        self.shards = shards


class DeviceScheduler:
    """The shared scheduler. One per process in production (see
    `configure()` / `scheduler()`); tests construct their own with
    `start_worker=False` and drive `drain_once()` by hand."""

    def __init__(self, cfg: SchedConfig | None = None,
                 now: Callable[[], float] = time.monotonic,
                 start_worker: bool = True) -> None:
        self.cfg = cfg or SchedConfig()
        self.now = now
        self._cond = threading.Condition()
        # fn jobs per class; row jobs live in merge groups (ingest class)
        self._queues: tuple[deque, ...] = (deque(), deque(), deque())
        self._groups: "OrderedDict[object, _MergeGroup]" = OrderedDict()
        self._inflight = 0
        # re-entrant: a dispatched job may itself flush() (e.g. a
        # scheduled read that needs queued sketch updates drained first)
        self._drain_lock = threading.RLock()
        self._drainer: "int | None" = None
        # guards the per-kernel stat dicts: the worker and shed-path
        # caller threads dispatch concurrently, and losing increments
        # during saturation would corrupt exactly the metrics that
        # diagnose saturation
        self._stats_lock = threading.Lock()
        self._stop = threading.Event()
        self._worker: "threading.Thread | None" = None
        self._worker_ident: "int | None" = None
        # plain-dict stats (obs renders them through callback families;
        # the hot path pays dict increments, never registry locks)
        self.jobs_total = {c: 0 for c in CLASS_NAMES}
        self.shed_total = {c: 0 for c in CLASS_NAMES}
        self.batches_total: dict[str, int] = {}
        self.coalesced_total: dict[str, int] = {}
        self.padding_waste_bytes: dict[str, int] = {}
        # serving-mesh split of the padding waste, keyed (kernel, shard):
        # only mesh dispatches (submits with shards set) populate it; the
        # exposition renders it as `shard` label rows next to the
        # non-mesh aggregate (shard="") without double counting
        self.padding_waste_shard: dict[tuple[str, str], int] = {}
        self.bucket_warmups: dict[str, int] = {}
        self.dispatch_errors = 0
        # compaction-class anti-starvation: consecutive drains that left
        # a non-empty compaction queue untouched, and how many jobs the
        # minimum-dispatch-share floor force-dispatched (guarded by _cond)
        self._comp_starved = 0
        self.comp_forced_total = 0
        self.occupancy_sum: dict[str, float] = {}
        self._warm_buckets: set[tuple] = set()
        # pressure → keep-fraction controller state (EWMA-smoothed; see
        # keep_fraction below). Guarded by _frac_lock: the distributor
        # reads per push from any receiver thread.
        self._frac_lock = threading.Lock()
        self._frac = 1.0
        self._frac_t: "float | None" = None
        # ingest jobs currently being dispatched (popped off the queues
        # but not yet landed) — the controller's pressure must include
        # them or it collapses to zero mid-drain (see control_pressure)
        self._inflight_ingest = 0
        # `tuning: auto` window/bucket chooser (always constructed —
        # only consulted when the mode says so, and the mode can change
        # via reconfigure())
        self._tuner = WindowTuner(now=now)
        if start_worker and self.cfg.enabled:
            self.start()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if self._worker is not None and self._worker.is_alive():
            return
        self._stop.clear()
        self._worker = threading.Thread(target=self._worker_loop,
                                        name="tempo-sched", daemon=True)
        self._worker.start()

    def stop(self, flush: bool = True) -> None:
        if flush:
            self.flush()
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        if self._worker is not None:
            self._worker.join(timeout=2)
            self._worker = None
            self._worker_ident = None

    def reconfigure(self, cfg: SchedConfig) -> None:
        """Adopt new knobs in place (multiple Apps in one process share
        the singleton; last writer wins)."""
        self.cfg = cfg
        if cfg.enabled:
            self.start()

    # -- introspection -----------------------------------------------------

    def _limit(self, prio: int) -> int:
        return (self.cfg.max_queue_ingest, self.cfg.max_queue_query,
                self.cfg.max_queue_compaction)[prio]

    def depth(self, prio: int) -> int:
        with self._cond:
            n = len(self._queues[prio])
            if prio == PRIO_INGEST:
                n += sum(len(g.jobs) for g in self._groups.values())
            return n

    def pending(self) -> int:
        with self._cond:
            return (sum(len(q) for q in self._queues)
                    + sum(len(g.jobs) for g in self._groups.values())
                    + self._inflight)

    def pressure(self) -> dict[str, float]:
        """class → fill ratio of its bounded queue (the backpressure
        signal the distributor and frontend consult)."""
        return {CLASS_NAMES[p]: self.depth(p) / max(self._limit(p), 1)
                for p in (PRIO_INGEST, PRIO_QUERY, PRIO_COMPACTION)}

    def ingest_saturated(self) -> bool:
        return self.cfg.enabled and \
            self.depth(PRIO_INGEST) >= self._limit(PRIO_INGEST)

    def query_saturated(self) -> bool:
        return self.cfg.enabled and \
            self.depth(PRIO_QUERY) >= self._limit(PRIO_QUERY)

    def ingest_retry_after(self) -> "float | None":
        """Seconds a rejected producer should back off, or None to
        admit — the `IngestBackpressure` hook contract."""
        return self.cfg.retry_after_s if self.ingest_saturated() else None

    def control_pressure(self) -> float:
        """Live-ingest pressure for the sampling controller: queued PLUS
        in-flight jobs over the bound (may exceed 1.0 while the device
        chews a popped backlog). The hard-429 signal stays queue-only —
        the bound protects queue memory — but the controller must keep
        sampling through a batchy drain, or the fraction sawtooths to
        1.0 every time the worker pops the backlog and re-saturates the
        moment full-row pushes resume."""
        with self._cond:
            inflight = self._inflight_ingest
        return (self.depth(PRIO_INGEST) + inflight) \
            / max(self._limit(PRIO_INGEST), 1)

    def keep_fraction(self) -> float:
        """The overload controller's current span keep-fraction in
        (0, 1]: 1.0 means sampling is off (the distributor bypasses its
        sampling stage entirely), anything lower tells the distributor
        to hash-sample non-forced spans at that rate. Driven by the SAME
        live-ingest queue that feeds `IngestBackpressure` (plus its
        in-flight tail, see control_pressure), so the escalation order
        is: full stream → sampled stream → 429.

        The published value is EWMA-smoothed (`sampling_smoothing_s`)
        because queue fill is spiky push to push; it snaps back to
        exactly 1.0 once the raw control law has fully recovered so the
        below-threshold path stays bit-identical."""
        cfg = self.cfg
        if not cfg.enabled or not cfg.sampling_enabled:
            return 1.0
        raw = fraction_for_pressure(self.control_pressure(),
                                    cfg.sampling_start_pressure,
                                    cfg.sampling_min_fraction)
        tau = cfg.sampling_smoothing_s
        if tau <= 0:
            return raw
        now = self.now()
        with self._frac_lock:
            if self._frac_t is None:
                self._frac = raw
            else:
                dt = max(now - self._frac_t, 0.0)
                # asymmetric: shed fast (tau/4), recover slowly (tau) —
                # a batchy drain makes raw pressure sawtooth, and a
                # controller that snaps back to 1.0 between drain cycles
                # re-saturates the queue with full-row pushes every cycle
                tau_eff = tau if raw > self._frac else tau / 4.0
                alpha = 1.0 - math.exp(-dt / tau_eff)
                self._frac += alpha * (raw - self._frac)
                if raw >= 1.0 and self._frac >= 0.99:
                    self._frac = 1.0   # recovered: exact off, not 0.99…
            self._frac_t = now
            return max(self._frac, cfg.sampling_min_fraction)

    def mean_occupancy(self, kernel: "str | None" = None) -> float:
        if kernel is not None:
            n = self.batches_total.get(kernel, 0)
            return self.occupancy_sum.get(kernel, 0.0) / n if n else 0.0
        n = sum(self.batches_total.values())
        return sum(self.occupancy_sum.values()) / n if n else 0.0

    # -- submission --------------------------------------------------------

    def submit_rows(self, kernel: str, merge_key, arrays: Sequence,
                    n_rows: int, dispatch: Callable,
                    pads: "Sequence | None" = None,
                    tenant: str = "", pack: bool = False,
                    align: int = 1, shards: int = 0) -> Job:
        """Enqueue a coalescible row batch (live-ingest class).

        `arrays` are row-aligned host vectors (one per kernel argument
        role); `pads[i]` is the fill value padding rows take in role i
        (defaults: -1 for the first role — the slot ids every scatter
        kernel drops — and 0 for the rest). `dispatch(*padded_arrays)`
        runs ONCE per merged batch on the worker thread and must bind the
        new device state itself (under its own state lock).

        `pack=True` ships the merged batch as ONE row-major f32 matrix
        `[n_roles, bucket]` (dispatch receives a single array): all roles
        ride one host-to-device copy. Every role must survive an f32
        round trip (slot ids do while the series capacity is < 2^24; the
        caller owns that gate).

        `align` (serving-mesh mode) rounds the merged pow-2 bucket UP to
        a multiple of it, so the single padded window splits evenly
        across the mesh's 'data' shards: ONE merged window feeds every
        shard's K1 launch. `shards` is the mesh dispatch's data-shard
        count for observability (0 = non-mesh): mesh dispatches emit one
        occupancy sample per shard under the `shard` label, non-mesh
        batches keep the aggregate under shard="".

        Never blocks and never drops data: on a saturated queue the job
        executes inline on the caller (shed, counted) — ADMISSION control
        lives at the distributor boundary, which consults
        `ingest_retry_after()` before accepting the bytes at all.
        """
        pads = tuple(pads) if pads is not None else \
            (-1,) + (0,) * (len(arrays) - 1)
        job = Job(priority=PRIO_INGEST, kernel=kernel, merge_key=merge_key,
                  arrays=tuple(arrays), pads=pads, n_rows=int(n_rows),
                  dispatch=dispatch, tenant=tenant)
        if not self.cfg.enabled:
            self._run_group(_group_of(job, pack, align, shards))
            return job
        if self.cfg.tuning == "auto":
            # arrival-rate accounting for the window tuner (outside
            # _cond: the tuner has its own lock)
            self._tuner.note_rows(kernel, job.n_rows)
        with self._cond:
            depth = len(self._queues[PRIO_INGEST]) + sum(
                len(g.jobs) for g in self._groups.values())
            if depth >= self._limit(PRIO_INGEST):
                self.shed_total["ingest"] += 1
            else:
                job.enqueue_t = self.now()
                g = self._groups.get(merge_key)
                if g is None:
                    g = self._groups[merge_key] = _MergeGroup(
                        kernel, pads, dispatch, job.enqueue_t, pack=pack,
                        align=align, shards=shards)
                g.jobs.append(job)
                g.rows += job.n_rows
                self.jobs_total["ingest"] += 1
                # wake the worker only when it has something new to DO:
                # the first job of a group (arm the deadline timer) or an
                # occupancy-threshold crossing (close now). Waking per
                # submit costs a context switch per push and was measured
                # to eat the whole coalescing win on the CPU backend.
                target = self._group_close_params(kernel)[1]
                if len(g.jobs) == 1 or (g.rows >= target
                                        and g.rows - job.n_rows < target):
                    self._cond.notify_all()
                return job
        # shed path: dispatch inline, outside the lock
        self._run_group(_group_of(job, pack, align, shards))
        return job

    def run(self, fn: Callable, kernel: str = "fn",
            priority: int = PRIO_QUERY, tenant: str = ""):
        """Execute `fn` (a device-dispatching closure) under scheduler
        ordering and return its result. Runs inline when the scheduler is
        disabled, when called FROM the worker (re-entrancy), when the
        scheduler is idle (no queue to order against — zero added
        latency on the common light-load path), or when the class queue
        is full (shed, counted)."""
        if not self.cfg.enabled or \
                threading.get_ident() == self._worker_ident:
            return fn()
        cls = CLASS_NAMES[priority]
        with self._cond:
            idle = not any(self._queues) and not self._groups \
                and self._inflight == 0
            if idle:
                self.jobs_total[cls] += 1
            elif len(self._queues[priority]) >= self._limit(priority):
                self.shed_total[cls] += 1
                idle = True            # run inline below
            else:
                from tempo_tpu_torch.obs import querystats
                job = Job(priority=priority, kernel=kernel, fn=fn,
                          tenant=tenant, stats=querystats.current())
                job.enqueue_t = self.now()
                self._queues[priority].append(job)
                self.jobs_total[cls] += 1
                self._cond.notify_all()
        if idle:
            return self._run_inline(fn, kernel, priority, tenant)
        job.wait()
        # pure QUEUE wait (enqueue → execution start, stamped by the
        # worker): the kernel's own wall time is already attributed by
        # the job's recording inside the adopted QueryStats scope
        wait_ns = max(int(job.wait_s * 1e9), 0)
        if job.stats is not None:
            job.stats.add_stage_ns("sched_wait", wait_ns)
            job.stats.add(sched_jobs=1)
        _QUEUE_WAIT.observe(wait_ns / 1e9, (cls,))
        return job.result

    def _run_inline(self, fn: Callable, kernel: str, priority: int,
                    tenant: str):
        """Idle/shed fast path of run(): execute on the caller, but
        still feed the device-time ledger and the ambient QueryStats —
        device-seconds attribution must not have a light-load blind
        spot (most query-class dispatches take exactly this path)."""
        from tempo_tpu_torch.obs import querystats

        t0 = time.perf_counter()
        try:
            return fn()
        finally:
            wall_ns = int((time.perf_counter() - t0) * 1e9)
            devtime.LEDGER.record_batch(
                kernel=kernel, bucket=0, prio=priority, shards=0,
                wall_ns=wall_ns, rows=0, padded_rows=0, queue_wait_ns=0,
                h2d_bytes=0,
                tenant_rows={tenant: 0} if tenant else None)
            st = querystats.current()
            if st is not None:
                st.add(device_ns=wall_ns)

    def _queued_count(self) -> int:
        with self._cond:
            return (sum(len(q) for q in self._queues)
                    + sum(len(g.jobs) for g in self._groups.values()))

    def flush(self, timeout: float = 30.0) -> bool:
        """Barrier: force-dispatch everything queued (windows ignored)
        and wait for in-flight work; returns True on a clean drain.
        Collection ticks, sketch-quantile reads, and stale-series purges
        call this so reads never miss queued updates (and slot reuse can
        never misroute one). Safe to call from INSIDE a dispatched job:
        the nested drain runs on the same thread and only waits for
        queued work, never for its own in-flight frame. Must not be
        called while holding a registry state_lock (dispatch closures
        take those locks)."""
        deadline = time.monotonic() + timeout
        inside = threading.get_ident() == self._drainer
        while time.monotonic() < deadline:
            if (self._queued_count() if inside else self.pending()) == 0:
                return True
            if not self.drain_once(force=True) and not inside:
                time.sleep(0.0005)
        # NEVER time out silently with work still queued: the caller is
        # about to read (or purge) state this barrier was supposed to
        # cover — a slot-reuse misroute downstream would be invisible
        _LOG.error("tempo-sched: flush timed out after %ss with %d jobs "
                   "still queued", timeout, self._queued_count())
        return False

    # -- draining ----------------------------------------------------------

    def _group_close_params(self, kernel: str) -> tuple[float, float]:
        """(window_seconds, close_target_rows) for a merge group — the
        static config, or the tuner's pick in `tuning: auto` once the
        cost model is warm for the kernel. HARD GUARD: the tuned window
        is clamped to the configured bounds and the tuned close target
        can only be ≤ the static occupancy close — auto mode can close
        batches earlier or stretch the window within bounds, but can
        never queue more rows per batch than static mode would, so the
        backpressure and flush semantics PR 5–6 rely on are untouched."""
        cfg = self.cfg
        window_s = cfg.batch_window_ms / 1000.0
        target = cfg.occupancy_target * cfg.max_batch_rows
        if cfg.tuning == "auto":
            choice = self._tuner.choice(kernel, cfg)
            if choice is not None:
                lo = max(cfg.tuning_window_min_ms, 1e-3) / 1e3
                hi = max(cfg.tuning_window_max_ms,
                         cfg.tuning_window_min_ms) / 1e3
                window_s = min(max(choice[0], lo), hi)
                target = min(float(choice[1]), target)
        return window_s, target

    def _group_ready(self, g: _MergeGroup, now: float) -> bool:
        window_s, target = self._group_close_params(g.kernel)
        return g.rows >= target or (now - g.first_t) >= window_s

    def tuned_window_ms(self, kernel: str) -> float:
        """The window currently in force for a kernel, milliseconds
        (the static config until auto mode is warm) — /status surface."""
        return self._group_close_params(kernel)[0] * 1e3

    def tuning_active(self) -> bool:
        """True when auto mode is live AND at least one kernel is being
        tuned from a warm cost model (the gauge behind
        TempoSchedCostModelStale's gating)."""
        return (self.cfg.enabled and self.cfg.tuning == "auto"
                and bool(self._tuner.windows_ms()))

    def _wait_budget_locked(self) -> "float | None":
        """How long the worker may sleep (caller holds _cond): 0 when
        anything is dispatchable right now, the nearest group deadline
        otherwise, None when idle."""
        if any(self._queues):
            return 0.0
        if not self._groups:
            return None
        now = self.now()
        if any(self._group_ready(g, now) for g in self._groups.values()):
            return 0.0
        return max(0.0, min(
            g.first_t + self._group_close_params(g.kernel)[0] - now
            for g in self._groups.values()))

    def drain_once(self, force: bool = False) -> bool:
        """One scheduling cycle: pop everything dispatchable right now
        and execute it in priority order (ready ingest groups, ingest
        fns, query fns; compaction only when nothing better is pending).
        Returns True when any work ran. Thread-safe: the worker loop and
        `flush()` callers serialize on the drain lock."""
        with self._drain_lock:
            prev_drainer, self._drainer = self._drainer, threading.get_ident()
            try:
                return self._drain_locked(force)
            finally:
                self._drainer = prev_drainer

    def _drain_locked(self, force: bool) -> bool:
        with self._cond:
            now = self.now()
            groups = [k for k, g in self._groups.items()
                      if force or self._group_ready(g, now)]
            ready = [self._groups.pop(k) for k in groups]
            ingest_fns = list(self._queues[PRIO_INGEST])
            self._queues[PRIO_INGEST].clear()
            query_fns = list(self._queues[PRIO_QUERY])
            self._queues[PRIO_QUERY].clear()
            comp_fns: list[Job] = []
            if (not ready and not ingest_fns and not query_fns
                    and not self._groups) or force:
                comp_fns = list(self._queues[PRIO_COMPACTION])
                self._queues[PRIO_COMPACTION].clear()
                self._comp_starved = 0
            elif self._queues[PRIO_COMPACTION]:
                # anti-starvation floor (compaction_min_share): sustained
                # ingest/query pressure means the idle-only branch above
                # never fires; after 1/share consecutive starved drains,
                # force ONE compaction job through — a bounded minimum
                # dispatch share that can't invert priorities
                self._comp_starved += 1
                share = self.cfg.compaction_min_share
                if share > 0.0 and self._comp_starved * share >= 1.0:
                    comp_fns = [self._queues[PRIO_COMPACTION].popleft()]
                    self._comp_starved = 0
                    self.comp_forced_total += 1
            n = (len(ready) + len(ingest_fns) + len(query_fns)
                 + len(comp_fns))
            n_ing = sum(len(g.jobs) for g in ready) + len(ingest_fns)
            self._inflight += n
            self._inflight_ingest += n_ing
        if n == 0:
            return False
        try:
            for g in ready:
                self._run_group(g)
            for job in ingest_fns + query_fns + comp_fns:
                self._run_fn(job)
        finally:
            with self._cond:
                self._inflight -= n
                self._inflight_ingest -= n_ing
                self._cond.notify_all()
        return True

    def _worker_loop(self) -> None:
        self._worker_ident = threading.get_ident()
        while not self._stop.is_set():
            with self._cond:
                # the readiness check and the wait share ONE lock
                # acquisition: a submit's notify between a check and a
                # separate wait would otherwise be lost and stretch a
                # 2ms batch window to the 200ms fallback sleep
                wait = self._wait_budget_locked()
                if wait is None or wait > 0:
                    self._cond.wait(min(wait, 0.2) if wait is not None
                                    else 0.2)
            if self._stop.is_set():
                break
            try:
                self.drain_once()
            except BaseException as e:       # noqa: BLE001 — keep alive
                # a dead worker is a total silent outage (every queued
                # caller hangs, ingest fills to 429): log and keep going
                _LOG.exception("tempo-sched: drain cycle failed: %r", e)

    # -- execution ---------------------------------------------------------

    def _run_group(self, g: _MergeGroup) -> None:
        """Coalesce one merge group into padded pow-2 tensors and
        dispatch, chunked at `max_batch_rows`."""
        jobs = g.jobs
        i = 0
        while i < len(jobs):
            chunk = [jobs[i]]
            rows = jobs[i].n_rows
            i += 1
            while i < len(jobs) and \
                    rows + jobs[i].n_rows <= self.cfg.max_batch_rows:
                rows += jobs[i].n_rows
                chunk.append(jobs[i])
                i += 1
            self._dispatch_chunk(g, chunk, rows)

    def _dispatch_chunk(self, g: _MergeGroup, chunk: list[Job],
                        rows: int) -> None:
        # queue wait stamps at execution start (enqueue → now), summed
        # into the ledger so wait vs device-wall shares are separable
        t_start = self.now()
        queue_wait_ns = 0
        tenant_rows: dict[str, int] = {}
        for j in chunk:
            if j.enqueue_t:
                j.wait_s = max(t_start - j.enqueue_t, 0.0)
                queue_wait_ns += int(j.wait_s * 1e9)
            tenant_rows[j.tenant] = tenant_rows.get(j.tenant, 0) + j.n_rows
        t0 = time.perf_counter()
        bucket = h2d_bytes = 0
        err: "BaseException | None" = None
        try:
            # the WHOLE build+dispatch sits under the guard: a failure
            # anywhere (allocation, a bad job array, the kernel itself)
            # must land on the jobs, never escape to kill the worker
            if faults.ARMED:
                faults.fire("sched.dispatch")
            bucket = bucket_rows(max(rows, 1), self.cfg.min_bucket_rows)
            if g.align > 1 and bucket % g.align:
                # serving mesh: the padded window must split evenly over
                # the 'data' shards of the one merged dispatch
                bucket = -(-bucket // g.align) * g.align
            waste = 0
            if g.pack:
                # one row-major f32 matrix = ONE H2D for the whole batch
                mat = np.empty((len(g.pads), bucket), np.float32)
                for role, pad_val in enumerate(g.pads):
                    off = 0
                    for j in chunk:
                        a = j.arrays[role]
                        mat[role, off:off + len(a)] = a
                        off += len(a)
                    mat[role, off:] = pad_val
                waste = (bucket - rows) * mat.dtype.itemsize * len(g.pads)
                padded = [mat]
            else:
                padded = []
                for role, pad_val in enumerate(g.pads):
                    parts = [np.asarray(j.arrays[role]) for j in chunk]
                    cat = parts[0] if len(parts) == 1 \
                        else np.concatenate(parts)
                    if len(cat) < bucket:
                        out = np.full(bucket, pad_val, dtype=cat.dtype)
                        out[: len(cat)] = cat
                        cat = out
                    waste += (bucket - rows) * cat.dtype.itemsize
                    padded.append(cat)
            sig = (g.kernel, bucket) + tuple(a.dtype.str for a in padded)
            occ = rows / bucket
            with self._stats_lock:
                if sig not in self._warm_buckets:
                    self._warm_buckets.add(sig)
                    self.bucket_warmups[g.kernel] = \
                        self.bucket_warmups.get(g.kernel, 0) + 1
                self.occupancy_sum[g.kernel] = \
                    self.occupancy_sum.get(g.kernel, 0.0) + occ
                self.batches_total[g.kernel] = \
                    self.batches_total.get(g.kernel, 0) + 1
                self.coalesced_total[g.kernel] = \
                    self.coalesced_total.get(g.kernel, 0) + len(chunk)
                self.padding_waste_bytes[g.kernel] = \
                    self.padding_waste_bytes.get(g.kernel, 0) + waste
                if g.shards:
                    self._note_shard_stats(g, bucket, rows, waste)
            if g.shards:
                # mesh mode: one occupancy sample PER 'data' shard — rows
                # pack contiguously, so the tail shard carries the
                # padding; a persistently cold last shard means the batch
                # window is closing under-full for this mesh width
                per = bucket // g.shards
                for i in range(g.shards):
                    real = min(max(rows - i * per, 0), per)
                    _OCCUPANCY.observe(real / per, (g.kernel, str(i)))
            else:
                _OCCUPANCY.observe(occ, (g.kernel, ""))
            h2d_bytes = sum(int(a.nbytes) for a in padded)
            # slow dispatches are findable by trace: same span surface
            # as distributor.push / frontend.Search (NoopTracer default
            # costs one dict build per MERGED batch). The span LINKS the
            # coalesced batch back to each contributing request's tree
            # (bounded: a batch is a fan-in, links are how OTel models
            # it) and carries the devtime ledger identity — kernel,
            # bucket, device_ns — so device time is attributable per
            # trace. A single-tenant batch goes through the tenant-aware
            # guard: an all-reserved-tenant batch (loopback self-ingest)
            # must not re-trace itself.
            attrs = {"kernel": g.kernel, "bucket": bucket, "rows": rows,
                     "shard": str(g.shards) if g.shards else ""}
            links = sorted({j.traceparent for j in chunk
                            if j.traceparent is not None})
            if links:
                attrs["link.traceparents"] = ",".join(links[:8])
            tenants = {j.tenant for j in chunk}
            only = next(iter(tenants)) if len(tenants) == 1 else ""
            cm = tracing.span_for_tenant("sched.dispatch", only, **attrs) \
                if only else tracing.span("sched.dispatch", **attrs)
            with cm as sp:
                td0 = time.perf_counter()
                g.dispatch(*padded)
                if sp is not None:
                    sp.attrs["device_ns"] = \
                        int((time.perf_counter() - td0) * 1e9)
        except BaseException as e:           # noqa: BLE001 — propagated
            err = e
            self._note_dispatch_error(g.kernel, e)
        wall_s = time.perf_counter() - t0
        _DISPATCH_SECONDS.observe(wall_s, (g.kernel,))
        # the device-time ledger sees every dispatch (failed ones too —
        # their wall was still spent); the cost model learns only from
        # clean, really-bucketed dispatches so an exploding kernel or a
        # build failure cannot poison the fit
        devtime.LEDGER.record_batch(
            kernel=g.kernel, bucket=bucket, prio=PRIO_INGEST,
            shards=g.shards, wall_ns=int(wall_s * 1e9), rows=rows,
            padded_rows=max(bucket - rows, 0),
            queue_wait_ns=queue_wait_ns, h2d_bytes=h2d_bytes,
            tenant_rows=tenant_rows)
        if err is None and bucket:
            devtime.COST_MODEL.observe(g.kernel, bucket, rows, wall_s)
        t_end = self.now()
        for j in chunk:
            if j.enqueue_t and err is None:
                # ingest-VISIBLE latency per job (window + queue wait +
                # dispatch): the quantity `tuning: auto` minimizes. A
                # failed dispatch dropped its rows — they never became
                # visible, so they must not count as fast ones here
                devtime.INGEST_LATENCY.observe(
                    max(t_end - j.enqueue_t, 0.0), (g.kernel,))
            j.error = err
            j.event.set()


    def _note_shard_stats(self, g: _MergeGroup, bucket: int, rows: int,
                          waste: int) -> None:
        """Per-'data'-shard padding split of a mesh dispatch (caller
        holds _stats_lock). Rows pack contiguously across the shards, so
        padding concentrates on the tail shard."""
        pad_rows = bucket - rows
        if pad_rows <= 0:
            return
        per = bucket // g.shards
        for i in range(g.shards):
            shard_pad = per - min(max(rows - i * per, 0), per)
            if shard_pad:
                key = (g.kernel, str(i))
                self.padding_waste_shard[key] = \
                    self.padding_waste_shard.get(key, 0) \
                    + waste * shard_pad // pad_rows
    def _note_dispatch_error(self, kernel: str, e: BaseException) -> None:
        """Dispatch failures must never be silent: ingest-route jobs are
        fire-and-forget, so the error is counted (exported as
        tempo_sched_dispatch_errors_total) AND logged — a persistently
        failing kernel means updates are being dropped."""
        with self._stats_lock:
            self.dispatch_errors += 1
        _LOG.error("tempo-sched: dispatch of kernel %r failed: %r",
                   kernel, e)

    def _run_fn(self, job: Job) -> None:
        from tempo_tpu_torch.obs import querystats

        if job.enqueue_t:
            job.wait_s = max(self.now() - job.enqueue_t, 0.0)
        t0 = time.perf_counter()
        try:
            # re-enter the submitter's trace context: query-route device
            # work parents under the request's tree across the worker
            # thread boundary (the row-job path links instead — a
            # coalesced batch has many parents, a fn job has one)
            with tracing.adopted(job.traceparent), \
                    tracing.span_for_tenant("sched.dispatch", job.tenant,
                                            kernel=job.kernel, bucket=0,
                                            rows=0, shard="") as sp:
                if job.stats is not None:
                    # adopt the caller's per-request QueryStats on this
                    # thread so the kernel's own recording (device_scan
                    # bytes, kernel wall) lands in the right request scope
                    with querystats.scope(job.stats):
                        job.result = job.fn()
                else:
                    job.result = job.fn()
                if sp is not None:
                    sp.attrs["device_ns"] = \
                        int((time.perf_counter() - t0) * 1e9)
        except BaseException as e:           # noqa: BLE001 — propagated
            # fn jobs have a waiting caller who re-raises and owns the
            # error surface; dispatch_errors stays a dropped-ingest-batch
            # signal (its family help + dashboard panel say so)
            job.error = e
        wall_s = time.perf_counter() - t0
        _DISPATCH_SECONDS.observe(wall_s, (job.kernel,))
        wall_ns = int(wall_s * 1e9)
        # fn jobs ledger under bucket 0 (no coalesced shape); their wall
        # is attributed to the query via QueryStats.device_ns so the
        # qlog line carries the request's device-seconds directly
        devtime.LEDGER.record_batch(
            kernel=job.kernel, bucket=0, prio=job.priority, shards=0,
            wall_ns=wall_ns, rows=0, padded_rows=0,
            queue_wait_ns=int(job.wait_s * 1e9), h2d_bytes=0,
            tenant_rows={job.tenant: 0} if job.tenant else None)
        if job.stats is not None:
            job.stats.add(device_ns=wall_ns)
        job.event.set()


def _group_of(job: Job, pack: bool = False, align: int = 1,
              shards: int = 0) -> _MergeGroup:
    g = _MergeGroup(job.kernel, job.pads, job.dispatch, job.enqueue_t,
                    pack=pack, align=align, shards=shards)
    g.jobs.append(job)
    g.rows = job.n_rows
    return g


# ---------------------------------------------------------------------------
# the process-wide scheduler (configured by App, consulted everywhere)
# ---------------------------------------------------------------------------

_default: "DeviceScheduler | None" = None
_default_lock = threading.Lock()


def configure(cfg: SchedConfig | None = None,
              now: Callable[[], float] = time.monotonic) -> DeviceScheduler:
    """Create or reconfigure the process-wide scheduler (App wiring).
    Like the JAX runtime registry, it is process-level state: several
    Apps in one test process share it, last configuration wins."""
    global _default
    with _default_lock:
        if _default is None:
            _default = DeviceScheduler(cfg, now=now)
        else:
            _default.reconfigure(cfg or SchedConfig())
        return _default


def scheduler() -> "DeviceScheduler | None":
    """The process-wide scheduler, or None when never configured —
    callers fall back to their original synchronous dispatch."""
    return _default


def reset() -> None:
    """Flush + drop the process scheduler (test isolation: a test that
    booted an App must not leave later standalone tests' dispatches
    riding a scheduler they never asked for). The device-time ledger
    and cost model reset with it — they are the scheduler's memory."""
    global _default
    with _default_lock:
        sc, _default = _default, None
    if sc is not None:
        sc.stop(flush=True)
    devtime.reset()


@contextlib.contextmanager
def use(sc: "DeviceScheduler | None"):
    """Install `sc` as the process scheduler for a with-block (tests)."""
    global _default
    with _default_lock:
        prev, _default = _default, sc
    try:
        yield sc
    finally:
        with _default_lock:
            _default = prev


def run(fn: Callable, kernel: str = "fn",
        priority: int = PRIO_QUERY, tenant: str = ""):
    """Route one device-dispatching closure through the process
    scheduler; plain `fn()` when none is configured or it is disabled."""
    sc = _default
    if sc is None or not sc.cfg.enabled:
        return fn()
    return sc.run(fn, kernel=kernel, priority=priority, tenant=tenant)


def flush() -> None:
    """Barrier on the process scheduler, if any (collection ticks,
    state readers)."""
    sc = _default
    if sc is not None and sc.cfg.enabled:
        sc.flush()


def ingest_keep_fraction() -> float:
    """The process-wide overload keep-fraction (1.0 = sampling off):
    the distributor's span sampler and the frontend's query-log
    annotation both read this one signal."""
    sc = _default
    if sc is None:
        return 1.0
    return sc.keep_fraction()


# ---------------------------------------------------------------------------
# obs: scheduler families in the process-wide runtime registry
# ---------------------------------------------------------------------------

from tempo_tpu_torch.obs.runtime import RUNTIME  # noqa: E402
from tempo_tpu_torch.obs.registry import exponential_buckets  # noqa: E402


def _per_class(field: str):
    def fn():
        sc = _default
        if sc is None:
            return []
        return [((c,), float(v)) for c, v in getattr(sc, field).items()]
    return fn


def _per_kernel(field: str):
    def fn():
        sc = _default
        if sc is None:
            return []
        return [((k,), float(v)) for k, v in getattr(sc, field).items()]
    return fn


RUNTIME.gauge_func(
    "tempo_sched_queue_depth",
    lambda: [] if _default is None else
    [((CLASS_NAMES[p],), float(_default.depth(p))) for p in (0, 1, 2)],
    help="Jobs waiting in the device scheduler, by priority class",
    labels=("class",))
RUNTIME.gauge_func(
    "tempo_sched_queue_limit",
    lambda: [] if _default is None else
    [((CLASS_NAMES[p],), float(_default._limit(p))) for p in (0, 1, 2)],
    help="Bounded queue capacity per priority class (saturation "
         "denominator for alerting)",
    labels=("class",))
RUNTIME.counter_func(
    "tempo_sched_jobs_total", _per_class("jobs_total"),
    help="Jobs accepted by the device scheduler, by priority class",
    labels=("class",))
RUNTIME.counter_func(
    "tempo_sched_shed_jobs_total", _per_class("shed_total"),
    help="Jobs shed to inline execution because their class queue was "
         "full (sustained shedding means the device is the bottleneck)",
    labels=("class",))
RUNTIME.counter_func(
    "tempo_sched_batches_total", _per_kernel("batches_total"),
    help="Merged batches dispatched, by kernel",
    labels=("kernel",))
RUNTIME.counter_func(
    "tempo_sched_coalesced_jobs_total", _per_kernel("coalesced_total"),
    help="Row jobs folded into merged batches, by kernel "
         "(coalesced/batches = jobs amortized per dispatch)",
    labels=("kernel",))
def _padding_waste_rows():
    """Padding waste with the serving-mesh `shard` split: per-shard rows
    for mesh dispatches, the remaining (non-mesh) waste under shard="" —
    the label values sum to the true per-kernel total, no double count."""
    sc = _default
    if sc is None:
        return []
    # snapshot under the stats lock: padding_waste_shard grows at
    # dispatch time and a concurrent scrape iterating a resizing dict
    # would raise and 500 the whole /metrics render
    with sc._stats_lock:
        shard_items = list(sc.padding_waste_shard.items())
        kernel_items = list(sc.padding_waste_bytes.items())
    out = []
    sharded_by_kernel: dict[str, int] = {}
    for (k, sh), v in shard_items:
        out.append(((k, sh), float(v)))
        sharded_by_kernel[k] = sharded_by_kernel.get(k, 0) + v
    for k, v in kernel_items:
        rest = v - sharded_by_kernel.get(k, 0)
        if rest or k not in sharded_by_kernel:
            out.append(((k, ""), float(max(rest, 0))))
    return out


RUNTIME.counter_func(
    "tempo_sched_padding_waste_bytes_total",
    _padding_waste_rows,
    help="Bytes of pow-2 padding dispatched beyond real rows, by kernel "
         "(the price of the pow-2 shape buckets); serving-mesh "
         "dispatches additionally split by 'data' shard (non-mesh waste "
         "keeps shard=\"\")",
    labels=("kernel", "shard"))
RUNTIME.counter_func(
    "tempo_sched_bucket_warmups_total", _per_kernel("bucket_warmups"),
    help="First-time (kernel, shape-bucket) combinations dispatched; "
         "flat after warmup means every bucket size has been seen",
    labels=("kernel",))
RUNTIME.gauge_func(
    "tempo_sched_ingest_keep_fraction",
    lambda: [] if _default is None else
    [((), float(_default.keep_fraction()))],
    help="Overload controller's current span keep-fraction (1.0 = "
         "sampling off; below 1.0 the distributor hash-samples "
         "non-forced spans before hard 429)")
RUNTIME.counter_func(
    "tempo_sched_dispatch_errors_total",
    lambda: [] if _default is None else
    [((), float(_default.dispatch_errors))],
    help="Scheduler dispatches that raised (fire-and-forget ingest "
         "batches were DROPPED; also logged on tempo_tpu_torch.sched)")
RUNTIME.counter_func(
    "tempo_sched_compaction_forced_dispatches_total",
    lambda: [] if _default is None else
    [((), float(_default.comp_forced_total))],
    help="Compaction jobs force-dispatched by the anti-starvation floor "
         "(sched.compaction_min_share) while ingest/query stayed busy")
RUNTIME.gauge_func(
    "tempo_sched_tuned_window_ms",
    lambda: [] if _default is None else
    [((k,), float(ms)) for k, ms in _default._tuner.windows_ms()],
    help="Batch window currently chosen by `tuning: auto` per kernel, "
         "milliseconds (absent until the cost model is warm; compare "
         "against the static sched.batch_window_ms)",
    labels=("kernel",))
RUNTIME.gauge_func(
    "tempo_sched_tuning_active",
    lambda: [] if _default is None else
    [((), 1.0 if _default.tuning_active() else 0.0)],
    help="1 while `tuning: auto` is driving batch windows from a warm "
         "cost model, 0 in static mode or during model warm-up "
         "(TempoSchedCostModelStale only fires while this is 1)")
_OCCUPANCY = RUNTIME.histogram(
    "tempo_sched_batch_occupancy_ratio",
    "Real rows / padded bucket rows per merged batch; serving-mesh "
    "dispatches observe one sample per 'data' shard (non-mesh batches "
    "keep shard=\"\")",
    labels=("kernel", "shard"),
    buckets=(0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0))
_DISPATCH_SECONDS = RUNTIME.histogram(
    "tempo_sched_dispatch_duration_seconds",
    "Wall time of one scheduler dispatch (merged batch or fn job), by "
    "kernel", labels=("kernel",),
    buckets=exponential_buckets(1e-5, 4.0, 12))
_QUEUE_WAIT = RUNTIME.histogram(
    "tempo_sched_queue_wait_seconds",
    "Time a scheduled job waited between enqueue and completion, by "
    "priority class", labels=("class",),
    buckets=exponential_buckets(1e-5, 4.0, 12))


__all__ = [
    "PRIO_INGEST", "PRIO_QUERY", "PRIO_COMPACTION", "CLASS_NAMES",
    "SchedConfig", "QueryBackpressure", "Job", "WindowTuner",
    "DeviceScheduler", "bucket_rows", "configure", "scheduler", "use",
    "run", "flush", "reset", "fraction_for_pressure",
    "ingest_keep_fraction",
]
