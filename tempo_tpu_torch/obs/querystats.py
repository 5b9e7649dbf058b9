"""Request-scoped query statistics: the dskit `stats` analog.

Counterpart of `tempo_tpu/obs/querystats.py`; the device scheduler
threads the caller's `QueryStats` into the jobs it runs.

The reference threads a per-request stats object from querier block scans
back through gRPC trailers to the query-frontend (`pkg/usagestats` /
dskit stats middleware), which merges shard stats, returns them in
`SearchMetrics`, and logs a structured "query complete" line. This module
is that axis for this build: a `QueryStats` accumulator installed in a
contextvar (the `SelfTracer` span-stack pattern, utils/tracing.py), so
the read path records into the ambient scope with ZERO coupling — and a
None-check-only cost when no query is in flight (loops, compaction,
ingest never pay).

Scoping rules:

- An entry point (API handler, frontend endpoint, RPC server handler)
  opens `scope()`; everything on that thread records into it.
- The frontend gives every sharded sub-request job its OWN QueryStats
  and the executing worker installs it with `scope(job.stats)` — contextvars
  do not cross thread-pool boundaries, and per-job objects mean no lock
  contention between shards. The issuer merges child stats at fold time.
- Cross-process, stats ride the RPC plane (tempopb metrics submessage,
  worker-stream result messages, `/internal/*` JSON bodies — the
  gRPC-trailer analog) and `absorb()` folds them into the ambient scope.

Stage wall-times (`stage_ns`) are per-stage wall clocks: stages nest and
overlap (block-fetch happens inside engine-eval's lazy view pull), so
they are attribution hints, not a partition of the request duration.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import threading
import time

_current: "contextvars.ContextVar[QueryStats | None]" = contextvars.ContextVar(
    "tempo_query_stats", default=None)

# counter fields, in wire order (tempopb assigns proto field numbers from
# this tuple's order — append only, never reorder)
COUNTER_FIELDS = (
    "inspected_traces",      # traces whose spans a scan examined
    "inspected_bytes",       # bytes materialized from block row groups
    "inspected_spans",       # candidate spans the engines evaluated
    "total_blocks",          # blocks the sharder considered
    "blocks_scanned",        # block slices actually scanned (per job)
    "blocks_skipped",        # bloom + time-range/shard prunes
    "total_jobs",            # sharded sub-requests issued
    "completed_jobs",        # sub-requests folded (incl. cache hits)
    "cache_hits",            # sub-requests served from the response cache
    "device_scan_bytes",     # bytes uploaded to the device read plane
    "kernel_wall_ns",        # wall nanos blocked on device kernel results
    "sched_jobs",            # device-scheduler jobs this request queued
    "device_ns",             # device-dispatch wall attributed by the
    #                          device-time ledger (obs/devtime.py): the
    #                          request's share of scheduler dispatches
)

# canonical per-stage wall-time breakdown keys (free-form keys are
# accepted; these are the ones the read path records)
STAGES = ("queue_wait", "block_fetch", "device_scan", "engine_eval", "merge",
          "sched_wait")


@dataclasses.dataclass
class QueryStats:
    """One request's (or sub-request's) accumulated read-path statistics.

    Thread-safe: a lock guards every mutation so an issuer folding child
    stats can race a straggler worker without corrupting counts.
    """

    inspected_traces: int = 0
    inspected_bytes: int = 0
    inspected_spans: int = 0
    total_blocks: int = 0
    blocks_scanned: int = 0
    blocks_skipped: int = 0
    total_jobs: int = 0
    completed_jobs: int = 0
    cache_hits: int = 0
    device_scan_bytes: int = 0
    kernel_wall_ns: int = 0
    sched_jobs: int = 0
    device_ns: int = 0
    stage_ns: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        self._lock = threading.Lock()

    # -- recording ----------------------------------------------------------

    def add(self, **fields: int) -> None:
        with self._lock:
            for name, n in fields.items():
                setattr(self, name, getattr(self, name) + int(n))

    def add_stage_ns(self, stage: str, ns: int) -> None:
        with self._lock:
            self.stage_ns[stage] = self.stage_ns.get(stage, 0) + int(ns)

    def merge(self, other: "QueryStats | None") -> None:
        """Fold a child's (shard job, remote leg) stats into this one."""
        if other is None or other is self:
            return
        with other._lock:
            counters = {f: getattr(other, f) for f in COUNTER_FIELDS}
            stages = dict(other.stage_ns)
        with self._lock:
            for f, n in counters.items():
                setattr(self, f, getattr(self, f) + n)
            for s, ns in stages.items():
                self.stage_ns[s] = self.stage_ns.get(s, 0) + ns

    def floor_inspected_traces(self, n: int) -> None:
        """Lift inspected_traces to >= n: results RETURNED were at least
        inspected, even when they came from a path that records nothing
        (ingester live-trace scans, fully cache-served shard sets). Every
        response surface applies this once before rendering stats."""
        with self._lock:
            if self.inspected_traces < n:
                self.inspected_traces = int(n)

    # -- serialization ------------------------------------------------------

    def to_json(self) -> dict:
        """JSON-safe snapshot (snake_case — the internal RPC shape)."""
        with self._lock:
            out = {f: getattr(self, f) for f in COUNTER_FIELDS
                   if getattr(self, f)}
            if self.stage_ns:
                out["stage_ns"] = dict(self.stage_ns)
        return out

    @classmethod
    def from_json(cls, d: "dict | None") -> "QueryStats":
        st = cls()
        if not d:
            return st
        for f in COUNTER_FIELDS:
            if f in d:
                setattr(st, f, int(d[f]))
        for s, ns in (d.get("stage_ns") or {}).items():
            st.stage_ns[str(s)] = int(ns)
        return st

    def search_metrics(self) -> dict:
        """`SearchMetrics`-shaped dict for API responses (camelCase,
        every field present so consumers need no existence checks)."""
        with self._lock:
            return {
                "inspectedTraces": self.inspected_traces,
                "inspectedBytes": self.inspected_bytes,
                "inspectedSpans": self.inspected_spans,
                "totalBlocks": self.total_blocks,
                "blocksScanned": self.blocks_scanned,
                "blocksSkipped": self.blocks_skipped,
                "totalJobs": self.total_jobs,
                "completedJobs": self.completed_jobs,
                "cacheHits": self.cache_hits,
                "deviceScanBytes": self.device_scan_bytes,
                "kernelWallNanos": self.kernel_wall_ns,
                "schedJobs": self.sched_jobs,
                "deviceNanos": self.device_ns,
                "stageDurationNanos": dict(self.stage_ns),
            }


# ---------------------------------------------------------------------------
# ambient scope
# ---------------------------------------------------------------------------


def current() -> "QueryStats | None":
    return _current.get()


@contextlib.contextmanager
def scope(stats: "QueryStats | None" = None):
    """Install a stats object (a fresh one by default) as the ambient
    scope for the duration of the block. Workers use `scope(job.stats)`
    to adopt a sub-request's accumulator on their own thread."""
    st = stats if stats is not None else QueryStats()
    token = _current.set(st)
    try:
        yield st
    finally:
        _current.reset(token)


@contextlib.contextmanager
def ensure_scope():
    """Join the ambient scope, or open a fresh one when none is active —
    frontend entry points use this so an API handler's scope (which must
    outlive the call to render the response) is reused, while direct
    programmatic calls still get stats for the query log."""
    st = _current.get()
    if st is not None:
        yield st
        return
    with scope() as st:
        yield st


def add(**fields: int) -> None:
    """Record counters into the ambient scope; no-op (one None check)
    outside any query."""
    st = _current.get()
    if st is not None:
        st.add(**fields)


def absorb(child: "QueryStats | None") -> None:
    """Merge a deserialized child (remote shard / ingester leg) into the
    ambient scope, if any."""
    st = _current.get()
    if st is not None and child is not None:
        st.merge(child)


@contextlib.contextmanager
def stage(name: str):
    """Time a region into the ambient scope's per-stage breakdown;
    no-op outside any query."""
    st = _current.get()
    if st is None:
        yield
        return
    t0 = time.perf_counter_ns()
    try:
        yield
    finally:
        st.add_stage_ns(name, time.perf_counter_ns() - t0)


__all__ = ["QueryStats", "COUNTER_FIELDS", "STAGES", "current", "scope",
           "ensure_scope", "add", "absorb", "stage"]
