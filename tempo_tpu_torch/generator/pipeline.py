"""Double-buffered host→device ingest pipeline.

Counterpart of `tempo_tpu/generator/pipeline.py`. With the device
scheduler (`tempo_tpu_torch.sched`) a span-metrics update dispatches on
the scheduler's worker thread; this module adds the two pieces that turn
that into a pipeline on the staged fast route (`SpanMetricsProcessor.
push_staged` / `push_from_recs`):

- **A staging-buffer ring**: a small set of pre-allocated resolve buffer
  sets (`native.ResolveBuffers`: the slots/packed/rows arrays the C++
  resolve fills and the dispatch later reads). A buffer set recycles
  once the scheduler job that reads it has completed, so steady-state
  ingest allocates no staging memory per push. A job completes after
  its dispatch returned, and the dispatch's copy to the card has read
  the coalescer's host matrix (built from these rows) by then: the copy
  is a blocking one from pageable memory.
- **Bounded decode-ahead**: a producer may stage at most
  `pipeline_depth` batches beyond the device (`SchedConfig.
  pipeline_depth`); past that, `acquire` blocks on the OLDEST in-flight
  job: backpressure by buffer exhaustion, like a double buffer. Host
  decode of batch N+1 overlaps the device update of batch N.

The drain barrier stays where it was: `sched.flush()` (collection ticks,
quantile reads) force-dispatches every queued batch and waits it out, so
registry state equals the synchronous no-scheduler route's; `drain()`
here also reaps the buffer ring behind that barrier.

Observable on the process runtime registry (`obs.runtime.RUNTIME`), under
the reference's names: in-flight depth, decode/stall seconds, the
decode-overlap ratio (share of host staging wall that ran while a device
dispatch was in flight), and staging-buffer reuse against fresh
allocations.
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import deque

from tempo_tpu_torch.native import ResolveBuffers

_PIPELINES: "weakref.WeakSet[IngestPipeline]" = weakref.WeakSet()
_FREE_PER_KEY = 4          # recycled buffer sets kept per (cap, labels)


class IngestPipeline:
    """Per-processor staging ring + decode-ahead bound (see module doc)."""

    def __init__(self, depth: int = 2,
                 now=time.perf_counter) -> None:
        self.depth = max(int(depth), 1)
        self.now = now
        self._lock = threading.Lock()
        self._inflight: "deque[tuple[object, ResolveBuffers | None]]" = \
            deque()
        self._free: dict[tuple[int, int], list[ResolveBuffers]] = {}
        # stats (plain fields; obs renders through callback families)
        self.alloc_total = 0
        self.reuse_total = 0
        self.submitted_total = 0
        self.stall_ns = 0
        self.decode_ns = 0
        self.overlap_ns = 0
        self._acquire_t = 0.0
        self._acquire_overlapped = False
        _PIPELINES.add(self)

    # -- buffer ring -------------------------------------------------------

    def _reap_locked(self) -> None:
        while self._inflight and self._inflight[0][0].event.is_set():
            _job, bufs = self._inflight.popleft()
            self._recycle_locked(bufs)

    def _recycle_locked(self, bufs: "ResolveBuffers | None") -> None:
        if bufs is None:
            return
        free = self._free.setdefault((bufs.cap, bufs.n_labels), [])
        if len(free) < _FREE_PER_KEY:
            free.append(bufs)

    def acquire(self, cap: int, n_labels: int) -> ResolveBuffers:
        """A staging-buffer set for one resolve. Reaps completed jobs;
        when `depth` batches are already staged ahead, blocks on the
        oldest (the double-buffer backpressure), with the stall counted —
        sustained stalls mean the device, not the host, is the
        bottleneck."""
        oldest = None
        with self._lock:
            self._reap_locked()
            if len(self._inflight) >= self.depth:
                oldest = self._inflight[0][0]
        if oldest is not None:
            t0 = time.perf_counter_ns()
            oldest.event.wait(30.0)
            with self._lock:
                self.stall_ns += time.perf_counter_ns() - t0
                self._reap_locked()
        with self._lock:
            free = self._free.get((cap, n_labels))
            if free:
                bufs = free.pop()
                self.reuse_total += 1
            else:
                bufs = ResolveBuffers(cap, n_labels)
                self.alloc_total += 1
            # the decode that follows overlaps the device iff something
            # is still in flight right now
            self._acquire_overlapped = bool(self._inflight)
            self._acquire_t = time.perf_counter_ns()
        return bufs

    def release(self, bufs: "ResolveBuffers | None") -> None:
        """Return an acquired-but-unsubmitted buffer set straight to the
        ring (empty batches, fast-path bail-outs)."""
        with self._lock:
            self._acquire_t = 0.0
            self._recycle_locked(bufs)

    def track(self, job, bufs: "ResolveBuffers | None") -> None:
        """Adopt one submitted scheduler job (+ the buffers its dispatch
        reads). Called right after submit: the acquire→track interval is
        the host decode/resolve wall for this batch."""
        with self._lock:
            if self._acquire_t:
                span = time.perf_counter_ns() - self._acquire_t
                self.decode_ns += span
                if self._acquire_overlapped:
                    self.overlap_ns += span
                self._acquire_t = 0.0
            self._inflight.append((job, bufs))
            self.submitted_total += 1

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Wait out every in-flight job and reap its buffers. The DEVICE
        barrier is `sched.flush()` — callers run that first (it force-
        closes batch windows); this reaps the ring behind it."""
        deadline = time.monotonic() + timeout_s
        while True:
            with self._lock:
                self._reap_locked()
                if not self._inflight:
                    return True
                job = self._inflight[0][0]
            if not job.event.wait(max(deadline - time.monotonic(), 0.0)):
                return False

    # -- introspection -----------------------------------------------------

    def in_flight(self) -> int:
        with self._lock:
            self._reap_locked()
            return len(self._inflight)

    def overlap_ratio(self) -> float:
        """Share of host staging wall spent while a device dispatch was
        in flight — 0 is fully serialized, →1 is fully overlapped."""
        return self.overlap_ns / self.decode_ns if self.decode_ns else 0.0


# ---------------------------------------------------------------------------
# obs: pipeline families in the process-wide runtime registry
# ---------------------------------------------------------------------------

from tempo_tpu_torch.obs.runtime import RUNTIME  # noqa: E402


def _sum(field: str):
    def fn():
        total = sum(getattr(p, field) for p in list(_PIPELINES))
        return [((), float(total))]
    return fn


RUNTIME.gauge_func(
    "tempo_ingest_pipeline_inflight",
    lambda: [((), float(sum(p.in_flight() for p in list(_PIPELINES))))],
    help="Decoded batches staged ahead of the device across all ingest "
         "pipelines (the double-buffer occupancy; bounded by "
         "sched.pipeline_depth per processor)")
RUNTIME.counter_func(
    "tempo_ingest_pipeline_batches_total", _sum("submitted_total"),
    help="Batches submitted through the ingest staging pipeline")
RUNTIME.counter_func(
    "tempo_ingest_pipeline_staging_reuse_total", _sum("reuse_total"),
    help="Resolve staging-buffer sets recycled from the ring (steady "
         "state should reuse, not allocate)")
RUNTIME.counter_func(
    "tempo_ingest_pipeline_staging_alloc_total", _sum("alloc_total"),
    help="Fresh resolve staging-buffer allocations (rising in steady "
         "state means shape churn defeats the ring)")
RUNTIME.counter_func(
    "tempo_ingest_pipeline_decode_seconds_total",
    lambda: [((), sum(p.decode_ns for p in list(_PIPELINES)) / 1e9)],
    help="Host decode/resolve wall spent staging pipelined batches")
RUNTIME.counter_func(
    "tempo_ingest_pipeline_stall_seconds_total",
    lambda: [((), sum(p.stall_ns for p in list(_PIPELINES)) / 1e9)],
    help="Producer wall spent blocked on a full staging ring (sustained "
         "stalling = the device is the ingest bottleneck)")
RUNTIME.gauge_func(
    "tempo_ingest_pipeline_overlap_ratio",
    lambda: [((), (lambda d, o: o / d if d else 0.0)(
        sum(p.decode_ns for p in list(_PIPELINES)),
        sum(p.overlap_ns for p in list(_PIPELINES))))],
    help="Share of host decode wall overlapped with an in-flight device "
         "dispatch (0 = serialized, 1 = fully pipelined)")


__all__ = ["IngestPipeline"]
