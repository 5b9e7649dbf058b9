"""Graceful-overload span sampling over the staged columns.

Following "Trace Sampling 2.0" (PAPERS.md), overload degrades to a
REPRESENTATIVE sampled stream instead of a hard 429 cliff: when the
device scheduler's live-ingest pressure pushes the process keep-fraction
below 1.0 (`sched.keep_fraction`, the same signal that feeds
`IngestBackpressure`), the distributor runs this keep/drop stage over
the already-interned staging columns BEFORE trace grouping, ring
replication, and the generator tee — one decision, shared by every tee
target through the row-view filtering.

Scoring is cheap by construction (the decode-once path already paid for
the columns) and deterministic where it must be:

- **error spans** (`status_code == ERROR`) are always kept, exactly;
- **latency-tail spans** — duration above the tenant's own recent
  `tail_quantile` (host log2 sketch, the qlog geometry) — are always
  kept, exactly;
- everything else keeps iff `hash64(trace_id) / 2^53 < keep_fraction`:
  a pure function of (trace id, keep fraction), so the ingester tee and
  the in-process generator agree on every span, and raising the
  fraction only ADDS spans (monotone — a trace kept at f stays kept at
  every f' > f). Across replicas/retries the hash-DROPPED set is
  deterministic; the forced-keep classes can only diverge ADDITIVELY
  (a replica with a colder tail sketch keeps no fewer hash-passing
  spans, it just force-keeps fewer tail ones).

Kept spans carry a Horvitz-Thompson weight (1 for force-kept spans,
1/keep_fraction for hash-kept ones) that rides the staged view into the
generator, so spanmetrics rates upscale to the true stream and latency
quantiles stay bounded on the sampled stream.

Counterpart of `tempo_tpu/distributor/sampler.py`: the same keep
decisions and the same f32 weights on the same records. The pressure
signal is the port's `sched.ingest_keep_fraction()`.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from typing import Callable

import numpy as np

from tempo_tpu_torch.overrides.limits import SamplingLimits

_LOG = logging.getLogger("tempo_tpu_torch.ingest")

_STATUS_ERROR = 2          # OTLP STATUS_CODE_ERROR

# qlog LatencySketch geometry: bucket b>0 holds [2^(b-1-_OFFSET),
# 2^(b-_OFFSET)) seconds — covers ~2^-32s .. ~2^31s in 64 buckets
_NBUCKETS = 64
_OFFSET = 32
# decay the duration sketch once it holds this many observations so the
# tail threshold tracks RECENT traffic, not the process's whole history
_DECAY_AFTER = 1 << 20

_FNV_OFFSET = np.uint64(14695981039346656037)
_FNV_PRIME = np.uint64(1099511628211)


def trace_hash_u01(tids: np.ndarray) -> np.ndarray:
    """[n,16] uint8 trace-id matrix → float64 in [0,1): FNV-1a over the
    padded 16 bytes, top 53 bits as the uniform variate. Vectorized,
    byte-order-stable, and a pure function of the id bytes — the
    determinism contract the keep/drop decision rests on."""
    tids = np.ascontiguousarray(tids, np.uint8)
    h = np.full(len(tids), _FNV_OFFSET, np.uint64)
    with np.errstate(over="ignore"):
        for col in range(tids.shape[1]):
            h ^= tids[:, col].astype(np.uint64)
            h *= _FNV_PRIME
    return (h >> np.uint64(11)).astype(np.float64) / float(1 << 53)


class _DurationSketch:
    """Host log2 duration histogram per tenant (the write-path twin of
    `obs.qlog.LatencySketch`, vectorized): feeds the latency-tail
    always-keep threshold. One bincount per push."""

    __slots__ = ("counts", "total")

    def __init__(self) -> None:
        self.counts = np.zeros(_NBUCKETS, np.int64)
        self.total = 0

    def record(self, dur_s: np.ndarray) -> None:
        if not len(dur_s):
            return
        b = np.zeros(len(dur_s), np.int64)
        pos = dur_s > 0
        if pos.any():
            b[pos] = np.clip(
                np.floor(np.log2(dur_s[pos])).astype(np.int64) + 1 + _OFFSET,
                0, _NBUCKETS - 1)
        self.counts += np.bincount(b, minlength=_NBUCKETS)
        self.total += len(dur_s)
        if self.total > _DECAY_AFTER:
            self.counts //= 2
            self.total = int(self.counts.sum())

    def quantile(self, q: float) -> float:
        """Interpolated q-quantile in seconds (0.0 when empty). `q` is
        clamped to [0, 1] — a misconfigured tenant policy (e.g.
        tail_quantile: 1.5) must degrade, never crash the push path."""
        if self.total <= 0:
            return 0.0
        q = min(max(q, 0.0), 1.0)
        target = max(q * self.total, 1e-12)
        cum = np.cumsum(self.counts)
        b = int(np.searchsorted(cum, target))
        if b <= 0:
            return 0.0
        c = int(self.counts[b])
        prev = int(cum[b]) - c
        frac = (target - prev) / c if c else 1.0
        return 2.0 ** (b - 1 - _OFFSET + frac)


class _TenantState:
    __slots__ = ("sketch", "last_fraction", "last_seen", "dropped_total",
                 "kept_forced_total", "exemplars", "_band")

    def __init__(self, now: float) -> None:
        self.sketch = _DurationSketch()
        self.last_fraction = 1.0
        self.last_seen = now
        self.dropped_total = 0
        self.kept_forced_total = 0
        self.exemplars: list[str] = []     # recent dropped trace-id hexes
        self._band = 10                    # fraction band for the qlog line


class SpanSampler:
    """The distributor's overload sampling stage (one per distributor).

    `fraction_source` is the process keep-fraction signal — defaults to
    `sched.ingest_keep_fraction` and is injectable for tests/bench so a
    pressure ramp can be driven deterministically."""

    # sweep idle tenant states like the rate limiter's buckets
    IDLE_TTL_S = 900.0
    MAX_TENANTS = 10_000
    N_EXEMPLARS = 5

    def __init__(self,
                 fraction_source: "Callable[[], float] | None" = None,
                 now: Callable[[], float] = time.time) -> None:
        self.now = now
        self._source = fraction_source
        # re-entrant: public methods hold it around every read/write of
        # per-tenant state — receivers push from many threads (HTTP
        # ThreadingServer, gRPC executor), and numpy in-place updates on
        # the shared sketch release the GIL mid-read-modify-write
        self._lock = threading.RLock()
        self._tenants: dict[str, _TenantState] = {}
        self._next_sweep = 0.0

    # -- the pressure signal ------------------------------------------------

    def global_fraction(self) -> float:
        if self._source is not None:
            return self._source()
        from tempo_tpu_torch import sched
        return sched.ingest_keep_fraction()

    def effective_fraction(self, tenant: str, pol: SamplingLimits) -> float:
        """This tenant's keep-fraction right now: the process controller
        clamped by the tenant floor; exactly 1.0 when the tenant opted
        out or the controller is idle (sampling bypassed entirely).
        Called once per staged push — it also book-keeps the value the
        per-tenant gauge exports, including the recovery back to 1.0."""
        frac = 1.0
        if pol.enabled:
            g = self.global_fraction()
            if g < 1.0:
                frac = max(g, min(max(pol.floor, 0.0), 1.0))
        with self._lock:
            st = self._state(tenant)
            st.last_fraction = frac
            if frac >= 1.0 and st._band != 10:
                # recovery closes the episode: emit the final line (an
                # operator must be able to bound the sampled window from
                # the log alone) and reset the band so the NEXT episode
                # logs even if it lands in the same 0.1-band
                st._band = 10
                _LOG.warning(json.dumps({
                    "msg": "ingest sampling",
                    "tenant": tenant,
                    "keepFraction": 1.0,
                    "droppedSpansTotal": st.dropped_total,
                    "forcedKeepTotal": st.kept_forced_total,
                    "droppedTraceExemplars": st.exemplars,
                }, sort_keys=True))
        return frac

    # -- scoring ------------------------------------------------------------

    def observe(self, tenant: str, recs: np.ndarray,
                dur_s: "np.ndarray | None" = None) -> None:
        """Feed the tenant's duration sketch (every push, sampled or
        not) so the latency-tail threshold is warm when overload hits.
        Observing never changes the push's own output. `dur_s` lets the
        caller share one durations pass with `sample()`."""
        if dur_s is None:
            dur_s = self.durations_s(recs)
        with self._lock:
            self._state(tenant).sketch.record(dur_s)

    def sample(self, tenant: str, recs: np.ndarray, valid: np.ndarray,
               fraction: float, pol: SamplingLimits,
               dur_s: "np.ndarray | None" = None
               ) -> tuple[np.ndarray, np.ndarray]:
        """(keep mask, Horvitz-Thompson weights) over the staged rows.

        keep = error-status ∪ latency-tail ∪ (trace hash < fraction);
        weights are 1.0 for force-kept spans (P(keep)=1 → exact) and
        1/fraction for hash-kept ones. Rows outside `valid` are left
        unkept with weight 1 (they were never admitted)."""
        n = len(recs)
        if dur_s is None:
            dur_s = self.durations_s(recs)
        forced = np.zeros(n, bool)
        if pol.keep_errors:
            forced |= recs["status_code"] == _STATUS_ERROR
        u = trace_hash_u01(recs["trace_id"])
        hash_keep = u < fraction
        with self._lock:
            st = self._state(tenant)
            if pol.tail_quantile > 0 and \
                    st.sketch.total >= pol.tail_min_spans:
                thr = st.sketch.quantile(pol.tail_quantile)
                if thr > 0:
                    forced |= dur_s >= thr
            keep = (forced | hash_keep) & valid
            weights = np.ones(n, np.float32)
            scaled = hash_keep & ~forced
            weights[scaled] = np.float32(1.0 / max(fraction, 1e-6))
            self._note(st, tenant, recs, valid, keep, forced, fraction)
        return keep, weights

    @staticmethod
    def durations_s(recs: np.ndarray) -> np.ndarray:
        start = recs["start_ns"].astype(np.int64)
        end = recs["end_ns"].astype(np.int64)
        return np.maximum(end - start, 0) / 1e9

    # -- book-keeping / observability ---------------------------------------

    def _state(self, tenant: str) -> _TenantState:
        now = self.now()
        with self._lock:
            st = self._tenants.get(tenant)
            if st is None:
                st = self._tenants[tenant] = _TenantState(now)
            st.last_seen = now
            if now >= self._next_sweep or len(self._tenants) > self.MAX_TENANTS:
                self._sweep_locked(now)
            return st

    def _sweep_locked(self, now: float) -> None:
        self._next_sweep = now + self.IDLE_TTL_S / 4
        dead = [t for t, s in self._tenants.items()
                if now - s.last_seen > self.IDLE_TTL_S]
        for t in dead:
            del self._tenants[t]
        if len(self._tenants) > self.MAX_TENANTS:
            by_age = sorted(self._tenants.items(),
                            key=lambda kv: kv[1].last_seen)
            for t, _ in by_age[:len(self._tenants) - self.MAX_TENANTS]:
                del self._tenants[t]

    def _note(self, st: _TenantState, tenant: str, recs: np.ndarray,
              valid: np.ndarray, keep: np.ndarray, forced: np.ndarray,
              fraction: float) -> None:
        dropped = valid & ~keep
        n_dropped = int(dropped.sum())
        st.dropped_total += n_dropped
        st.kept_forced_total += int((forced & valid).sum())
        if n_dropped:
            # a handful of dropped trace ids as exemplars for the
            # structured overload log line (bounded, newest win)
            tids = recs["trace_id"][dropped][: self.N_EXEMPLARS]
            tls = recs["tid_len"][dropped][: self.N_EXEMPLARS]
            st.exemplars = [bytes(t)[: int(ln)].hex()
                            for t, ln in zip(tids, tls)]
        # one JSON line per fraction BAND transition (0.1-wide), not per
        # push: the overload story is greppable without being a log storm
        band = min(int(fraction * 10), 10)
        if band != st._band:
            st._band = band
            _LOG.warning(json.dumps({
                "msg": "ingest sampling",
                "tenant": tenant,
                "keepFraction": round(fraction, 4),
                "droppedSpansTotal": st.dropped_total,
                "forcedKeepTotal": st.kept_forced_total,
                "droppedTraceExemplars": st.exemplars,
            }, sort_keys=True))

    def fractions(self) -> list:
        """Callback-family shape for the per-tenant keep-fraction gauge:
        [((tenant,), fraction), ...]."""
        with self._lock:
            return [((t,), float(s.last_fraction))
                    for t, s in self._tenants.items()]

    def tenants(self) -> int:
        with self._lock:
            return len(self._tenants)


__all__ = ["SpanSampler", "trace_hash_u01"]
