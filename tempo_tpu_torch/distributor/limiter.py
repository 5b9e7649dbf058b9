"""Per-tenant ingestion rate limiting (token bucket).

Analog of the dskit limiter the distributor consults per push
(`checkForRateLimits` `distributor.go:368` + `ingestion_rate_strategy.go`):
`local` gives each distributor the full per-tenant rate; `global` divides
the rate by the (healthy) distributor count so the fleet-wide total holds.

Counterpart of `tempo_tpu/distributor/limiter.py`, host code copied with
its imports moved to the port; `IngestBackpressure`
reads the port's process scheduler (`sched.scheduler().ingest_retry_after()`).
"""

from __future__ import annotations

import threading
import time
from typing import Callable


class _Bucket:
    __slots__ = ("tokens", "last", "rate", "burst")

    def __init__(self, burst: float, now: float) -> None:
        self.tokens = burst
        self.last = now
        self.rate = 0.0        # last-seen limits, for refill-aware eviction
        self.burst = burst


class RateLimiter:
    """Token buckets per tenant, with idle eviction: under tenant churn
    (ephemeral tenant ids, fuzzing, abuse) the bucket map would otherwise
    grow without bound. Eviction is REFILL-AWARE: a bucket is evicted
    only once enough idle time has passed that its refill would have
    reached the burst cap anyway — recreating it full on the next push
    is then byte-identical to having kept it. A freshly drained bucket
    (unrefilled debt) is never TTL-evicted, and the max-size trim takes
    refilled buckets first, so churning ephemeral tenant ids cannot be
    used to launder away another tenant's spent burst."""

    IDLE_TTL_S = 900.0
    MAX_BUCKETS = 100_000

    def __init__(self, now: Callable[[], float] = time.time,
                 idle_ttl_s: float = IDLE_TTL_S,
                 max_buckets: int = MAX_BUCKETS) -> None:
        self.now = now
        self.idle_ttl_s = idle_ttl_s
        self.max_buckets = max_buckets
        self._buckets: dict[str, _Bucket] = {}
        self._lock = threading.Lock()
        self._next_sweep = 0.0

    def allow(self, tenant: str, n_bytes: int, rate: float, burst: float) -> bool:
        """Take n_bytes from the tenant bucket; False = over limit (caller
        returns ResourceExhausted / RetryInfo like the receiver shim)."""
        if rate <= 0:
            return True
        t = self.now()
        with self._lock:
            if t >= self._next_sweep or len(self._buckets) > self.max_buckets:
                self._sweep_locked(t)
            b = self._buckets.get(tenant)
            if b is None:
                b = self._buckets[tenant] = _Bucket(burst, t)
            b.rate = rate
            b.burst = burst
            b.tokens = min(burst, b.tokens + (t - b.last) * rate)
            b.last = t
            if n_bytes > b.tokens:
                return False
            b.tokens -= n_bytes
            return True

    @staticmethod
    def _refilled(b: _Bucket, t: float) -> bool:
        """True when evicting b loses nothing: its refill has reached
        the burst cap, so recreation starts from the same state."""
        return b.tokens + (t - b.last) * b.rate >= b.burst

    def _sweep_locked(self, t: float) -> None:
        """Amortized eviction (caller holds the lock): refill-aware TTL
        pass first, then a trim toward 90% of max (hysteresis — trimming
        to exactly the cap would re-sort the whole map on every push
        while churn holds it at the limit), refilled buckets first."""
        self._next_sweep = t + self.idle_ttl_s / 4
        dead = [k for k, b in self._buckets.items()
                if t - b.last > self.idle_ttl_s and self._refilled(b, t)]
        for k in dead:
            del self._buckets[k]
        if len(self._buckets) > self.max_buckets:
            target = int(self.max_buckets * 0.9)
            by_age = sorted(self._buckets.items(),
                            key=lambda kv: kv[1].last)
            # pass 1 evicts only refilled buckets (lossless); pass 2
            # evicts anything (bounded memory beats perfect accounting
            # under pathological churn)
            for lossless_only in (True, False):
                if len(self._buckets) <= target:
                    break
                for k, b in by_age:
                    if len(self._buckets) <= target:
                        break
                    if k in self._buckets and \
                            (not lossless_only or self._refilled(b, t)):
                        del self._buckets[k]


def effective_rate(strategy: str, rate: float, n_distributors: int) -> float:
    """`local`: per-replica rate; `global`: fleet rate split evenly
    (`ingestion_rate_strategy.go`)."""
    if strategy == "global" and n_distributors > 0:
        return rate / n_distributors
    return rate


class IngestBackpressure:
    """Admission gate fed by the device scheduler's ingest queue.

    The token-bucket limiter above protects against tenants exceeding
    their CONFIGURED rate; this hook protects the process itself: when
    the shared device-execution scheduler's live-ingest queue is
    saturated (the chip cannot keep up), the distributor rejects pushes
    with 429 + Retry-After instead of queuing unboundedly — clients back
    off, memory stays bounded, and the queue drains. Rejections are
    visible as `tempo_discarded_spans_total{reason="sched_backpressure"}`
    and the queue itself as `tempo_sched_queue_depth{class="ingest"}`.
    """

    def __init__(self, retry_after_fn: "Callable[[], float | None] | None"
                 = None) -> None:
        # injectable for tests; default consults the process scheduler
        self._fn = retry_after_fn

    def retry_after(self) -> "float | None":
        """Seconds the producer should back off, or None to admit."""
        if self._fn is not None:
            return self._fn()
        from tempo_tpu_torch import sched
        sc = sched.scheduler()
        return sc.ingest_retry_after() if sc is not None else None
