"""Structured query logging: one JSON "query complete" line per request.

Counterpart of `tempo_tpu/obs/qlog.py` (host code, copied); the records
are the reference's, on the `tempo_tpu_torch.query` logger.

The reference's query-frontend logs a structured result line per query
(`modules/frontend/handler.go` "query stats" logging) carrying tenant,
query, duration, and the merged stats fields. This module is that
emitter, with tail-based capture so log volume tracks interesting
queries, not traffic:

- errors log unconditionally (ERROR level);
- queries slower than a moment-sketch-estimated latency quantile log as
  slow queries (WARNING) — the in-process log2 sketch gives cheap
  mergeable quantiles (arXiv:1803.01969's observation that log-spaced
  summaries are the right compact primitive for latency telemetry), so
  the threshold self-tunes to each op's own distribution instead of a
  static number;
- everything else is head-sampled 1-in-N (INFO).

Non-error emission is token-bucket rate-limited so a latency regression
cannot turn the query log into its own outage; errors bypass the bucket.
Every record is one `json.dumps` line on the `tempo_tpu_torch.query` logger —
machine-parseable, greppable, and carrying the active SelfTracer trace
id so a slow line is one click from its trace.
"""

from __future__ import annotations

import json
import logging
import math
import threading
import time
from collections import OrderedDict
from typing import Callable

from tempo_tpu_torch.obs.querystats import QueryStats

LOGGER_NAME = "tempo_tpu_torch.query"

_NBUCKETS = 64
# bucket offset shifts coverage down to sub-millisecond latencies:
# bucket b>0 holds durations in [2^(b-1-_OFFSET), 2^(b-_OFFSET)) seconds,
# so with _OFFSET=32 the range spans ~2^-32s .. ~2^31s (ops/sketches
# Log2Histogram geometry, host-side — one int array, no device round trip)
_OFFSET = 32


class LatencySketch:
    """Per-op power-of-two latency histogram with interpolated quantile —
    the host twin of `ops.sketches.Log2Histogram` (same bucketing, same
    exponential interpolation), sized for one counter add per query."""

    def __init__(self) -> None:
        self.counts = [0] * _NBUCKETS
        self.total = 0

    def record(self, seconds: float) -> None:
        if seconds <= 0:
            b = 0
        else:
            b = min(max(int(math.floor(math.log2(seconds))) + 1 + _OFFSET, 0),
                    _NBUCKETS - 1)
        self.counts[b] += 1
        self.total += 1

    def quantile(self, q: float) -> float:
        """Interpolated q-quantile in seconds (0.0 when empty)."""
        if self.total <= 0:
            return 0.0
        target = max(q * self.total, 1e-12)
        cum = 0
        for b, c in enumerate(self.counts):
            cum += c
            if cum >= target:
                if b == 0:
                    return 0.0
                frac = (target - (cum - c)) / c if c else 1.0
                return 2.0 ** (b - 1 - _OFFSET + frac)
        return 2.0 ** (_NBUCKETS - 1 - _OFFSET)


class QueryLogger:
    """Level- and rate-limit-aware structured query logger.

    `log_query` is called once per frontend request; whether a record is
    emitted follows the error > slow > sampled cascade above. Emission
    counts are kept per outcome (for a registry callback family) so
    suppressed volume stays observable.
    """

    def __init__(self, *,
                 slow_quantile: float = 0.95,
                 sample_every: int = 100,
                 min_observations: int = 30,
                 rate_limit_per_s: float = 10.0,
                 burst: int = 20,
                 logger: "logging.Logger | None" = None,
                 now: Callable[[], float] = time.time) -> None:
        self.slow_quantile = float(slow_quantile)
        self.sample_every = max(int(sample_every), 1)
        self.min_observations = int(min_observations)
        self.now = now
        self._logger = logger if logger is not None \
            else logging.getLogger(LOGGER_NAME)
        self._lock = threading.Lock()
        self._sketches: dict[str, LatencySketch] = {}
        self._seen: dict[str, int] = {}
        # recurring-query recognition: per-fingerprint (obs/queryfp.py
        # — the identity shared with the matview tier) hit counts over
        # a sliding window, bounded LRU so dashboard churn cannot grow
        # it without bound. The materialized-view tier reads these
        # counts to auto-subscribe hot queries.
        self._recur: "OrderedDict[str, tuple[int, float]]" = OrderedDict()
        self._recur_window_s = 600.0
        self._recur_max = 4096
        # token bucket for non-error records (errors always emit)
        self._rate = float(rate_limit_per_s)
        self._burst = float(burst)
        self._tokens = float(burst)
        self._last_refill = now()
        self.emitted: dict[str, int] = {}      # reason -> count
        self.suppressed = 0

    # -- decision helpers ---------------------------------------------------

    def threshold(self, op: str) -> float:
        """Current slow-query duration threshold for an op, seconds
        (0.0 until the sketch has min_observations)."""
        with self._lock:
            sk = self._sketches.get(op)
            if sk is None or sk.total < self.min_observations:
                return 0.0
            return sk.quantile(self.slow_quantile)

    def _take_token(self) -> bool:
        t = self.now()
        self._tokens = min(self._burst,
                           self._tokens + (t - self._last_refill) * self._rate)
        self._last_refill = t
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            return True
        return False

    def _decide(self, op: str, status: str, duration_s: float) -> "str | None":
        """Returns the emission reason, or None to suppress. Also feeds
        the duration sketch (every query observes, logged or not)."""
        with self._lock:
            sk = self._sketches.get(op)
            if sk is None:
                sk = self._sketches[op] = LatencySketch()
            warmed = sk.total >= self.min_observations
            thr = sk.quantile(self.slow_quantile) if warmed else 0.0
            sk.record(duration_s)
            if status != "ok":
                return "error"
            # head-sampling counts only ok queries (errors always emit and
            # must not steal a sample slot)
            self._seen[op] = n = self._seen.get(op, 0) + 1
            if warmed and duration_s >= thr:
                reason = "slow"
            elif (n - 1) % self.sample_every == 0:
                reason = "sampled"
            else:
                self.suppressed += 1
                return None
            if not self._take_token():
                self.suppressed += 1
                return None
            return reason

    def note_fingerprint(self, fp: str) -> int:
        """Count one sighting of a query fingerprint; returns how many
        times it recurred within the sliding window. The frontend feeds
        every metrics request through here and hands the count to the
        materializer's auto-subscribe decision — qlog owns recurrence so
        the query log and the matview tier see the same hot set."""
        t = self.now()
        with self._lock:
            n, first = self._recur.get(fp, (0, t))
            if t - first > self._recur_window_s:
                n, first = 0, t            # window rolled: restart count
            self._recur[fp] = (n + 1, first)
            self._recur.move_to_end(fp)
            while len(self._recur) > self._recur_max:
                self._recur.popitem(last=False)
            return n + 1

    def fingerprint_count(self, fp: str) -> int:
        with self._lock:
            n, first = self._recur.get(fp, (0, 0.0))
            if n and self.now() - first > self._recur_window_s:
                return 0
            return n

    # -- emission -----------------------------------------------------------

    def log_query(self, *, op: str, tenant: str, query: str, status: str,
                  duration_s: float, stats: "QueryStats | None" = None,
                  trace_id: "str | None" = None,
                  error: "str | None" = None,
                  extra: "dict | None" = None) -> "dict | None":
        """Emit (or suppress) one "query complete" record; returns the
        record dict when emitted, None when suppressed. `extra` merges
        additional context fields into the record (e.g. the frontend's
        ingest keep-fraction exemplar while overload sampling is active
        — a reader of a slow/odd query line needs to know whether its
        quantiles came from a sampled stream)."""
        reason = self._decide(op, status, duration_s)
        if reason is None:
            return None
        record = {
            "msg": "query complete",
            "reason": reason,
            "op": op,
            "tenant": tenant,
            "query": query,
            "status": status,
            "durationMs": round(duration_s * 1e3, 3),
            "traceId": trace_id,
        }
        if extra:
            record.update(extra)
        if error:
            record["error"] = str(error)[:500]
        if stats is not None:
            record.update(stats.search_metrics())
            # tenant read-cost investigation fields, pre-derived so a
            # reader never joins against /metrics: the request's device
            # wall (device-time ledger attribution, obs/devtime.py) and
            # the share of its duration spent waiting on the device
            # scheduler (high share = the chip, not the query, is slow)
            record["deviceSeconds"] = round(record["deviceNanos"] / 1e9, 6)
            if duration_s > 0:
                wait_ns = record["stageDurationNanos"].get("sched_wait", 0)
                record["schedWaitShare"] = round(
                    min(wait_ns / 1e9 / duration_s, 1.0), 4)
        level = (logging.ERROR if reason == "error"
                 else logging.WARNING if reason == "slow" else logging.INFO)
        with self._lock:
            self.emitted[reason] = self.emitted.get(reason, 0) + 1
        self._logger.log(level, json.dumps(record, sort_keys=True))
        return record

    # -- registry bridge ----------------------------------------------------

    def emitted_by_reason(self) -> list:
        """Callback-family shape: [((reason,), count), ...] plus the
        suppressed count under reason="suppressed"."""
        with self._lock:
            out = [((k,), float(v)) for k, v in self.emitted.items()]
            out.append((("suppressed",), float(self.suppressed)))
        return out


__all__ = ["QueryLogger", "LatencySketch", "LOGGER_NAME"]
