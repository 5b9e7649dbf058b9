"""Data-quality warning metrics (ref `pkg/dataquality/dataquality.go`).

The reference counts spans whose timestamps are disagreeably far in the
future or past (`tempo_warnings_total{reason=...}`) so operators can spot
misbehaving SDK clocks before they skew blocks and metrics. Same idea
here, vectorized: one pass over a batch's start times.

Counterpart of `tempo_tpu/utils/dataquality.py`. The orphan-span counter
registers on the port's process registry
(`tempo_tpu_torch.obs.runtime.RUNTIME`) under the reference's family
name, where the reference registers it on `obs.jaxruntime.RUNTIME`."""

from __future__ import annotations

import threading
import time
from typing import Callable, Sequence

REASON_OUTSIDE_INGESTION_SLACK = "outside_ingestion_time_slack"
REASON_BLOCK_OUTSIDE_SLACK = "blocks_outside_ingestion_time_slack"
REASON_FUTURE = "disparate_future_time"
REASON_PAST = "disparate_past_time"

_FUTURE_S = 2 * 3600.0          # dataquality.go thresholds
_PAST_S = 14 * 24 * 3600.0

# ---------------------------------------------------------------------------
# orphan-parent spans — process-wide, fed by the trace-analytics cut
# ---------------------------------------------------------------------------
#
# A span with a non-zero parent id whose parent never arrived within its
# trace by cut time. These previously vanished silently; the structural
# analytics tier both needs the signal (an orphan invalidates its
# subtree's critical path) and surfaces it here for operators. Process-
# wide like the RUNTIME families: orphanhood is decided per cut, not per
# App, and the counter must exist (for the dashboard drift gate) even in
# processes that never enable the processor.

_orphan_lock = threading.Lock()
_orphan_spans: dict[str, int] = {}      # tenant -> total


def note_orphan_spans(tenant: str, n: int) -> None:
    if n <= 0:
        return
    with _orphan_lock:
        _orphan_spans[tenant] = _orphan_spans.get(tenant, 0) + int(n)


def orphan_spans_snapshot() -> dict[str, int]:
    with _orphan_lock:
        return dict(_orphan_spans)


def reset_orphan_spans() -> None:
    """Test hook: counters are process-wide and monotonic."""
    with _orphan_lock:
        _orphan_spans.clear()


def _register_orphan_counter() -> None:
    from tempo_tpu_torch.obs.runtime import RUNTIME

    RUNTIME.counter_func(
        "tempo_dataquality_orphan_spans_total",
        lambda: [((t,), float(v)) for t, v in orphan_spans_snapshot().items()
                 if v],
        help="Spans whose non-zero parent span id never resolved within "
             "their trace by analytics cut time (trace-analytics "
             "processor; subtree excluded from critical-path attribution)",
        labels=("tenant",))


_register_orphan_counter()


class DataQuality:
    """Per-tenant warning counters, exposed on /metrics as
    tempo_warnings_total{tenant,reason}."""

    def __init__(self, now: Callable[[], float] = time.time) -> None:
        self.now = now
        self._lock = threading.Lock()
        self.warnings: dict[tuple[str, str], int] = {}

    def warn(self, tenant: str, reason: str, n: int = 1) -> None:
        if n <= 0:
            return
        with self._lock:
            k = (tenant, reason)
            self.warnings[k] = self.warnings.get(k, 0) + int(n)

    def observe_spans(self, tenant: str, spans: Sequence[dict]) -> None:
        """Count spans with clocks far off now (one pass, no copies)."""
        now_ns = self.now() * 1e9
        fut = now_ns + _FUTURE_S * 1e9
        past = now_ns - _PAST_S * 1e9
        n_future = n_past = 0
        for s in spans:
            st = s.get("start_unix_nano", 0)
            if st > fut:
                n_future += 1
            elif st and st < past:
                n_past += 1
        self.warn(tenant, REASON_FUTURE, n_future)
        self.warn(tenant, REASON_PAST, n_past)

    def observe_start_ns(self, tenant: str, start_ns) -> None:
        """Vectorized variant over a [n] start-time column (the columnar
        distributor path)."""
        import numpy as np

        st = np.asarray(start_ns, np.float64)
        now_ns = self.now() * 1e9
        self.warn(tenant, REASON_FUTURE,
                  int((st > now_ns + _FUTURE_S * 1e9).sum()))
        self.warn(tenant, REASON_PAST,
                  int(((st > 0) & (st < now_ns - _PAST_S * 1e9)).sum()))

    def snapshot(self) -> dict[tuple[str, str], int]:
        with self._lock:
            return dict(self.warnings)


__all__ = ["DataQuality", "REASON_FUTURE", "REASON_PAST",
           "REASON_OUTSIDE_INGESTION_SLACK", "REASON_BLOCK_OUTSIDE_SLACK",
           "note_orphan_spans", "orphan_spans_snapshot",
           "reset_orphan_spans"]
