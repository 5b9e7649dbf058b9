"""Live-trace accumulation with size/count limits and idle cutting.

Counterpart of `tempo_tpu/utils/livetraces.py`, host code copied with its imports
moved to the port.

Analog of `pkg/livetraces/livetraces.go:23-120` (used by the ingester
instance, generator localblocks, and blockbuilder): spans group per trace id
in memory; traces are "cut" (emitted for WAL append) once idle longer than
`idle_s`, older than `max_age_s`, or immediately on demand. Per-trace byte
and global count limits guard memory, mirroring the push error reasons of
`modules/ingester/instance.go:199-228` (`PushErrorReason`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable

ERR_LIVE_TRACES_EXCEEDED = "live_traces_exceeded"
ERR_TRACE_TOO_LARGE = "trace_too_large"


@dataclasses.dataclass
class LiveTrace:
    trace_id: bytes
    spans: list = dataclasses.field(default_factory=list)
    bytes: int = 0
    first_append: float = 0.0
    last_append: float = 0.0


class LiveTraceStore:
    def __init__(self, max_live_traces: int = 0, max_trace_bytes: int = 0,
                 now: Callable[[], float] = time.time):
        self.max_live_traces = max_live_traces  # 0 = unlimited
        self.max_trace_bytes = max_trace_bytes
        self.now = now
        self.traces: dict[bytes, LiveTrace] = {}
        self.total_bytes = 0
        self.pushes_rejected: dict[str, int] = {}

    def __len__(self) -> int:
        return len(self.traces)

    def push(self, trace_id: bytes, spans: Iterable[dict],
             size_bytes: int | None = None) -> str | None:
        """Append spans to a live trace. Returns an error reason or None."""
        spans = list(spans)
        sz = size_bytes if size_bytes is not None else _approx_size(spans)
        lt = self.traces.get(trace_id)
        # Both limit checks run before any store mutation, so a rejected
        # first push leaves no empty LiveTrace behind.
        if self.max_trace_bytes and (lt.bytes if lt else 0) + sz > self.max_trace_bytes:
            self.pushes_rejected[ERR_TRACE_TOO_LARGE] = (
                self.pushes_rejected.get(ERR_TRACE_TOO_LARGE, 0) + 1)
            return ERR_TRACE_TOO_LARGE
        if lt is None:
            if self.max_live_traces and len(self.traces) >= self.max_live_traces:
                self.pushes_rejected[ERR_LIVE_TRACES_EXCEEDED] = (
                    self.pushes_rejected.get(ERR_LIVE_TRACES_EXCEEDED, 0) + 1)
                return ERR_LIVE_TRACES_EXCEEDED
            lt = self.traces[trace_id] = LiveTrace(
                trace_id, first_append=self.now())
        lt.spans.extend(spans)
        lt.bytes += sz
        lt.last_append = self.now()
        self.total_bytes += sz
        return None

    def cut(self, idle_s: float = 0.0, max_age_s: float = 0.0,
            immediate: bool = False) -> list[LiveTrace]:
        """Remove and return traces idle > idle_s or older than max_age_s
        (`CutCompleteTraces` `instance.go:237`); immediate cuts everything."""
        now = self.now()
        out = []
        for tid in list(self.traces):
            lt = self.traces[tid]
            if (immediate
                    or (idle_s and now - lt.last_append >= idle_s)
                    or (max_age_s and now - lt.first_append >= max_age_s)):
                out.append(self.traces.pop(tid))
                self.total_bytes -= lt.bytes
        return out


def _approx_size(spans: list[dict]) -> int:
    # cheap stand-in for proto size: span count * nominal span bytes + attrs
    return sum(200 + 32 * (len(s.get("attrs") or {}) + len(s.get("res_attrs") or {}))
               for s in spans)
