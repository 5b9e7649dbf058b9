"""Self-tracing hooks: the span surface the scheduler and the frontend call.

Counterpart of the part of `tempo_tpu/utils/tracing.py` that the
scheduler and the query frontend use (`span`, `span_for_tenant`,
`adopted`, `install` / `tracer`, `mark_keep`, `kept_trace_id_hex`,
`current_trace_id_hex`, the disabled `NoopTracer` and the
reserved-tenant guard, reference `:389-503`), and the `selftrace:` config
block the App reads (`SelfTraceConfig`, reference `:51-83`). The
reference's `SelfTracer` (tail-keep buffers, W3C propagation, OTLP export
and loopback self-ingest) comes with ROADMAP section 1, item 9b: the App
raises naming it when self-tracing is configured, and the installed
tracer is the `NoopTracer` unless a caller installs an object with the
same surface.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses

_current_span = contextvars.ContextVar("tempo_self_span", default=None)
# recursion guard: True while this process is ingesting its own export
# (any span_for_tenant() block for the reserved tenant); span creation
# is then a no-op
_suppress = contextvars.ContextVar("tempo_self_suppress", default=False)


@dataclasses.dataclass
class SelfTraceConfig:
    """The `selftrace:` config block (runbook "Tracing Tempo with
    Tempo"). `enabled` routes export into this process's OWN distributor
    under the reserved `tenant`; `endpoint` routes to an external OTLP
    host instead (mutually exclusive — loopback wins)."""

    enabled: bool = False
    endpoint: str = ""
    tenant: str = "tempo-self"
    head_sample_rate: float = 1.0
    flush_interval_s: float = 2.0
    max_buffer: int = 4096        # spans ready to export
    max_trace_spans: int = 256    # tail buffer: spans held per open trace
    max_open_traces: int = 1024   # tail buffer: concurrently open traces

    def check(self) -> list[str]:
        problems = []
        if not (0.0 <= self.head_sample_rate <= 1.0):
            problems.append(f"head_sample_rate {self.head_sample_rate} "
                            "outside [0, 1]")
        if self.flush_interval_s <= 0:
            problems.append("flush_interval_s must be > 0")
        if self.max_buffer < 1 or self.max_trace_spans < 2 \
                or self.max_open_traces < 1:
            problems.append("max_buffer/max_trace_spans/max_open_traces "
                            "must be positive (max_trace_spans >= 2)")
        if self.enabled and not self.tenant:
            problems.append("enabled requires a reserved tenant name")
        if self.enabled and self.endpoint:
            problems.append("both enabled (loopback) and endpoint set: "
                            "loopback wins, endpoint is ignored")
        return ["selftrace: " + p for p in problems] if problems else []


class NoopTracer:
    """Disabled tracer: the default; `span()` costs one call."""

    dropped = 0
    exported = 0
    loopback = False
    tenant = None
    stats: dict = {}

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        yield None

    def traceparent(self) -> None:
        return None

    def adopt(self, traceparent):
        return None

    def mark_keep(self) -> None:
        pass

    def trace_kept(self) -> None:
        return None

    def tail_buffered(self) -> int:
        return 0

    def status(self) -> None:
        return None

    def flush(self) -> int:
        return 0

    def shutdown(self) -> None:
        pass


_tracer = NoopTracer()


def install(tracer) -> None:
    global _tracer
    _tracer = tracer


def tracer():
    return _tracer


def span(name: str, **attrs):
    """Module-level convenience: `with tracing.span("sched.dispatch"):`"""
    return _tracer.span(name, **attrs)


def mark_keep() -> None:
    """Force the current trace past head sampling (SLO miss / error)."""
    _tracer.mark_keep()


def kept_trace_id_hex() -> "str | None":
    """Hex id of the current trace if its tree will be kept, else None —
    stamped into qlog "query complete" lines as `selfTraceId`."""
    return _tracer.trace_kept()


def current_trace_id_hex() -> "str | None":
    """Trace id of the active span (local or adopted remote context), or
    None outside any span — slow requests stamp this onto their histogram
    observation as the exemplar."""
    s = _current_span.get()
    return s.trace_id.hex() if s is not None else None


def reserved_tenant() -> "str | None":
    """The loopback ops tenant, when self-ingest is active."""
    t = _tracer
    return t.tenant if getattr(t, "loopback", False) else None


def is_reserved(tenant: str) -> bool:
    rt = reserved_tenant()
    return rt is not None and tenant == rt


def suppressed() -> bool:
    """True while span creation is suppressed (self-ingest in progress)."""
    return _suppress.get()


@contextlib.contextmanager
def suppress():
    """Suppress span creation for a block (self-ingest recursion guard)."""
    token = _suppress.set(True)
    try:
        yield None
    finally:
        _suppress.reset(token)


def span_for_tenant(name: str, tenant: str, **attrs):
    """Like span(), but for the self-tracing tenant it suppresses tracing
    for the whole block: tracing the ingestion of the process's own spans
    would emit new spans per flush, forever."""
    if getattr(_tracer, "tenant", None) == tenant:
        return suppress()
    return _tracer.span(name, tenant=tenant, **attrs)


@contextlib.contextmanager
def adopted(traceparent: "str | None"):
    """Continue an incoming W3C trace context for the duration of a block
    (the scheduler re-enters a fn job's submitter context on its worker);
    resets cleanly afterwards."""
    token = _tracer.adopt(traceparent)
    try:
        yield
    finally:
        if token is not None:
            _current_span.reset(token)


__all__ = ["SelfTraceConfig", "NoopTracer", "install", "tracer", "span", "span_for_tenant",
           "adopted", "mark_keep", "kept_trace_id_hex",
           "current_trace_id_hex", "reserved_tenant", "is_reserved",
           "suppress", "suppressed"]
