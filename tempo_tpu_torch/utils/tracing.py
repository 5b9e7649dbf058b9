"""Self-tracing hooks: the span surface the scheduler and the frontend call.

Counterpart of the part of `tempo_tpu/utils/tracing.py` that the
scheduler and the query frontend use (`span`, `span_for_tenant`,
`adopted`, `install` / `tracer`, `mark_keep`, `kept_trace_id_hex`,
`current_trace_id_hex`, the disabled `NoopTracer` and the
reserved-tenant guard, reference `:389-503`). The reference's `SelfTracer` (tail-keep buffers,
W3C propagation, OTLP export and loopback self-ingest) comes with the
app-wiring slice of the port; until then the installed tracer is the
`NoopTracer` unless a caller installs an object with the same surface.
"""

from __future__ import annotations

import contextlib
import contextvars

_current_span = contextvars.ContextVar("tempo_self_span", default=None)
# recursion guard: True while this process is ingesting its own export
# (any span_for_tenant() block for the reserved tenant); span creation
# is then a no-op
_suppress = contextvars.ContextVar("tempo_self_suppress", default=False)


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


__all__ = ["NoopTracer", "install", "tracer", "span", "span_for_tenant",
           "adopted", "mark_keep", "kept_trace_id_hex",
           "current_trace_id_hex", "reserved_tenant", "is_reserved",
           "suppress", "suppressed"]
