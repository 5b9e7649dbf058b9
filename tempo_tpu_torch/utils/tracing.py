"""Self-tracing: the framework traces its own hot entry points.

The reference installs an OTel tracer at startup (`cmd/tempo/main.go:
227-281`) and wraps hot entries in spans (`distributor.PushBytes`
`distributor.go:401`, `traceql.Engine.ExecuteSearch` `engine.go:50`) with
W3C traceparent propagation. This is a from-scratch minimal tracer with
the same surface plus two properties the reference gets from the OTel
SDK + collector pair:

- **Tail-keep.** Spans buffer per trace until the trace's last local
  span closes; the whole tree is then either kept (exported) or dropped
  by a deterministic head-sample coin on the trace id — EXCEPT that
  errored and explicitly `mark_keep()`-ed traces (SLO misses) are always
  kept. Sampling a trace id (not each span) keeps trees intact across
  threads and processes: every hop coins the same verdict.
- **Loopback.** Instead of an OTLP/HTTP endpoint, a `sink` callable can
  deliver encoded batches straight into this process's own distributor
  under a reserved ops tenant. Recursion is guarded twice: the sink runs
  with span creation suppressed, and `span_for_tenant()` suppresses the
  whole ingest call-tree for the reserved tenant (a remote fleet member
  ingesting a peer's self-spans must not trace that ingestion either).

No global mutable state beyond one module-level tracer the app installs;
disabled (zero overhead beyond a None check) until configured.

A third tracer, `SpanRecorder`, keeps spans in memory for the process to
read: every span of the recording tracers carries, besides the exported
wall clock, its start and end on `time.perf_counter_ns()` (the clock a
device trace is placed against), its thread and that thread's CPU time.

Counterpart of `tempo_tpu/utils/tracing.py`, host code copied. One
deliberate difference: a `SelfTracer` draws its trace and span ids and
its export jitter from its own `random.Random(seed)` (`seed=None` seeds
from the OS), where the reference reads `os.urandom` and the module
`random`; with a seed, ids, and so the head-sample verdicts that are a
function of the trace id, repeat run for run.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
import itertools
import random
import threading
import time
import urllib.request
from typing import Callable

_current_span = contextvars.ContextVar("tempo_self_span", default=None)
# recursion guard: True while this process is ingesting its own export
# (loopback sink call, or any span_for_tenant() block for the reserved
# tenant). span() is a no-op under it.
_suppress = contextvars.ContextVar("tempo_self_suppress", default=False)

# bound on the forced-keep mark set and the keep-decision LRU; late spans
# (async sched jobs finishing after root close) look their verdict up here
_DECISION_LRU = 4096


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


class _Span:
    """One span. `start_ns`/`end_ns` are the exported wall clock (Unix
    epoch, 0 under a `SpanRecorder`); `t0_ns`/`t1_ns` are
    `time.perf_counter_ns()`, the monotonic clock a device trace is
    mapped onto; `thread` is the opening thread's ident and `cpu_ns` that
    thread's CPU time over the span."""

    __slots__ = ("trace_id", "span_id", "parent_span_id", "name",
                 "start_ns", "end_ns", "attrs", "status_code",
                 "t0_ns", "t1_ns", "thread", "cpu_ns")

    def __init__(self, trace_id: bytes, span_id: bytes,
                 parent_span_id: bytes, name: str, start_ns: int):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_span_id = parent_span_id
        self.name = name
        self.start_ns = start_ns
        self.end_ns = 0
        self.attrs: dict = {}
        self.status_code = 0
        self.t0_ns = self.t1_ns = self.cpu_ns = 0
        self.thread = 0


class _SpanStack:
    """The span surface the recording tracers share: nested spans through
    the `_current_span` contextvar, W3C traceparent propagation, and the
    clocks every span reads. A subclass gives ids (`_ids`), the exported
    wall clock (`_wall_ns`) and what happens to a span when it opens
    (`_opened`) and closes (`_record`)."""

    def _wall_ns(self) -> int:
        return 0

    def _opened(self, s: _Span) -> None:
        pass

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        if _suppress.get():
            yield None               # ingesting our own export: no spans
            return
        parent: _Span | None = _current_span.get()
        tid, sid = self._ids(parent)
        s = _Span(tid, sid, parent.span_id if parent is not None else b"",
                  name, self._wall_ns())
        s.attrs.update(attrs)
        s.thread = threading.get_ident()
        token = _current_span.set(s)
        self._opened(s)
        s.cpu_ns = time.thread_time_ns()
        s.t0_ns = time.perf_counter_ns()
        try:
            yield s
        except Exception as e:
            s.status_code = 2
            s.attrs["error.message"] = str(e)[:200]
            raise
        finally:
            s.t1_ns = time.perf_counter_ns()
            s.cpu_ns = time.thread_time_ns() - s.cpu_ns
            _current_span.reset(token)
            s.end_ns = self._wall_ns()
            self._record(s)

    def traceparent(self) -> str | None:
        """W3C traceparent for outgoing RPCs (`main.go:252-258`)."""
        s = _current_span.get()
        if s is None:
            return None
        return f"00-{s.trace_id.hex()}-{s.span_id.hex()}-01"

    def adopt(self, traceparent: str | None):
        """Continue an incoming W3C trace context; returns a context
        manager token holder or None when the header is absent/bad."""
        if not traceparent:
            return None
        parts = traceparent.split("-")
        if len(parts) < 4 or len(parts[1]) != 32 or len(parts[2]) != 16:
            return None
        try:
            tid, sid = bytes.fromhex(parts[1]), bytes.fromhex(parts[2])
        except ValueError:
            return None      # W3C: invalid traceparent values are ignored
        remote = _Span(tid, sid, b"", "remote-parent", 0)
        return _current_span.set(remote)


class SelfTracer(_SpanStack):
    """Minimal tracer: span stack via contextvars, per-trace tail buffer,
    bounded export buffer, batch export thread. Spans export as OTLP (the
    codec this framework already speaks) so any OTLP endpoint — including
    this process (loopback) — can ingest its own traces."""

    def __init__(self, endpoint: str = "", *,
                 service_name: str = "tempo-tpu",
                 tenant: str = "tempo-self", flush_interval_s: float = 2.0,
                 max_buffer: int = 4096, head_sample_rate: float = 1.0,
                 max_trace_spans: int = 256, max_open_traces: int = 1024,
                 sink: Callable[[bytes], None] | None = None,
                 resource_attrs: dict | None = None,
                 now: Callable[[], float] = time.time,
                 seed: int | None = None) -> None:
        self.endpoint = endpoint.rstrip("/")
        # ids and export jitter: one explicit generator (thread-safe at
        # the call; see the module docstring)
        self._rng = random.Random(seed)
        self.service_name = service_name
        self.tenant = tenant
        self.sink = sink
        self.now = now
        self.max_buffer = max_buffer
        self.head_sample_rate = head_sample_rate
        self.max_trace_spans = max_trace_spans
        self.max_open_traces = max_open_traces
        self.resource_attrs = dict(resource_attrs or {})
        self._buf: list[_Span] = []          # decided-keep, export-ready
        self._traces: dict[bytes, list[_Span]] = {}   # tail buffer
        self._open: dict[bytes, int] = {}    # open local spans per trace
        self._keep: set[bytes] = set()       # forced-keep marks (undecided)
        self._decided: "collections.OrderedDict[bytes, bool]" = \
            collections.OrderedDict()        # keep-verdict LRU
        self._retry: list[_Span] = []        # one failed batch, held once
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self.exported = 0
        # the tempo_selftrace_*_total families (app._init_app_obs)
        self.stats = {"spans": 0, "kept_traces": 0, "dropped_spans": 0,
                      "sampled_spans": 0, "export_retries": 0,
                      "loopback_batches": 0}
        self._thread = threading.Thread(
            target=self._loop, args=(flush_interval_s,), daemon=True)
        self._thread.start()

    @property
    def loopback(self) -> bool:
        return self.sink is not None

    # -- span API ----------------------------------------------------------

    def _ids(self, parent: "_Span | None") -> tuple[bytes, bytes]:
        tid = parent.trace_id if parent is not None \
            else self._rng.randbytes(16)
        return tid, self._rng.randbytes(8)

    def _wall_ns(self) -> int:
        return int(self.now() * 1e9)

    def _opened(self, s: _Span) -> None:
        with self._lock:
            self._open[s.trace_id] = self._open.get(s.trace_id, 0) + 1

    def mark_keep(self) -> None:
        """Force the current trace past head sampling (SLO miss, error):
        its whole tree exports even at head_sample_rate 0."""
        s = _current_span.get()
        if s is None:
            return
        with self._lock:
            self._mark_keep_locked(s.trace_id)

    def _mark_keep_locked(self, tid: bytes) -> None:
        if tid in self._decided:
            self._decided[tid] = True       # flip for late spans
        else:
            if len(self._keep) >= _DECISION_LRU:
                self._keep.pop()
            self._keep.add(tid)

    def trace_kept(self) -> str | None:
        """Hex trace id of the current trace IF its tree will be (or was)
        kept, else None — the qlog `selfTraceId` bridge. Deterministic
        head sampling makes the verdict knowable before root close."""
        s = _current_span.get()
        if s is None:
            return None
        tid = s.trace_id
        with self._lock:
            verdict = self._decided.get(tid)
            if verdict is None:
                verdict = tid in self._keep or self._head_keep(tid)
        return tid.hex() if verdict else None

    def _head_keep(self, tid: bytes) -> bool:
        if self.head_sample_rate >= 1.0:
            return True
        # deterministic per-trace coin: every hop of a distributed tree
        # (other threads, other processes) coins the same verdict
        return int.from_bytes(tid[:8], "big") \
            < int(self.head_sample_rate * 2.0 ** 64)

    # -- tail buffer -------------------------------------------------------

    def _record(self, s: _Span) -> None:
        tid = s.trace_id
        with self._lock:
            self.stats["spans"] += 1
            if s.status_code == 2:
                self._mark_keep_locked(tid)
            open_n = self._open.get(tid, 0) - 1
            if open_n > 0:
                self._open[tid] = open_n
            else:
                self._open.pop(tid, None)
            verdict = self._decided.get(tid)
            if verdict is not None:
                # late span: trace already finalized (root closed before
                # an async job span, or evicted) — follow its verdict
                self._decided.move_to_end(tid)
                if verdict or s.status_code == 2:
                    self._decided[tid] = True
                    self._enqueue_locked([s])
                else:
                    self.stats["sampled_spans"] += 1
                return
            buf = self._traces.setdefault(tid, [])
            if len(buf) >= self.max_trace_spans:
                self.stats["dropped_spans"] += 1
            else:
                buf.append(s)
            if open_n <= 0:
                self._finalize_locked(tid)
            elif len(self._traces) > self.max_open_traces:
                # bound: force-decide the oldest open trace; its later
                # spans follow the cached verdict individually
                self._finalize_locked(next(iter(self._traces)))

    def _finalize_locked(self, tid: bytes) -> None:
        spans = self._traces.pop(tid, [])
        keep = tid in self._keep or self._head_keep(tid)
        self._keep.discard(tid)
        self._decided[tid] = keep
        while len(self._decided) > _DECISION_LRU:
            self._decided.popitem(last=False)
        if keep:
            self.stats["kept_traces"] += 1
            self._enqueue_locked(spans)
        else:
            self.stats["sampled_spans"] += len(spans)

    def _enqueue_locked(self, spans: list[_Span]) -> None:
        room = self.max_buffer - len(self._buf)
        if room < len(spans):
            self.stats["dropped_spans"] += len(spans) - max(0, room)
            spans = spans[:max(0, room)]
        self._buf.extend(spans)

    def tail_buffered(self) -> int:
        """Spans held in per-trace tail buffers (undecided traces) — the
        tempo_selftrace_tail_buffer_spans gauge."""
        with self._lock:
            return sum(len(v) for v in self._traces.values())

    @property
    def dropped(self) -> int:
        """Spans lost to buffer overflow OR failed exports — the span-loss
        signal behind `tempo_self_tracer_dropped_spans_total`. Head-
        sampled-out spans are NOT losses and count separately."""
        with self._lock:
            return self.stats["dropped_spans"]

    # -- export ------------------------------------------------------------

    def _drain(self) -> tuple[list[_Span], bool]:
        with self._lock:
            spans, retrying = self._retry + self._buf, bool(self._retry)
            self._retry, self._buf = [], []
        return spans, retrying

    def flush(self) -> int:
        """Export buffered spans now; returns how many went out. A failed
        export holds the batch for exactly ONE retry on the next flush
        tick (export_retries) before counting it into dropped."""
        spans, retrying = self._drain()
        if not spans:
            return 0
        from tempo_tpu_torch.model.otlp import encode_spans_otlp

        res_attrs = {"service.name": self.service_name}
        res_attrs.update(self.resource_attrs)
        payload = encode_spans_otlp([{
            "trace_id": s.trace_id, "span_id": s.span_id,
            "parent_span_id": s.parent_span_id, "name": s.name,
            "service": self.service_name, "kind": 1,   # INTERNAL
            "status_code": s.status_code,
            "start_unix_nano": s.start_ns, "end_unix_nano": s.end_ns,
            "attrs": {k: v for k, v in s.attrs.items()},
            "res_attrs": res_attrs,
        } for s in spans])
        try:
            if self.sink is not None:
                # loopback: deliver into this process's own distributor.
                # Suppress span creation for the whole sink call — the
                # recursion guard's first line of defense (span_for_tenant
                # guards the remote-ingest half).
                token = _suppress.set(True)
                try:
                    self.sink(payload)
                finally:
                    _suppress.reset(token)
                with self._lock:
                    self.stats["loopback_batches"] += 1
            else:
                req = urllib.request.Request(
                    self.endpoint + "/v1/traces", data=payload,
                    headers={"Content-Type": "application/x-protobuf",
                             "X-Scope-OrgID": self.tenant})
                urllib.request.urlopen(req, timeout=5).close()
            self.exported += len(spans)
            return len(spans)
        except Exception:
            # self-tracing must never hurt the service — but the loss must
            # be visible: hold the batch once, then drop it where the
            # check_metrics_drift-gated alerting watches for span loss
            with self._lock:
                if retrying:
                    self.stats["dropped_spans"] += len(spans)
                else:
                    self._retry = spans
                    self.stats["export_retries"] += 1
            return 0

    def _loop(self, interval_s: float) -> None:
        # jittered: N fleet members must not export in lockstep
        while not self._stop.wait(interval_s * (0.5 + self._rng.random())):
            self.flush()

    def status(self) -> dict:
        """/status block: export health at a glance."""
        with self._lock:
            stats = dict(self.stats)
            tail = sum(len(v) for v in self._traces.values())
        return {"tenant": self.tenant, "loopback": self.loopback,
                "endpoint": self.endpoint or None,
                "headSampleRate": self.head_sample_rate,
                "exported": self.exported, "tailBufferSpans": tail,
                **{k: v for k, v in stats.items()}}

    def shutdown(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2)
        self.flush()
        self.flush()        # second pass drains a held retry batch


class NoopTracer:
    """Disabled tracer: the default; `span()` costs one None check."""

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


class SpanRecorder(_SpanStack):
    """Keeps finished spans in memory for the process itself to read (a
    benchmark, a profile of one stage): no export and no thread. At most
    `max_spans` are kept; later ones are counted in `dropped`. Its
    `tenant` is None, so `span_for_tenant` never suppresses under it.
    Trace and span ids count up from 1."""

    exported = 0
    loopback = False
    tenant = None

    def __init__(self, max_spans: int = 131_072) -> None:
        self.max_spans = max_spans
        self.spans: list[_Span] = []
        self.dropped = 0
        self._next_id = itertools.count(1)
        self._lock = threading.Lock()

    def _ids(self, parent: "_Span | None") -> tuple[bytes, bytes]:
        sid = next(self._next_id).to_bytes(8, "big")
        return (parent.trace_id if parent is not None else bytes(8) + sid,
                sid)

    def _record(self, s: _Span) -> None:
        with self._lock:
            if len(self.spans) < self.max_spans:
                self.spans.append(s)
            else:
                self.dropped += 1

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


_tracer: "SelfTracer | NoopTracer | SpanRecorder" = NoopTracer()


def install(tracer: "SelfTracer | NoopTracer | SpanRecorder") -> None:
    global _tracer
    _tracer = tracer


def tracer() -> "SelfTracer | NoopTracer | SpanRecorder":
    return _tracer


def span(name: str, **attrs):
    """Module-level convenience: `with tracing.span("distributor.push"):`"""
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
    None outside any span — the metrics-side exemplar bridge: slow
    requests stamp this onto their histogram observation."""
    s = _current_span.get()
    return s.trace_id.hex() if s is not None else None


def reserved_tenant() -> "str | None":
    """The loopback ops tenant, when self-ingest is active — excluded
    from fleet handoff, matview auto-subscribe, and public push APIs."""
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
    """Like span(), but for the self-tracing tenant it SUPPRESSES tracing
    for the whole block: in loopback mode (exporting into this very
    process, or into a fleet peer that forwards back) tracing the
    ingestion of our own spans would emit new spans per flush, forever.
    Plain nullcontext would only skip THIS span; nested wal.append /
    sched.dispatch spans under the ingest call-tree must go quiet too."""
    if getattr(_tracer, "tenant", None) == tenant:
        return suppress()
    return _tracer.span(name, tenant=tenant, **attrs)


@contextlib.contextmanager
def adopted(traceparent: str | None):
    """Continue an incoming W3C trace context for the duration of a
    request handler; resets cleanly afterwards (receiver-side half of
    `main.go:252-258` propagation)."""
    token = _tracer.adopt(traceparent)
    try:
        yield
    finally:
        if token is not None:
            _current_span.reset(token)


__all__ = ["SelfTracer", "NoopTracer", "SpanRecorder", "SelfTraceConfig",
           "install", "tracer", "span", "span_for_tenant", "adopted",
           "mark_keep", "kept_trace_id_hex", "current_trace_id_hex",
           "reserved_tenant", "is_reserved", "suppress", "suppressed"]
