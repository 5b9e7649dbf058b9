"""Per-tenant generator instance: processors + registry + remote write.

Counterpart of `tempo_tpu/generator/instance.py`, the analog of the
reference's `modules/generator/instance.go`: `push_batch` fans a span
batch to the enabled processors (`instance.go:398-415`), ingestion-slack
filtering (`instance.go:442-473`) drops spans whose end time is outside
[now - slack, now + slack], and a collection tick drains the registry to
the remote-write client.

The port runs the reference's default processors, `span-metrics` and
`service-graphs`, over paged state when a page pool is active and the
tenant's capacity splits into its pages, over dense state otherwise.
Span-metrics updates ride the process device scheduler when one is
configured and enabled (`tempo_tpu_torch.sched.configure`; the
processor's `use_scheduler`, on by default) and the direct route
otherwise; `drain()` flushes the scheduler, so a collection sees every
push accepted before it. There is no staging pipeline (it serves the
staged native push paths): with the scheduler on, the port behaves as
the reference does at `pipeline_depth: 0`. The `local-blocks` and
`trace-analytics` processors and the staged native fast paths raise
`NotImplementedError`.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from tempo_tpu_torch import sched
from tempo_tpu_torch.device import resolve_device
from tempo_tpu_torch.generator.processors.servicegraphs import (
    ServiceGraphsConfig,
    ServiceGraphsProcessor,
)
from tempo_tpu_torch.generator.processors.spanmetrics import (
    SpanMetricsConfig,
    SpanMetricsProcessor,
)
from tempo_tpu_torch.generator.remote_write import RemoteWriteClient, RemoteWriteConfig
from tempo_tpu_torch.model.span_batch import SpanBatch
from tempo_tpu_torch.registry import ManagedRegistry, RegistryOverrides


@dataclasses.dataclass
class GeneratorConfig:
    processors: tuple[str, ...] = ("span-metrics", "service-graphs")
    registry: RegistryOverrides = dataclasses.field(default_factory=RegistryOverrides)
    spanmetrics: SpanMetricsConfig = dataclasses.field(default_factory=SpanMetricsConfig)
    servicegraphs: ServiceGraphsConfig = dataclasses.field(
        default_factory=ServiceGraphsConfig)
    remote_write: RemoteWriteConfig = dataclasses.field(default_factory=RemoteWriteConfig)
    ingestion_time_range_slack_s: float = 30.0


class GeneratorInstance:
    """One tenant's generator on `device` (`cuda` unless `"cpu"` is asked
    for). Its state lives in the active page pool, which must then be on
    the same device, or with no pool (or a capacity the pool's pages do
    not divide) in dense state on `device`."""

    def __init__(self, tenant: str, cfg: GeneratorConfig | None = None,
                 now=time.time, device=None):
        self.device = resolve_device(device)
        self.tenant = tenant
        self.cfg = cfg or GeneratorConfig()
        self.now = now
        self.registry = ManagedRegistry(tenant, self.cfg.registry, now=now,
                                        device=self.device)
        self.remote_write = RemoteWriteClient(self.cfg.remote_write)
        self.processors: dict[str, object] = {}
        self.update_processors(self.cfg.processors)
        self.spans_received = 0
        self.spans_filtered_slack = 0
        self._last_purge = 0.0

    def drain(self) -> None:
        """The collection barrier: flush the device scheduler, so every
        update accepted before this call is in device state."""
        sched.flush()

    def update_processors(self, desired: tuple[str, ...]) -> None:
        for name in list(self.processors):
            if name not in desired:
                del self.processors[name]
        for name in desired:
            if name in self.processors:
                continue
            if name == "span-metrics":
                self.processors[name] = SpanMetricsProcessor(
                    self.registry, self.cfg.spanmetrics)
            elif name == "service-graphs":
                self.processors[name] = ServiceGraphsProcessor(
                    self.registry, self.cfg.servicegraphs)
            elif name in ("trace-analytics", "local-blocks"):
                raise NotImplementedError(
                    f"processor {name} comes with a later slice of the port")
            else:
                raise ValueError(f"unknown processor {name}")

    # -- ingest ------------------------------------------------------------

    def push_otlp_staged(self, data: bytes, trusted: bool = False):
        """The reference's staged native fast route (OTLP bytes → C++ stage
        → fused resolve) comes with the port's C++ host layer."""
        raise NotImplementedError(
            "the staged native fast paths come with a later slice of the "
            "port (the C++ host layer); use otlp_proto_to_batch + push_batch")

    def _slack_bounds(self, now_s: "float | None" = None) -> tuple[int, int]:
        slack = self.cfg.ingestion_time_range_slack_s
        if slack <= 0:
            return 0, 0
        now_ns = int((self.now() if now_s is None else now_s) * 1e9)
        return now_ns - int(slack * 1e9), now_ns + int(slack * 1e9)

    def push_batch(self, sb: SpanBatch, span_sizes: np.ndarray | None = None,
                   sample_weights: np.ndarray | None = None,
                   now_s: "float | None" = None) -> None:
        self.spans_received += sb.n
        sb = self._apply_slack(sb, now_s)
        for proc in self.processors.values():
            if isinstance(proc, SpanMetricsProcessor):
                proc.push_batch(sb, span_sizes, sample_weights=sample_weights)
            else:
                proc.push_batch(sb)

    def _apply_slack(self, sb: SpanBatch,
                     now_s: "float | None" = None) -> SpanBatch:
        slack = self.cfg.ingestion_time_range_slack_s
        if slack <= 0:
            return sb
        lo, hi = self._slack_bounds(now_s)
        keep = (sb.end_unix_nano >= lo) & (sb.end_unix_nano <= hi)
        dropped = int((sb.valid & ~keep).sum())
        if dropped:
            self.spans_filtered_slack += dropped
            sb = dataclasses.replace(sb, valid=sb.valid & keep)
        return sb

    # -- collection tick ---------------------------------------------------

    def collect_and_push(self, ts_ms: int | None = None) -> int:
        """One collection: purge stale series, gather device state, remote
        write. Returns the number of samples pushed."""
        self.drain()
        if self.now() - self._last_purge > 60.0:
            self.registry.purge_stale()
            self._last_purge = self.now()
        samples = self.registry.collect(ts_ms)
        self.remote_write.send(samples)
        return len(samples)

    # -- accounting --------------------------------------------------------

    @property
    def state_layout(self) -> str:
        return "dense" if self.registry.pages is None else "paged"

    def device_state_bytes(self) -> int:
        """Device bytes of this tenant's metric state: registry families
        plus the processors' sketch sidecars (paged: backed pages only;
        dense: whole arenas, trash pages included)."""
        total = self.registry.device_state_bytes()
        for proc in self.processors.values():
            fn = getattr(proc, "device_state_bytes", None)
            if fn is not None:
                total += fn()
        return total
