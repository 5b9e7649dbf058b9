"""Root configuration: one YAML document mirrored by dataclasses.

Counterpart of `tempo_tpu/app/config.py`, copied with its imports moved
to the port: the same keys, defaults and warnings. PyYAML is imported
only inside `load_config`, when a file or text is given; every other
path of the port runs without it.

Analog of `cmd/tempo/app/config.go:33-139` (the aggregate Config struct and
its `RegisterFlagsAndApplyDefaults` / `CheckConfig` warning pass) and
`cmd/tempo/main.go:146-225` (load + env expansion).
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Any

from tempo_tpu_torch.db.compactor import CompactorConfig
from tempo_tpu_torch.db.poller import PollerConfig
from tempo_tpu_torch.distributor.distributor import DistributorConfig
from tempo_tpu_torch.fleet import FleetConfig
from tempo_tpu_torch.frontend.frontend import FrontendConfig
from tempo_tpu_torch.generator.instance import GeneratorConfig
from tempo_tpu_torch.generator.wal import IngestWalConfig
from tempo_tpu_torch.generator.processors.localblocks import LocalBlocksConfig
from tempo_tpu_torch.ingester.ingester import IngesterConfig
from tempo_tpu_torch.ingester.instance import InstanceConfig
from tempo_tpu_torch.matview import MatViewConfig
from tempo_tpu_torch.overrides.limits import Limits
from tempo_tpu_torch.parallel.serving import MeshConfig
from tempo_tpu_torch.querier.querier import QuerierConfig
from tempo_tpu_torch.registry.pages import PagePoolConfig
from tempo_tpu_torch.sched import SchedConfig
from tempo_tpu_torch.utils.faults import FaultsConfig
from tempo_tpu_torch.utils.tracing import SelfTraceConfig


@dataclasses.dataclass
class ServerConfig:
    http_listen_port: int = 3200
    http_listen_address: str = "127.0.0.1"
    grpc_listen_port: int = 0           # 0 = gRPC disabled on this process
    grpc_listen_address: str = "127.0.0.1"
    graceful_shutdown_timeout_s: float = 5.0


@dataclasses.dataclass
class WorkerConfig:
    """Querier worker-pull config (`modules/querier/worker/worker.go`):
    a standalone querier dials the frontend and pulls job batches."""

    frontend_address: str = ""          # "grpc://host:port"; empty = no worker
    parallelism: int = 2


@dataclasses.dataclass
class StorageConfig:
    backend: str = "local"             # local | mem | s3 | gcs | azure
    local_path: str = "./tempo-data/blocks"
    wal_path: str = "./tempo-data/wal"
    cloud: dict = dataclasses.field(default_factory=dict)
    poll_interval_s: float = 30.0
    pool_workers: int = 30
    cache_enabled: bool = True          # bloom/footer/page role caches
    cache_bytes_per_role: int = 64 << 20
    # shared external cache tier (pkg/cache/memcached_client.go analog):
    # "host:port[,host:port...]" — when set, the listed roles ride the
    # SDK-free memcached client (write-behind) so every querier/frontend
    # replica shares one working set; empty = in-process LRUs only
    memcached_addrs: str = ""
    # redis alternative (pkg/cache/redis_client.go analog, RESP2 GET/SET);
    # takes the same roles — configure ONE of the two tiers
    redis_addrs: str = ""
    memcached_roles: tuple = ("bloom", "parquet-footer", "frontend-search")
    memcached_timeout_s: float = 0.5
    memcached_expiration_s: int = 0
    hedge_delay_s: float = 0.0          # >0: hedge slow object reads
    hedge_max: int = 1
    # object-store resilience (backend/cloud.py ResilientBackend):
    # transient op failures retry with bounded jittered backoff; cloud
    # clients get a per-op socket timeout so a hung endpoint cannot
    # wedge a flush/checkpoint thread forever
    op_retries: int = 2
    op_retry_backoff_s: float = 0.1
    op_timeout_s: float = 30.0


@dataclasses.dataclass
class PeersConfig:
    """Static peer addresses for microservice deployments: {id: base_url}.
    The static-address stand-in for ring gossip discovery; in-process
    objects are used when empty (single-binary)."""

    ingesters: dict = dataclasses.field(default_factory=dict)
    generators: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class IngestConfig:
    """The ingest-storage path (`cfg.Ingest` gating `modules.go:386-406`):
    the distributor produces partition-keyed records onto a bus instead
    of replicating to ingesters; a block-builder target persists them and
    generators consume the same partitions."""

    enabled: bool = False
    # "" = in-memory bus (single process / tests); host:port = real Kafka
    # via the SDK-free wire client (ingest/kafka.py)
    kafka_bootstrap: str = ""
    topic: str = "tempo-ingest"
    n_partitions: int = 2
    partitions: tuple = ()              # consumed partitions ((): all)
    consume_interval_s: float = 1.0


@dataclasses.dataclass
class Config:
    target: str = "all"
    multitenancy_enabled: bool = False
    # cross-process ring state: URL of a process serving /kv/* CAS routes
    # (the memberlist-cluster analog). Empty = in-process KV (single binary
    # or static peers).
    ring_kv_url: str = ""
    instance_id: str = ""               # auto: <target>-<http port>
    advertise_addr: str = ""            # auto: http://<addr>:<http port>
    heartbeat_interval_s: float = 15.0
    heartbeat_timeout_s: float = 60.0
    peers: PeersConfig = dataclasses.field(default_factory=PeersConfig)
    server: ServerConfig = dataclasses.field(default_factory=ServerConfig)
    storage: StorageConfig = dataclasses.field(default_factory=StorageConfig)
    distributor: DistributorConfig = dataclasses.field(default_factory=DistributorConfig)
    ingester: IngesterConfig = dataclasses.field(default_factory=IngesterConfig)
    generator: GeneratorConfig = dataclasses.field(default_factory=GeneratorConfig)
    frontend: FrontendConfig = dataclasses.field(default_factory=FrontendConfig)
    querier: QuerierConfig = dataclasses.field(default_factory=QuerierConfig)
    querier_worker: WorkerConfig = dataclasses.field(default_factory=WorkerConfig)
    compactor: CompactorConfig = dataclasses.field(default_factory=CompactorConfig)
    # shared device-execution scheduler (tempo_tpu_torch.sched): continuous
    # micro-batching of kernel dispatch across the write and read paths,
    # default on; `sched.enabled: false` restores direct dispatch
    sched: SchedConfig = dataclasses.field(default_factory=SchedConfig)
    # serving mesh (tempo_tpu_torch.parallel.serving): registry/sketch
    # state sharded over 'series'. Default off (single device)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    # device page pool (tempo_tpu_torch.registry.pages): registry/sketch state
    # paged into process-wide device arenas allocated on demand per
    # tenant instead of fixed-capacity dense planes. Default off (dense
    # layout); see runbook
    # "Sizing the page pool"
    pages: PagePoolConfig = dataclasses.field(default_factory=PagePoolConfig)
    # materialized query grids (tempo_tpu_torch.matview): hot recurring
    # TraceQL-metrics queries stream into standing device grids at
    # ingest; reads become a grid slice + final pass instead of a
    # block/registry recompute. Default on (no overhead until a query
    # is subscribed); see runbook "Materialized query grids"
    matview: MatViewConfig = dataclasses.field(default_factory=MatViewConfig)
    # generator fleet (tempo_tpu_torch.fleet): N generator processes
    # dividing the tenant space over the ring, with checkpoint/restore
    # through the storage backend (see runbook "Operating a generator
    # fleet"). Default off
    fleet: FleetConfig = dataclasses.field(default_factory=FleetConfig)
    # generator ingest WAL (tempo_tpu_torch.generator.wal): every acked
    # push appends to a per-tenant segment log before the ack returns,
    # and boot replays it onto the device. Default off
    wal: IngestWalConfig = dataclasses.field(default_factory=IngestWalConfig)
    # fault injection (tempo_tpu_torch.utils.faults): named fault points in
    # the real backend/KV/RPC/sched/WAL paths, scripted with
    # deterministic seeds — for chaos runs ONLY (`faults.allow: true`
    # required; zero cost disarmed)
    faults: FaultsConfig = dataclasses.field(default_factory=FaultsConfig)
    overrides_defaults: Limits = dataclasses.field(default_factory=Limits)
    per_tenant_override_config: str = ""   # runtime-config file path
    compaction_interval_s: float = 30.0
    ingest: IngestConfig = dataclasses.field(default_factory=IngestConfig)
    # anonymized usage reporting (pkg/usagestats): leader-elected via the
    # shared KV, report written to the backend under usage-stats/ — never
    # sent anywhere (inspectable stand-in for the reference's reporter)
    usage_stats_enabled: bool = True
    usage_stats_interval_s: float = 3600.0
    # self-tracing (cmd/tempo/main.go:227-281): OTLP/HTTP endpoint that
    # receives this process's own spans — another cluster, or this very
    # process's listen address (dogfood mode). Empty = disabled.
    # DEPRECATED in favor of the selftrace: block below; kept as an
    # alias (maps onto selftrace.endpoint/tenant when the block is
    # untouched) so existing YAMLs keep working.
    self_tracing_endpoint: str = ""
    self_tracing_tenant: str = "tempo-self"
    # self-tracing loopback (runbook "Tracing Tempo with Tempo"):
    # propagated spans from every internal hop, tail-kept per trace
    # (SLO-miss/error trees always survive head sampling), exported
    # into this process's OWN distributor under the reserved ops tenant
    selftrace: SelfTraceConfig = dataclasses.field(
        default_factory=SelfTraceConfig)

    def check(self) -> list[str]:
        """Config sanity warnings (`config.go:145-236` CheckConfig)."""
        warnings = []
        if self.ingester.instance.max_block_duration_s < 60:
            warnings.append("ingester.max_block_duration_s < 1m: tiny blocks "
                            "inflate blocklist and query fan-out")
        if self.frontend.target_bytes_per_job < (1 << 20):
            warnings.append("frontend.target_bytes_per_job < 1MiB: job "
                            "dispatch overhead will dominate")
        if self.storage.backend not in ("local", "mem", "s3", "gcs", "azure"):
            warnings.append(f"unknown storage backend {self.storage.backend!r}")
        if self.compactor.retention_s and self.compactor.retention_s < 3600:
            warnings.append("compactor.retention_s < 1h deletes data quickly")
        if not (0 <= self.sched.compaction_min_share <= 0.5):
            warnings.append(
                "sched.compaction_min_share must be in [0, 0.5]: 0 lets "
                "sustained ingest starve compaction forever, above 0.5 "
                "compaction-class work outranks the foreground classes "
                "it exists to yield to")
        if self.compactor.backfill_sidecars < 0:
            warnings.append("compactor.backfill_sidecars < 0: use 0 to "
                            "disable the per-sweep sidecar backfill")
        if self.compactor.backfill_sidecars > 64:
            warnings.append("compactor.backfill_sidecars > 64 full-block "
                            "reads per sweep competes with query reads")
        if self.sched.enabled and self.sched.batch_window_ms > 100:
            warnings.append("sched.batch_window_ms > 100ms adds that much "
                            "to ingest-visible metrics latency per batch")
        if self.sched.enabled and not (0 < self.sched.occupancy_target <= 1):
            warnings.append("sched.occupancy_target must be in (0, 1]")
        if self.sched.pipeline_depth < 0:
            warnings.append("sched.pipeline_depth < 0: use 0 to disable "
                            "the ingest staging ring")
        if self.sched.tuning not in ("static", "auto"):
            warnings.append(f"sched.tuning {self.sched.tuning!r} unknown: "
                            "use 'static' (fixed batch_window_ms) or "
                            "'auto' (cost-model-driven windows)")
        if self.sched.tuning == "auto":
            if self.sched.tuning_window_min_ms <= 0 or \
                    self.sched.tuning_window_max_ms < \
                    self.sched.tuning_window_min_ms:
                warnings.append("sched.tuning_window_{min,max}_ms must "
                                "satisfy 0 < min <= max: the tuner's "
                                "window search is clamped to this range")
            if self.sched.tuning_window_max_ms > 100:
                warnings.append("sched.tuning_window_max_ms > 100ms lets "
                                "auto-tuning add that much ingest-visible "
                                "metrics latency per batch")
            if self.sched.tuning_interval_s <= 0:
                warnings.append("sched.tuning_interval_s must be > 0: a "
                                "non-positive interval refits the window "
                                "tuner on every submit and measures "
                                "arrival rates over microsecond windows")
        if self.sched.sampling_enabled:
            if not (0 <= self.sched.sampling_start_pressure < 1):
                warnings.append("sched.sampling_start_pressure must be in "
                                "[0, 1): 1.0 would never sample before the "
                                "hard 429")
            if not (0 < self.sched.sampling_min_fraction <= 1):
                warnings.append("sched.sampling_min_fraction must be in "
                                "(0, 1]: 0 would drop every non-forced span "
                                "at saturation")
        sm = self.generator.spanmetrics
        if sm.sketch not in ("dd", "moments", "both"):
            warnings.append(
                f"generator.spanmetrics.sketch {sm.sketch!r} unknown: use "
                "'dd' (DDSketch plane), 'moments' (~15-float moments "
                "rows, psum combine), or 'both' (moments answers, "
                "DDSketch fallback) — serve time falls back to 'dd'")
        if not (2 <= sm.moments_k <= 16):
            warnings.append(
                f"generator.spanmetrics.moments_k ({sm.moments_k}) outside "
                "2..16: fewer than 2 moments cannot fit a distribution, "
                "more than 16 adds f32 accumulation noise faster than "
                "accuracy — serve time clamps into range")
        if sm.sketch in ("moments", "both") and \
                not sm.enable_quantile_sketch:
            warnings.append(
                "generator.spanmetrics.sketch selects the moments tier "
                "but enable_quantile_sketch is false: no sketch plane "
                "will be built and quantile() answers will be empty")
        if sm.kernel not in ("xla", "pallas"):
            warnings.append(
                f"generator.spanmetrics.kernel {sm.kernel!r} unknown: use "
                "'xla' (composed scatter, lowers everywhere) or 'pallas' "
                "(single-pass ragged-page kernel; paged layout + TPU "
                "backend) — serve time falls back to 'xla'")
        if sm.kernel == "pallas" and not self.pages.enabled:
            # warn, don't fail: the kernel falls back per-process with
            # a single warning — the fallback contract tier-1 enforces
            warnings.append(
                "generator.spanmetrics.kernel 'pallas' needs the paged "
                "layout (pages.enabled: true): the kernel IS the "
                "page-table walker — serve time falls back to 'xla'; "
                "non-TPU backends also fall back unless "
                "pallas_interpret (debug parity only) is set")
        if sm.pallas_interpret:
            warnings.append(
                "generator.spanmetrics.pallas_interpret is a debug/CI "
                "knob: the Pallas interpreter is orders of magnitude "
                "slower than XLA — never set it in production")
        if sm.compact_state and not self.pages.enabled:
            warnings.append(
                "generator.spanmetrics.compact_state needs the paged "
                "layout (pages.enabled: true) — serve time stays on f32 "
                "state; see runbook 'Choosing the update kernel' for the "
                "tier's documented tolerances")
        ta = self.generator.traceanalytics
        if ta.trace_idle_s <= 0:
            warnings.append(
                "generator.traceanalytics.trace_idle_s must be > 0: the "
                "idle cut IS the trace-completion signal; 0 would analyze "
                "every trace after its first push and count the rest of "
                "its spans late")
        if ta.late_window_s < 0:
            warnings.append(
                "generator.traceanalytics.late_window_s < 0: use 0 to "
                "disable late-span counting, positive seconds to bound "
                "the post-cut window")
        if not (2 <= ta.max_spans_per_trace <= 65536):
            warnings.append(
                f"generator.traceanalytics.max_spans_per_trace "
                f"({ta.max_spans_per_trace}) outside 2..65536: one span "
                "cannot form an edge, beyond 64Ki a single trace owns "
                "the whole analysis batch — spans past the cap count "
                "late rather than grow the buffer unboundedly")
        if ta.max_live_traces < 1:
            warnings.append(
                "generator.traceanalytics.max_live_traces must be >= 1: "
                "the live buffer needs room for at least one trace "
                "(overflow force-cuts the oldest quarter)")
        if not (2 <= ta.moments_k <= 16):
            warnings.append(
                f"generator.traceanalytics.moments_k ({ta.moments_k}) "
                "outside 2..16 (same bounds as the spanmetrics sketch) — "
                "serve time clamps into range")
        if not (0 < ta.share_min < ta.share_max <= 1.0):
            warnings.append(
                "generator.traceanalytics.share_{min,max} must satisfy "
                "0 < min < max <= 1: latency shares are fractions of "
                "the trace's end-to-end duration")
        mvc = self.matview
        if mvc.enabled:
            if mvc.window_steps < 2:
                warnings.append(
                    "matview.window_steps < 2: a materialized grid needs "
                    "at least two ring columns to advance")
            if mvc.window_steps > 4096:
                warnings.append(
                    "matview.window_steps > 4096: each grid holds "
                    "series x window_steps (x64 for bucket kinds) f32 "
                    "cells in HBM — size the ring to the dashboard "
                    "window, not the retention window")
            if not (0 < mvc.min_step_s <= mvc.max_step_s):
                warnings.append(
                    "matview.min_step_s/max_step_s must satisfy "
                    "0 < min <= max")
            if mvc.max_staleness_s <= 0:
                warnings.append(
                    "matview.max_staleness_s must be > 0: every read "
                    "would fall through to the recompute path")
            if mvc.max_subscriptions < 1 or mvc.max_series < 1:
                warnings.append(
                    "matview.max_subscriptions and matview.max_series "
                    "must be >= 1")
            if mvc.auto_subscribe and mvc.auto_subscribe_after < 1:
                warnings.append(
                    "matview.auto_subscribe_after < 1 materializes every "
                    "query on first sight — set >= 1 (recurrences within "
                    "qlog's sliding window)")
        warnings.extend(self.mesh.check())
        warnings.extend(self.fleet.check())
        warnings.extend(self.wal.check())
        warnings.extend(self.faults.check())
        if self.wal.enabled and not self.fleet.enabled:
            warnings.append(
                "wal.enabled without fleet.enabled: nothing truncates "
                "the ingest WAL (truncation rides checkpoint watermarks) "
                "— boot replay stays correct but segments and replay "
                "time grow without bound; enable the fleet (a single "
                "member is fine) to cycle checkpoints")
        if self.distributor.generator_placement not in ("trace", "tenant"):
            warnings.append(
                f"distributor.generator_placement "
                f"{self.distributor.generator_placement!r} unknown: use "
                "'trace' (spans spread over the whole generator ring) or "
                "'tenant' (a tenant's entire stream routes to its ring "
                "owner — required for fleet mode) — serve time falls "
                "back to 'trace'")
        if self.fleet.enabled and self.server.http_listen_port == 0 \
                and not self.instance_id:
            warnings.append(
                "fleet.enabled with an ephemeral http port needs an "
                "explicit instance_id: the derived <target>-<host>-<port> "
                "ring id would collide between two :0 members on one "
                "host")
        if self.fleet.enabled and \
                self.distributor.generator_placement != "tenant":
            warnings.append(
                "fleet.enabled needs distributor.generator_placement: "
                "'tenant' on every distributor: trace-spread routing "
                "would scatter one tenant's series across members and "
                "reads/checkpoints would each see a fraction")
        if self.pages.enabled:
            # only the series-table capacity must split into whole pages;
            # the spanmetrics sketch plane rounds ITSELF up to page
            # multiples (masking at the configured row count)
            warnings.extend(self.pages.check(
                (self.generator.registry.max_active_series,)))
        warnings.extend(self.selftrace.check())
        if self.selftrace.enabled and self.target not in ("all",):
            warnings.append(
                "selftrace.enabled on a non-all target: loopback needs "
                "this process's own distributor; single-role processes "
                "should set selftrace.endpoint to a distributor URL "
                "instead (spans still join one fleet-wide tree via "
                "traceparent propagation)")
        if self.selftrace.enabled and self.fleet.enabled and \
                self.distributor.generator_placement == "tenant" and \
                not self.selftrace.tenant:
            warnings.append(
                "selftrace under fleet placement needs a reserved tenant "
                "name: it is excluded from handoff/auto-subscribe by name")
        if self.distributor.jaeger_agent_port and \
                self.distributor.jaeger_agent_host in ("", "0.0.0.0", "::") \
                and not self.distributor.jaeger_agent_allow_wildcard:
            warnings.append(
                "distributor.jaeger_agent_host binds all interfaces "
                "(unauthenticated UDP ingest) — set "
                "jaeger_agent_allow_wildcard: true to confirm, or keep "
                "the 127.0.0.1 default")
        return warnings


_ENV_RE = re.compile(r"\$\{(\w+)(?::-([^}]*))?\}")


def _expand_env(text: str) -> str:
    """${VAR} / ${VAR:-default} expansion (`main.go` env expansion)."""
    return _ENV_RE.sub(
        lambda m: os.environ.get(m.group(1), m.group(2) or ""), text)


def _apply(obj: Any, data: dict) -> None:
    for k, v in (data or {}).items():
        if not hasattr(obj, k):
            raise ValueError(f"unknown config key: {k} on {type(obj).__name__}")
        cur = getattr(obj, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            _apply(cur, v)
        elif isinstance(v, list) and isinstance(cur, tuple):
            setattr(obj, k, tuple(v))
        else:
            setattr(obj, k, v)


def load_config(path: str | None = None, text: str | None = None,
                overrides: dict | None = None) -> Config:
    cfg = Config()
    doc: dict = {}
    if path:
        with open(path) as f:
            text = f.read()
    if text:
        import yaml

        doc = yaml.safe_load(_expand_env(text)) or {}
    _apply(cfg, doc)
    if overrides:
        _apply(cfg, overrides)
    return cfg


# convenience for nested dataclass defaults referenced from YAML docs
__all__ = ["Config", "ServerConfig", "StorageConfig", "load_config",
           "InstanceConfig", "LocalBlocksConfig", "PollerConfig"]
