"""App: module wiring + lifecycle for a selected target.

Counterpart of `tempo_tpu/app/app.py`. `App(cfg, now=..., device=None)`
runs on `cuda` unless `device="cpu"` is given, and hands that device to
everything that holds device state: the page pool, the materializer,
the generator (span metrics through K1), `TempoDB` (the read plane and
the compaction merge) and the block-builder. The wiring, targets, rings
and loops are the reference's. Configurations whose parts are not
ported would raise `NotImplementedError` naming their ROADMAP item where
the reference first builds the part; since items 13 and 14 none is left:
`mesh.enabled` configures the serving mesh over the App's device,
`ingest.kafka_bootstrap` builds a `KafkaBus` and
`distributor.jaeger_agent_port` starts the UDP agent receiver. The gRPC plane
(`server.grpc_listen_port`, `grpc://` peers, the frontend worker at
`querier_worker.frontend_address`) and self-tracing (`selftrace.enabled`
loopback, `self_tracing_endpoint`) are wired as in the reference.

Analog of `cmd/tempo/app/app.go:165-253` (`App.Run`) and the module DAG of
`modules.go:679-757`. Modules are constructed lazily in dependency order;
the single-binary target (`all`) wires every service in-process with
direct client references where the reference uses gRPC — the process
boundary collapses but every seam (ring, clients, queue) stays.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable

from tempo_tpu_torch.app.config import Config
from tempo_tpu_torch.backend.local import LocalBackend
from tempo_tpu_torch.backend.mem import MemBackend
from tempo_tpu_torch.db.tempodb import TempoDB, TempoDBConfig
from tempo_tpu_torch.distributor import Distributor
from tempo_tpu_torch.frontend import Frontend
from tempo_tpu_torch.generator import Generator
from tempo_tpu_torch.ingester import Ingester
from tempo_tpu_torch.obs import Registry
from tempo_tpu_torch.overrides import Overrides, UserConfigurableOverrides
from tempo_tpu_torch.querier import Querier
from tempo_tpu_torch.ring import ACTIVE, InstanceDesc, Lifecycler, Ring
from tempo_tpu_torch.ring.ring import _instance_tokens

# module names (`modules.go:52-90`)
STORE, OVERRIDES, DISTRIBUTOR, INGESTER, GENERATOR = (
    "store", "overrides", "distributor", "ingester", "metrics-generator")
QUERIER, FRONTEND, COMPACTOR = "querier", "query-frontend", "compactor"
BLOCKBUILDER = "block-builder"
ALL = "all"

TARGETS = {
    ALL: [OVERRIDES, STORE, INGESTER, GENERATOR, DISTRIBUTOR, QUERIER,
          FRONTEND, COMPACTOR],
    DISTRIBUTOR: [OVERRIDES, DISTRIBUTOR],
    INGESTER: [OVERRIDES, STORE, INGESTER],
    GENERATOR: [OVERRIDES, GENERATOR],
    QUERIER: [OVERRIDES, STORE, QUERIER],
    # the query tier: frontend embeds its querier (job dispatch is
    # in-process; scale-out adds more query-tier processes)
    FRONTEND: [OVERRIDES, STORE, QUERIER, FRONTEND],
    COMPACTOR: [OVERRIDES, STORE, COMPACTOR],
    # kafka-path persister (`modules.go:386-406`, gated on Ingest.Enabled)
    BLOCKBUILDER: [OVERRIDES, STORE, BLOCKBUILDER],
}


def _make_remote_client(addr: str, kind: str):
    """Transport by URL scheme: grpc:// → gRPC plane, else HTTP RPC."""
    if addr.startswith("grpc://"):
        from tempo_tpu_torch.grpcplane import (GrpcGeneratorClient,
                                               GrpcIngesterClient)
        cls = GrpcIngesterClient if kind == "ingesters" \
            else GrpcGeneratorClient
    else:
        from tempo_tpu_torch.rpc import (RemoteGeneratorClient,
                                         RemoteIngesterClient)
        cls = RemoteIngesterClient if kind == "ingesters" \
            else RemoteGeneratorClient
    return cls(addr)


class RingClientPool:
    """Client lookup driven by live ring membership: instances discovered
    via the shared KV resolve to RPC clients by their advertised address.
    Replaces static `cfg.peers` maps in ring-KV deployments — the analog of
    dskit's ring-aware client pools."""

    def __init__(self, ring, kind: str) -> None:
        self.ring = ring
        self.kind = kind
        self._cache: dict[str, tuple[str, object]] = {}

    def _build(self, instance_id: str):
        inst = self.ring.instance(instance_id)
        if inst is None or not inst.addr:
            return None
        cached = self._cache.get(instance_id)
        if cached is not None and cached[0] == inst.addr:
            return cached[1]
        client = _make_remote_client(inst.addr, self.kind)
        self._cache[instance_id] = (inst.addr, client)
        return client

    def get(self, instance_id: str, default=None):
        c = self._build(instance_id)
        return c if c is not None else default

    def __getitem__(self, instance_id: str):
        c = self._build(instance_id)
        if c is None:
            raise KeyError(instance_id)
        return c

    def __contains__(self, instance_id: str) -> bool:
        return self._build(instance_id) is not None

    def __bool__(self) -> bool:
        return True      # pool exists even while the ring is still empty


class App:
    def __init__(self, cfg: Config | None = None,
                 now: Callable[[], float] = time.time,
                 device=None) -> None:
        from tempo_tpu_torch.device import resolve_device

        self.device = resolve_device(device)
        self.cfg = cfg or Config()
        if self.cfg.target not in TARGETS:
            raise ValueError(f"unknown target {self.cfg.target!r}")
        self.now = now
        # ring_kv_url: "" = in-process KV + static wiring; "local" = host
        # the shared KV on this process's /kv routes (ring mode); a URL =
        # consume another process's KV; a comma list of "local" + peer
        # URLs = replicated KV (no single point of failure — each listed
        # member hosts a store; AP: writes land on every reachable member,
        # reads merge, convergence via heartbeat republish)
        from tempo_tpu_torch.ring.kv import make_kv
        self.kv, self.kv_host = make_kv(self.cfg.ring_kv_url)
        # named ring views this process holds (ingester/generator/...),
        # tracked for the /status rings block and the tempo_ring_*
        # gauges — populated as modules wire up
        self.rings: dict[str, Ring] = {}
        self.fleet = None
        # ONE obs registry per App: every module registers its families
        # here and /metrics renders it (plus the process-wide runtime
        # registry) — the single source of truth for self-telemetry
        self.obs = Registry()
        self._init_app_obs()
        self.ready = False
        self._stop = threading.Event()
        # modules (populated by _init_*)
        self.backend = None
        self.db: TempoDB | None = None
        self.overrides: Overrides | None = None
        self.distributor: Distributor | None = None
        self.ingester: Ingester | None = None
        self.generator: Generator | None = None
        self.querier: Querier | None = None
        self.frontend: Frontend | None = None
        self.usage_reporter = None
        self.bus = None
        self.blockbuilder = None
        self.grpc_server = None
        self.grpc_port: int = 0
        self.frontend_worker = None
        self.jaeger_agent = None
        self._lifecyclers: list[Lifecycler] = []
        # warm the native layer at startup so the first proto push never
        # pays the g++ compile inside a request handler
        from tempo_tpu_torch import native
        native.load()
        self._build()

    # -- wiring ------------------------------------------------------------

    def _init_app_obs(self) -> None:
        """App-level families that belong to no single module."""
        def reports():
            ur = getattr(self, "usage_reporter", None)
            return [((), ur.reports_written)] if ur is not None else []

        self.obs.counter_func(
            "tempo_usage_stats_reports_written_total", reports,
            help="Usage-stats reports written by the leader reporter")

        def tracer_dropped():
            from tempo_tpu_torch.utils import tracing
            return [((), float(getattr(tracing.tracer(), "dropped", 0)))]

        # registered unconditionally (NoopTracer reports 0) so the drift
        # gate sees the family whether or not self-tracing is configured
        self.obs.counter_func(
            "tempo_self_tracer_dropped_spans_total", tracer_dropped,
            help="Self-tracing spans lost to buffer overflow or failed "
                 "OTLP exports (silent span loss is an alerting signal)")

        # the selftrace loopback families (runbook "Tracing Tempo with
        # Tempo"): registered unconditionally — NoopTracer reports 0 —
        # so the drift gate sees every name on every deployment
        def _selftrace_stat(key):
            def read():
                from tempo_tpu_torch.utils import tracing
                stats = getattr(tracing.tracer(), "stats", None) or {}
                return [((), float(stats.get(key, 0)))]
            return read

        for key, txt in (
                ("spans", "Spans recorded by the installed SelfTracer "
                          "(pre-sampling; every hop of every trace)"),
                ("kept_traces", "Traces whose whole tree survived to "
                                "export: head-sampled in, errored, or "
                                "mark_keep()-ed (SLO miss)"),
                ("dropped_spans", "Self-spans LOST: tail/export buffer "
                                  "overflow or a batch dropped after its "
                                  "one bounded export retry (sampled-out "
                                  "spans are not losses and not counted)"),
                ("export_retries", "Export batches held for their one "
                                   "bounded retry after a failed flush"),
                ("loopback_batches", "Batches delivered through the "
                                     "loopback sink into this process's "
                                     "own distributor")):
            self.obs.counter_func(
                f"tempo_selftrace_{key}_total", _selftrace_stat(key),
                help=txt)

        def tail_buffer():
            from tempo_tpu_torch.utils import tracing
            t = tracing.tracer()
            return [((), float(t.tail_buffered()))] \
                if hasattr(t, "tail_buffered") else [((), 0.0)]

        self.obs.gauge_func(
            "tempo_selftrace_tail_buffer_spans", tail_buffer,
            help="Spans held in per-trace tail-keep buffers awaiting "
                 "their trace's keep/sample verdict (sizing signal for "
                 "selftrace.max_trace_spans / max_open_traces)")
        # ring membership/placement families (fleet satellite): rows
        # appear as rings wire up; the families are registered eagerly
        # so the dashboards/alerts drift gate always sees the names
        self.obs.gauge_func(
            "tempo_ring_members",
            lambda: [((n,), float(len(r))) for n, r in self.rings.items()],
            help="Registered instances per ring this process watches",
            labels=("ring",))
        self.obs.gauge_func(
            "tempo_ring_ownership_ratio",
            lambda: [((n, iid), frac) for n, r in self.rings.items()
                     for iid, frac in r.ownership().items()],
            help="Fraction of the token space each instance owns (RF1 "
                 "placement share; a balanced N-member ring reads ~1/N)",
            labels=("ring", "instance"))
        self.obs.gauge_func(
            "tempo_ring_member_heartbeat_age_seconds",
            lambda: [((n,), r.oldest_heartbeat_age())
                     for n, r in self.rings.items()],
            help="Age of the STALEST active member heartbeat per ring — "
                 "the TempoRingMemberStale signal (0 = empty ring or "
                 "heartbeats disabled)",
            labels=("ring",))
        # the serving-surface histograms are registered eagerly so the
        # drift gate sees them before any request arrives; the HTTP
        # handler and gRPC server observe through these App handles (one
        # declaration — name, help, labels — instead of three copies)
        self.http_request_duration = self.obs.histogram(
            "tempo_request_duration_seconds",
            "HTTP API request latency by route, method, and status",
            labels=("route", "method", "status"))
        self.grpc_request_duration = self.obs.histogram(
            "tempo_grpc_request_duration_seconds",
            "gRPC plane request latency by method and outcome (streams "
            "time first message to stream end)",
            labels=("method", "status"))

    def _build(self) -> None:
        mods = TARGETS[self.cfg.target]
        # fault injection is process-wide and must arm before any module
        # whose paths carry fault points is constructed; disarmed (the
        # default) it costs one module-flag check per guarded call site
        from tempo_tpu_torch.utils import faults
        faults.configure(self.cfg.faults)
        # the shared device-execution scheduler is process-wide state
        # (like the runtime registry): configure it before any module
        # that dispatches kernels is constructed
        from tempo_tpu_torch import sched
        self.sched = sched.configure(self.cfg.sched)
        # the serving mesh is process-wide for the same reason: None
        # when `mesh.enabled` is off, else a mesh over this App's
        # device (every visible card under `cuda`)
        from tempo_tpu_torch.parallel import serving
        self.mesh = serving.configure(self.cfg.mesh, device=self.device)
        # the device page pool comes AFTER the mesh (arenas shard
        # page-aligned over 'series' when the mesh is on) and BEFORE any
        # registry is built: tenants created from here on page their
        # state instead of allocating dense planes
        from tempo_tpu_torch.registry import pages as device_pages
        self.pages = device_pages.configure(self.cfg.pages,
                                            device=self.device)
        # the TraceQL quantile_over_time accumulation axis follows the
        # spanmetrics sketch tier: "moments" switches query grids to
        # k+1-float moment rows (ops/moments.py); dd/both keep the
        # log2 bucket grids (process-wide, like the sched/mesh/pages
        # state — every MetricsEvaluator consults it)
        from tempo_tpu_torch.ops import moments as moments_mod
        moments_mod.set_query_tier(self.cfg.generator.spanmetrics.sketch)
        self._init_backend()
        self._init_bus()
        if OVERRIDES in mods:
            self._init_overrides()
        # the materialized-view tier is process-wide like sched/pages
        # (generator appends + frontend reads share it); configured
        # AFTER overrides so grid expiry can fingerprint tenant limits
        from tempo_tpu_torch import matview
        self.matview = matview.configure(self.cfg.matview,
                                         overrides=self.overrides,
                                         now=self.now, device=self.device)
        if STORE in mods:
            self._init_store()
        if INGESTER in mods:
            self._init_ingester()
        if GENERATOR in mods:
            self._init_generator()
        if DISTRIBUTOR in mods:
            self._init_distributor()
        if QUERIER in mods:
            self._init_querier()
        if FRONTEND in mods:
            self._init_frontend()
        if BLOCKBUILDER in mods or (self.cfg.target == ALL
                                    and self.bus is not None):
            # ALL + ingest.enabled: the bus REPLACES ingester replication
            # on the write path, so the single binary must also run the
            # persister or pushes would 200 and silently never store
            self._init_blockbuilder()

    def _init_bus(self) -> None:
        """The ingest-storage bus (`cfg.Ingest.Enabled` gate): real Kafka
        via the wire client when a bootstrap is configured, the in-memory
        partitioned log otherwise (single-process / tests). Only targets
        that USE the bus open a broker connection — a shared config file
        must not make the read path dial (or fail on) Kafka."""
        self.bus = None
        if not self.cfg.ingest.enabled:
            return
        mods = TARGETS[self.cfg.target]
        if not ({DISTRIBUTOR, GENERATOR, BLOCKBUILDER} & set(mods)
                or self.cfg.target == ALL):
            return
        ic = self.cfg.ingest
        if ic.kafka_bootstrap:
            from tempo_tpu_torch.ingest.kafka import KafkaBus
            self.bus = KafkaBus(ic.kafka_bootstrap, topic=ic.topic,
                                n_partitions=ic.n_partitions)
        else:
            from tempo_tpu_torch.ingest import Bus
            self.bus = Bus(n_partitions=ic.n_partitions)

    def _init_blockbuilder(self) -> None:
        from tempo_tpu_torch.blockbuilder import BlockBuilder, BlockBuilderConfig
        if self.bus is None:
            raise ValueError(
                "target=block-builder requires ingest.enabled: true")
        parts: "tuple | None" = tuple(self.cfg.ingest.partitions) or None
        if parts is None and not hasattr(self.bus, "group_request"):
            parts = tuple(range(self.cfg.ingest.n_partitions))
        self.blockbuilder = BlockBuilder(
            self.bus, self.backend,
            BlockBuilderConfig(partitions=parts), now=self.now,
            device=self.device)

    def _init_backend(self) -> None:
        s = self.cfg.storage
        if s.backend == "mem":
            self.backend = MemBackend()
        elif s.backend == "local":
            os.makedirs(s.local_path, exist_ok=True)
            self.backend = LocalBackend(s.local_path)
        else:
            from tempo_tpu_torch.backend.cloud import open_backend
            self.backend = open_backend(s.backend, op_timeout_s=s.op_timeout_s,
                                        **s.cloud)
        # resilience wrapper: backend.read/write fault points + bounded
        # jittered-backoff retries on transient store errors (cloud
        # flaps, injected faults) — DoesNotExist/AlreadyExists pass
        # through untouched
        from tempo_tpu_torch.backend.cloud import ResilientBackend
        self.backend = ResilientBackend(self.backend,
                                        retries=s.op_retries,
                                        backoff_s=s.op_retry_backoff_s)

    def _init_overrides(self) -> None:
        uc = UserConfigurableOverrides(self.backend, self.backend)
        self.overrides = Overrides(
            defaults=self.cfg.overrides_defaults,
            runtime_config_path=self.cfg.per_tenant_override_config or None,
            user_configurable=uc)

    def _init_store(self) -> None:
        reader = self.backend
        if self.cfg.storage.hedge_delay_s > 0:
            from tempo_tpu_torch.utils.hedging import HedgedReader
            reader = HedgedReader(reader, self.cfg.storage.hedge_delay_s,
                                  self.cfg.storage.hedge_max)
        if self.cfg.storage.cache_enabled:
            from tempo_tpu_torch.backend.cache import CacheProvider, CachingReader
            sc = self.cfg.storage
            caches = {}
            if sc.memcached_addrs and sc.redis_addrs:
                raise ValueError(
                    "configure ONE shared cache tier: both "
                    "storage.memcached_addrs and storage.redis_addrs set")
            if sc.memcached_addrs or sc.redis_addrs:
                from tempo_tpu_torch.backend.memcached import (MemcachedCache,
                                                         RedisCache)
                cls = RedisCache if sc.redis_addrs else MemcachedCache
                shared = cls(
                    sc.redis_addrs or sc.memcached_addrs,
                    timeout_s=sc.memcached_timeout_s,
                    expiration_s=sc.memcached_expiration_s)
                caches = {role: shared for role in sc.memcached_roles}
            self.cache_provider = CacheProvider(
                caches=caches, default_bytes=sc.cache_bytes_per_role)
            reader = CachingReader(reader, self.cache_provider)
        self.db = TempoDB(reader, self.backend, TempoDBConfig(
            compactor=self.cfg.compactor,
            pool_workers=self.cfg.storage.pool_workers,
            # mesh mode: the read plane adopts the serving mesh
            # data-major (span columns split over 'data', the grids
            # reduced in shard order)
            plane_mesh=self.mesh.plane_mesh
            if getattr(self, "mesh", None) is not None else None),
            registry=self.obs, device=self.device)

    def _iid(self, kind: str) -> str:
        """This process's ring identity for a module kind. Single-binary
        keeps the -0 names; cross-process derives host+port identity (two
        containers on different hosts with the same port must not collide
        on one ring id — that would silently collapse RF to 1)."""
        if self.cfg.instance_id:
            return f"{kind}/{self.cfg.instance_id}"
        if self.cfg.ring_kv_url:
            import socket
            return (f"{kind}-{socket.gethostname()}-"
                    f"{self.cfg.server.http_listen_port}")
        return f"{kind}-0"

    def _advertise(self) -> str:
        if self.cfg.advertise_addr:
            return self.cfg.advertise_addr
        s = self.cfg.server
        host = s.http_listen_address
        if host in ("", "0.0.0.0", "::"):
            # the bind-any address is unroutable for peers: advertise the
            # hostname instead (dskit's advertise-address inference)
            import socket
            host = socket.gethostname()
        return f"http://{host}:{s.http_listen_port}"

    def _init_ingester(self) -> None:
        data_dir = os.path.dirname(self.cfg.storage.wal_path) or "./tempo-data"
        iid = self._iid("ingester")
        self.ingester = Ingester(
            data_dir, flush_writer=self.backend, cfg=self.cfg.ingester,
            overrides=self.overrides, now=self.now, instance_id=iid,
            registry=self.obs)
        self._join_ring("ingester", iid)

    def _init_generator(self) -> None:
        cfg = self.cfg.generator
        cfg.localblocks_flush_writer = self.backend
        iid = self._iid("generator")
        wal = None
        if self.cfg.wal.enabled:
            from tempo_tpu_torch.generator.wal import GeneratorWal
            wal = GeneratorWal(self.cfg.wal, now=self.now)
        self.generator = Generator(cfg, overrides=self.overrides,
                                   instance_id=iid, registry=self.obs,
                                   now=self.now, wal=wal, device=self.device)
        self._join_ring("generator", iid)
        if wal is not None and not self.cfg.fleet.enabled:
            # boot recovery without a fleet: no checkpoints exist, so the
            # whole WAL replays through the push routes onto the device
            # (the fleet replays in its controller's boot tick, after
            # the restore pass set the watermarks)
            got = self.generator.replay_wal_all()
            if got["batches"] or got["dead_letters"]:
                import logging
                logging.getLogger("tempo_tpu_torch.generator.wal").info(
                    "boot WAL replay: %d batches across %d tenants "
                    "(%d dead-lettered)", got["batches"], got["tenants"],
                    got["dead_letters"])
        if self.cfg.fleet.enabled:
            # the controller's own view of the generator ring: membership
            # changes (and heartbeat expiry) drive the drain, checkpoint
            # and restore protocol against the backend
            from tempo_tpu_torch.backend import raw
            from tempo_tpu_torch.fleet.controller import FleetController

            # keep the checkpoint prefix out of store-side tenant listing
            raw.RESERVED_ROOTS.add(self.cfg.fleet.checkpoint_prefix)
            fring = self._shared_ring("generator", 1)
            self.fleet = FleetController(
                self.generator, fring, iid, self.backend, self.backend,
                cfg=self.cfg.fleet, now=self.now)

    def _peer_clients(self, kind: str):
        """Remote peers from static config → (clients, populated ring).
        The URL scheme selects the transport: http:// → the HTTP RPC
        clients, grpc:// → the gRPC plane."""
        from tempo_tpu_torch.ring.ring import _instance_tokens

        addrs = getattr(self.cfg.peers, kind)
        clients = {iid: _make_remote_client(url, kind)
                   for iid, url in addrs.items()}
        ring = Ring(replication_factor=1 if kind == "generators"
                    else self.cfg.distributor.rf,
                    heartbeat_timeout_s=0, now=self.now)
        for iid, url in addrs.items():
            ring.register(InstanceDesc(id=iid, addr=url, state=ACTIVE,
                                       tokens=_instance_tokens(iid, 128)))
        self._track_ring(kind.rstrip("s"), ring)
        return clients, ring

    def _track_ring(self, name: str, ring: Ring) -> Ring:
        """Record a ring view for /status + the tempo_ring_* gauges
        (first view per name wins — they share the same KV state)."""
        self.rings.setdefault(name, ring)
        return ring

    def _shared_ring(self, key: str, rf: int) -> Ring:
        """ONE Ring view per KV key: fleet + distributor + querier all
        watch the same membership, and each extra view would register
        its own kv.watch_key and re-deserialize/re-sort the token state
        on every heartbeat publish."""
        got = self.rings.get(key)
        if got is not None and got.kv is self.kv and got.rf == rf:
            return got
        return self._track_ring(key, Ring(
            kv=self.kv, key=key, replication_factor=rf,
            heartbeat_timeout_s=self.cfg.heartbeat_timeout_s,
            now=self.now))

    def _init_distributor(self) -> None:
        if self.cfg.peers.ingesters:
            ing_clients, iring = self._peer_clients("ingesters")
        elif self.cfg.ring_kv_url:
            # dynamic membership over the shared KV ring: peers appear via
            # their lifecyclers, clients resolve from advertised addrs
            iring = self._shared_ring("ingester", self.cfg.distributor.rf)
            ing_clients = RingClientPool(iring, "ingesters")
        else:
            iring = self._track_ring("ingester", Ring(
                kv=self.kv, key="ingester",
                replication_factor=self.cfg.distributor.rf,
                now=self.now))
            ing_clients = {self._iid("ingester"): self.ingester} \
                if self.ingester else {}
        if self.cfg.peers.generators:
            gen_clients, gring = self._peer_clients("generators")
        elif self.cfg.ring_kv_url:
            gring = self._shared_ring("generator", 1)
            gen_clients = RingClientPool(gring, "generators")
        else:
            gring = self._track_ring("generator", Ring(
                kv=self.kv, key="generator", replication_factor=1,
                now=self.now)) if self.generator else None
            gen_clients = ({self._iid("generator"): self.generator}
                           if self.generator else None)
        self.distributor = Distributor(
            iring, ing_clients, overrides=self.overrides,
            generator_ring=gring, generator_clients=gen_clients,
            cfg=self.cfg.distributor, bus=self.bus, registry=self.obs,
            now=self.now)
        if self.cfg.target == ALL and not self.cfg.peers.ingesters \
                and not self.cfg.ring_kv_url:
            self.distributor.cfg.rf = 1   # one in-process ingester

    def _init_querier(self) -> None:
        if self.cfg.peers.ingesters:
            clients, iring = self._peer_clients("ingesters")
            self.querier = Querier(self.db, iring, clients,
                                   overrides=self.overrides,
                                   cfg=self.cfg.querier, registry=self.obs,
                                   now=self.now)
            return
        if self.cfg.ring_kv_url:
            iring = self._shared_ring("ingester", self.cfg.querier.rf)
            self.querier = Querier(self.db, iring,
                                   RingClientPool(iring, "ingesters"),
                                   overrides=self.overrides,
                                   cfg=self.cfg.querier, registry=self.obs,
                                   now=self.now)
            return
        iring = Ring(kv=self.kv, key="ingester", replication_factor=1,
                     now=self.now)
        self.querier = Querier(
            self.db, iring,
            {self._iid("ingester"): self.ingester} if self.ingester else {},
            overrides=self.overrides, cfg=self.cfg.querier,
            registry=self.obs, now=self.now)
        if self.cfg.target == ALL:
            self.querier.cfg.rf = 1

    def _init_frontend(self) -> None:
        gen_qr = self.generator.query_range if self.generator else None
        if self.cfg.peers.generators or self.cfg.ring_kv_url:
            # Fan out over the WHOLE generator ring even when this process
            # hosts a generator: in a horizontally scaled deployment the
            # distributor spreads spans across every ring member, so a
            # local-only read silently returns partial metrics (ADVICE r2
            # #2). The local generator is served in-process and
            # UNCONDITIONALLY — it is trivially reachable, so a stale KV
            # view must not drop its data; the health filter gates only
            # remote members. The local-id skip applies only in ring-KV
            # mode, where _iid() and ring member ids share a namespace.
            if self.cfg.peers.generators:
                clients, gring = self._peer_clients("generators")
                local_iid = None
            else:
                gring = self._shared_ring("generator", 1)
                clients = RingClientPool(gring, "generators")
                local_iid = self._iid("generator") if self.generator else None
            local_qr = self.generator.query_range if self.generator else None

            def gen_qr(tenant, req, clip_start_ns=None,
                       _clients=clients, _ring=gring, _local=local_iid,
                       _local_qr=local_qr):
                out = []
                if _local_qr is not None:
                    out.extend(_local_qr(tenant, req,
                                         clip_start_ns=clip_start_ns))
                for inst in _ring.healthy_instances():
                    if _local is not None and inst.id == _local:
                        continue       # already served in-process
                    client = _clients.get(inst.id)
                    if client is not None:
                        out.extend(client.query_range(
                            tenant, req, clip_start_ns=clip_start_ns))
                return out
        self.frontend = Frontend(
            self.db, self.querier, cfg=self.cfg.frontend,
            overrides=self.overrides,
            generator_query_range=gen_qr,
            cache_provider=getattr(self, "cache_provider", None),
            registry=self.obs, now=self.now)

    def _join_ring(self, key: str, instance_id: str) -> None:
        self._lifecyclers.append(
            Lifecycler(self.kv, instance_id, key=key,
                       addr=self._advertise(), now=self.now))

    # -- lifecycle ---------------------------------------------------------

    def start_loops(self) -> None:
        """Background loops for the enabled modules (`App.Run`)."""
        if self.cfg.server.grpc_listen_port:
            from tempo_tpu_torch.grpcplane import build_grpc_server
            self.grpc_server, self.grpc_port = build_grpc_server(
                self, f"{self.cfg.server.grpc_listen_address}:"
                      f"{self.cfg.server.grpc_listen_port}")
        if self.querier and self.cfg.querier_worker.frontend_address:
            from tempo_tpu_torch.grpcplane import FrontendWorker
            self.frontend_worker = FrontendWorker(
                self.cfg.querier_worker.frontend_address, self.querier,
                worker_id=f"querier-{id(self) & 0xffff:x}",
                parallelism=self.cfg.querier_worker.parallelism)
            self.frontend_worker.start()
        if self.distributor is not None and \
                self.cfg.distributor.jaeger_agent_port:
            from tempo_tpu_torch.distributor.receiver_agent import (
                JaegerAgentConfig,
                JaegerAgentReceiver,
            )
            self.jaeger_agent = JaegerAgentReceiver(
                self.distributor, JaegerAgentConfig(
                    host=self.cfg.distributor.jaeger_agent_host,
                    port=self.cfg.distributor.jaeger_agent_port,
                    allow_wildcard_bind=self.cfg.distributor
                        .jaeger_agent_allow_wildcard))
            self.jaeger_agent.start()
        if self.ingester:
            self.ingester.start()
        if self.generator:
            self.generator.start()
        if self.db:
            self.db.enable_polling(self.cfg.storage.poll_interval_s)
            if self.cfg.target in (ALL, COMPACTOR):
                self.db.enable_compaction(self.cfg.compaction_interval_s)
        stc = self.cfg.selftrace
        st_endpoint = stc.endpoint or self.cfg.self_tracing_endpoint
        st_tenant = stc.tenant if stc.tenant != "tempo-self" \
            else self.cfg.self_tracing_tenant
        st_sink = None
        if stc.enabled and self.distributor is not None:
            # loopback: export batches go straight into this process's
            # own distributor under the reserved ops tenant (recursion-
            # guarded inside the tracer and span_for_tenant); from there
            # they take the push path onto the device like any tenant's
            def st_sink(payload, _dist=self.distributor,
                        _tenant=st_tenant):
                _dist.push_otlp(_tenant, payload)
        if st_sink is not None or st_endpoint:
            from tempo_tpu_torch.utils import tracing
            # service.name is the fleet-wide identity ("tempo-tpu"); the
            # process role rides as a resource attribute
            self._self_tracer = tracing.SelfTracer(
                st_endpoint, service_name="tempo-tpu", tenant=st_tenant,
                flush_interval_s=stc.flush_interval_s,
                max_buffer=stc.max_buffer,
                head_sample_rate=stc.head_sample_rate,
                max_trace_spans=stc.max_trace_spans,
                max_open_traces=stc.max_open_traces,
                sink=st_sink,
                resource_attrs={"tempo.target": self.cfg.target},
                now=self.now)
            tracing.install(self._self_tracer)
        if self.bus is not None and (self.blockbuilder is not None
                                     or self.generator is not None):
            ic = self.cfg.ingest
            # explicit partitions pin a static assignment; otherwise a
            # Kafka bus runs in consumer-group mode (None) and an
            # in-process bus consumes everything
            parts: "tuple | None" = tuple(ic.partitions) or None
            if parts is None and not hasattr(self.bus, "group_request"):
                parts = tuple(range(ic.n_partitions))
            self.bus_consume_errors = 0

            def consume_loop():
                import sys
                last_logged = 0.0
                while not self._stop.wait(ic.consume_interval_s):
                    try:
                        if self.blockbuilder is not None:
                            self.blockbuilder.consume_cycle()
                        if self.generator is not None:
                            self.generator.consume_bus(self.bus, parts)
                    except Exception as e:
                        # retried next tick, but NEVER silently: a
                        # permanently failing consumer must be visible
                        self.bus_consume_errors += 1
                        now = self.now()
                        if now - last_logged > 60:
                            last_logged = now
                            print(f"tempo-tpu: bus consume error "
                                  f"(#{self.bus_consume_errors}): {e!r}",
                                  file=sys.stderr)
            t = threading.Thread(target=consume_loop, daemon=True)
            t.start()
        if self.cfg.usage_stats_enabled and self.backend is not None:
            from tempo_tpu_torch.utils.usagestats import UsageReporter
            self.usage_reporter = UsageReporter(
                self.kv, self.backend,
                instance_id=self.cfg.instance_id or self._iid("report"),
                interval_s=self.cfg.usage_stats_interval_s, now=self.now)
            self.usage_reporter.set_stat("target", self.cfg.target)
            self.usage_reporter.start()
        # each lifecycler heartbeats on its own jittered background loop
        # (ring.Lifecycler.start_heartbeat); a failed publish is retried
        # next beat — peers only mark us unhealthy after the timeout
        for lc in self._lifecyclers:
            lc.start_heartbeat(self.cfg.heartbeat_interval_s)
        if self.fleet is not None:
            self.fleet.start()
        self.ready = True

    def shutdown(self) -> None:
        self.ready = False
        self._stop.set()
        # drain queued device batches so final collections see them (the
        # process-wide scheduler itself stays up: other Apps may share it)
        if getattr(self, "sched", None) is not None:
            self.sched.flush()
        if getattr(self, "usage_reporter", None) is not None:
            self.usage_reporter.shutdown()
        mine = getattr(self, "_self_tracer", None)
        if mine is not None:
            from tempo_tpu_torch.utils import tracing
            mine.shutdown()
            # uninstall the global only while it is still this App's:
            # another App in the process may have installed its own since
            if tracing.tracer() is mine:
                tracing.install(tracing.NoopTracer())
        if self.jaeger_agent is not None:
            self.jaeger_agent.stop()
        if self.frontend_worker:
            self.frontend_worker.shutdown()
        if self.grpc_server:
            self.grpc_server.stop(grace=1).wait(2)
        if self.distributor:
            self.distributor.forwarders.shutdown()  # drain queued tees
        if self.ingester:
            self.ingester.shutdown()
        if self.fleet is not None:
            # before the generator's shutdown: the drain and shutdown
            # checkpoints must see the instances
            self.fleet.shutdown()
        if self.generator:
            self.generator.shutdown()
        if self.frontend:
            self.frontend.shutdown()
        if self.db:
            self.db.shutdown()
        for lc in self._lifecyclers:
            try:
                lc.leave()
            except Exception:
                pass      # KV process may already be gone at teardown
        if hasattr(self.kv, "shutdown"):
            self.kv.shutdown()

    # -- serving -----------------------------------------------------------

    def run(self) -> None:
        """Start loops + HTTP server; blocks until shutdown (`app.go:165`)."""
        from tempo_tpu_torch.app.api import serve
        self.start_loops()
        try:
            serve(self)
        finally:
            self.shutdown()
