"""The metrics-generator service: tenants, ticks, and the push entry.

Counterpart of `tempo_tpu/generator/generator.py`, the analog of
`modules/generator/generator.go`: `push_spans` (the
`MetricsGenerator.PushSpans` RPC, `generator.go:275`) creates or loads
the tenant instance under the tenant's overrides, stages the span dicts
into a SpanBatch built on the tenant registry's interner, and hands it
to the processors; `push_otlp`, `push_otlp_recs` and `push_staged_view`
are the distributor's in-process tee routes (OTLP bytes, scan records
with their payload, and a row view of a decode-once staging); a
collection loop drives every instance's collection tick.

Every instance runs on the generator's `device` (`cuda` unless `"cpu"`
is asked for). With an ingest WAL (`wal=`, a `generator.wal.
GeneratorWal`) every push route appends its record before the ack,
`replay_wal` / `replay_wal_all` push recorded batches back through the
same routes (the scheduler and K1 on the device), and `truncate_wal`
drops what a written fleet checkpoint covers; `pop_instance` /
`end_handoff` bound the fleet handoff's window. `consume_bus` on a
Kafka bus with `partitions=None` joins a consumer group. `query_range` and
`get_metrics` read a tenant's local blocks (the `local-blocks`
processor); for a tenant with no instance they answer empty, as in the
reference. `query_range` is the query frontend's `generator_query_range`
hook.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import threading
import time
from typing import Callable, Sequence

import numpy as np

from tempo_tpu_torch.device import resolve_device
from tempo_tpu_torch.generator.instance import GeneratorConfig, GeneratorInstance
from tempo_tpu_torch.model.otlp_batch import batch_from_otlp, stage_otlp
from tempo_tpu_torch.model.span_batch import SpanBatchBuilder
from tempo_tpu_torch.obs import Registry
from tempo_tpu_torch.overrides import Overrides
from tempo_tpu_torch.utils import tracing

_LOG = logging.getLogger("tempo_tpu_torch.generator")


class Generator:
    # the distributor's in-process tee may pass trusted=True to push_otlp
    # (bytes validated by its own scan); see GeneratorClient protocol
    accepts_local_trust = True

    def __init__(self, cfg: GeneratorConfig | None = None,
                 overrides: Overrides | None = None,
                 instance_id: str = "generator-0",
                 registry: Registry | None = None,
                 now: Callable[[], float] = time.time,
                 wal=None, device=None) -> None:
        self.device = resolve_device(device)
        self.base_cfg = cfg or GeneratorConfig()
        self.overrides = overrides or Overrides()
        self.id = instance_id
        self.now = now
        self._cgroups: dict = {}      # group name → ConsumerGroup (kafka)
        # ingest WAL (generator/wal.py, None = off): every acked push is
        # appended before the ack returns and replayed on boot past the
        # fleet-checkpoint watermark
        self.wal = wal
        # tenants mid-handoff: their pushes skip the WAL append. The
        # popped instance's snapshot claims the tenant's WAL watermark,
        # and a replacement instance's record under that claim would be
        # truncated without being in any blob; set with the detach in
        # pop_instance, cleared when the handoff concludes
        self._wal_skip: set[str] = set()
        self.instances: dict[str, GeneratorInstance] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self.obs = registry if registry is not None else Registry()
        self._register_obs(self.obs)

    def _register_obs(self, reg: Registry) -> None:
        def insts():
            with self._lock:
                return dict(self.instances)

        reg.counter_func(
            "tempo_metrics_generator_spans_received_total",
            lambda: [((t,), gi.spans_received) for t, gi in insts().items()],
            help="Spans received by the metrics-generator, per tenant",
            labels=("tenant",))
        reg.gauge_func(
            "tempo_metrics_generator_registry_active_series",
            lambda: [((t,), gi.registry.budget.used)
                     for t, gi in insts().items()],
            help="Active series in the tenant registry vs its budget",
            labels=("tenant",))
        reg.gauge_func(
            "tempo_registry_state_bytes",
            lambda: [((t, gi.state_layout), gi.device_state_bytes())
                     for t, gi in insts().items()],
            help="Device bytes of per-tenant metric state (registry "
                 "families + sketch planes): dense tenants report full "
                 "pre-sized planes, paged tenants only backed pages — "
                 "the paging win, visible without a heap dump",
            labels=("tenant", "layout"))
        self.collect_duration = reg.histogram(
            "tempo_metrics_generator_collect_duration_seconds",
            "One tenant collection tick: device-state gather through "
            "remote-write send")

    def instance(self, tenant: str) -> GeneratorInstance:
        """The tenant's instance, created on first use with the tenant's
        overrides applied to the base config: processors, series budget,
        collection interval and switch, ingestion slack, the span-metrics
        sketch tier, moments count and kernel tier, and the `ta_*` limits
        of the trace-analytics config. The instance's `_matview_limits`
        resolves the tenant's current overrides for the materializer."""
        with self._lock:
            inst = self.instances.get(tenant)
            if inst is None:
                lim = self.overrides.for_tenant(tenant)
                cfg = dataclasses.replace(self.base_cfg)
                if lim.generator.processors:
                    cfg.processors = tuple(lim.generator.processors)
                cfg.registry = dataclasses.replace(
                    cfg.registry,
                    max_active_series=lim.generator.max_active_series,
                    collection_interval_s=lim.generator.collection_interval_s,
                    disable_collection=lim.generator.disable_collection)
                cfg.ingestion_time_range_slack_s = \
                    lim.generator.ingestion_time_range_slack_s
                sm_patch = {}
                if lim.generator.sketch:
                    sm_patch["sketch"] = lim.generator.sketch
                if lim.generator.sketch_moments_k:
                    sm_patch["moments_k"] = lim.generator.sketch_moments_k
                if lim.generator.kernel:
                    sm_patch["kernel"] = lim.generator.kernel
                if sm_patch:
                    cfg.spanmetrics = dataclasses.replace(
                        cfg.spanmetrics, **sm_patch)
                ta_patch = {}
                if lim.generator.ta_trace_idle_s:
                    ta_patch["trace_idle_s"] = lim.generator.ta_trace_idle_s
                if lim.generator.ta_late_window_s:
                    ta_patch["late_window_s"] = lim.generator.ta_late_window_s
                if lim.generator.ta_max_live_traces:
                    ta_patch["max_live_traces"] = \
                        lim.generator.ta_max_live_traces
                if lim.generator.ta_max_spans_per_trace:
                    ta_patch["max_spans_per_trace"] = \
                        lim.generator.ta_max_spans_per_trace
                if ta_patch:
                    cfg.traceanalytics = dataclasses.replace(
                        cfg.traceanalytics, **ta_patch)
                inst = GeneratorInstance(tenant, cfg, now=self.now,
                                         device=self.device)
                inst._matview_limits = \
                    lambda t=tenant: self.overrides.for_tenant(t)
                if self.wal is not None:
                    inst._wal_mark = \
                        lambda t=tenant: (self.id, *self.wal.watermark(t))
                self.instances[tenant] = inst
            return inst

    def tenants(self) -> list[str]:
        """Tenants with a live instance in this process."""
        with self._lock:
            return list(self.instances)

    def peek_instance(self, tenant: str) -> "GeneratorInstance | None":
        """The tenant's live instance, or None; never creates one."""
        with self._lock:
            return self.instances.get(tenant)

    def pop_instance(self, tenant: str) -> "GeneratorInstance | None":
        """Detach a tenant instance WITHOUT releasing its device state
        (fleet handoff step 1: later pushes create a fresh instance
        while the popped one is fenced + checkpointed; call
        `release_instance_pages` once the snapshot is cut). Marks the
        instance detached under its push lock so `_tracked_push` entries
        that resolved it but have not yet registered in-flight re-route
        to a fresh instance instead of scattering into the snapshot."""
        with self._lock:
            inst = self.instances.pop(tenant, None)
            if inst is not None and self.wal is not None:
                self._wal_skip.add(tenant)
        if inst is not None:
            with inst._push_cv:
                inst.detached = True
        return inst

    def end_handoff(self, tenant: str) -> None:
        """Close the WAL-skip window a `pop_instance` opened (idempotent;
        the fleet controller calls it once the cut concluded: blob
        written and truncated, instance reattached, or orphaned)."""
        with self._lock:
            self._wal_skip.discard(tenant)

    def reattach_instance(self, tenant: str,
                          inst: "GeneratorInstance") -> bool:
        """Undo `pop_instance` after a failed handoff checkpoint: put the
        instance back and lift its detached fence — unless a straggler
        push already built a replacement (then the caller keeps the
        popped instance; two live instances for one tenant would fork the
        series space). The fence lifts only AFTER the instance is back in
        the map, so a handler spinning in `_tracked_push` never scatters
        into an instance that stays detached."""
        with self._lock:
            if tenant in self.instances:
                return False
            self.instances[tenant] = inst
            self._wal_skip.discard(tenant)   # the WAL resumes with it
        with inst._push_cv:
            inst.detached = False
            inst._push_cv.notify_all()
        return True

    def _wal_for(self, tenant: str):
        """The WAL this tenant's pushes append to, or None (WAL off, or
        the tenant is mid-handoff: see `_wal_skip`)."""
        if self.wal is None or tenant in self._wal_skip:
            return None
        return self.wal

    @contextlib.contextmanager
    def _tracked_push(self, tenant: str):
        """Atomic instance-resolve + in-flight registration against
        `pop_instance`: a detached instance is re-resolved, so an acked
        push never scatters into an instance a handoff already fenced."""
        while True:
            inst = self.instance(tenant)
            if inst.try_track():
                break
        try:
            yield inst
        finally:
            inst.untrack()

    def release_instance_pages(self, inst: "GeneratorInstance") -> None:
        """Release a popped instance's device state. Dense planes are
        per-instance garbage once unreferenced; paged tenants return
        their pages to the pool, or the arena leaks the tenant forever
        (pages are zeroed on free, so slot reuse starts clean)."""
        if inst.registry.pages is None:
            return
        reg = inst.registry
        with reg.state_lock:
            seen: dict[int, object] = {}
            for mt in reg._metrics.values():
                seen[id(mt.table)] = mt.table
            for table in seen.values():
                if table.backing is None:
                    continue
                for plane, _limit in table.backing.planes:
                    plane.free_lpages(np.flatnonzero(plane.page_map >= 0))

    def remove_instance(self, tenant: str) -> "GeneratorInstance | None":
        """pop + release in one step."""
        inst = self.pop_instance(tenant)
        if inst is not None:
            self.release_instance_pages(inst)
            self.end_handoff(tenant)
        return inst

    # -- write (PushSpans RPC analog; the distributor's GeneratorClient) ---

    def push_spans(self, tenant: str, spans: Sequence[dict],
                   durable: bool = True) -> None:
        # tenant-aware span: for the reserved self-tracing tenant it
        # suppresses the whole ingest call tree
        with tracing.span_for_tenant("generator.Push", tenant,
                                     n_spans=len(spans)):
            with self._tracked_push(tenant) as inst:
                self._push_spans(inst, spans)
                wal = self._wal_for(tenant)
                if durable and wal is not None:
                    # bus-driven pushes pass durable=False: the bus
                    # commits offsets after processing, so it is the
                    # replay log, and a WAL record would apply twice
                    wal.append_spans(tenant, spans)

    def _push_spans(self, inst: GeneratorInstance, spans: Sequence[dict],
                    now_s: "float | None" = None) -> None:
        b = SpanBatchBuilder(inst.registry.interner)
        for s in spans:
            b.append(
                trace_id=s.get("trace_id", b""),
                span_id=s.get("span_id", b""),
                parent_span_id=s.get("parent_span_id", b""),
                name=s.get("name", ""),
                service=s.get("service", ""),
                kind=int(s.get("kind", 0)),
                status_code=int(s.get("status_code", 0)),
                status_message=s.get("status_message", ""),
                start_unix_nano=int(s.get("start_unix_nano", 0)),
                end_unix_nano=int(s.get("end_unix_nano", 0)),
                attrs=s.get("attrs"),
                res_attrs=s.get("res_attrs"))
        inst.push_batch(b.build(), now_s=now_s)

    def push_otlp(self, tenant: str, data: bytes, trusted: bool = False,
                  push_id: str | None = None) -> int:
        """OTLP ExportTraceServiceRequest bytes → series state: the
        span-metrics fast route when the instance is eligible, else the
        staged SpanBatch. Returns the span count. `trusted` marks bytes
        already validated in this process (the distributor's tee): the
        stage may skip re-validating attribute bytes; never set it for
        wire input. `push_id` makes retries idempotent: a recently acked
        id returns its count without scattering again.

        With the WAL on, the payload is staged once, pushed through the
        staged-view route and its staged columns appended (the record
        shape the distributor's tee logs). A push whose scatter landed
        but whose append failed stays ("pending", n) under its push id:
        the retry redoes only the append."""
        with tracing.span_for_tenant("generator.Push", tenant,
                                     n_bytes=len(data)), \
                self._tracked_push(tenant) as inst:
            seen = inst.seen_push(push_id) if push_id is not None else None
            if isinstance(seen, int):
                return seen
            pending = seen[1] if seen is not None else None
            wal = self._wal_for(tenant)
            if self.wal is not None:
                need_span, need_res = inst.needs_attr_columns()
                with tracing.span("generator.stage") as sp:
                    view = stage_otlp(data, inst.registry.interner,
                                      trusted=trusted,
                                      include_span_attrs=need_span,
                                      include_res_attrs=need_res).view()
                    if sp is not None:
                        sp.attrs["spans"] = view.n
                got = pending if pending is not None \
                    else inst.push_staged_view(view)
                if got is not None:
                    if push_id is not None:
                        inst.note_push(push_id, ("pending", got))
                    if wal is not None:
                        wal.append_view(tenant, view, push_id=push_id)
                    if push_id is not None:
                        inst.note_push(push_id, got)
                    return got
            if pending is not None:
                got = pending
            else:
                got = inst.push_otlp_staged(data, trusted=trusted)
                if got is None:
                    need_span, need_res = inst.needs_attr_columns()
                    with tracing.span("generator.stage") as sp:
                        sb, sizes = batch_from_otlp(
                            data, inst.registry.interner, return_sizes=True,
                            include_span_attrs=need_span,
                            include_res_attrs=need_res, trusted=trusted)
                        if sp is not None:
                            sp.attrs["spans"] = sb.n
                    inst.push_batch(sb, span_sizes=sizes)
                    got = sb.n
            if push_id is not None:
                inst.note_push(push_id, ("pending", got))
            if wal is not None:
                # no staged product on this route: log the raw payload
                wal.append_otlp(tenant, data, trusted=trusted,
                                push_id=push_id)
            if push_id is not None:
                inst.note_push(push_id, got)
            return got

    def push_otlp_recs(self, tenant: str, raw: bytes, recs) -> int | None:
        """In-process distributor tee: scan records (any ring-sharded
        subset) + the ORIGINAL payload — no re-parse, no re-encode.
        Returns span count or None when this tenant needs the full
        staging path (caller sends payload bytes instead)."""
        if self.wal is not None:
            # scan records carry raw-offset columns, not interner ids: no
            # WAL-able product, so the caller takes push_otlp, which logs
            return None
        with self._tracked_push(tenant) as inst:
            return inst.push_otlp_recs(raw, recs)

    # -- decode-once staged tee (distributor StagedIngest views) -----------

    def staging_interner(self, tenant: str):
        """The interner the distributor must stage against for this
        tenant's decode-once tee (id spaces are shared between staging
        and series labels)."""
        return self.instance(tenant).registry.interner

    def staging_profile(self, tenant: str):
        """(interner, need_span_attrs, need_res_attrs) — what a
        decode-once staging destined for this tenant must include."""
        inst = self.instance(tenant)
        need_span, need_res = inst.needs_attr_columns()
        return inst.registry.interner, need_span, need_res

    def push_staged_view(self, tenant: str, view) -> int | None:
        """The zero-copy distributor tee: a row-index view over a shared
        decode-once staging (`model.otlp_batch.StagedView`). Returns the
        span count, or None when this instance cannot consume the view
        (foreign interner) — the caller falls back to payload bytes.

        The WAL append comes after the scatter and before the ack, both
        inside the tracked-push fence, so a checkpoint's watermark (read
        after `wait_pushes_idle`) covers every record whose scatter the
        snapshot gathered."""
        with self._tracked_push(tenant) as inst:
            got = inst.push_staged_view(view)
            if got is not None:
                wal = self._wal_for(tenant)
                if wal is not None:
                    wal.append_view(tenant, view)
            return got

    # -- ingest WAL (generator/wal.py): replay + truncation ----------------

    def _apply_wal_record(self, tenant: str, meta: dict, arrays,
                          seg_strings, idmap_cache: "dict | None" = None
                          ) -> None:
        """Replay ONE WAL record through the normal push routes at the
        original push's wall time (the slack filter drops exactly what
        the live push dropped). Raises on a declined or unknown record,
        which the WAL dead-letters."""
        from tempo_tpu_torch.generator import wal as wal_mod
        from tempo_tpu_torch.rpc import _json_to_spans

        kind = meta.get("kind")
        ts = float(meta.get("ts", self.now()))
        with self._tracked_push(tenant) as inst:
            pid = meta.get("push_id")
            if pid is not None and inst.seen_push(pid) is not None:
                return                  # already applied this boot
            if kind == "staged":
                # the id map grows with the segment's string table (keyed
                # on the list itself, held strongly): re-interning the
                # whole vocabulary per record would be O(records x strings)
                c = idmap_cache if idmap_cache is not None else {}
                if c.get("list") is not seg_strings:
                    c.clear()
                    c.update(list=seg_strings, n=0,
                             idmap=np.zeros(0, np.int32))
                if len(seg_strings) > c["n"]:
                    new = np.asarray(inst.registry.interner.intern_many(
                        seg_strings[c["n"]:]), np.int32)
                    c["idmap"] = np.concatenate([c["idmap"], new])
                    c["n"] = len(seg_strings)
                view = wal_mod.rebuild_view(inst.registry.interner, meta,
                                            arrays, seg_strings, c["idmap"])
                got = inst.push_staged_view(view, now_s=ts)
                if got is None:
                    raise RuntimeError(
                        "staged WAL record declined by the live instance")
            elif kind == "otlp":
                data = arrays["raw"].tobytes()
                trusted = bool(meta.get("trusted"))
                need_span, need_res = inst.needs_attr_columns()
                st = stage_otlp(data, inst.registry.interner,
                                trusted=trusted, include_span_attrs=need_span,
                                include_res_attrs=need_res)
                got = inst.push_staged_view(st.view(), now_s=ts)
                if got is None:
                    sb, sizes = batch_from_otlp(
                        data, inst.registry.interner, return_sizes=True,
                        include_span_attrs=need_span,
                        include_res_attrs=need_res, trusted=trusted)
                    inst.push_batch(sb, span_sizes=sizes, now_s=ts)
                    got = sb.n
            elif kind == "spans":
                self._push_spans(inst, _json_to_spans(meta["spans"]),
                                 now_s=ts)
                got = int(meta.get("n", 0))
            else:
                raise ValueError(f"unknown WAL record kind {kind!r}")
            if pid is not None:
                # re-seed the idempotency window: a client retry landing
                # after crash recovery still dedupes
                inst.note_push(pid, got)

    def replay_wal(self, tenant: str, past_seq: "int | None" = None) -> dict:
        """Replay this tenant's local WAL records past the watermark:
        `past_seq=None` reads it from the instance's restored checkpoint
        metadata (this member's entry; -1 = nothing restored, replay
        everything on disk)."""
        if self.wal is None:
            return {"batches": 0, "dead_letters": 0}
        if past_seq is None:
            wm = self.instance(tenant).wal_watermarks.get(self.id)
            past_seq = int(wm[1]) if wm else -1
        cache: dict = {}
        return self.wal.replay(
            tenant,
            lambda meta, arrays, seg_strings, t=tenant:
                self._apply_wal_record(t, meta, arrays, seg_strings,
                                       idmap_cache=cache),
            past_seq=past_seq)

    def replay_wal_all(self) -> dict:
        """Boot recovery: replay every tenant with WAL segments on disk
        (ownership is irrelevant: these records exist nowhere else; a
        fleet handoff moves replayed state to its owner on the next
        tick)."""
        out = {"tenants": 0, "batches": 0, "dead_letters": 0}
        if self.wal is None:
            return out
        for tenant in self.wal.tenants_on_disk():
            got = self.replay_wal(tenant)
            out["tenants"] += 1
            out["batches"] += got["batches"]
            out["dead_letters"] += got["dead_letters"]
        return out

    def truncate_wal(self, tenant: str, upto_seq: "int | None") -> None:
        """Drop WAL segments wholly covered by a written checkpoint."""
        if self.wal is not None and upto_seq is not None and upto_seq >= 0:
            self.wal.truncate(tenant, upto_seq)

    # -- reads (frontend generator_query_range hook) -----------------------

    def query_range(self, tenant: str, req, clip_start_ns: int | None = None):
        with self._lock:
            if tenant not in self.instances:
                return []
        return self.instance(tenant).query_range(req, clip_start_ns=clip_start_ns)

    def get_metrics(self, tenant: str, query: str, group_by,
                    max_series: int = 1000):
        with self._lock:
            if tenant not in self.instances:
                from tempo_tpu_torch.traceql.metrics_summary import \
                    MetricsResults
                return MetricsResults(max_series)
        return self.instance(tenant).get_metrics(query, group_by,
                                                 max_series=max_series)

    # -- bus consumption (generator_kafka.go:25-110 analog) ----------------

    def consume_bus(self, bus, partitions=None,
                    group: str = "metrics-generator",
                    max_records: int = 1000) -> int:
        """Drain owned partitions from the last committed offset into the
        tenant instances; commit AFTER processing (replayable). Spans batch
        per tenant across the fetched records, and tenants with metrics
        generation disabled are skipped — the same gate the direct RPC tee
        applies (`distributor.go:563` + overrides), since the bus carries
        every trace for the blockbuilder's sake.

        `partitions=None` on a Kafka bus enters CONSUMER-GROUP mode: the
        group protocol (JoinGroup/SyncGroup/Heartbeat) assigns partitions
        and re-assigns them when replicas join or die; commits are
        generation-fenced. With a static bus (or explicit partitions) the
        token→partition assignment stays as configured."""
        from tempo_tpu_torch.ingest.encoding import decode_push

        cg = None
        if partitions is None:
            if hasattr(bus, "group_request"):
                cg = self._cgroups.get(group)
                if cg is None:
                    from tempo_tpu_torch.ingest.kafka import ConsumerGroup
                    cg = self._cgroups[group] = ConsumerGroup(
                        bus, group, now=self.now)
                partitions = cg.ensure_active()
            else:
                partitions = range(getattr(bus, "n_partitions", 1))
        total = 0
        skip: set[str] = set()
        for p in partitions:
            start = bus.committed(group, p)
            recs = bus.fetch(p, start, max_records)
            if not recs:
                continue
            by_tenant: dict[str, list[dict]] = {}
            for rec in recs:
                if rec.tenant in skip:
                    continue
                if rec.tenant not in by_tenant:
                    lim = self.overrides.for_tenant(rec.tenant)
                    if not lim.generator.processors and \
                            rec.tenant not in self.instances:
                        skip.add(rec.tenant)
                        continue
                for _tid, spans in decode_push(rec.value):
                    by_tenant.setdefault(rec.tenant, []).extend(spans)
            for tenant, spans in by_tenant.items():
                # durable=False: the bus commit below is these spans'
                # replay log; a WAL record too would apply them twice
                self.push_spans(tenant, spans, durable=False)
            if cg is not None:
                cg.commit(p, recs[-1].offset + 1)    # generation-fenced
            else:
                bus.commit(group, p, recs[-1].offset + 1)
            total += len(recs)
        return total

    # -- loops -------------------------------------------------------------

    def collect_all(self) -> int:
        """One collection tick for every tenant (registry → remote write)."""
        with self._lock:
            insts = list(self.instances.values())
        total = 0
        for inst in insts:
            # in-flight fence against a fleet handoff: a detached
            # instance is not collected
            if not inst.try_track():
                continue
            try:
                if not inst.registry.overrides.disable_collection:
                    t0 = time.perf_counter()
                    total += inst.collect_and_push()
                    self.collect_duration.observe(time.perf_counter() - t0)
                inst.tick()
            finally:
                inst.untrack()
        return total

    def start(self) -> None:
        def loop():
            interval = self.base_cfg.registry.collection_interval_s
            while not self._stop.wait(interval):
                try:
                    self.collect_all()
                except Exception:
                    # the loop must outlive one failed tick
                    _LOG.exception("generator %s: collection tick failed",
                                   self.id)
        t = threading.Thread(target=loop, daemon=True)
        t.start()
        self._threads.append(t)

    def shutdown(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2)
        self.collect_all()
        if self.wal is not None:
            self.wal.close()
