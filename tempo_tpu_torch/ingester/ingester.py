"""The ingester service: tenant instances + flush machinery + replay.

Analog of `modules/ingester/ingester.go` + `flush.go`: a push entry point
(`PushBytesV2` `ingester.go:301`), a periodic cut loop (`cutToWalLoop`
`flush.go:142`), two-phase flush ops (opKindComplete → opKindFlush
`flush.go:70-73`) through deduping retry queues, shutdown flush-all, and
WAL replay on construction.

Counterpart of `tempo_tpu/ingester/ingester.py`, host code copied with its
imports moved to the port. `push_otlp` decodes with the port's native
layer, which builds at import or raises (no Python-decoder fallback).
`search`, `tag_names` and `tag_values` run TraceQL over in-memory views
of the live traces (`traceql.memview`) and over local complete blocks.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
from typing import Callable, Sequence

import numpy as np

from tempo_tpu_torch import native
from tempo_tpu_torch.backend.raw import RawWriter, block_keypath
from tempo_tpu_torch.block.wal import rescan_blocks
from tempo_tpu_torch.ingester.instance import InstanceConfig, TenantInstance
from tempo_tpu_torch.obs import Registry
from tempo_tpu_torch.overrides import Overrides
from tempo_tpu_torch.utils.flushqueues import FlushQueues, backoff_at

log = logging.getLogger(__name__)

OP_COMPLETE = "complete"
OP_FLUSH = "flush"


@dataclasses.dataclass
class IngesterConfig:
    instance: InstanceConfig = dataclasses.field(default_factory=InstanceConfig)
    concurrent_flushes: int = 4
    flush_check_period_s: float = 10.0
    complete_block_timeout_s: float = 900.0   # keep local 15m after flush
    max_flush_attempts: int = 10
    flush_backoff_base_s: float = 30.0


@dataclasses.dataclass
class _FlushOp:
    kind: str
    tenant: str
    block_id: str
    attempts: int = 0
    wal_block: object = None


class Ingester:
    def __init__(self, data_dir: str,
                 flush_writer: RawWriter | None = None,
                 cfg: IngesterConfig | None = None,
                 overrides: Overrides | None = None,
                 now: Callable[[], float] = time.time,
                 instance_id: str = "ingester-0",
                 registry: Registry | None = None) -> None:
        self.cfg = cfg or IngesterConfig()
        self.overrides = overrides or Overrides()
        self.now = now
        self.id = instance_id
        self.wal_root = os.path.join(data_dir, "wal")
        self.local_root = os.path.join(data_dir, "blocks")
        self.flush_writer = flush_writer
        self.instances: dict[str, TenantInstance] = {}
        self.lock = threading.RLock()
        self.queues = FlushQueues(self.cfg.concurrent_flushes, now=now)
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self.obs = registry if registry is not None else Registry()
        self._register_obs(self.obs)
        self.replay()

    def _register_obs(self, reg: Registry) -> None:
        def live():
            with self.lock:
                insts = dict(self.instances)
            return [((t,), len(inst.live)) for t, inst in insts.items()]

        def discarded():
            with self.lock:
                insts = dict(self.instances)
            return [((t, r), v) for t, inst in insts.items()
                    for r, v in inst.discarded.items()]

        reg.gauge_func("tempo_ingester_live_traces", live,
                       help="Traces currently held in memory, per tenant",
                       labels=("tenant",))
        reg.counter_func(
            "tempo_ingester_discarded_traces_total", discarded,
            help="Traces rejected by the ingester after the distributor "
                 "accepted them, by tenant and reason",
            labels=("tenant", "reason"))
        self.cut_duration = reg.histogram(
            "tempo_ingester_cut_duration_seconds",
            "One cut sweep for a tenant: idle-trace cut plus head-block "
            "seal decision")
        self.flush_duration = reg.histogram(
            "tempo_ingester_flush_duration_seconds",
            "One flush-queue operation, by kind (complete = WAL to local "
            "block; flush = local block to object storage)",
            labels=("op",))

    # -- instances ---------------------------------------------------------

    def instance(self, tenant: str) -> TenantInstance:
        with self.lock:
            inst = self.instances.get(tenant)
            if inst is None:
                inst = self.instances[tenant] = TenantInstance(
                    tenant,
                    wal_dir=self.wal_root,
                    local_dir=self.local_root,
                    cfg=self.cfg.instance,
                    limits=self.overrides.for_tenant(tenant),
                    now=self.now)
            return inst

    # -- write -------------------------------------------------------------

    def push(self, tenant: str,
             traces: Sequence[tuple[bytes, list[dict]]]) -> list[str | None]:
        """Push (trace_id, spans) groups; returns a per-trace error reason
        (or None) aligned with the input — the PushResponse error slice of
        `PushBytesV2`, letting the distributor dedupe reasons across
        replicas instead of summing them RF times."""
        inst = self.instance(tenant)
        return [inst.push_trace(tid, spans) for tid, spans in traces]

    def push_otlp(self, tenant: str, payload: bytes) -> dict[str, str]:
        """OTLP wire-slice push (the columnar distributor's PushBytesV2
        shape: raw proto per replica, unmarshalled HERE — as the reference
        ingester unmarshals trace bytes). Returns {trace_id_hex: reason}
        for rejected traces only."""
        spans = native.spans_from_otlp_proto_native(payload)
        by_tid: dict[bytes, list[dict]] = {}
        for s in spans:
            by_tid.setdefault(s["trace_id"], []).append(s)
        inst = self.instance(tenant)
        out: dict[str, str] = {}
        for tid, group in by_tid.items():
            reason = inst.push_trace(tid, group)
            if reason:
                out[tid.hex()] = reason
        return out

    def push_staged(self, tenant: str, view) -> dict[str, str]:
        """Staged-view push (the decode-once distributor tee): this
        replica's traces arrive as a row-index slice over the shared
        columnar staging (`model.otlp_batch.StagedView`) — live-trace
        groups come straight off the trace-id column and span dicts
        convert from the staged columns, with events/links restored from
        the staging's one lazy payload pass. No per-replica protobuf
        re-decode. The view's rows convert in one call (the reference
        converts each trace's rows in a call of its own: the same dicts).
        Same return contract as `push_otlp`: {trace_id_hex: reason} for
        rejected traces only."""
        inst = self.instance(tenant)
        rows = view.row_indices()
        dicts = view.to_span_dicts()
        at = np.zeros(int(rows.max()) + 1 if len(rows) else 0, np.int64)
        at[rows] = np.arange(len(rows))
        out: dict[str, str] = {}
        for tid, grp in view.trace_groups():
            reason = inst.push_trace(tid, [dicts[i] for i in at[grp].tolist()])
            if reason:
                out[tid.hex()] = reason
        return out

    # -- cut/flush machinery ----------------------------------------------

    def sweep_instance(self, tenant: str, immediate: bool = False) -> None:
        """One cut tick for a tenant (`sweepInstance` flush.go:142):
        cut idle traces, maybe seal head, enqueue completion."""
        t0 = time.perf_counter()
        inst = self.instance(tenant)
        inst.cut_complete_traces(immediate=immediate)
        sealed = inst.cut_block_if_ready(immediate=immediate)
        self.cut_duration.observe(time.perf_counter() - t0)
        if sealed is not None:
            self.queues.enqueue(
                f"{tenant}/{sealed.block_id}",
                _FlushOp(OP_COMPLETE, tenant, sealed.block_id, wal_block=sealed))

    def sweep_all(self, immediate: bool = False) -> None:
        with self.lock:
            tenants = list(self.instances)
        for t in tenants:
            self.sweep_instance(t, immediate=immediate)

    def _handle_op(self, key: str, op: _FlushOp) -> bool:
        t0 = time.perf_counter()
        try:
            return self._handle_op_inner(key, op)
        finally:
            self.flush_duration.observe(time.perf_counter() - t0,
                                        (op.kind,))

    def _handle_op_inner(self, key: str, op: _FlushOp) -> bool:
        inst = self.instance(op.tenant)
        try:
            if op.kind == OP_COMPLETE:
                if op.wal_block is not None:
                    inst.complete_block(op.wal_block)
                # chain to flush (two-phase, `flush.go:264-364`)
                self.queues.done(key)
                self.queues.enqueue(f"{key}/flush",
                                    _FlushOp(OP_FLUSH, op.tenant, op.block_id))
                return True
            # OP_FLUSH: copy the completed local block to object storage
            if self.flush_writer is not None:
                entry = inst.complete.get(op.block_id)
                if entry is None:
                    self.queues.done(key)
                    return True
                _copy_block_files(inst, op.block_id, self.flush_writer)
            inst.mark_flushed(op.block_id)
            self.queues.done(key)
            return True
        except Exception:
            # the flush loop keeps running: the op is retried with backoff,
            # and its failure is logged with the traceback
            op.attempts += 1
            log.warning("ingester %s: %s op %s failed (attempt %d of %d)",
                        self.id, op.kind, key, op.attempts,
                        self.cfg.max_flush_attempts, exc_info=True)
            if op.attempts >= self.cfg.max_flush_attempts:
                self.queues.done(key)   # abandon (`flush.go` op abandonment)
                return False
            self.queues.requeue(key, op, backoff_at(
                self.now(), op.attempts, self.cfg.flush_backoff_base_s))
            return False

    def flush_tick(self, queue_idx: int | None = None) -> int:
        """Drain due ops (one queue when an index is given — the per-worker
        loop — or all queues until quiescent, for tests/manual ticks: an
        OP_COMPLETE chains an OP_FLUSH that may hash to any queue, so a
        single pass is not enough)."""
        n = 0
        if queue_idx is not None:
            while True:
                got = self.queues.dequeue(queue_idx)
                if got is None:
                    return n
                self._handle_op(*got)
                n += 1
        progressed = True
        while progressed:
            progressed = False
            for qi in range(self.cfg.concurrent_flushes):
                while True:
                    got = self.queues.dequeue(qi)
                    if got is None:
                        break
                    self._handle_op(*got)
                    n += 1
                    progressed = True
        return n

    def flush_all(self) -> None:
        """/flush + shutdown behavior: cut everything, complete, flush."""
        self.sweep_all(immediate=True)
        self.queues.drain(self._handle_op)
        # completion enqueues flush ops; drain those too
        self.queues.drain(self._handle_op)

    # -- read path (recent data, `instance_search.go`) ---------------------

    def find_trace_by_id(self, tenant: str, trace_id: bytes) -> list[dict] | None:
        with self.lock:
            if tenant not in self.instances:
                return None
        return self.instance(tenant).find_trace_by_id(trace_id)

    def search(self, tenant: str, query: str, limit: int = 20,
               start_s: float = 0, end_s: float = 0):
        """TraceQL over live+WAL data (in-memory ColumnView) and local
        complete blocks — the ingester side of querier fan-out."""
        from tempo_tpu_torch.block.fetch import scan_views
        from tempo_tpu_torch.traceql.engine import compile_query, execute_search
        from tempo_tpu_torch.traceql.memview import view_from_traces

        with self.lock:
            if tenant not in self.instances:
                return []
        inst = self.instance(tenant)
        q, req = compile_query(query, int(start_s * 1e9), int(end_s * 1e9))

        def views():
            traces = inst.all_recent_traces()
            if traces:
                v = view_from_traces(traces)
                yield v, np.arange(v.n)
            for b in inst.complete_blocks():
                yield from scan_views(b, req)

        return execute_search(q, views(), limit=limit,
                              start_ns=int(start_s * 1e9),
                              end_ns=int(end_s * 1e9))

    def tag_names(self, tenant: str) -> dict[str, list[str]]:
        from tempo_tpu_torch.block.fetch import block_tag_names
        from tempo_tpu_torch.traceql.engine import execute_tag_names
        from tempo_tpu_torch.traceql.memview import view_from_traces

        with self.lock:
            if tenant not in self.instances:
                return {}
        inst = self.instance(tenant)
        traces = inst.all_recent_traces()
        out: dict[str, set] = {"span": set(), "resource": set()}
        if traces:
            v = view_from_traces(traces)
            for scope, names in execute_tag_names([(v, np.arange(v.n))]).items():
                out.setdefault(scope, set()).update(names)
        for b in inst.complete_blocks():
            for scope, names in block_tag_names(b).items():
                out.setdefault(scope, set()).update(names)
        return {k: sorted(v) for k, v in out.items()}

    def tag_values(self, tenant: str, name: str, limit: int = 1000) -> list[dict]:
        """Distinct values of one attribute over live+WAL data and local
        complete blocks (the ingester leg of `ExecuteTagValues`)."""
        from tempo_tpu_torch.block.fetch import scan_views
        from tempo_tpu_torch.traceql.engine import execute_tag_values, tag_values_request
        from tempo_tpu_torch.traceql.memview import view_from_traces

        with self.lock:
            if tenant not in self.instances:
                return []
        inst = self.instance(tenant)
        req = tag_values_request(name)

        def views():
            traces = inst.all_recent_traces()
            if traces:
                v = view_from_traces(traces)
                yield v, np.arange(v.n)
            for b in inst.complete_blocks():
                yield from scan_views(b, req)

        return execute_tag_values(name, views(), limit=limit)

    # -- replay ------------------------------------------------------------

    def replay(self) -> None:
        """Adopt WAL + local complete blocks left by a previous process and
        queue them for (re)completion and flush."""
        if not os.path.isdir(self.wal_root):
            return
        for wb in rescan_blocks(self.wal_root):
            inst = self.instance(wb.tenant)
            with inst.lock:
                if wb.block_id not in [b.block_id for b in inst.completing]:
                    inst.completing.append(wb)
            self.queues.enqueue(
                f"{wb.tenant}/{wb.block_id}",
                _FlushOp(OP_COMPLETE, wb.tenant, wb.block_id, wal_block=wb))
        if os.path.isdir(self.local_root):
            for tenant in os.listdir(self.local_root):
                inst = self.instance(tenant)
                _, n = inst.replay()
                for bid, e in inst.complete.items():
                    if not e.flushed_ts:
                        self.queues.enqueue(f"{tenant}/{bid}/flush",
                                            _FlushOp(OP_FLUSH, tenant, bid))

    # -- loops -------------------------------------------------------------

    def start(self) -> None:
        def cut_loop():
            while not self._stop.wait(self.cfg.flush_check_period_s):
                self.sweep_all()
        def flush_loop(qi: int):
            while not self._stop.wait(1.0):
                self.flush_tick(qi)
        self._threads = [threading.Thread(target=cut_loop, daemon=True)]
        self._threads += [threading.Thread(target=flush_loop, args=(i,), daemon=True)
                          for i in range(self.cfg.concurrent_flushes)]
        for t in self._threads:
            t.start()

    def shutdown(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5)
        self.flush_all()


def _copy_block_files(inst: TenantInstance, block_id: str, dst: RawWriter) -> None:
    kp = block_keypath(block_id, inst.tenant)
    src = inst.local_backend
    for name in src.find(kp):
        dst.write(name, kp, src.read(name, kp))
