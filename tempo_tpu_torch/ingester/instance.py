"""Per-tenant ingester instance: live traces → head block → local blocks.

Mirrors `modules/ingester/instance.go`: push with limit enforcement
(`push` `instance.go:199-228` → `PushErrorReason`), complete-trace cutting,
head-block lifecycle, WAL→columnar completion, and recent-data reads
(find/search) across live traces + head + completing + complete blocks.

Counterpart of `tempo_tpu/ingester/instance.py`, host code copied with
its imports moved to the port: completed blocks are written by the port's
block writer (its own Parquet codec, `gzip` pages). `Ingester.search`
reads these blocks and the live traces (through `traceql.memview`).
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Callable, Sequence

from tempo_tpu_torch.backend.local import LocalBackend
from tempo_tpu_torch.backend.meta import BlockMeta, read_block_meta
from tempo_tpu_torch.backend.raw import DoesNotExist, block_keypath
from tempo_tpu_torch.block.reader import BackendBlock
from tempo_tpu_torch.block.wal import WALBlock, rescan_blocks
from tempo_tpu_torch.block.writer import write_block
from tempo_tpu_torch.model.combine import combine_spans, sort_spans
from tempo_tpu_torch.overrides.limits import Limits
from tempo_tpu_torch.utils.livetraces import (
    ERR_LIVE_TRACES_EXCEEDED,
    ERR_TRACE_TOO_LARGE,
    LiveTraceStore,
)

PUSH_ERRORS = (ERR_LIVE_TRACES_EXCEEDED, ERR_TRACE_TOO_LARGE)


@dataclasses.dataclass
class InstanceConfig:
    max_block_duration_s: float = 1800.0   # ingester default 30m
    max_block_bytes: int = 500_000_000
    trace_idle_s: float = 5.0              # trace_idle_period
    trace_live_s: float = 30.0             # max live time before forced cut
    dedicated_columns: tuple = ()
    row_group_rows: int = 50_000
    replication_factor: int = 3            # 1 for generator localblocks


@dataclasses.dataclass
class LocalBlockEntry:
    """A completed, locally owned block (`modules/ingester/local_block.go`):
    flushed_ts tracks backend flush for replay-safe deletion."""
    meta: BlockMeta
    block: BackendBlock
    flushed_ts: float = 0.0


class TenantInstance:
    def __init__(self, tenant: str, wal_dir: str, local_dir: str,
                 cfg: InstanceConfig | None = None,
                 limits: Limits | None = None,
                 now: Callable[[], float] = time.time) -> None:
        self.tenant = tenant
        self.cfg = cfg or InstanceConfig()
        self.now = now
        lim = limits or Limits()
        self.live = LiveTraceStore(
            max_live_traces=lim.ingestion.max_traces_per_user,
            max_trace_bytes=lim.read.max_bytes_per_trace,
            now=now)
        self.wal_dir = wal_dir
        self.local_dir = local_dir
        os.makedirs(wal_dir, exist_ok=True)
        self.local_backend = LocalBackend(local_dir)
        self.head: WALBlock | None = None
        self.head_created = 0.0
        self.completing: list[WALBlock] = []     # cut, awaiting completion
        self.complete: dict[str, LocalBlockEntry] = {}
        self.lock = threading.RLock()
        self.discarded: dict[str, int] = {}

    # -- write path --------------------------------------------------------

    def push_trace(self, trace_id: bytes, spans: Sequence[dict],
                   size_bytes: int | None = None) -> str | None:
        """Append one trace's spans; returns a PushErrorReason or None."""
        with self.lock:
            err = self.live.push(trace_id, spans, size_bytes)
            if err:
                self.discarded[err] = self.discarded.get(err, 0) + 1
            return err

    def cut_complete_traces(self, immediate: bool = False) -> int:
        """Idle/aged live traces → head WAL block (`CutCompleteTraces`)."""
        with self.lock:
            cut = self.live.cut(idle_s=self.cfg.trace_idle_s,
                                max_age_s=self.cfg.trace_live_s,
                                immediate=immediate)
            if not cut:
                return 0
            if self.head is None:
                self.head = WALBlock(self.wal_dir, self.tenant)
                self.head_created = self.now()
            for lt in cut:
                self.head.append(sort_spans(combine_spans(lt.spans)))
            return len(cut)

    def head_bytes(self) -> int:
        if self.head is None:
            return 0
        return sum(os.path.getsize(os.path.join(self.head.dir, s))
                   for s in self.head.segments())

    def cut_block_if_ready(self, immediate: bool = False) -> WALBlock | None:
        """Seal the head block when over age/size (`CutBlockIfReady`);
        returns the sealed WAL block to enqueue for completion."""
        with self.lock:
            if self.head is None:
                return None
            age = self.now() - self.head_created
            if not (immediate
                    or age >= self.cfg.max_block_duration_s
                    or self.head_bytes() >= self.cfg.max_block_bytes):
                return None
            sealed = self.head
            self.head = None
            if not sealed.segments():
                sealed.clear()
                return None
            self.completing.append(sealed)
            return sealed

    def complete_block(self, wal_block: WALBlock) -> BlockMeta:
        """WAL → columnar complete block on local disk (`CompleteBlock`
        `instance.go:316`): read back every trace, dedupe/sort, write the
        same block format the storage engine serves."""
        traces = wal_block.complete()
        meta = write_block(
            self.local_backend, self.tenant,
            [(tid, sort_spans(combine_spans(spans))) for tid, spans in traces],
            block_id=wal_block.block_id,
            dedicated_columns=self.cfg.dedicated_columns,
            row_group_rows=self.cfg.row_group_rows,
            replication_factor=self.cfg.replication_factor)
        with self.lock:
            self.complete[meta.block_id] = LocalBlockEntry(
                meta, BackendBlock(self.local_backend, meta))
            if wal_block in self.completing:
                self.completing.remove(wal_block)
        wal_block.clear()
        return meta

    def mark_flushed(self, block_id: str) -> None:
        with self.lock:
            e = self.complete.get(block_id)
            if e:
                e.flushed_ts = self.now()

    def delete_old_flushed(self, after_s: float) -> list[str]:
        """Drop local complete blocks flushed more than after_s ago
        (complete_block_timeout semantics)."""
        out = []
        with self.lock:
            for bid in list(self.complete):
                e = self.complete[bid]
                if e.flushed_ts and self.now() - e.flushed_ts >= after_s:
                    del self.complete[bid]
                    out.append(bid)
        for bid in out:
            # a recursive delete ignores what is already gone
            self.local_backend.delete("", block_keypath(bid, self.tenant),
                                      recursive=True)
        return out

    # -- replay ------------------------------------------------------------

    def replay(self) -> tuple[int, int]:
        """Restart recovery: re-adopt WAL blocks and local complete blocks
        (`instance.go:601` + `ingester.go:159`). Returns (wal, complete)."""
        n_wal = 0
        for wb in rescan_blocks(self.wal_dir):
            if wb.tenant != self.tenant:
                continue
            with self.lock:
                if wb.block_id in {b.block_id for b in self.completing}:
                    continue
                self.completing.append(wb)
            n_wal += 1
        n_complete = 0
        blocks_root = os.path.join(self.local_dir, self.tenant)
        if os.path.isdir(blocks_root):
            for bid in os.listdir(blocks_root):
                try:
                    meta = read_block_meta(self.local_backend, bid, self.tenant)
                except DoesNotExist:
                    continue    # a block dir whose meta was never written
                with self.lock:
                    self.complete[bid] = LocalBlockEntry(
                        meta, BackendBlock(self.local_backend, meta))
                n_complete += 1
        return n_wal, n_complete

    # -- read path ---------------------------------------------------------

    def find_trace_by_id(self, trace_id: bytes) -> list[dict] | None:
        """Combine across live + head + completing + complete blocks
        (the recent-data side of `Querier.FindTraceByID`)."""
        parts: list[list[dict]] = []
        with self.lock:
            lt = self.live.traces.get(trace_id)
            if lt:
                parts.append(list(lt.spans))
            heads = [b for b in ([self.head] if self.head else [])] + list(self.completing)
            complete = list(self.complete.values())
        for wb in heads:
            spans = wb.find_trace_by_id(trace_id)
            if spans:
                parts.append(spans)
        for e in complete:
            spans = e.block.find_trace_by_id(trace_id)
            if spans:
                parts.append(spans)
        if not parts:
            return None
        return sort_spans(combine_spans(*parts))

    def all_recent_traces(self) -> list[tuple[bytes, list[dict]]]:
        """Snapshot of live + WAL data as (trace_id, spans) groups (the
        input of the read side's in-memory search)."""
        by_id: dict[bytes, list[dict]] = {}
        with self.lock:
            for tid, lt in self.live.traces.items():
                by_id.setdefault(tid, []).extend(lt.spans)
            heads = [b for b in ([self.head] if self.head else [])] + list(self.completing)
        for wb in heads:
            for s in wb.iter_spans():
                by_id.setdefault(s["trace_id"], []).append(s)
        return [(tid, sort_spans(combine_spans(spans)))
                for tid, spans in by_id.items()]

    def complete_blocks(self) -> list[BackendBlock]:
        with self.lock:
            return [e.block for e in self.complete.values()]
