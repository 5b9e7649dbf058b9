"""Compaction: time-window block selection + trace-merging rewrites.

Counterpart of `tempo_tpu/db/compactor.py` (`tempodb/compactor.go:79-185`
+ `compaction_block_selector.go` + `vparquet4/compactor.go`): pick
same-level blocks in the same time window, k-way merge their trace
groups (dedup spans per trace id like `pkg/model/trace/combine.go`), emit
size-targeted output blocks one level up, then mark inputs compacted.
Ring ownership is a pluggable `owns` predicate
(`modules/compactor/compactor.go:190`).

Two routes, as in the reference: the host route (`compact`: `heapq`
merge of per-block trace streams, `combine_spans`, `write_block`) and
the device route (`compact_device`: every input decoded once into one
column table, the merge permutation from `ops/compact.merge_order` on
the caller's device, the permuted table written through
`write_block_from_table` with a sketch sidecar a block). The reference
goes through pyarrow; the port through its own codec's `ColumnTable`
(`take`, `slice`, `concat`, `with_column`). The device route has no host
fallback here: its failure reaches the caller.
"""

from __future__ import annotations

import dataclasses
import heapq
import logging
import time
from typing import Callable, Iterable, Iterator

import numpy as np

from tempo_tpu_torch.backend import meta as bm
from tempo_tpu_torch.backend.raw import RawReader, RawWriter
from tempo_tpu_torch.block import parquet
from tempo_tpu_torch.block.reader import BackendBlock, _rows_to_spans
from tempo_tpu_torch.block.writer import write_block, write_block_from_table
from tempo_tpu_torch.model.combine import combine_spans

log = logging.getLogger("tempo_tpu_torch.db.compactor")


@dataclasses.dataclass
class CompactorConfig:
    """Subset of `tempodb/config.go` CompactorConfig."""

    max_compaction_window_s: float = 3600.0
    min_inputs: int = 2
    max_inputs: int = 4               # MaxCompactionObjects guard analog
    max_block_objects: int = 1_000_000
    max_block_bytes: int = 100 << 30
    compacted_grace_s: float = 3600.0  # retention grace for compacted markers
    retention_s: float = 14 * 86400.0
    # device cold tier (runbook "Compacting on device"): merge/dedup/
    # re-sort input blocks on device (`ops/compact.py`, one columnar
    # decode per input) instead of the host heapq merge; the host merge
    # runs only with this off (the reference falls back to it on a
    # device failure, the port does not)
    device: bool = True
    # emit a sketch sidecar (block/sidecar.py) next to every compaction
    # output — the historical-fold tier's per-block summary
    sidecars: bool = True
    # compactor sweeps also backfill sidecars for pre-existing blocks
    # (low-priority compaction-class work), this many per tenant sweep
    backfill_sidecars: int = 2


class TimeWindowBlockSelector:
    """Group candidate blocks by (level, time window); oldest window first
    (`compaction_block_selector.go:29,119`)."""

    def __init__(self, cfg: CompactorConfig):
        self.cfg = cfg

    def blocks_to_compact(self, metas: list[bm.BlockMeta]) -> list[list[bm.BlockMeta]]:
        win = self.cfg.max_compaction_window_s
        groups: dict[tuple[int, int], list[bm.BlockMeta]] = {}
        for m in metas:
            groups.setdefault((m.compaction_level, int(m.end_time // win)), []).append(m)
        out = []
        for (_lvl, _w), ms in sorted(groups.items(), key=lambda kv: (kv[0][1], kv[0][0])):
            ms.sort(key=lambda m: m.size_bytes)
            while len(ms) >= self.cfg.min_inputs:
                take = ms[: self.cfg.max_inputs]
                ms = ms[self.cfg.max_inputs:]
                if len(take) >= self.cfg.min_inputs:
                    out.append(take)
        return out


def iter_trace_groups(block: BackendBlock) -> Iterator[tuple[bytes, list[dict]]]:
    """Stream (trace_id, spans) in trace-id order from one block; rows of a
    trace are contiguous, so groups fall out of row-group scans."""
    pending_tid: bytes | None = None
    pending: list[dict] = []
    pf = block.parquet_file()
    for rg in range(pf.num_row_groups):
        tbl = pf.read_row_group(rg)
        spans = _rows_to_spans(tbl, np.arange(tbl.num_rows))
        for s in spans:
            tid = bytes(s["trace_id"])
            if tid != pending_tid:
                if pending_tid is not None:
                    yield pending_tid, pending
                pending_tid, pending = tid, []
            pending.append(s)
    if pending_tid is not None:
        yield pending_tid, pending


def merge_blocks(blocks: Iterable[BackendBlock]) -> Iterator[tuple[bytes, list[dict]]]:
    """K-way merge by trace id with span dedup across blocks."""
    iters = [iter_trace_groups(b) for b in blocks]
    merged = heapq.merge(*iters, key=lambda g: g[0])
    cur_tid: bytes | None = None
    cur_lists: list[list[dict]] = []
    for tid, spans in merged:
        if tid != cur_tid:
            if cur_tid is not None:
                yield cur_tid, combine_spans(*cur_lists)
            cur_tid, cur_lists = tid, []
        cur_lists.append(spans)
    if cur_tid is not None:
        yield cur_tid, combine_spans(*cur_lists)


def compact(r: RawReader, w: RawWriter, tenant: str,
            inputs: list[bm.BlockMeta], cfg: CompactorConfig) -> list[bm.BlockMeta]:
    """Compact one input group → output metas (inputs marked compacted)."""
    blocks = [BackendBlock(r, m) for m in inputs]
    level = max(m.compaction_level for m in inputs) + 1
    ded = inputs[0].dedicated_columns
    out_metas: list[bm.BlockMeta] = []
    batch: list[tuple[bytes, list[dict]]] = []
    nspans = 0
    ntraces = 0
    est_bytes_per_span = max(
        sum(m.size_bytes for m in inputs) // max(sum(m.total_spans for m in inputs), 1), 1)

    def flush():
        nonlocal batch, nspans, ntraces
        if not batch:
            return
        meta = write_block(w, tenant, batch, dedicated_columns=ded,
                           compaction_level=level,
                           replication_factor=inputs[0].replication_factor)
        out_metas.append(meta)
        batch, nspans, ntraces = [], 0, 0

    for tid, spans in merge_blocks(blocks):
        batch.append((tid, spans))
        nspans += len(spans)
        ntraces += 1
        if (ntraces >= cfg.max_block_objects
                or nspans * est_bytes_per_span >= cfg.max_block_bytes):
            flush()
    flush()
    for m in inputs:
        bm.mark_block_compacted(r, w, m.block_id, tenant)
    log.info("compacted %d blocks -> %d (tenant=%s level=%d)",
             len(inputs), len(out_metas), tenant, level)
    return out_metas


# ---------------------------------------------------------------------------
# device route: decode once → merge/dedup/re-sort on device → stream back
# ---------------------------------------------------------------------------

def _id_matrix(col, width: int) -> np.ndarray:
    """An id column → [n, width] uint8: the codec's fixed-width columns as
    they are, variable-length ones padded or cut to `width`."""
    if isinstance(col, np.ndarray) and col.ndim == 2 and col.shape[1] == width:
        return np.ascontiguousarray(col, np.uint8)
    vals = parquet.column_pylist(col)
    joined = b"".join(bytes(v or b"").ljust(width, b"\0")[:width]
                      for v in vals)
    return np.frombuffer(joined, np.uint8).reshape(len(vals), width)


def _trace_starts(tid: np.ndarray) -> np.ndarray:
    """Row offsets where each trace run of a tid-grouped [n, 16] column
    starts, with n appended."""
    n = len(tid)
    if n == 0:
        return np.zeros(1, np.int64)
    cut = np.flatnonzero((tid[1:] != tid[:-1]).any(axis=1)) + 1
    return np.concatenate([[0], cut, [n]]).astype(np.int64)


def _write_merged(w: RawWriter, tenant: str, table: parquet.ColumnTable,
                  order: np.ndarray, inputs: list[bm.BlockMeta],
                  cfg: CompactorConfig, stats: dict | None,
                  device=None) -> list[bm.BlockMeta]:
    """Permute the concatenated input table into merged order and write
    size-targeted output blocks (+ sidecars) — the host `flush` loop's
    trace/byte budgets applied to trace RUNS of the merged order."""
    level = max(m.compaction_level for m in inputs) + 1
    est_bytes_per_span = max(
        sum(m.size_bytes for m in inputs)
        // max(sum(m.total_spans for m in inputs), 1), 1)
    out = table.take(order)
    tid_np = _id_matrix(out.column("trace_id"), 16)
    # trace run boundaries in merged order (order is tid-grouped)
    starts = _trace_starts(tid_np).tolist()
    out_metas: list[bm.BlockMeta] = []
    lo_t = 0
    while lo_t < len(starts) - 1:
        # host-flush boundary semantics: add whole traces until the
        # trace/byte budget trips ON the trace just added (inclusive)
        hi_t = lo_t
        while hi_t < len(starts) - 1:
            hi_t += 1
            if (hi_t - lo_t >= cfg.max_block_objects
                    or (starts[hi_t] - starts[lo_t]) * est_bytes_per_span
                    >= cfg.max_block_bytes):
                break
        lo_r, hi_r = starts[lo_t], starts[hi_t]
        chunk = out.slice(lo_r, hi_r)
        # dense per-block trace index (writer normally derives it from
        # the trace grouping; the permuted table carries stale values)
        run_lens = np.diff(starts[lo_t:hi_t + 1])
        chunk = chunk.with_column("trace_idx", np.repeat(
            np.arange(len(run_lens), dtype=np.int32), run_lens))
        trace_ids = [tid_np[starts[t]].tobytes() for t in range(lo_t, hi_t)]
        meta = write_block_from_table(
            w, tenant, chunk, trace_ids,
            dedicated_columns=inputs[0].dedicated_columns,
            compaction_level=level,
            replication_factor=inputs[0].replication_factor)
        if cfg.sidecars:
            write_sidecar_for_table(w, tenant, meta, chunk, stats,
                                    device=device)
        out_metas.append(meta)
        lo_t = hi_t
    return out_metas


def write_sidecar_for_table(w: RawWriter, tenant: str, meta: bm.BlockMeta,
                            table: parquet.ColumnTable,
                            stats: dict | None = None, device=None) -> None:
    """Build + write the sketch sidecar from block-resident columns (the
    sketch pass on `device`) and flip the meta marker (blocks are born
    with sidecars on this path)."""
    from tempo_tpu_torch.block import sidecar as sdc

    sc = sdc.build_sidecar(
        np.asarray(parquet.column_pylist(table.column("service")), object),
        np.asarray(parquet.column_pylist(table.column("name")), object),
        np.asarray(table.column("duration_ns")),
        _id_matrix(table.column("trace_id"), 16), device=device)
    sdc.write_sidecar(w, tenant, meta.block_id, sc)
    meta.sidecar = True
    bm.write_block_meta(w, meta)
    if stats is not None:
        stats["sidecars_written"] += 1


def compact_device(r: RawReader, w: RawWriter, tenant: str,
                   inputs: list[bm.BlockMeta], cfg: CompactorConfig,
                   stats: dict | None = None,
                   dispatch: Callable | None = None,
                   device=None) -> list[bm.BlockMeta]:
    """Device-route `compact`: each input block is decoded ONCE into the
    concatenated column table, the merge/dedup/re-sort permutation is
    computed on `device` (`ops/compact.merge_order`, bit-compatible with
    the host heapq/combine_spans contract), and outputs stream back
    through the standard writer with sketch sidecars attached.

    `dispatch` wraps the device call (the sched compaction-class hook).
    A decode or schema surprise raises.
    """
    from tempo_tpu_torch.ops import compact as cops

    blocks = [BackendBlock(r, m) for m in inputs]
    table = parquet.ColumnTable.concat(
        [b.parquet_file().read() for b in blocks])
    out_metas: list[bm.BlockMeta] = []
    if table.num_rows:
        tid = _id_matrix(table.column("trace_id"), 16)
        sid = _id_matrix(table.column("span_id"), 8)
        t0 = time.monotonic()
        run = dispatch if dispatch is not None else (lambda fn: fn())
        order = run(lambda: cops.merge_order(tid, sid, device=device))
        dt = time.monotonic() - t0
        out_metas = _write_merged(w, tenant, table, order, inputs, cfg,
                                  stats, device=device)
        if stats is not None:
            stats["device_seconds"] += dt
    for m in inputs:
        bm.mark_block_compacted(r, w, m.block_id, tenant)
    if stats is not None:
        stats["blocks"] += len(inputs)
        stats["spans"] += int(table.num_rows)
    log.info("device-compacted %d blocks -> %d (tenant=%s spans=%d)",
             len(inputs), len(out_metas), tenant, table.num_rows)
    return out_metas


def backfill_sidecar(r: RawReader, w: RawWriter, tenant: str,
                     meta: bm.BlockMeta, stats: dict | None = None,
                     device=None) -> bool:
    """Attach a sidecar to an existing block (columnar read of just the
    four needed columns). Returns False when the block vanished
    mid-backfill (compaction races are benign — the marker never flips)."""
    try:
        pf = BackendBlock(r, meta).parquet_file()
        table = pf.read(columns=["trace_id", "service", "name",
                                 "duration_ns"])
    except Exception:
        return False
    write_sidecar_for_table(w, tenant, meta, table, stats, device=device)
    return True


def do_retention(r: RawReader, w: RawWriter, tenant: str,
                 metas: list[bm.BlockMeta], compacted: list[bm.CompactedBlockMeta],
                 cfg: CompactorConfig, now: Callable[[], float]) -> tuple[list, list]:
    """Mark over-retention live blocks compacted; delete compacted blocks
    past the grace period (`tempodb/retention.go:17-113`). Returns
    (marked_metas, deleted_block_ids)."""
    marked = []
    deleted = []
    cutoff = now() - cfg.retention_s
    for m in metas:
        if m.end_time < cutoff:
            bm.mark_block_compacted(r, w, m.block_id, tenant)
            marked.append(m)
    grace = now() - cfg.compacted_grace_s
    for c in compacted:
        if c.compacted_time < grace:
            bm.clear_block(w, c.meta.block_id, tenant)
            deleted.append(c.meta.block_id)
    return marked, deleted
