"""Block writer: column table → parquet + bloom + row-group index + meta.

Counterpart of `tempo_tpu/block/writer.py` (the create path of
`tempodb/encoding/vparquet4/create.go`): one sorted `data.parquet` per
block plus `meta.json`, sharded `bloom-*`, and `index.json` (per-row-group
trace-id bounds for trace-by-ID and ranged scans).

The Parquet file comes from the port's own codec (`block/parquet.py`):
PLAIN `DataPage` V1 pages, `gzip` by default (the reference writes
`zstd`, which the standard library cannot), no column statistics.
`meta.encoding` records the codec written.
"""

from __future__ import annotations

import json
from typing import Iterable, Sequence

import numpy as np

from tempo_tpu_torch.backend.meta import BlockMeta, DedicatedColumn, write_block_meta
from tempo_tpu_torch.backend.raw import RawWriter, block_keypath
from tempo_tpu_torch.block import parquet
from tempo_tpu_torch.block import schema as bs
from tempo_tpu_torch.block.bloom import ShardedBloom, shard_name

DATA_NAME = "data.parquet"
INDEX_NAME = "index.json"

DEFAULT_ROW_GROUP_ROWS = 50_000
DEFAULT_BLOOM_FPP = 0.01
DEFAULT_COMPRESSION = "gzip"


def write_block(
    w: RawWriter,
    tenant: str,
    traces: Iterable[tuple[bytes, list[dict]]],
    *,
    block_id: str | None = None,
    dedicated_columns: Sequence[DedicatedColumn] = (),
    row_group_rows: int = DEFAULT_ROW_GROUP_ROWS,
    bloom_fpp: float = DEFAULT_BLOOM_FPP,
    bloom_shard_count: int = 1,
    replication_factor: int = 3,
    compaction_level: int = 0,
    compression: str = DEFAULT_COMPRESSION,
) -> BlockMeta:
    """Write one complete block from pre-sorted (trace_id, spans) groups."""
    traces = list(traces)
    table = bs.traces_to_table(traces, dedicated_columns)
    return write_block_from_table(
        w, tenant, table, [tid for tid, _ in traces],
        block_id=block_id, dedicated_columns=dedicated_columns,
        row_group_rows=row_group_rows, bloom_fpp=bloom_fpp,
        bloom_shard_count=bloom_shard_count,
        replication_factor=replication_factor,
        compaction_level=compaction_level, compression=compression)


def _trace_aligned_slices(table: parquet.ColumnTable,
                          target_rows: int) -> list[tuple[int, int]]:
    """Row ranges for row groups: >= target_rows each but never splitting a
    trace (trace_idx runs are kept whole)."""
    n = table.num_rows
    if n == 0:
        return []
    tidx = table.column("trace_idx")
    # first row of each trace
    starts = np.flatnonzero(np.diff(tidx, prepend=tidx[0] - 1))
    out = []
    lo = 0
    while lo < n:
        want = lo + target_rows
        if want >= n:
            out.append((lo, n))
            break
        # next trace boundary at or after `want`
        j = int(np.searchsorted(starts, want, side="left"))
        hi = int(starts[j]) if j < len(starts) else n
        if hi <= lo:
            hi = n
        out.append((lo, hi))
        lo = hi
    return out


def write_block_from_table(
    w: RawWriter,
    tenant: str,
    table: parquet.ColumnTable,
    trace_ids: list[bytes],
    *,
    block_id: str | None = None,
    dedicated_columns: Sequence[DedicatedColumn] = (),
    row_group_rows: int = DEFAULT_ROW_GROUP_ROWS,
    bloom_fpp: float = DEFAULT_BLOOM_FPP,
    bloom_shard_count: int = 1,
    replication_factor: int = 3,
    compaction_level: int = 0,
    compression: str = DEFAULT_COMPRESSION,
) -> BlockMeta:
    parquet.codec_id(compression)       # an unwritable codec raises first
    meta = BlockMeta.new(
        tenant, block_id,
        version=bs.VERSION,
        encoding=compression,
        replication_factor=replication_factor,
        compaction_level=compaction_level,
        dedicated_columns=list(dedicated_columns),
        bloom_shard_count=bloom_shard_count,
    )
    kp = block_keypath(meta.block_id, tenant)

    # data.parquet — row groups are cut at TRACE boundaries so every scan
    # batch holds whole traces.
    slices = _trace_aligned_slices(table, max(row_group_rows, 1))
    data = parquet.write_table(table, compression=compression,
                               row_groups=slices)
    w.write(DATA_NAME, kp, data)

    # row-group index: trace-id bounds + row offsets per row group.
    tid = table.column("trace_id")
    groups = [{
        "row_offset": lo,
        "rows": hi - lo,
        "min_trace_id": tid[lo].tobytes().hex(),
        "max_trace_id": tid[hi - 1].tobytes().hex(),
    } for lo, hi in slices]
    w.write(INDEX_NAME, kp, json.dumps({"row_groups": groups}).encode())

    # bloom shards
    bloom = ShardedBloom(bloom_shard_count, max(len(trace_ids), 1), bloom_fpp)
    for t in trace_ids:
        bloom.add(bytes(t).ljust(16, b"\0")[:16])
    for i in range(bloom.shard_count):
        w.write(shard_name(i), kp, bloom.shard_bytes(i))

    if groups:
        meta.min_trace_id = groups[0]["min_trace_id"]
        meta.max_trace_id = groups[-1]["max_trace_id"]
    stats = bs.table_stats(table)
    meta.total_spans = stats["total_spans"]
    meta.total_objects = stats["total_objects"]
    meta.start_time = stats["start_time"]
    meta.end_time = stats["end_time"]
    meta.size_bytes = len(data)
    meta.row_group_count = len(slices)
    meta.footer_size = int.from_bytes(data[-8:-4], "little") if len(data) >= 8 else 0
    write_block_meta(w, meta)
    return meta
