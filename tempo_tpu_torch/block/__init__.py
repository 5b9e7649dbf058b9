"""Block encoding plane: columnar (parquet) blocks, bloom filters, WAL.

Counterpart of `tempo_tpu/block/`: the port's own Parquet codec
(`parquet.py`), the block schema, bloom filters, the block writer,
trace-by-ID reads, the WAL, the columnar TraceQL fetch (`fetch.py`) and
the device scan plane (`device_scan.py`) and the sketch sidecar
(`sidecar.py`).
"""

from tempo_tpu_torch.block.bloom import BloomFilter, ShardedBloom, shard_name
from tempo_tpu_torch.block.reader import BackendBlock
from tempo_tpu_torch.block.schema import (
    VERSION,
    block_schema,
    nested_set,
    spans_by_trace,
    traces_to_table,
)
from tempo_tpu_torch.block.wal import WALBlock, rescan_blocks
from tempo_tpu_torch.block.writer import DATA_NAME, INDEX_NAME, write_block

__all__ = [
    "BackendBlock", "BloomFilter", "DATA_NAME", "INDEX_NAME", "ShardedBloom",
    "VERSION", "WALBlock", "block_schema", "nested_set", "rescan_blocks",
    "shard_name", "spans_by_trace", "traces_to_table", "write_block",
]
