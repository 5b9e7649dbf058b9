"""Write-ahead log: per-block append-only parquet segments + replay.

Counterpart of `tempo_tpu/block/wal.py` (`tempodb/wal/wal.go:23-160` +
`vparquet4/wal_block.go`), with the same on-disk layout, so either
package's `rescan_blocks` reads the other's WAL directory: a WAL block is
a directory `<wal>/<block_id>+<tenant>+vtpu1/` of numbered parquet
segment files, each written to a dot-tmp name, fsynced, renamed into
place and its directory fsynced. Replay = `rescan_blocks`: re-read every
segment of every block dir, skipping torn files (`RescanBlocks`
`wal/wal.go:80`).

The port writes its segments with its own codec, `gzip` by default (the
reference's are `zstd`, which the port cannot read: such a segment raises
`NotImplementedError` naming the codec rather than being skipped as
torn). A block handle also keeps which segments hold each trace, so a
find reads only those.

`complete()` merges all segments into sorted (trace_id, spans) groups —
input to `writer.write_block` (WAL block → complete block,
`modules/ingester/instance.go:316` CompleteBlock).
"""

from __future__ import annotations

import os
import uuid
from typing import Iterable, Iterator

import numpy as np

from tempo_tpu_torch.block import parquet
from tempo_tpu_torch.block import schema as bs
from tempo_tpu_torch.block.reader import _rows_to_spans
from tempo_tpu_torch.utils import fsync_dir as _fsync_dir

SEGMENT_COMPRESSION = "gzip"


class WALBlock:
    def __init__(self, path: str, tenant: str, block_id: str | None = None):
        self.tenant = tenant
        self.block_id = block_id or str(uuid.uuid4())
        self.dir = os.path.join(path, f"{self.block_id}+{tenant}+{bs.VERSION}")
        created = not os.path.isdir(self.dir)
        os.makedirs(self.dir, exist_ok=True)
        if created:
            # fsync the WAL ROOT so the block dir's own dirent survives a
            # crash: a segment fsyncs itself and the block dir, but a power
            # loss right after the first append could otherwise drop the
            # block directory entry from the root
            _fsync_dir(path)
        self._next_seg = self._scan_next_seg()
        self.spans_appended = 0
        # trace id -> segment files holding it (None until first needed
        # for a handle rescanned from disk)
        self._where: dict[bytes, list[str]] | None = \
            {} if self._next_seg == 0 else None

    def _scan_next_seg(self) -> int:
        segs = [int(f.split(".")[0]) for f in os.listdir(self.dir)
                if f.endswith(".parquet") and f.split(".")[0].isdigit()]
        return max(segs, default=-1) + 1

    def append(self, spans: Iterable[dict]) -> None:
        """Durably append a batch of flat span dicts as one segment file."""
        groups = bs.spans_by_trace(spans)
        if not groups:
            return
        table = bs.traces_to_table(groups)
        data = parquet.write_table(table, compression=SEGMENT_COMPRESSION)
        name = f"{self._next_seg:07d}.parquet"
        tmp = os.path.join(self.dir, f".{self._next_seg:07d}.tmp")
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.dir, name))
        # fsync the directory so the rename itself survives power loss
        _fsync_dir(self.dir)
        self._next_seg += 1
        self.spans_appended += table.num_rows
        if self._where is not None:
            for tid, _ in groups:
                self._where.setdefault(tid.ljust(16, b"\0")[:16],
                                       []).append(name)

    def segments(self) -> list[str]:
        try:
            return sorted(f for f in os.listdir(self.dir) if f.endswith(".parquet"))
        except FileNotFoundError:
            return []  # cleared by a concurrent completion — read as empty

    def _read_segment(self, seg: str, columns=None
                      ) -> parquet.ColumnTable | None:
        """One segment's table, or None when it is torn or gone."""
        try:
            with open(os.path.join(self.dir, seg), "rb") as f:
                data = f.read()
            return parquet.ParquetFile(data).read(columns)
        except (FileNotFoundError, parquet.ParquetError):
            return None   # torn segment: skip, like RescanBlocks tolerates

    def iter_spans(self) -> Iterator[dict]:
        for seg in self.segments():
            tbl = self._read_segment(seg)
            if tbl is not None:
                yield from _rows_to_spans(tbl, np.arange(tbl.num_rows))

    def complete(self) -> list[tuple[bytes, list[dict]]]:
        """All WAL contents as sorted trace groups (spans of a trace merged
        across segments)."""
        return bs.spans_by_trace(self.iter_spans())

    def _segments_of(self, tid: bytes) -> list[str]:
        if self._where is None:
            where: dict[bytes, list[str]] = {}
            for seg in self.segments():
                tbl = self._read_segment(seg, ["trace_id"])
                if tbl is None:
                    continue
                for t in np.unique(bs.trace_ids(tbl)).tolist():
                    where.setdefault(bytes(t), []).append(seg)
            self._where = where
        return self._where.get(tid, [])

    def find_trace_by_id(self, trace_id: bytes) -> list[dict] | None:
        tid = bytes(trace_id).ljust(16, b"\0")[:16]
        out: list[dict] = []
        for seg in self._segments_of(tid):
            tbl = self._read_segment(seg)
            if tbl is None:
                continue
            rows = np.flatnonzero(bs.trace_ids(tbl) == np.void(tid))
            out.extend(_rows_to_spans(tbl, rows))
        return out or None

    def clear(self) -> None:
        for f in os.listdir(self.dir):
            try:
                os.unlink(os.path.join(self.dir, f))
            except FileNotFoundError:
                pass
        os.rmdir(self.dir)


def rescan_blocks(path: str) -> list[WALBlock]:
    """Rebuild WALBlock handles for every block dir found under `path`."""
    out = []
    if not os.path.isdir(path):
        return out
    for d in sorted(os.listdir(path)):
        parts = d.split("+")
        if len(parts) != 3 or not os.path.isdir(os.path.join(path, d)):
            continue
        block_id, tenant, _version = parts
        out.append(WALBlock(path, tenant, block_id))
    return out
