"""BackendBlock reader: trace-by-ID over range reads.

Counterpart of `tempo_tpu/block/reader.py` (`vparquet4/
block_findtracebyid.go`). All object reads go through the RawReader: the
Parquet footer once, then byte-range reads of the column chunks of the
one row group the row-group index names. The port reads with its own
codec (`block/parquet.py`).

The columnar scan (`column_batches`) hands the port's codec columns to
`block/fetch.py` and the TraceQL engines.
"""

from __future__ import annotations

import json
import threading
from collections import OrderedDict
from typing import Iterator, Sequence

import numpy as np

from tempo_tpu_torch.backend.meta import BlockMeta
from tempo_tpu_torch.backend.raw import DoesNotExist, RawReader, block_keypath
from tempo_tpu_torch.block import parquet
from tempo_tpu_torch.block import schema as bs
from tempo_tpu_torch.block.bloom import BloomFilter, shard_name
from tempo_tpu_torch.block.writer import DATA_NAME, INDEX_NAME
from tempo_tpu_torch.obs import querystats

# decoded row groups a block keeps: PLAIN strings decode at Python speed,
# so repeated finds in one row group read it once
CACHED_ROW_GROUPS = 2


class BackendBlock:
    """One immutable block in object storage."""

    def __init__(self, r: RawReader, meta: BlockMeta):
        self.r = r
        self.meta = meta
        self.kp = block_keypath(meta.block_id, meta.tenant_id)
        self._pf: parquet.ParquetFile | None = None
        self._index: list[dict] | None = None
        self._groups: OrderedDict[int, parquet.ColumnTable] = OrderedDict()
        self._groups_lock = threading.Lock()     # finds run concurrently

    # -- plumbing ----------------------------------------------------------

    def parquet_file(self) -> parquet.ParquetFile:
        if self._pf is None:
            size = self.meta.size_bytes
            if size <= 0:
                size = self.r.size(DATA_NAME, self.kp)  # type: ignore[attr-defined]
            self._pf = parquet.ParquetFile(
                lambda off, n: self.r.read_range(DATA_NAME, self.kp, off, n),
                size)
        return self._pf

    def row_group_index(self) -> list[dict]:
        if self._index is None:
            try:
                doc = json.loads(self.r.read(INDEX_NAME, self.kp))
                self._index = doc["row_groups"]
            except DoesNotExist:
                self._index = []
        return self._index

    def read_row_group(self, rg: int) -> parquet.ColumnTable:
        """Every column of row group `rg` (kept for the next
        `CACHED_ROW_GROUPS - 1` other reads)."""
        with self._groups_lock:
            tbl = self._groups.pop(rg, None)
        if tbl is None:
            with querystats.stage("block_fetch"):
                tbl = self.parquet_file().read_row_group(rg)
        with self._groups_lock:
            self._groups[rg] = tbl
            while len(self._groups) > CACHED_ROW_GROUPS:
                self._groups.popitem(last=False)
        return tbl

    # -- trace by id (`block_findtracebyid.go`) -----------------------------

    def _bloom_maybe(self, trace_id: bytes) -> bool:
        shard = (trace_id[0] if trace_id else 0) % max(self.meta.bloom_shard_count, 1)
        try:
            bf = BloomFilter.from_bytes(self.r.read(shard_name(shard), self.kp))
        except DoesNotExist:
            return True  # no bloom → must scan
        return trace_id in bf

    def find_trace_by_id(self, trace_id: bytes) -> list[dict] | None:
        """Spans of one trace as flat dicts, or None. Bloom probe → row-group
        binary search on the index bounds → single-group read."""
        tid = bytes(trace_id).ljust(16, b"\0")[:16]
        if not self._bloom_maybe(tid):
            querystats.add(blocks_skipped=1)      # bloom prune
            return None
        hexid = tid.hex()
        pf = self.parquet_file()
        index = self.row_group_index()
        if index:
            rgs = [i for i, g in enumerate(index)
                   if g["min_trace_id"] <= hexid <= g["max_trace_id"]]
        else:
            rgs = list(range(pf.num_row_groups))  # index lost: full scan
        if not rgs:
            querystats.add(blocks_skipped=1)      # row-group bounds prune
            return None
        querystats.add(blocks_scanned=1)
        out: list[dict] = []
        for rg in rgs:
            tbl = self.read_row_group(rg)
            querystats.add(inspected_bytes=tbl.nbytes,
                           inspected_spans=tbl.num_rows)
            sel = bs.trace_ids(tbl) == np.void(tid)
            if sel.any():
                out.extend(_rows_to_spans(tbl, np.flatnonzero(sel)))
        return out or None

    # -- columnar scan -----------------------------------------------------

    def column_batches(self, columns: Sequence[str] | None = None,
                       row_groups: Sequence[int] | None = None
                       ) -> Iterator[dict]:
        """Yield {column: values} per row group (+ '_row_offset', '_rows').

        Fixed-width columns come back as numpy arrays (fixed binary as
        uint8 [n, width]); strings as `parquet.Strings` and lists as
        `parquet.Lists` (offsets plus values), where the reference hands
        out Arrow arrays. The caller picks only the columns its compiled
        conditions touch — the pushdown analog of `AllConditions`."""
        pf = self.parquet_file()
        index = self.row_group_index()
        rgs = range(pf.num_row_groups) if row_groups is None else row_groups
        for rg in rgs:
            with querystats.stage("block_fetch"):
                tbl = pf.read_row_group(
                    rg, columns=list(columns) if columns else None)
            querystats.add(inspected_bytes=tbl.nbytes)
            out: dict = {"_rows": tbl.num_rows}
            out["_row_offset"] = index[rg]["row_offset"] if rg < len(index) else None
            for name in tbl.names:
                out[name] = tbl.column(name)
            yield out

    def dedicated_column_name(self, scope: str, attr: str) -> str | None:
        for i, c in enumerate(self.meta.dedicated_columns):
            if c.scope == scope and c.name == attr:
                return bs.dedicated_field_name(scope, i)
        return None


_ATTR_COLS = {
    "attrs": (("sattr_str_keys", "sattr_str_vals"),
              ("sattr_int_keys", "sattr_int_vals"),
              ("sattr_f64_keys", "sattr_f64_vals"),
              ("sattr_bool_keys", "sattr_bool_vals")),
    "res_attrs": (("rattr_str_keys", "rattr_str_vals"),
                  ("rattr_int_keys", "rattr_int_vals"),
                  ("rattr_f64_keys", "rattr_f64_vals"),
                  ("rattr_bool_keys", "rattr_bool_vals")),
}


def _rows_to_spans(tbl: parquet.ColumnTable, rows: np.ndarray) -> list[dict]:
    """Materialize selected rows back into flat span dicts (find-by-id
    path), as the reference's `_rows_to_spans` does."""
    sub = tbl.take(rows) if len(rows) != tbl.num_rows else tbl
    col = {n: parquet.column_pylist(sub.column(n)) for n in (
        "trace_id", "span_id", "parent_span_id", "name", "service", "kind",
        "status_code", "status_message", "start_unix_nano", "duration_ns",
        "event_times", "event_names", "link_trace_ids", "link_span_ids",
        *(c for pairs in _ATTR_COLS.values() for pair in pairs for c in pair))}
    out = []
    for r in range(len(rows)):
        maps = {}
        for field, pairs in _ATTR_COLS.items():
            m: dict = {}
            for kcol, vcol in pairs:
                m.update(zip(col[kcol][r], col[vcol][r]))
            maps[field] = m
        start = col["start_unix_nano"][r]
        out.append({
            "trace_id": col["trace_id"][r],
            "span_id": col["span_id"][r],
            "parent_span_id": col["parent_span_id"][r],
            "name": col["name"][r],
            "service": col["service"][r],
            "kind": col["kind"][r],
            "status_code": col["status_code"][r],
            "status_message": col["status_message"][r],
            "start_unix_nano": start,
            "end_unix_nano": start + col["duration_ns"][r],
            "attrs": maps["attrs"],
            "res_attrs": maps["res_attrs"],
            "events": [{"time_unix_nano": t, "name": n} for t, n in
                       zip(col["event_times"][r], col["event_names"][r])],
            "links": [{"trace_id": t, "span_id": s} for t, s in
                      zip(col["link_trace_ids"][r], col["link_span_ids"][r])],
        })
    return out
