"""Block metadata and the per-tenant index.

Analog of `tempodb/backend/block_meta.go` (BlockMeta/CompactedBlockMeta) and
`tempodb/backend/tenantindex.go` (the gzipped per-tenant index the poller
builds so non-builders can cheaply learn the blocklist).

BlockMeta fields mirror the reference's: id, tenant, version, encoding,
span/trace counts, byte size, time range, compaction level, dedicated
columns, replication factor (RF1 marks generator localblocks — filtered at
the frontend per `modules/frontend/frontend.go:357-375`), plus bloom shard
count and footer size for range reads.

Counterpart of `tempo_tpu/backend/meta.py`, host code copied with its
imports moved to the port.
"""

from __future__ import annotations

import dataclasses
import gzip
import json
import time
import uuid
from typing import Any

from tempo_tpu_torch.backend.raw import (
    CompactedMetaName,
    DoesNotExist,
    KeyPath,
    MetaName,
    RawReader,
    RawWriter,
    TenantIndexName,
    block_keypath,
)

DEFAULT_REPLICATION_FACTOR = 3
METRICS_GENERATOR_REPLICATION_FACTOR = 1


@dataclasses.dataclass
class DedicatedColumn:
    """One dynamically-assigned dedicated attribute column
    (`tempodb/backend/block_meta.go` DedicatedColumn / vparquet4
    `dedicated_columns.go`): scope 'span'|'resource', attr name, type."""

    scope: str
    name: str
    type: str = "string"

    def to_json(self) -> dict[str, str]:
        return {"scope": self.scope, "name": self.name, "type": self.type}

    @staticmethod
    def from_json(d: dict[str, str]) -> "DedicatedColumn":
        return DedicatedColumn(d["scope"], d["name"], d.get("type", "string"))


@dataclasses.dataclass
class BlockMeta:
    block_id: str
    tenant_id: str
    version: str = "vtpu1"
    encoding: str = "zstd"
    start_time: float = 0.0            # unix seconds, min span start
    end_time: float = 0.0              # unix seconds, max span end
    total_objects: int = 0             # traces
    total_spans: int = 0
    size_bytes: int = 0
    row_group_count: int = 0           # parquet row groups (job sharding)
    compaction_level: int = 0
    bloom_shard_count: int = 1
    footer_size: int = 0
    replication_factor: int = DEFAULT_REPLICATION_FACTOR
    dedicated_columns: list[DedicatedColumn] = dataclasses.field(default_factory=list)
    min_trace_id: str = ""             # hex; trace-id shard pruning (includeBlock)
    max_trace_id: str = ""
    # a sketch sidecar (block/sidecar.py) sits next to the block — the
    # poller-visible marker the historical fold path keys off; absent in
    # pre-sidecar metas (from_json drops unknown keys both ways)
    sidecar: bool = False

    @staticmethod
    def new(tenant: str, block_id: str | None = None, **kw: Any) -> "BlockMeta":
        return BlockMeta(block_id=block_id or str(uuid.uuid4()), tenant_id=tenant, **kw)

    def to_json(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["dedicated_columns"] = [c.to_json() for c in self.dedicated_columns]
        return d

    @staticmethod
    def from_json(d: dict[str, Any]) -> "BlockMeta":
        d = dict(d)
        d["dedicated_columns"] = [DedicatedColumn.from_json(c)
                                  for c in d.get("dedicated_columns", [])]
        known = {f.name for f in dataclasses.fields(BlockMeta)}
        return BlockMeta(**{k: v for k, v in d.items() if k in known})


@dataclasses.dataclass
class CompactedBlockMeta:
    """Marker written when a block is superseded by compaction; the block
    stays readable until retention deletes it after a grace period
    (`tempodb/retention.go:35`)."""

    meta: BlockMeta
    compacted_time: float

    def to_json(self) -> dict[str, Any]:
        return {"meta": self.meta.to_json(), "compacted_time": self.compacted_time}

    @staticmethod
    def from_json(d: dict[str, Any]) -> "CompactedBlockMeta":
        return CompactedBlockMeta(BlockMeta.from_json(d["meta"]), d["compacted_time"])


@dataclasses.dataclass
class TenantIndex:
    """The gzipped blocklist snapshot one elected poller builds per tenant
    (`tendantindex.go`; election at `blocklist/poller.go:485`)."""

    created_at: float
    metas: list[BlockMeta]
    compacted: list[CompactedBlockMeta]

    def to_bytes(self) -> bytes:
        doc = {
            "created_at": self.created_at,
            "meta": [m.to_json() for m in self.metas],
            "compacted": [c.to_json() for c in self.compacted],
        }
        return gzip.compress(json.dumps(doc).encode())

    @staticmethod
    def from_bytes(b: bytes) -> "TenantIndex":
        doc = json.loads(gzip.decompress(b))
        return TenantIndex(
            created_at=doc.get("created_at", 0.0),
            metas=[BlockMeta.from_json(m) for m in doc.get("meta", [])],
            compacted=[CompactedBlockMeta.from_json(c) for c in doc.get("compacted", [])],
        )


# ---------------------------------------------------------------------------
# Typed meta I/O over a raw backend (`tempodb/backend/backend.go:42-100`)
# ---------------------------------------------------------------------------

def write_block_meta(w: RawWriter, meta: BlockMeta) -> None:
    w.write(MetaName, block_keypath(meta.block_id, meta.tenant_id),
            json.dumps(meta.to_json()).encode())


def read_block_meta(r: RawReader, block_id: str, tenant: str) -> BlockMeta:
    return BlockMeta.from_json(json.loads(r.read(MetaName, block_keypath(block_id, tenant))))


def mark_block_compacted(r: RawReader, w: RawWriter, block_id: str, tenant: str) -> None:
    """Rename meta.json → meta.compacted.json (`backend.go` Compactor impl)."""
    kp = block_keypath(block_id, tenant)
    meta = read_block_meta(r, block_id, tenant)
    cm = CompactedBlockMeta(meta, compacted_time=time.time())
    w.write(CompactedMetaName, kp, json.dumps(cm.to_json()).encode())
    w.delete(MetaName, kp)


def read_compacted_block_meta(r: RawReader, block_id: str, tenant: str) -> CompactedBlockMeta:
    kp = block_keypath(block_id, tenant)
    return CompactedBlockMeta.from_json(json.loads(r.read(CompactedMetaName, kp)))


def clear_block(w: RawWriter, block_id: str, tenant: str) -> None:
    w.delete(block_id, KeyPath((tenant,)), recursive=True)


def write_tenant_index(w: RawWriter, tenant: str, metas: list[BlockMeta],
                       compacted: list[CompactedBlockMeta]) -> None:
    idx = TenantIndex(created_at=time.time(), metas=metas, compacted=compacted)
    w.write(TenantIndexName, KeyPath((tenant,)), idx.to_bytes())


def read_tenant_index(r: RawReader, tenant: str) -> TenantIndex:
    return TenantIndex.from_bytes(r.read(TenantIndexName, KeyPath((tenant,))))


def has_meta(r: RawReader, block_id: str, tenant: str) -> tuple[bool, bool]:
    """(has live meta, has compacted meta) — poller classification."""
    live = compacted = False
    try:
        r.read(MetaName, block_keypath(block_id, tenant))
        live = True
    except DoesNotExist:
        pass
    try:
        r.read(CompactedMetaName, block_keypath(block_id, tenant))
        compacted = True
    except DoesNotExist:
        pass
    return live, compacted
