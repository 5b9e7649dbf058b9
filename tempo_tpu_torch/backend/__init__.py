"""Object-storage plane: raw interfaces and the in-memory store.

Counterpart of `tempo_tpu/backend/`. The port carries `raw.py` (the
`RawReader`/`RawWriter` interfaces and keypaths), `mem.py` (the in-memory
store), `local.py` (the filesystem store the ingesters write their blocks
to), `meta.py` (block metadata and the tenant index) and `cache.py` (the
role-keyed in-process caches the query frontend's job cache uses). The
cloud backends come with the rest of the storage layer (ROADMAP section
1, item 5b): `open_backend` raises `NotImplementedError` until then.
"""

from tempo_tpu_torch.backend.cache import CacheProvider, CachingReader, LRUCache
from tempo_tpu_torch.backend.local import LocalBackend
from tempo_tpu_torch.backend.mem import MemBackend
from tempo_tpu_torch.backend.meta import (
    BlockMeta,
    CompactedBlockMeta,
    DedicatedColumn,
    TenantIndex,
    clear_block,
    has_meta,
    mark_block_compacted,
    read_block_meta,
    read_compacted_block_meta,
    read_tenant_index,
    write_block_meta,
    write_tenant_index,
)
from tempo_tpu_torch.backend.raw import (
    AlreadyExists,
    CompactedMetaName,
    DoesNotExist,
    KeyPath,
    MetaName,
    RawReader,
    RawWriter,
    TenantIndexName,
    block_keypath,
    blocks,
    copy_block,
    tenants,
)

_LATER = {"open_backend"}


def __getattr__(name: str):
    if name in _LATER:
        raise NotImplementedError(
            f"tempo_tpu_torch.backend.{name} comes with the rest of the "
            f"storage layer (ROADMAP section 1, item 5b)")
    raise AttributeError(name)


__all__ = [
    "AlreadyExists", "BlockMeta", "CacheProvider", "CachingReader",
    "CompactedBlockMeta", "CompactedMetaName", "DedicatedColumn",
    "DoesNotExist", "KeyPath", "LRUCache", "LocalBackend", "MemBackend",
    "MetaName", "RawReader", "RawWriter", "TenantIndex", "TenantIndexName", "block_keypath", "blocks", "clear_block",
    "copy_block", "has_meta", "mark_block_compacted", "read_block_meta",
    "read_compacted_block_meta", "read_tenant_index", "tenants",
    "write_block_meta", "write_tenant_index",
]
