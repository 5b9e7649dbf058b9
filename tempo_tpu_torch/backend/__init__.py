"""Object-storage plane: raw interfaces and the in-memory store.

Counterpart of `tempo_tpu/backend/`. This slice of the port carries
`raw.py` (the `RawReader`/`RawWriter` interfaces and keypaths) and
`mem.py` (the in-memory store), which the user-configurable overrides
read and write through. The local, cloud and cache backends and the block
metadata come with the write side of storage (ROADMAP section 1, item 5):
their names raise `NotImplementedError` until then.
"""

from tempo_tpu_torch.backend.mem import MemBackend
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

_LATER = {
    "BlockMeta", "CacheProvider", "CachingReader", "CompactedBlockMeta",
    "DedicatedColumn", "LRUCache", "LocalBackend", "TenantIndex",
    "clear_block", "has_meta", "mark_block_compacted", "open_backend",
    "read_block_meta", "read_compacted_block_meta", "read_tenant_index",
    "write_block_meta", "write_tenant_index",
}


def __getattr__(name: str):
    if name in _LATER:
        raise NotImplementedError(
            f"tempo_tpu_torch.backend.{name} comes with the write side of "
            f"storage (ROADMAP section 1, item 5)")
    raise AttributeError(name)


__all__ = [
    "AlreadyExists", "CompactedMetaName", "DoesNotExist", "KeyPath",
    "MemBackend", "MetaName", "RawReader", "RawWriter", "TenantIndexName",
    "block_keypath", "blocks", "copy_block", "tenants",
]
