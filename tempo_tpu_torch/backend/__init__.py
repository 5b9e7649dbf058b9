"""Object-storage plane: raw interfaces, local/mem/cloud impls, block meta,
tenant index, role-keyed caching.

Counterpart of `tempo_tpu/backend/`, with the same exports: `raw.py` (the
`RawReader`/`RawWriter` interfaces and keypaths), `mem.py` and `local.py`
(the in-memory and filesystem stores), `meta.py` (block metadata and the
tenant index), `cache.py` (role-keyed in-process caches) and
`memcached.py` (the shared memcached/redis tier), and the cloud backends
behind `open_backend` (`cloud.py`: `s3.py`'s SigV4 client for S3 and GCS,
`azure.py`'s SharedKey client), all host code over the standard library.
"""

from tempo_tpu_torch.backend.cache import CacheProvider, CachingReader, LRUCache
from tempo_tpu_torch.backend.cloud import open_backend
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

__all__ = [
    "AlreadyExists", "BlockMeta", "CacheProvider", "CachingReader",
    "CompactedBlockMeta", "CompactedMetaName", "DedicatedColumn",
    "DoesNotExist", "KeyPath", "LRUCache", "LocalBackend", "MemBackend",
    "MetaName", "RawReader", "RawWriter", "TenantIndex", "TenantIndexName",
    "block_keypath", "blocks", "clear_block", "copy_block", "has_meta",
    "mark_block_compacted", "open_backend", "read_block_meta",
    "read_compacted_block_meta", "read_tenant_index", "tenants",
    "write_block_meta", "write_tenant_index",
]
