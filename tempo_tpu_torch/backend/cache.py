"""Role-keyed caching reader.

Counterpart of `tempo_tpu/backend/cache.py` (in-process host code,
copied). The shared memcached/redis tier is `backend/memcached.py`.

Analog of `tempodb/backend/cache/` + `modules/cache`: reads of hot small
objects (bloom filters, parquet footers, pages) go through a cache selected
by *role*, so operators can size bloom vs page caches independently
(`modules/cache/cache.go` roles: bloom, parquet-footer, parquet-page,
frontend-search). Here the provider maps roles to in-process LRUs; the
memcached/redis client layer of the reference collapses to this interface —
swapping in a remote client is a provider change only.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

from tempo_tpu_torch.backend.raw import KeyPath, RawReader

ROLE_BLOOM = "bloom"
ROLE_FOOTER = "parquet-footer"
ROLE_PAGE = "parquet-page"
ROLE_FRONTEND_SEARCH = "frontend-search"


class LRUCache:
    """Byte-bounded LRU; the in-process stand-in for memcached/redis
    (`pkg/cache/memcached.go` etc.)."""

    def __init__(self, max_bytes: int = 64 << 20) -> None:
        self.max_bytes = max_bytes
        self._d: OrderedDict[str, bytes] = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key: str) -> bytes | None:
        with self._lock:
            v = self._d.get(key)
            if v is None:
                self.misses += 1
                return None
            self._d.move_to_end(key)
            self.hits += 1
            return v

    def put(self, key: str, value: bytes) -> None:
        with self._lock:
            old = self._d.pop(key, None)
            if old is not None:
                self._bytes -= len(old)
            self._d[key] = value
            self._bytes += len(value)
            while self._bytes > self.max_bytes and self._d:
                _, ev = self._d.popitem(last=False)
                self._bytes -= len(ev)


class CacheProvider:
    """Role → cache mapping (`modules/cache/cache.go`)."""

    def __init__(self, caches: dict[str, LRUCache] | None = None,
                 default_bytes: int = 64 << 20) -> None:
        self._caches = caches or {}
        self._default_bytes = default_bytes

    def cache_for(self, role: str) -> LRUCache:
        c = self._caches.get(role)
        if c is None:
            c = self._caches[role] = LRUCache(self._default_bytes)
        return c


#: object-name suffix → cache role, mirroring what the reference caches
_NAME_ROLES = {
    "bloom": ROLE_BLOOM,
    "footer": ROLE_FOOTER,
}


class CachingReader(RawReader):
    """RawReader wrapper that serves bloom/footer reads and page ranges from
    role caches (`tempodb/backend/cache/cache.go`)."""

    def __init__(self, inner: RawReader, provider: CacheProvider) -> None:
        self.inner = inner
        self.provider = provider

    def _role_for(self, name: str) -> str | None:
        for suffix, role in _NAME_ROLES.items():
            if suffix in name:
                return role
        return None

    def list(self, keypath: KeyPath) -> list[str]:
        return self.inner.list(keypath)

    def find(self, keypath: KeyPath, suffix: str = "") -> list[str]:
        return self.inner.find(keypath, suffix)

    def read(self, name: str, keypath: KeyPath) -> bytes:
        role = self._role_for(name)
        if role is None:
            return self.inner.read(name, keypath)
        cache = self.provider.cache_for(role)
        key = keypath.object(name)
        v = cache.get(key)
        if v is None:
            v = self.inner.read(name, keypath)
            cache.put(key, v)
        return v

    def read_range(self, name: str, keypath: KeyPath, offset: int, length: int) -> bytes:
        cache = self.provider.cache_for(ROLE_PAGE)
        key = f"{keypath.object(name)}:{offset}:{length}"
        v = cache.get(key)
        if v is None:
            v = self.inner.read_range(name, keypath, offset, length)
            cache.put(key, v)
        return v

    def size(self, name: str, keypath: KeyPath) -> int:
        return self.inner.size(name, keypath)  # type: ignore[attr-defined]

    def shutdown(self) -> None:
        self.inner.shutdown()
