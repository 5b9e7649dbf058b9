"""String interning: the host-side dictionary for device-coded attributes.

Strings never reach the device. Every attribute key/value, span name and
service name is interned to a dense int32 id on the host; device code
sees only id columns.

Counterpart of `tempo_tpu/model/interner.py` with its native table: the
ids live in the C++ table of `tempo_tpu_torch.native` (`Interner` in
native.cpp), so the OTLP staging pass (`native.otlp_stage`) interns
every wire string without crossing back into Python. This class fronts
the C++ table with a str-keyed cache and an id → str mirror that learns
the ids C++ created at `sync()` (a lookup past the mirror syncs first).
Raw wire bytes that are not valid UTF-8 are interned as they are in C++
and mirrored here with replacement characters: two such byte strings
that decode alike keep distinct ids.
"""

from __future__ import annotations

import threading
from typing import Iterable

import numpy as np

from tempo_tpu_torch import native

INVALID_ID = -1


class StringInterner:
    """Append-only str→int32 table with reverse lookup. Thread-safe."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._ids: dict[str, int] = {}
        self._strs: list[str] = []
        self._native = native.NativeInterner()

    def __len__(self) -> int:
        return self._native.count()

    def _sync_locked(self) -> None:
        """Pull strings interned C++-side (otlp_stage) into the mirror."""
        cnt = self._native.count()
        first = len(self._strs)
        if cnt > first:
            for b in self._native.dump(first, cnt - first):
                s = b.decode("utf-8", "replace")
                self._ids.setdefault(s, len(self._strs))
                self._strs.append(s)

    def sync(self) -> None:
        with self._lock:
            self._sync_locked()

    def intern(self, s: str) -> int:
        sid = self._ids.get(s)
        if sid is not None:
            return sid
        sid = self._native.intern_bytes(s.encode("utf-8", "surrogatepass"))
        with self._lock:
            self._sync_locked()
            # a cache hit for this exact str even when the mirror's decode
            # of its bytes differs (surrogates)
            self._ids.setdefault(s, sid)
        return sid

    def intern_many(self, strs: Iterable[str]) -> np.ndarray:
        return np.fromiter((self.intern(s) for s in strs), dtype=np.int32)

    def get(self, s: str) -> int:
        """Lookup without inserting; INVALID_ID when absent."""
        sid = self._ids.get(s)
        if sid is not None:
            return sid
        return self._native.find_bytes(s.encode("utf-8", "surrogatepass"))

    def lookup(self, sid: int) -> str:
        if sid >= len(self._strs):
            self.sync()
        return self._strs[sid]

    def lookup_many(self, ids: np.ndarray) -> list[str]:
        ids = np.asarray(ids)
        if ids.size and int(ids.max()) >= len(self._strs):
            self.sync()
        strs = self._strs
        return [strs[i] if i >= 0 else "" for i in ids.tolist()]

    def snapshot(self) -> list[str]:
        with self._lock:
            self._sync_locked()
            return list(self._strs)

    def native_handle(self) -> "native.NativeInterner":
        """The NativeInterner behind this table (staging interns wire
        strings through it without crossing into Python)."""
        return self._native
