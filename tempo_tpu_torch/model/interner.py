"""String interning: the host-side dictionary for device-coded attributes.

Strings never reach the device. Every attribute key/value, span name and
service name is interned to a dense int32 id on the host; device code
sees only id columns. This is the pure-Python id table; the C++ table of
the reference (`tempo_tpu/native/`) comes with a later slice.
"""

from __future__ import annotations

import threading
from typing import Iterable

import numpy as np

INVALID_ID = -1


class StringInterner:
    """Append-only str→int32 table with reverse lookup. Thread-safe."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._ids: dict[str, int] = {}
        self._strs: list[str] = []

    def __len__(self) -> int:
        return len(self._strs)

    def intern(self, s: str) -> int:
        sid = self._ids.get(s)
        if sid is not None:
            return sid
        with self._lock:
            sid = self._ids.get(s)
            if sid is None:
                sid = len(self._strs)
                self._strs.append(s)
                self._ids[s] = sid
            return sid

    def intern_many(self, strs: Iterable[str]) -> np.ndarray:
        return np.fromiter((self.intern(s) for s in strs), dtype=np.int32)

    def get(self, s: str) -> int:
        """Lookup without inserting; INVALID_ID when absent."""
        return self._ids.get(s, INVALID_ID)

    def lookup(self, sid: int) -> str:
        return self._strs[sid]

    def lookup_many(self, ids: np.ndarray) -> list[str]:
        strs = self._strs
        return [strs[i] if i >= 0 else "" for i in np.asarray(ids).tolist()]

    def snapshot(self) -> list[str]:
        with self._lock:
            return list(self._strs)
