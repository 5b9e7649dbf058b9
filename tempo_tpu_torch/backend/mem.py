"""In-memory object store — the test double.

Counterpart of `tempo_tpu/backend/mem.py`, host code copied with its imports
moved to the port.

Plays the role of `tempodb/backend/mocks.go:24-100` (MockRawReader/Writer):
multi-node behavior is tested against this without any cluster, per the
reference's test strategy (SURVEY.md §4.2). Thread-safe; also records op
counts so tests can assert on I/O behavior (hedging, caching).
"""

from __future__ import annotations

import threading
from typing import BinaryIO

from tempo_tpu_torch.backend.raw import DoesNotExist, KeyPath, RawReader, RawWriter


class MemBackend(RawReader, RawWriter):
    def __init__(self) -> None:
        self._objects: dict[str, bytes] = {}
        self._lock = threading.Lock()
        self.reads = 0
        self.writes = 0

    def _key(self, name: str, keypath: KeyPath) -> str:
        return keypath.object(name) if keypath.parts else name

    # -- RawReader ---------------------------------------------------------

    def list(self, keypath: KeyPath) -> list[str]:
        prefix = str(keypath) + "/" if keypath.parts else ""
        out = set()
        with self._lock:
            for k in self._objects:
                if k.startswith(prefix):
                    rest = k[len(prefix):]
                    if "/" in rest:
                        out.add(rest.split("/", 1)[0])
        return sorted(out)

    def find(self, keypath: KeyPath, suffix: str = "") -> list[str]:
        prefix = str(keypath) + "/" if keypath.parts else ""
        with self._lock:
            return sorted(
                k[len(prefix):] for k in self._objects
                if k.startswith(prefix) and k.endswith(suffix)
            )

    def read(self, name: str, keypath: KeyPath) -> bytes:
        with self._lock:
            self.reads += 1
            try:
                return self._objects[self._key(name, keypath)]
            except KeyError:
                raise DoesNotExist(self._key(name, keypath)) from None

    def read_range(self, name: str, keypath: KeyPath, offset: int, length: int) -> bytes:
        return self.read(name, keypath)[offset : offset + length]

    def size(self, name: str, keypath: KeyPath) -> int:
        return len(self.read(name, keypath))

    # -- RawWriter ---------------------------------------------------------

    def write(self, name: str, keypath: KeyPath, data: bytes | BinaryIO) -> None:
        if not isinstance(data, (bytes, bytearray, memoryview)):
            data = data.read()
        with self._lock:
            self.writes += 1
            self._objects[self._key(name, keypath)] = bytes(data)

    def delete(self, name: str, keypath: KeyPath, recursive: bool = False) -> None:
        key = self._key(name, keypath) if name else str(keypath)
        with self._lock:
            if recursive:
                prefix = key + "/"
                for k in [k for k in self._objects if k.startswith(prefix) or k == key]:
                    del self._objects[k]
            else:
                self._objects.pop(key, None)
