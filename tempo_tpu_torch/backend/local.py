"""Filesystem object store — analog of `tempodb/backend/local/`.

Used both as the production 'local' backend and as the WAL's completed-block
staging area. Writes go through a temp file + atomic rename so a crashed
writer never leaves a torn object (the reference relies on the filesystem for
the same guarantee).

Counterpart of `tempo_tpu/backend/local.py`, host code copied with its
imports moved to the port.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import BinaryIO

from tempo_tpu_torch.backend.raw import DoesNotExist, KeyPath, RawReader, RawWriter


class LocalBackend(RawReader, RawWriter):
    def __init__(self, path: str) -> None:
        self.path = path
        os.makedirs(path, exist_ok=True)

    # -- helpers -----------------------------------------------------------

    def _dir(self, keypath: KeyPath) -> str:
        return os.path.join(self.path, *keypath.parts)

    def _obj(self, name: str, keypath: KeyPath) -> str:
        return os.path.join(self._dir(keypath), name)

    # -- RawReader ---------------------------------------------------------

    def list(self, keypath: KeyPath) -> list[str]:
        d = self._dir(keypath)
        try:
            return sorted(e.name for e in os.scandir(d) if e.is_dir())
        except FileNotFoundError:
            return []

    def find(self, keypath: KeyPath, suffix: str = "") -> list[str]:
        root = self._dir(keypath)
        out = []
        for dirpath, _dirnames, filenames in os.walk(root):
            rel = os.path.relpath(dirpath, root)
            for f in filenames:
                if f.endswith(suffix):
                    out.append(f if rel == "." else os.path.join(rel, f))
        return sorted(out)

    def read(self, name: str, keypath: KeyPath) -> bytes:
        try:
            with open(self._obj(name, keypath), "rb") as f:
                return f.read()
        except FileNotFoundError:
            raise DoesNotExist(f"{keypath}/{name}") from None

    def read_range(self, name: str, keypath: KeyPath, offset: int, length: int) -> bytes:
        try:
            with open(self._obj(name, keypath), "rb") as f:
                f.seek(offset)
                return f.read(length)
        except FileNotFoundError:
            raise DoesNotExist(f"{keypath}/{name}") from None

    def size(self, name: str, keypath: KeyPath) -> int:
        try:
            return os.path.getsize(self._obj(name, keypath))
        except FileNotFoundError:
            raise DoesNotExist(f"{keypath}/{name}") from None

    # -- RawWriter ---------------------------------------------------------

    def write(self, name: str, keypath: KeyPath, data: bytes | BinaryIO) -> None:
        d = self._dir(keypath)
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, prefix=f".{name}.")
        try:
            with os.fdopen(fd, "wb") as f:
                if isinstance(data, (bytes, bytearray, memoryview)):
                    f.write(data)
                else:
                    shutil.copyfileobj(data, f)
            os.replace(tmp, self._obj(name, keypath))
        except BaseException:
            try:
                os.unlink(tmp)
            except FileNotFoundError:
                pass
            raise

    def delete(self, name: str, keypath: KeyPath, recursive: bool = False) -> None:
        if recursive:
            shutil.rmtree(os.path.join(self._dir(keypath), name) if name
                          else self._dir(keypath), ignore_errors=True)
            return
        try:
            os.unlink(self._obj(name, keypath))
        except FileNotFoundError:
            pass
