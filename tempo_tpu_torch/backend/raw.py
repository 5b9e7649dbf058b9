"""Raw object-store abstraction.

Counterpart of `tempo_tpu/backend/raw.py`, host code copied with its imports
moved to the port.

The storage plane of the framework: every block, tenant index, and override
document lives in an object store behind these two small interfaces — the
analog of the reference's `RawReader`/`RawWriter` (`tempodb/backend/raw.go:46,58`)
with the same keypath layout:

    <tenant>/<block id>/<object name>          block objects
    <tenant>/index.json.gz                     tenant index (see meta.py)
    <tenant>/<block id>/meta.json              block meta
    <tenant>/<block id>/meta.compacted.json    compacted marker

Implementations: `local` (filesystem), `mem` (in-memory, the test mock per
`tempodb/backend/mocks.go:24-100`), and gated `s3/gcs/azure` stubs. All are
CPU-side I/O; device code never touches this layer.
"""

from __future__ import annotations

import abc
import dataclasses
import io
from typing import BinaryIO, Iterable

MetaName = "meta.json"
CompactedMetaName = "meta.compacted.json"
TenantIndexName = "index.json.gz"


class DoesNotExist(KeyError):
    """Object not found — analog of `backend.ErrDoesNotExist`."""


class AlreadyExists(KeyError):
    """Object exists and overwrite is not allowed."""


@dataclasses.dataclass(frozen=True)
class KeyPath:
    """A path inside the object store, rooted at the tenant."""

    parts: tuple[str, ...]

    def __str__(self) -> str:
        return "/".join(self.parts)

    @staticmethod
    def for_block(block_id: str, tenant: str) -> "KeyPath":
        return KeyPath((tenant, block_id))

    def object(self, name: str) -> str:
        return "/".join(self.parts + (name,))


class RawReader(abc.ABC):
    """Read side of the object store (`raw.go:46-56`)."""

    @abc.abstractmethod
    def list(self, keypath: KeyPath) -> list[str]:
        """Immediate child 'directories' under keypath (e.g. tenants, blocks)."""

    @abc.abstractmethod
    def read(self, name: str, keypath: KeyPath) -> bytes:
        """Full object contents. Raises DoesNotExist."""

    @abc.abstractmethod
    def read_range(self, name: str, keypath: KeyPath, offset: int, length: int) -> bytes:
        """Byte-range read — the parquet-footer/page path."""

    def find(self, keypath: KeyPath, suffix: str = "") -> list[str]:
        """Recursive listing of object names under keypath ending in suffix
        (`raw.go` Find; used by the poller for meta discovery)."""
        raise NotImplementedError

    def shutdown(self) -> None:  # noqa: B027
        """Release clients/sockets."""


class RawWriter(abc.ABC):
    """Write side of the object store (`raw.go:58-70`)."""

    @abc.abstractmethod
    def write(self, name: str, keypath: KeyPath, data: bytes | BinaryIO) -> None:
        ...

    @abc.abstractmethod
    def delete(self, name: str, keypath: KeyPath, recursive: bool = False) -> None:
        ...

    def append(self, name: str, keypath: KeyPath, tracker: object, data: bytes) -> object:
        """Streaming append; returns an opaque tracker threaded through calls
        (`raw.go` Append/CloseAppend). Default: buffer in memory."""
        buf = tracker if isinstance(tracker, io.BytesIO) else io.BytesIO()
        buf.write(data)
        return buf

    def close_append(self, name: str, keypath: KeyPath, tracker: object) -> None:
        if tracker is None:
            return
        assert isinstance(tracker, io.BytesIO)
        self.write(name, keypath, tracker.getvalue())


def block_keypath(block_id: str, tenant: str) -> KeyPath:
    return KeyPath.for_block(block_id, tenant)


# top-level store directories that are NOT tenants: the fleet's
# checkpoint prefix shares the backend root with tenant block dirs (a
# custom fleet.checkpoint_prefix registers itself here at App build) —
# without this filter every store poller would treat the prefix as a
# tenant and index-builders would write into it
RESERVED_ROOTS: set[str] = {"fleet-checkpoints"}


def tenants(r: RawReader) -> list[str]:
    """Tenant enumeration = top-level listing (`tempodb/backend/backend.go` Tenants)."""
    return [t for t in r.list(KeyPath(())) if t not in RESERVED_ROOTS]


def blocks(r: RawReader, tenant: str) -> list[str]:
    return r.list(KeyPath((tenant,)))


def copy_block(src: RawReader, dst: RawWriter, block_id: str, tenant: str,
               names: Iterable[str]) -> None:
    kp = block_keypath(block_id, tenant)
    for name in names:
        dst.write(name, kp, src.read(name, kp))
