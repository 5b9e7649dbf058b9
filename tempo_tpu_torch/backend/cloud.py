"""Cloud object-store backend factory: S3 / GCS / Azure.

The reference ships full impls (`tempodb/backend/{s3,gcs,azure}/`). Here,
all SDK-free:

- **s3**: SigV4 client (`backend/s3.py`) against any S3-compatible
  endpoint (AWS, MinIO, Ceph RGW, the test mock).
- **gcs**: the same client via GCS's S3-interoperability XML API
  (`storage.googleapis.com` + HMAC keys).
- **azure**: SharedKey Blob client (`backend/azure.py`) against Azure or
  Azurite, signature-verified by the test mock.

Counterpart of `tempo_tpu/backend/cloud.py`, copied with its imports
moved to the port; `ResilientBackend` consults the port's fault points
(`tempo_tpu_torch.utils.faults`).
"""

from __future__ import annotations

import logging
import random
import time
import urllib.error

from tempo_tpu_torch.backend.raw import (AlreadyExists, DoesNotExist, RawReader,
                                   RawWriter)
from tempo_tpu_torch.utils import faults

_LOG = logging.getLogger("tempo_tpu_torch_torch.backend")


def open_backend(kind: str, op_timeout_s: float = 30.0, **config: object):
    """Backend factory keyed by config string — `tempodb/backend` dispatch.

    `op_timeout_s` bounds every cloud op at the socket (an unresponsive
    endpoint fails the op instead of wedging a flush/checkpoint thread);
    an explicit `timeout_s` in the cloud config wins."""
    if kind == "local":
        from tempo_tpu_torch.backend.local import LocalBackend

        return LocalBackend(str(config.get("path", "/tmp/tempo_tpu/blocks")))
    if kind in ("mem", "memory"):
        from tempo_tpu_torch.backend.mem import MemBackend

        return MemBackend()
    if kind == "s3":
        from tempo_tpu_torch.backend.s3 import S3Backend

        config.setdefault("timeout_s", op_timeout_s)
        return S3Backend(**config)
    if kind == "gcs":
        from tempo_tpu_torch.backend.s3 import S3Backend

        config.setdefault("endpoint", "storage.googleapis.com")
        config.setdefault("timeout_s", op_timeout_s)
        return S3Backend(**config)
    if kind == "azure":
        from tempo_tpu_torch.backend.azure import AzureBackend

        config.setdefault("timeout_s", op_timeout_s)
        return AzureBackend(**config)
    raise ValueError(f"unknown backend {kind!r} (want local|mem|s3|gcs|azure)")


# transient failure classes worth retrying: transport/storage errors.
# DoesNotExist/AlreadyExists are KeyError subclasses — semantic results,
# never retried (and never faulted into existence by the wrapper).
_TRANSIENT = (OSError, TimeoutError, urllib.error.URLError)


class ResilientBackend(RawReader, RawWriter):
    """Fault-point + retry wrapper around any RawReader/RawWriter.

    Every op consults the `backend.read` / `backend.write` fault points
    (zero cost disarmed — one module-flag check) and retries transient
    failures with bounded jittered exponential backoff. Non-transient
    results (missing/duplicate keys, value errors) pass straight
    through. Unwrapped attributes (e.g. LocalBackend.size) forward to
    the inner backend."""

    def __init__(self, inner, retries: int = 2,
                 backoff_s: float = 0.1) -> None:
        self.inner = inner
        self.retries = max(0, int(retries))
        self.backoff_s = backoff_s

    def _op(self, point: str, fn, *args, **kw):
        delay = self.backoff_s
        for attempt in range(self.retries + 1):
            try:
                if faults.ARMED:
                    faults.fire(point)
                return fn(*args, **kw)
            except (DoesNotExist, AlreadyExists):
                raise
            except _TRANSIENT as e:
                if attempt >= self.retries:
                    raise
                _LOG.warning("backend %s retry %d/%d after %s: %s",
                             point, attempt + 1, self.retries,
                             type(e).__name__, e)
                time.sleep(delay * (0.5 + random.random()))
                delay = min(delay * 2, 5.0)

    # -- reads -------------------------------------------------------------

    def list(self, keypath):
        return self._op("backend.read", self.inner.list, keypath)

    def read(self, name, keypath):
        return self._op("backend.read", self.inner.read, name, keypath)

    def read_range(self, name, keypath, offset, length):
        return self._op("backend.read", self.inner.read_range, name,
                        keypath, offset, length)

    def find(self, keypath, suffix=""):
        return self._op("backend.read", self.inner.find, keypath, suffix)

    # -- writes ------------------------------------------------------------

    def write(self, name, keypath, data):
        # stream bodies can't replay after a partial send: one attempt
        if not isinstance(data, (bytes, bytearray, memoryview)):
            if faults.ARMED:
                faults.fire("backend.write")
            return self.inner.write(name, keypath, data)
        return self._op("backend.write", self.inner.write, name, keypath,
                        data)

    def delete(self, name, keypath, recursive=False):
        return self._op("backend.write", self.inner.delete, name, keypath,
                        recursive)

    def append(self, name, keypath, tracker, data):
        # appends are positional: a blind retry could double-write, so
        # the fault point fires but failures surface to the caller
        if faults.ARMED:
            faults.fire("backend.write")
        return self.inner.append(name, keypath, tracker, data)

    def close_append(self, name, keypath, tracker):
        return self.inner.close_append(name, keypath, tracker)

    def shutdown(self) -> None:
        self.inner.shutdown()

    def __getattr__(self, name):
        return getattr(self.inner, name)
