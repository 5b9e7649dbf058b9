"""Azure Blob Storage backend — SDK-free SharedKey client.

The reference's `tempodb/backend/azure/` rides the Azure SDK; this is a
from-scratch client the way `backend/s3.py` hand-rolls SigV4: the Blob
REST API subset RawReader/RawWriter needs (Put/Get/Delete Blob, Range
reads, List Blobs with prefix/delimiter/marker), authenticated with the
SharedKey scheme (HMAC-SHA256 over the canonicalized request, Authorization:
`SharedKey account:signature`). Works against real Azure or Azurite — the
test suite verifies signatures with an independent mock, like the S3 one.

Counterpart of `tempo_tpu/backend/azure.py` (host code, standard
library only), copied with its imports moved to the port.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import urllib.error
import urllib.parse
import urllib.request
import xml.etree.ElementTree as ET
from email.utils import formatdate
from typing import BinaryIO

from tempo_tpu_torch.backend.raw import DoesNotExist, KeyPath, RawReader, RawWriter

API_VERSION = "2021-08-06"


class SharedKeySigner:
    """Authorization: SharedKey over the Blob canonicalized request."""

    def __init__(self, account: str, key_b64: str) -> None:
        self.account = account
        self.key = base64.b64decode(key_b64) if key_b64 else b""

    def sign(self, method: str, url: str,
             headers: dict[str, str], content_length: int) -> dict[str, str]:
        h = {k.lower(): v for k, v in headers.items()}
        h.setdefault("x-ms-date", formatdate(usegmt=True))
        h.setdefault("x-ms-version", API_VERSION)
        parsed = urllib.parse.urlsplit(url)
        canon_headers = "".join(
            f"{k}:{h[k]}\n" for k in sorted(k for k in h
                                            if k.startswith("x-ms-")))
        canon_resource = f"/{self.account}{parsed.path}"
        if parsed.query:
            q = urllib.parse.parse_qs(parsed.query, keep_blank_values=True)
            for k in sorted(q):
                canon_resource += f"\n{k.lower()}:{','.join(q[k])}"
        string_to_sign = "\n".join([
            method,
            h.get("content-encoding", ""),
            h.get("content-language", ""),
            str(content_length) if content_length else "",
            h.get("content-md5", ""),
            h.get("content-type", ""),
            "",                      # Date (x-ms-date is used instead)
            h.get("if-modified-since", ""),
            h.get("if-match", ""),
            h.get("if-none-match", ""),
            h.get("if-unmodified-since", ""),
            h.get("range", ""),
        ]) + "\n" + canon_headers + canon_resource
        sig = base64.b64encode(hmac.new(
            self.key, string_to_sign.encode(), hashlib.sha256).digest())
        h["authorization"] = f"SharedKey {self.account}:{sig.decode()}"
        return h


class AzureBackend(RawReader, RawWriter):
    """RawReader/RawWriter over Azure Blob (`tempodb/backend/azure/`).

    Config mirrors the reference: storage_account_name,
    storage_account_key, container_name, endpoint (default
    `<account>.blob.core.windows.net`; set a full URL for Azurite)."""

    def __init__(self, *, container_name: str,
                 storage_account_name: str = "",
                 storage_account_key: str = "", endpoint: str = "",
                 prefix: str = "", timeout_s: float = 30.0,
                 **_ignored: object) -> None:
        if not container_name:
            raise ValueError("azure backend requires a container_name")
        if not endpoint:
            endpoint = f"https://{storage_account_name}.blob.core.windows.net"
        if "://" not in endpoint:
            endpoint = "https://" + endpoint
        self.base = f"{endpoint.rstrip('/')}/{container_name}"
        self.container = container_name
        self.prefix = prefix.strip("/")
        self.signer = SharedKeySigner(storage_account_name,
                                      storage_account_key)
        self.timeout = timeout_s

    # -- plumbing ----------------------------------------------------------

    def _key(self, keypath: KeyPath, name: str = "") -> str:
        parts = (self.prefix,) + keypath.parts + ((name,) if name else ())
        return "/".join(p for p in parts if p)

    def _request(self, method: str, key: str = "", query: str = "",
                 data: bytes | None = None,
                 extra_headers: dict[str, str] | None = None) -> bytes:
        url = self.base + ("/" + urllib.parse.quote(key) if key else "")
        if query:
            url += "?" + query
        headers = dict(extra_headers or {})
        if method == "PUT":
            headers["x-ms-blob-type"] = "BlockBlob"
            # set explicitly BEFORE signing: urllib would otherwise add
            # its own default content-type after the signature is computed
            headers["content-type"] = "application/octet-stream"
        headers = self.signer.sign(method, url, headers,
                                   len(data) if data else 0)
        req = urllib.request.Request(url, data=data, method=method,
                                     headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return r.read()
        except urllib.error.HTTPError as e:
            if e.code == 404:
                raise DoesNotExist(key)
            if e.code == 416:
                return b""
            raise RuntimeError(
                f"azure {method} {key}: HTTP {e.code}: "
                f"{e.read()[:200]!r}") from e

    def _list_blobs(self, prefix: str, delimiter: str = ""
                    ) -> tuple[list[str], list[str]]:
        names: list[str] = []
        prefixes: list[str] = []
        marker = ""
        while True:
            q = {"restype": "container", "comp": "list",
                 "prefix": prefix, "maxresults": "1000"}
            if delimiter:
                q["delimiter"] = delimiter
            if marker:
                q["marker"] = marker
            body = self._request(
                "GET", "", urllib.parse.urlencode(sorted(q.items())))
            root = ET.fromstring(body)
            blobs = root.find("Blobs")
            if blobs is not None:
                for b in blobs.findall("Blob"):
                    names.append(b.findtext("Name", ""))
                for p in blobs.findall("BlobPrefix"):
                    prefixes.append(p.findtext("Name", ""))
            marker = root.findtext("NextMarker", "") or ""
            if not marker:
                break
        return names, prefixes

    # -- RawReader ---------------------------------------------------------

    def list(self, keypath: KeyPath) -> list[str]:
        base = self._key(keypath)
        prefix = base + "/" if base else ""
        _names, prefixes = self._list_blobs(prefix, delimiter="/")
        return sorted({p[len(prefix):].rstrip("/") for p in prefixes})

    def find(self, keypath: KeyPath, suffix: str = "") -> list[str]:
        base = self._key(keypath)
        prefix = base + "/" if base else ""
        names, _ = self._list_blobs(prefix)
        return sorted(n[len(prefix):] for n in names if n.endswith(suffix))

    def read(self, name: str, keypath: KeyPath) -> bytes:
        return self._request("GET", self._key(keypath, name))

    def size(self, name: str, keypath: KeyPath) -> int:
        key = self._key(keypath, name)
        url = self.base + "/" + urllib.parse.quote(key)
        headers = self.signer.sign("HEAD", url, {}, 0)
        req = urllib.request.Request(url, method="HEAD", headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return int(r.headers.get("Content-Length", 0))
        except urllib.error.HTTPError as e:
            if e.code == 404:
                raise DoesNotExist(key)
            raise

    def read_range(self, name: str, keypath: KeyPath, offset: int,
                   length: int) -> bytes:
        if length <= 0:
            return b""
        hdr = {"range": f"bytes={offset}-{offset + length - 1}"}
        return self._request("GET", self._key(keypath, name),
                             extra_headers=hdr)

    # -- RawWriter ---------------------------------------------------------

    def write(self, name: str, keypath: KeyPath,
              data: bytes | BinaryIO) -> None:
        if not isinstance(data, bytes):
            data = data.read()
        self._request("PUT", self._key(keypath, name), data=data)

    def delete(self, name: str, keypath: KeyPath,
               recursive: bool = False) -> None:
        if recursive:
            base = self._key(keypath, name)
            names, _ = self._list_blobs(base + "/")
            for n in names:
                self._request("DELETE", n)
            return
        try:
            self._request("DELETE", self._key(keypath, name))
        except DoesNotExist:
            pass


__all__ = ["AzureBackend", "SharedKeySigner", "API_VERSION"]
