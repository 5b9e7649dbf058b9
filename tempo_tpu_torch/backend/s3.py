"""S3 object-store backend: SigV4-signed raw HTTP, no SDK dependency.

The analog of `tempodb/backend/s3/s3.go:25,129` (which uses minio-go +
hedgedhttp). This environment has no boto3 and zero egress, so the client
is a from-scratch AWS Signature V4 implementation over urllib — it works
against any S3-compatible endpoint (AWS, MinIO, Ceph RGW, and the
in-process mock server the tests use). Hedged requests are provided by
wrapping this reader in `utils.hedging.HedgedReader` (config
`storage.hedge_delay_s`), mirroring how the reference layers hedgedhttp
under the S3 transport.

Key layout matches `raw.py`: <prefix>/<tenant>/<block>/<object>.

Counterpart of `tempo_tpu/backend/s3.py` (host code, standard library
only), copied with its imports moved to the port.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import io
import urllib.error
import urllib.parse
import urllib.request
import xml.etree.ElementTree as ET
from typing import BinaryIO

from tempo_tpu_torch.backend.raw import DoesNotExist, KeyPath, RawReader, RawWriter

_EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


class SigV4Signer:
    """AWS Signature Version 4 for S3 (header-based auth, path-style)."""

    def __init__(self, access_key: str, secret_key: str,
                 region: str = "us-east-1", service: str = "s3") -> None:
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region
        self.service = service

    def sign(self, method: str, url: str, headers: dict[str, str],
             payload_sha256: str,
             now: datetime.datetime | None = None) -> dict[str, str]:
        """Returns headers + Authorization for the request."""
        u = urllib.parse.urlsplit(url)
        now = now or datetime.datetime.now(datetime.timezone.utc)
        amz_date = now.strftime("%Y%m%dT%H%M%SZ")
        datestamp = now.strftime("%Y%m%d")

        headers = dict(headers)
        headers["host"] = u.netloc
        headers["x-amz-date"] = amz_date
        headers["x-amz-content-sha256"] = payload_sha256

        # canonical request — the path arrives already percent-encoded by
        # _request; S3's canonical URI is the encoded path WITHOUT
        # double-encoding (re-quoting would sign %2520 for a %20 on the
        # wire → SignatureDoesNotMatch)
        canon_uri = u.path or "/"
        q = urllib.parse.parse_qsl(u.query, keep_blank_values=True)
        canon_query = "&".join(
            f"{urllib.parse.quote(k, safe='-_.~')}="
            f"{urllib.parse.quote(v, safe='-_.~')}"
            for k, v in sorted(q))
        signed_names = sorted(h.lower() for h in headers)
        canon_headers = "".join(
            f"{h}:{headers[next(k for k in headers if k.lower() == h)].strip()}\n"
            for h in signed_names)
        signed_headers = ";".join(signed_names)
        canon_req = "\n".join([method, canon_uri, canon_query, canon_headers,
                               signed_headers, payload_sha256])

        scope = f"{datestamp}/{self.region}/{self.service}/aws4_request"
        to_sign = "\n".join([
            "AWS4-HMAC-SHA256", amz_date, scope,
            hashlib.sha256(canon_req.encode()).hexdigest()])
        k = _hmac(("AWS4" + self.secret_key).encode(), datestamp)
        k = _hmac(k, self.region)
        k = _hmac(k, self.service)
        k = _hmac(k, "aws4_request")
        sig = hmac.new(k, to_sign.encode(), hashlib.sha256).hexdigest()
        headers["Authorization"] = (
            f"AWS4-HMAC-SHA256 Credential={self.access_key}/{scope}, "
            f"SignedHeaders={signed_headers}, Signature={sig}")
        return headers


class S3Backend(RawReader, RawWriter):
    """RawReader/RawWriter over an S3-compatible endpoint.

    Config mirrors `tempodb/backend/s3/config.go`: endpoint, bucket,
    region, access_key, secret_key, prefix, insecure (http).
    """

    def __init__(self, *, bucket: str, endpoint: str = "s3.amazonaws.com",
                 region: str = "us-east-1", access_key: str = "",
                 secret_key: str = "", prefix: str = "",
                 insecure: bool = False, timeout_s: float = 30.0,
                 **_ignored: object) -> None:
        if not bucket:
            raise ValueError("s3 backend requires a bucket")
        scheme = "http" if insecure else "https"
        if "://" in endpoint:
            scheme, endpoint = endpoint.split("://", 1)
        self.base = f"{scheme}://{endpoint.rstrip('/')}/{bucket}"
        self.prefix = prefix.strip("/")
        self.signer = SigV4Signer(access_key, secret_key, region)
        self.timeout = timeout_s

    # -- plumbing -----------------------------------------------------------

    def _key(self, keypath: KeyPath, name: str = "") -> str:
        parts = (self.prefix,) + keypath.parts + ((name,) if name else ())
        return "/".join(p for p in parts if p)

    def _request(self, method: str, key: str = "", query: str = "",
                 data: bytes | None = None,
                 extra_headers: dict[str, str] | None = None) -> bytes:
        url = self.base + ("/" + urllib.parse.quote(key) if key else "")
        if query:
            url += "?" + query
        payload = data or b""
        sha = hashlib.sha256(payload).hexdigest() if payload else _EMPTY_SHA256
        headers = self.signer.sign(method, url, extra_headers or {}, sha)
        req = urllib.request.Request(url, data=data, method=method,
                                     headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return r.read()
        except urllib.error.HTTPError as e:
            if e.code == 404:
                raise DoesNotExist(key)
            if e.code == 416:       # unsatisfiable range on empty object
                return b""
            raise RuntimeError(
                f"s3 {method} {key}: HTTP {e.code}: "
                f"{e.read()[:200]!r}") from e

    def _list_objects(self, prefix: str, delimiter: str = "") -> tuple[list[str], list[str]]:
        """(keys, common_prefixes) via ListObjectsV2 with pagination."""
        keys: list[str] = []
        prefixes: list[str] = []
        token = ""
        while True:
            q = {"list-type": "2", "prefix": prefix, "max-keys": "1000"}
            if delimiter:
                q["delimiter"] = delimiter
            if token:
                q["continuation-token"] = token
            body = self._request("GET", "", urllib.parse.urlencode(sorted(q.items())))
            root = ET.fromstring(body)
            ns = ""
            if root.tag.startswith("{"):
                ns = root.tag.split("}")[0] + "}"
            for c in root.findall(f"{ns}Contents"):
                keys.append(c.findtext(f"{ns}Key", ""))
            for p in root.findall(f"{ns}CommonPrefixes"):
                prefixes.append(p.findtext(f"{ns}Prefix", ""))
            if root.findtext(f"{ns}IsTruncated", "false") != "true":
                break
            token = root.findtext(f"{ns}NextContinuationToken", "")
            if not token:
                break
        return keys, prefixes

    # -- RawReader ----------------------------------------------------------

    def list(self, keypath: KeyPath) -> list[str]:
        base = self._key(keypath)
        prefix = base + "/" if base else ""
        _keys, prefixes = self._list_objects(prefix, delimiter="/")
        return sorted({p[len(prefix):].rstrip("/") for p in prefixes})

    def find(self, keypath: KeyPath, suffix: str = "") -> list[str]:
        base = self._key(keypath)
        prefix = base + "/" if base else ""
        keys, _ = self._list_objects(prefix)
        out = [k[len(prefix):] for k in keys if k.endswith(suffix)]
        return sorted(out)

    def read(self, name: str, keypath: KeyPath) -> bytes:
        return self._request("GET", self._key(keypath, name))

    def size(self, name: str, keypath: KeyPath) -> int:
        """HEAD request — the block reader uses this for footer reads."""
        key = self._key(keypath, name)
        url = self.base + "/" + urllib.parse.quote(key)
        headers = self.signer.sign("HEAD", url, {}, _EMPTY_SHA256)
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

    # -- RawWriter ----------------------------------------------------------

    def write(self, name: str, keypath: KeyPath,
              data: bytes | BinaryIO) -> None:
        if not isinstance(data, bytes):
            data = data.read()
        self._request("PUT", self._key(keypath, name), data=data)

    def delete(self, name: str, keypath: KeyPath,
               recursive: bool = False) -> None:
        if recursive:
            base = self._key(keypath, name)
            keys, _ = self._list_objects(base + "/")
            for k in keys:          # keys are bucket-relative already
                self._request("DELETE", k)
            return
        try:
            self._request("DELETE", self._key(keypath, name))
        except DoesNotExist:
            pass
