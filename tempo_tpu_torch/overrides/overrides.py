"""Overrides service: runtime-config file + user-configurable backend layer.

Analog of `modules/overrides/{runtime_config_overrides,
user_configurable_overrides}.go`: the runtime-config file carries
`overrides: {tenant: {...}}` plus a `*` wildcard default and reloads on
mtime change; the user-configurable layer is a JSON blob per tenant stored
in the object-store backend under `<tenant>/overrides.json`, exposed via an
API, and applied on top of runtime config for the subset of fields users may
set (validated in `cmd/tempo/app/overrides_validation.go`).

Counterpart of `tempo_tpu/overrides/overrides.py`. The reference imports
PyYAML when the module is imported; the port imports it only in
`reload()`, when a runtime-config file is given, so `Overrides()` without
one needs no PyYAML (not a dependency of the port). A runtime-config path
without PyYAML raises `ImportError` naming the path: the limits are
never quietly the defaults.
"""

from __future__ import annotations

import json
import os
import threading

from tempo_tpu_torch.backend.raw import DoesNotExist, KeyPath, RawReader, RawWriter
from tempo_tpu_torch.overrides.limits import Limits

WILDCARD = "*"

# Fields tenants may set through the user-configurable API — the same subset
# the reference allows (`user_configurable_overrides.go` UserConfigurableLimits:
# forwarders, metrics-generator processors/collection-interval/dimensions...).
USER_CONFIGURABLE_FIELDS = {
    "generator": {
        "processors", "collection_interval_s", "disable_collection",
        "dimensions", "histogram_buckets",
    },
}


class Overrides:
    """Per-tenant limit resolution: defaults < runtime file < user-config."""

    def __init__(self, defaults: Limits | None = None,
                 runtime_config_path: str | None = None,
                 user_configurable: "UserConfigurableOverrides | None" = None):
        self.defaults = defaults or Limits()
        self.path = runtime_config_path
        self.user_configurable = user_configurable
        self._mtime = 0.0
        self._lock = threading.Lock()
        self._per_tenant: dict[str, dict] = {}
        self._wildcard: dict = {}
        if self.path:
            self.reload()

    # -- runtime config file ----------------------------------------------

    def reload(self) -> bool:
        """Re-read the runtime-config file if its mtime moved (the dskit
        runtimeconfig watcher pattern). Returns True when content changed."""
        if not self.path or not os.path.exists(self.path):
            return False
        mtime = os.path.getmtime(self.path)
        if mtime == self._mtime:
            return False
        try:
            import yaml
        except ImportError as e:
            raise ImportError(
                f"runtime config {self.path!r} needs PyYAML, which is not "
                f"installed") from e
        with open(self.path) as f:
            doc = yaml.safe_load(f) or {}
        per_tenant = dict(doc.get("overrides", {}))
        with self._lock:
            self._mtime = mtime
            self._wildcard = per_tenant.pop(WILDCARD, {}) or {}
            self._per_tenant = per_tenant
        return True

    def set_tenant_patch(self, tenant: str, patch: dict) -> None:
        """Programmatic override injection (tests, single-binary config)."""
        with self._lock:
            self._per_tenant[tenant] = patch

    # -- resolution --------------------------------------------------------

    def for_tenant(self, tenant: str) -> Limits:
        with self._lock:
            wildcard = self._wildcard
            patch = self._per_tenant.get(tenant, {})
        lim = self.defaults.merged_with(wildcard).merged_with(patch)
        if self.user_configurable is not None:
            uc = self.user_configurable.get(tenant)
            if uc:
                lim = lim.merged_with(_filter_user_configurable(uc))
        return lim


def _filter_user_configurable(patch: dict) -> dict:
    out: dict = {}
    for group, fields in (patch or {}).items():
        allowed = USER_CONFIGURABLE_FIELDS.get(group)
        if not allowed or not isinstance(fields, dict):
            continue
        kept = {k: v for k, v in fields.items() if k in allowed}
        if kept:
            out[group] = kept
    return out


class UserConfigurableOverrides:
    """Tenant-editable override blobs persisted to the backend.

    Storage layout mirrors the reference (`user_configurable_overrides.go`
    client): one JSON object per tenant at `overrides/<tenant>/overrides.json`
    with optimistic concurrency via a version string.
    """

    NAME = "overrides.json"

    def __init__(self, r: RawReader, w: RawWriter):
        self.r = r
        self.w = w

    def _kp(self, tenant: str) -> KeyPath:
        return KeyPath(("overrides", tenant))

    def get(self, tenant: str) -> dict | None:
        try:
            raw = self.r.read(self.NAME, self._kp(tenant))
        except (DoesNotExist, KeyError, FileNotFoundError):
            return None
        doc = json.loads(raw.decode())
        return doc.get("limits")

    def set(self, tenant: str, limits_patch: dict,
            version: str | None = None) -> str:
        bad = _validate_user_patch(limits_patch)
        if bad:
            raise ValueError(f"field not user-configurable: {bad}")
        cur = self._read_doc(tenant)
        cur_ver = cur.get("version", "0") if cur else "0"
        if version is not None and version != cur_ver:
            raise RuntimeError(f"version conflict: have {cur_ver}, got {version}")
        new_ver = str(int(cur_ver) + 1)
        doc = {"version": new_ver, "limits": limits_patch}
        self.w.write(self.NAME, self._kp(tenant), json.dumps(doc).encode())
        return new_ver

    def delete(self, tenant: str) -> None:
        try:
            self.w.delete(self.NAME, self._kp(tenant))
        except (DoesNotExist, KeyError, FileNotFoundError):
            pass

    def _read_doc(self, tenant: str) -> dict | None:
        try:
            return json.loads(self.r.read(self.NAME, self._kp(tenant)).decode())
        except (DoesNotExist, KeyError, FileNotFoundError):
            return None


def _validate_user_patch(patch: dict) -> str | None:
    for group, fields in (patch or {}).items():
        allowed = USER_CONFIGURABLE_FIELDS.get(group)
        if allowed is None:
            return group
        if not isinstance(fields, dict):
            return group
        for k in fields:
            if k not in allowed:
                return f"{group}.{k}"
    return None
