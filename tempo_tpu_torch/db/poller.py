"""Backend poller: scan object store → per-tenant index → blocklist.

Analog of `tempodb/blocklist/poller.go:126-533`: one elected builder per
tenant lists every block and (re)writes the gzipped tenant index; everyone
else just reads the index (`pollTenantAndCreateIndex` `poller.go:239`,
builder election `poller.go:485`). Index staleness falls back to a full
listing, so a dead builder degrades to slow-but-correct.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable

from tempo_tpu_torch.backend import meta as bm
from tempo_tpu_torch.backend.raw import DoesNotExist, RawReader, RawWriter, blocks, tenants

log = logging.getLogger("tempo_tpu_torch.db.poller")


@dataclasses.dataclass
class PollerConfig:
    poll_interval_s: float = 300.0
    stale_tenant_index_s: float = 0.0   # 0 = accept any age
    tolerate_consecutive_errors: int = 1


class Poller:
    def __init__(self, r: RawReader, w: RawWriter,
                 cfg: PollerConfig | None = None,
                 is_index_builder: Callable[[str], bool] = lambda tenant: True,
                 now: Callable[[], float] = time.time):
        self.r = r
        self.w = w
        self.cfg = cfg or PollerConfig()
        self.is_index_builder = is_index_builder
        self.now = now
        self.consecutive_errors = 0

    # -- one full poll cycle (`Do` poller.go:139) ---------------------------

    def do(self) -> tuple[dict, dict]:
        metas: dict[str, list[bm.BlockMeta]] = {}
        compacted: dict[str, list[bm.CompactedBlockMeta]] = {}
        for tenant in tenants(self.r):
            try:
                m, c = self.poll_tenant(tenant)
            except Exception:
                self.consecutive_errors += 1
                if self.consecutive_errors > self.cfg.tolerate_consecutive_errors:
                    raise
                log.exception("poll tenant %s failed (tolerated)", tenant)
                continue
            self.consecutive_errors = 0
            if m or c:
                metas[tenant] = m
                compacted[tenant] = c
        return metas, compacted

    def poll_tenant(self, tenant: str):
        if self.is_index_builder(tenant):
            m, c = self._list_tenant(tenant)
            bm.write_tenant_index(self.w, tenant, m, c)
            return m, c
        try:
            idx = bm.read_tenant_index(self.r, tenant)
            age = self.now() - idx.created_at
            if (self.cfg.stale_tenant_index_s
                    and age > self.cfg.stale_tenant_index_s):
                raise DoesNotExist("stale tenant index")
            return idx.metas, idx.compacted
        except DoesNotExist:
            # no/stale index: fall back to listing (poller.go fallback)
            return self._list_tenant(tenant)

    def _list_tenant(self, tenant: str):
        metas: list[bm.BlockMeta] = []
        compacted: list[bm.CompactedBlockMeta] = []
        for block_id in blocks(self.r, tenant):
            try:
                metas.append(bm.read_block_meta(self.r, block_id, tenant))
                continue
            except DoesNotExist:
                pass
            try:
                compacted.append(bm.read_compacted_block_meta(self.r, block_id, tenant))
            except DoesNotExist:
                pass  # block mid-write or mid-delete: ignore this cycle
        return metas, compacted
