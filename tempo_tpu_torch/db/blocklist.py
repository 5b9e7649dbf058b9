"""In-memory per-tenant blocklist — analog of `tempodb/blocklist/list.go`.

The queryable snapshot of "which blocks exist per tenant", rebuilt by the
poller and adjusted in-place by the compactor between polls (ApplyPollResults
/ Update semantics), so queries never see a block both live and compacted.
"""

from __future__ import annotations

import threading

from tempo_tpu_torch.backend.meta import BlockMeta, CompactedBlockMeta


class List:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metas: dict[str, list[BlockMeta]] = {}
        self._compacted: dict[str, list[CompactedBlockMeta]] = {}

    def tenants(self) -> list[str]:
        with self._lock:
            return sorted(set(self._metas) | set(self._compacted))

    def metas(self, tenant: str) -> list[BlockMeta]:
        with self._lock:
            return list(self._metas.get(tenant, ()))

    def compacted_metas(self, tenant: str) -> list[CompactedBlockMeta]:
        with self._lock:
            return list(self._compacted.get(tenant, ()))

    def apply_poll_results(self, metas: dict[str, list[BlockMeta]],
                           compacted: dict[str, list[CompactedBlockMeta]]) -> None:
        with self._lock:
            self._metas = {t: list(v) for t, v in metas.items()}
            self._compacted = {t: list(v) for t, v in compacted.items()}

    def update(self, tenant: str, add: list[BlockMeta] = (),
               remove: list[BlockMeta] = (),
               compacted_add: list[CompactedBlockMeta] = (),
               compacted_remove: list[CompactedBlockMeta] = ()) -> None:
        """Compactor's in-place adjustment between polls (`list.go` Update)."""
        with self._lock:
            cur = self._metas.setdefault(tenant, [])
            rm = {m.block_id for m in remove}
            cur[:] = [m for m in cur if m.block_id not in rm]
            have = {m.block_id for m in cur}
            cur.extend(m for m in add if m.block_id not in have)
            ccur = self._compacted.setdefault(tenant, [])
            crm = {c.meta.block_id for c in compacted_remove}
            ccur[:] = [c for c in ccur if c.meta.block_id not in crm]
            chave = {c.meta.block_id for c in ccur}
            ccur.extend(c for c in compacted_add if c.meta.block_id not in chave)
