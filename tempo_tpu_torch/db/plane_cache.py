"""Per-block device-plane cache: the product read fast path.

Counterpart of `tempo_tpu/db/plane_cache.py`; the planes live on the
cache's torch device, and the views carry it (`view.meta["device"]`) for
the per-row-group offload of `condition_mask`. The cache also keeps the
sidecar-fold results (`fold_get` / `fold_put`), keyed by block.

Backend blocks are immutable, which makes (tenant, block_id) a perfect
cache key: the first query against a block pays one full columnar read
(host ColumnViews per row group) and lazy device-column adoption
(`BlockScanPlane`); every later query runs its whole first pass — pushdown
predicates, time clip, row-group shard selection, and for metrics the
complete grid aggregation — as one fused device dispatch over the
resident block. This is the analog of the reference's parquet page cache
plus dictionary-page predicate pushdown (`tempodb/tempodb.go:481` Fetch
dispatch, `block_traceql.go:1031`), restructured around the economics of
an accelerator: upload once, dispatch per query, tiny D2H.

Eviction is LRU under a device-byte budget plus an entry-count bound; a
dead block (compacted away) is dropped explicitly by the poller hook in
`db/tempodb.py`.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Iterator, Optional, Sequence

import numpy as np

from tempo_tpu_torch.block.device_scan import BlockScanPlane
from tempo_tpu_torch.block.reader import BackendBlock
from tempo_tpu_torch.traceql.conditions import FetchSpansRequest


class CachedBlock:
    """Host views + device plane for one immutable block."""

    def __init__(self, block: BackendBlock, mesh=None, device=None):
        from tempo_tpu_torch.block.fetch import scan_views
        from tempo_tpu_torch.device import resolve_device

        device = resolve_device(device)
        self.block = block
        self.views = [v for v, _ in scan_views(block, None, device=device)]
        self.plane = BlockScanPlane(self.views, mesh=mesh, device=device)
        # device path usage counters (tests + /metrics)
        self.device_scans = 0
        self.host_scans = 0
        pf = block.parquet_file()
        self._base_host_bytes = sum(pf.row_group_bytes(i)
                                    for i in range(pf.num_row_groups)) \
            or int(block.meta.size_bytes)

    @property
    def device_bytes(self) -> int:
        return self.plane.device_bytes

    @property
    def host_bytes(self) -> int:
        """Resident host estimate: decoded views (uncompressed parquet
        size) + the plane's adoption-side concatenated copies."""
        return self._base_host_bytes + self.plane.host_bytes

    def scan(self, req: Optional[FetchSpansRequest],
             row_groups: Optional[Sequence[int]] = None
             ) -> Iterator[tuple]:
        """Same contract as `fetch.scan_views`, served from the cache: the
        first pass runs on device when every predicate shape is supported,
        else falls back to the host mask per view."""
        from tempo_tpu_torch.block.fetch import condition_mask, prefilter_is_noop
        from tempo_tpu_torch.obs import querystats

        idxs = list(range(len(self.views)) if row_groups is None
                    else (i for i in row_groups
                          if 0 <= i < len(self.views)))
        # read-cost attribution for cache-served scans: each row-group
        # view the query examines charges its share of the block's
        # resident (uncompressed) size — warm queries inspect the same
        # data a cold scan would have read
        querystats.add(inspected_bytes=len(idxs) * (
            self._base_host_bytes // max(len(self.views), 1)))
        if req is None:
            for i in idxs:
                yield self.views[i], np.arange(self.views[i].n)
            return
        preds = [c for c in req.conditions if c.op is not None]
        cands = None
        if not prefilter_is_noop(req):
            m = self.plane.mask_async(
                preds, req.all_conditions,
                time_range=(req.start_ns, req.end_ns),
                row_groups=list(row_groups) if row_groups is not None
                else None)
            if m is not None:
                self.device_scans += 1
                cands = self.plane.split_mask(m)
        if cands is not None:
            for i in idxs:
                cand = cands[i]
                if len(cand) == 0 and req.all_conditions:
                    continue
                yield self.views[i], cand
            return
        self.host_scans += 1
        for i in idxs:
            view = self.views[i]
            mask = condition_mask(view, req)
            cand = np.flatnonzero(mask)
            if len(cand) == 0 and req.all_conditions:
                continue
            yield view, cand


class PlaneCache:
    """LRU of CachedBlocks bounded by device bytes, host bytes, and entry
    count (the device budget is the scarce resource; the host budget keeps
    pinned decoded views from growing to max_blocks full blocks)."""

    def __init__(self, budget_bytes: int = 1 << 30, max_blocks: int = 64,
                 host_budget_bytes: int = 4 << 30, mesh=None,
                 max_folds: int = 1024, device=None):
        from tempo_tpu_torch.device import resolve_device

        self.device = resolve_device(device)
        self.mesh = mesh              # multi-device planes (BlockScanPlane)
        self.budget_bytes = budget_bytes
        self.max_blocks = max_blocks
        self.host_budget_bytes = host_budget_bytes
        self._entries: "OrderedDict[tuple, CachedBlock]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        # sidecar-fold result cache: (tenant, block_id) → {window key →
        # job-level series}. Keyed by block so eviction (drop/drop_dead)
        # can never leave a dead block serving stale folds; bounded by
        # total cached window entries, LRU by block.
        self.max_folds = max_folds
        self._folds: "OrderedDict[tuple, dict]" = OrderedDict()
        self.fold_hits = 0
        self.fold_misses = 0

    def get(self, block: BackendBlock) -> CachedBlock:
        key = (block.meta.tenant_id, block.meta.block_id)
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                # lazy adoption grows footprints AFTER insertion; re-check
                # the budgets on hits too, or a stable hit-only working
                # set would never trigger eviction
                self._evict_locked()
                return entry
        # build outside the lock (full-block read); a racing duplicate
        # build is wasted work, not a correctness problem — last one wins
        entry = CachedBlock(block, mesh=self.mesh, device=self.device)
        with self._lock:
            self.misses += 1
            self._entries[key] = entry
            self._evict_locked()
        return entry

    def peek(self, tenant: str, block_id: str) -> Optional[CachedBlock]:
        with self._lock:
            return self._entries.get((tenant, block_id))

    def drop(self, tenant: str, block_id: str) -> None:
        with self._lock:
            self._entries.pop((tenant, block_id), None)
            self._folds.pop((tenant, block_id), None)

    def drop_dead(self, tenant: str, live_block_ids: set) -> None:
        with self._lock:
            for key in [k for k in self._entries
                        if k[0] == tenant and k[1] not in live_block_ids]:
                del self._entries[key]
            for key in [k for k in self._folds
                        if k[0] == tenant and k[1] not in live_block_ids]:
                del self._folds[key]

    # -- sidecar-fold results (block/sidecar.py) ---------------------------

    def fold_get(self, tenant: str, block_id: str, fold_key) -> "list | None":
        with self._lock:
            per_block = self._folds.get((tenant, block_id))
            got = None if per_block is None else per_block.get(fold_key)
            if got is None:
                self.fold_misses += 1
                return None
            self._folds.move_to_end((tenant, block_id))
            self.fold_hits += 1
            return got

    def fold_put(self, tenant: str, block_id: str, fold_key,
                 series: list) -> None:
        with self._lock:
            self._folds.setdefault((tenant, block_id), {})[fold_key] = series
            self._folds.move_to_end((tenant, block_id))
            while (sum(len(d) for d in self._folds.values()) > self.max_folds
                   and len(self._folds) > 1):
                self._folds.popitem(last=False)

    def _evict_locked(self) -> None:
        while len(self._entries) > self.max_blocks:
            self._entries.popitem(last=False)
        total = sum(e.device_bytes for e in self._entries.values())
        host = sum(e.host_bytes for e in self._entries.values())
        while ((total > self.budget_bytes or host > self.host_budget_bytes)
               and len(self._entries) > 1):
            _, gone = self._entries.popitem(last=False)
            total -= gone.device_bytes
            host -= gone.host_bytes

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "device_bytes": sum(e.device_bytes
                                    for e in self._entries.values()),
                "host_bytes": sum(e.host_bytes
                                  for e in self._entries.values()),
                "device_budget_bytes": self.budget_bytes,
                "host_budget_bytes": self.host_budget_bytes,
                "hits": self.hits,
                "misses": self.misses,
                "fold_entries": sum(len(d) for d in self._folds.values()),
                "fold_hits": self.fold_hits,
                "fold_misses": self.fold_misses,
            }
