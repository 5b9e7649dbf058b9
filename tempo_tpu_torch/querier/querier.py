"""The querier service.

Read-side counterpart of the distributor: resolves the trace's replication
set on the ring, requires quorum successful responses
(`forIngesterRings` `querier.go:318`), merges ingester recent data with
backend blocks (tempodb), and executes frontend-sharded block jobs.

Counterpart of `tempo_tpu/querier/querier.py` (host code, copied); block
jobs go to the port's `TempoDB.search` / `query_range` with `metas=` and
`row_groups=`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Protocol, Sequence

import numpy as np

from tempo_tpu_torch.backend.meta import BlockMeta
from tempo_tpu_torch.db.tempodb import TempoDB
from tempo_tpu_torch.model.combine import combine_spans, sort_spans
from tempo_tpu_torch.obs import Registry
from tempo_tpu_torch.obs import querystats
from tempo_tpu_torch.ops.hashing import token_for
from tempo_tpu_torch.overrides import Overrides
from tempo_tpu_torch.ring import Ring
from tempo_tpu_torch.traceql.engine import MetadataCombiner
from tempo_tpu_torch.utils import tracing


class IngesterQueryClient(Protocol):
    def find_trace_by_id(self, tenant: str, trace_id: bytes) -> list[dict] | None: ...
    def search(self, tenant: str, query: str, limit: int = 20,
               start_s: float = 0, end_s: float = 0): ...
    def tag_names(self, tenant: str) -> dict[str, list[str]]: ...


@dataclasses.dataclass
class QuerierConfig:
    rf: int = 3
    query_mode_all: bool = True     # ingesters + blocks (QueryModeAll)


class Querier:
    def __init__(self, db: TempoDB,
                 ingester_ring: Ring | None = None,
                 ingester_clients: dict[str, IngesterQueryClient] | None = None,
                 overrides: Overrides | None = None,
                 cfg: QuerierConfig | None = None,
                 registry: Registry | None = None,
                 now: Callable[[], float] = time.time) -> None:
        self.db = db
        self.ring = ingester_ring
        self.clients = ingester_clients or {}
        self.overrides = overrides or Overrides()
        self.cfg = cfg or QuerierConfig()
        self.now = now
        self.obs = registry if registry is not None else Registry()
        self.block_scan_duration = self.obs.histogram(
            "tempo_querier_block_scan_duration_seconds",
            "One frontend-sharded backend block job, by op "
            "(search or metrics)", labels=("op",))

    # -- trace by id -------------------------------------------------------

    def find_trace_by_id(self, tenant: str, trace_id: bytes,
                         start_s: float | None = None,
                         end_s: float | None = None) -> list[dict] | None:
        """Quorum read across the trace's replication set + backend blocks;
        results combined/deduped (RF3 write → spans appear ≤3 times)."""
        parts: list[list[dict]] = []
        if self.ring is not None and self.clients:
            mat = np.frombuffer(trace_id.ljust(16, b"\0")[:16], np.uint8)[None, :]
            token = int(token_for(tenant, mat)[0])
            rs = self.ring.get(token, self.cfg.rf)
            failures = 0
            for inst in rs.instances:
                try:
                    spans = self.clients[inst.id].find_trace_by_id(tenant, trace_id)
                except Exception:
                    failures += 1
                    if failures > rs.max_errors:
                        raise
                    continue
                if spans:
                    parts.append(spans)
        if self.cfg.query_mode_all:
            spans = self.db.find_trace_by_id(tenant, trace_id, start_s, end_s)
            if spans:
                parts.append(spans)
        if not parts:
            return None
        return sort_spans(combine_spans(*parts))

    # -- search ------------------------------------------------------------

    def search_recent(self, tenant: str, query: str, limit: int = 20,
                      start_s: float = 0, end_s: float = 0):
        """Fan search to every healthy ingester; merge top-N metadata.
        (Search fans to all ingesters — any of them may hold any trace's
        replicas; quorum applies per-ring-health not per-result.)"""
        combiner = MetadataCombiner(limit)
        if self.ring is None:
            return []
        for inst in self.ring.healthy_instances():
            client = self.clients.get(inst.id)
            if client is None:
                continue
            for md in client.search(tenant, query, limit, start_s, end_s):
                combiner.add(md)
        return combiner.results()

    def search_block(self, tenant: str, query: str, meta: BlockMeta,
                     row_groups: Sequence[int] | None = None,
                     limit: int = 20,
                     start_s: float | None = None, end_s: float | None = None):
        """One frontend-sharded backend job (`SearchBlock` `querier.go:780`)."""
        t0 = time.perf_counter()
        querystats.add(blocks_scanned=1)
        try:
            with tracing.span_for_tenant(
                    "querier.SearchBlock", tenant,
                    block_id=str(meta.block_id),
                    row_groups=len(row_groups) if row_groups else 0):
                return self.db.search(tenant, query, limit=limit,
                                      start_s=start_s, end_s=end_s,
                                      metas=[meta], row_groups=row_groups)
        finally:
            self.block_scan_duration.observe(time.perf_counter() - t0,
                                             ("search",))

    def query_range_block(self, tenant: str, req, meta: BlockMeta,
                          row_groups: Sequence[int] | None = None,
                          clip_start_ns: int | None = None,
                          clip_end_ns: int | None = None):
        """One metrics job: raw evaluator over a block slice; job-level
        series to be combined at the frontend (AggregateModeSum)."""
        t0 = time.perf_counter()
        querystats.add(blocks_scanned=1)
        try:
            with tracing.span_for_tenant(
                    "querier.QueryRangeBlock", tenant,
                    block_id=str(meta.block_id),
                    row_groups=len(row_groups) if row_groups else 0):
                return self.db.query_range(tenant, req, metas=[meta],
                                           row_groups=row_groups,
                                           clip_start_ns=clip_start_ns,
                                           clip_end_ns=clip_end_ns)
        finally:
            self.block_scan_duration.observe(time.perf_counter() - t0,
                                             ("metrics",))

    # -- tags --------------------------------------------------------------

    def tag_names(self, tenant: str, scopes: Sequence[str] = ("span", "resource"),
                  limit_bytes: int = 0,
                  on_partial=None) -> dict[str, list[str]]:
        """`on_partial` (optional) receives the current merged snapshot
        after the ingester pass and after each backend block that
        contributed new names — the incremental feed the streaming
        SearchTags endpoint diffs (`tempo.proto` StreamingQuerier)."""
        out: dict[str, set] = {}

        def snap() -> dict[str, list[str]]:
            return {k: sorted(v) for k, v in out.items()
                    if k in scopes or not scopes}

        if self.ring is not None:
            for inst in self.ring.healthy_instances():
                client = self.clients.get(inst.id)
                if client is None:
                    continue
                for scope, names in client.tag_names(tenant).items():
                    out.setdefault(scope, set()).update(names)
            if on_partial is not None and out:
                on_partial(snap())
        # backend blocks: key-list columns only, under a global byte budget
        from tempo_tpu_torch.block.fetch import block_tag_names
        limit_bytes = limit_bytes or \
            self.overrides.for_tenant(tenant).read.max_bytes_per_tag_values_query
        used = sum(len(n) for names in out.values() for n in names)
        for m in self.db.blocks(tenant):
            if limit_bytes and used >= limit_bytes:
                break
            per_block = block_tag_names(
                self.db.backend_block(m),
                byte_budget=(limit_bytes - used) if limit_bytes else 0)
            grew = False
            for scope, names in per_block.items():
                fresh = names - out.setdefault(scope, set())
                used += sum(len(n) for n in fresh)
                grew = grew or bool(fresh)
                out[scope] |= fresh
            if on_partial is not None and grew:
                on_partial(snap())
        return snap()

    def tag_values(self, tenant: str, name: str, limit: int = 1000,
                   on_partial=None) -> list[dict]:
        """Autocomplete values: ingester recent data + backend block scans,
        deduped (`ExecuteTagValues` fan-out, querier side). `on_partial`
        receives the current snapshot after the ingester pass (the
        streaming SearchTagValues feed)."""
        from tempo_tpu_torch.traceql.engine import execute_tag_values, tag_values_request

        seen: dict[str, dict] = {}
        if self.ring is not None:
            for inst in self.ring.healthy_instances():
                client = self.clients.get(inst.id)
                if client is None or not hasattr(client, "tag_values"):
                    continue
                for v in client.tag_values(tenant, name, limit):
                    seen.setdefault(v["value"], v)
            if on_partial is not None and seen:
                on_partial(list(seen.values())[:limit])
        req = tag_values_request(name)
        # ride the plane cache's retained views when a block is ALREADY
        # resident (autocomplete repeats per keystroke); cold blocks take
        # the projected one-column scan — a metadata endpoint must not
        # trigger full-block reads or evict the query working set
        views = (v for m in self.db.blocks(tenant)
                 for v in self.db.scan_source(m, req, cached_only=True))
        for v in execute_tag_values(name, views, limit=limit):
            seen.setdefault(v["value"], v)
        return list(seen.values())[:limit]
