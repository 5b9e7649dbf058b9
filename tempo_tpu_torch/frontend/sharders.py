"""Query sharding: time windows, block jobs, trace-id shards.

Analog of the frontend sharders:
- search: recent window → ingesters, older → backend block jobs of
  ~`target_bytes_per_job` built from row groups
  (`search_sharder.go:123-161,284-336`; 100MB default `search_sharder.go:25`)
- metrics: the same split with step-aligned window edges
  (`metrics_query_range_sharder.go:216-298`)
- trace-by-id: uniform trace-id keyspace shards
  (`traceid_sharder.go` + `pkg/blockboundary`)

Counterpart of `tempo_tpu/frontend/sharders.py` (copied).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

from tempo_tpu_torch.backend.meta import BlockMeta

DEFAULT_TARGET_BYTES_PER_JOB = 100 * 1024 * 1024
DEFAULT_QUERY_BACKEND_AFTER_S = 15 * 60      # query_backend_after default 15m
DEFAULT_QUERY_INGESTERS_UNTIL_S = 30 * 60    # query_ingesters_until default 30m


@dataclasses.dataclass
class SearchJob:
    """One dispatchable unit: a block slice (or an ingester window)."""
    kind: str                       # "backend" | "ingester" | "generator"
    tenant: str
    meta: BlockMeta | None = None
    row_groups: tuple[int, ...] = ()
    start_s: float = 0.0
    end_s: float = 0.0


def time_windows(now_s: float, start_s: float, end_s: float,
                 backend_after_s: float = DEFAULT_QUERY_BACKEND_AFTER_S,
                 ingesters_until_s: float = DEFAULT_QUERY_INGESTERS_UNTIL_S,
                 ) -> tuple[tuple[float, float] | None, tuple[float, float] | None]:
    """Split [start,end] into (ingester_window, backend_window)
    (`search_sharder.go:166-283`, `backendRange` :266). Windows overlap in
    [now-ingesters_until, now-backend_after] — both sides are queried there,
    dedupe happens in the combiner."""
    ing_lo = now_s - ingesters_until_s
    be_hi = now_s - backend_after_s
    ingester = None
    if end_s > ing_lo:
        ingester = (max(start_s, ing_lo), end_s)
    backend = None
    if start_s < be_hi:
        backend = (start_s, min(end_s, be_hi))
    return ingester, backend


def backend_search_jobs(tenant: str, metas: Sequence[BlockMeta],
                        start_s: float, end_s: float,
                        target_bytes_per_job: int = DEFAULT_TARGET_BYTES_PER_JOB,
                        ) -> list[SearchJob]:
    """Blocks overlapping the window → jobs of N row groups ≈ target bytes
    (`backendRequests`/`buildBackendRequests` `search_sharder.go:284-336`)."""
    jobs: list[SearchJob] = []
    for m in metas:
        if m.end_time < start_s or m.start_time > end_s:
            continue
        n_rg = max(m.row_group_count, 1)
        bytes_per_rg = max(m.size_bytes // n_rg, 1)
        rg_per_job = max(int(target_bytes_per_job // bytes_per_rg), 1)
        for lo in range(0, n_rg, rg_per_job):
            jobs.append(SearchJob(
                "backend", tenant, meta=m,
                row_groups=tuple(range(lo, min(lo + rg_per_job, n_rg))),
                start_s=start_s, end_s=end_s))
    return jobs


def query_range_jobs(tenant: str, metas: Sequence[BlockMeta],
                     start_s: float, end_s: float, step_s: float,
                     target_bytes_per_job: int = 225 * 1024 * 1024,
                     ) -> list[SearchJob]:
    """Metrics jobs: same block slicing, window edges aligned down/up to
    step boundaries so partial steps never straddle a job boundary
    (`metrics_query_range_sharder.go:216-298`; 225MB/job per docs)."""
    if step_s > 0:
        start_s = np.floor(start_s / step_s) * step_s
        end_s = np.ceil(end_s / step_s) * step_s
    return [dataclasses.replace(j, kind="backend_metrics")
            for j in backend_search_jobs(tenant, metas, start_s, end_s,
                                         target_bytes_per_job)]


def trace_id_shards(n_shards: int) -> list[tuple[bytes, bytes]]:
    """Uniform [min,max) trace-id boundaries: adjacent shards SHARE the
    boundary value (shard i's max == shard i+1's min), like
    `CreateBlockBoundaries` (`pkg/blockboundary/blockboundary.go:9`)."""
    bounds = np.linspace(0.0, float(2 ** 64), n_shards + 1, dtype=np.float64)
    edges = [min(int(b), 2 ** 64 - 1).to_bytes(8, "big") + b"\x00" * 8
             for b in bounds]
    edges[-1] = b"\xff" * 16
    return [(edges[i], edges[i + 1]) for i in range(n_shards)]


def prune_blocks_rf(metas: Iterable[BlockMeta], rf_filter: int | None = None
                    ) -> list[BlockMeta]:
    """Keep blocks matching the requested replication factor (RF1 generator
    blocks vs RF3 ingester blocks, `frontend.go:357-375`)."""
    out = []
    for m in metas:
        if rf_filter is None or m.replication_factor == rf_filter:
            out.append(m)
    return out
