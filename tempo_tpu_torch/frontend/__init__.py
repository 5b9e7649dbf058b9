"""Query frontend: shard, queue, dispatch, combine.

Analog of `modules/frontend`: per-endpoint pipelines shard a query into
block/row-group jobs targeting `target_bytes_per_job`
(`search_sharder.go:69-336`, `metrics_query_range_sharder.go:61-298`),
a tenant-fair queue hands jobs to querier workers
(`queue/queue.go:59-211`, worker pull model `v1/frontend.go:204-293`),
combiners merge partial results (`combiner/`), and SLO counters record
per-op latency/throughput conformance (`slos.go:29-38`).

Counterpart of `tempo_tpu/frontend/` (host code over the port's querier
and TempoDB).
"""

from tempo_tpu_torch.frontend.frontend import Frontend, FrontendConfig
from tempo_tpu_torch.frontend.queue import RequestQueue
from tempo_tpu_torch.frontend.sharders import (
    SearchJob,
    backend_search_jobs,
    query_range_jobs,
    time_windows,
)

__all__ = [
    "Frontend", "FrontendConfig", "RequestQueue",
    "SearchJob", "backend_search_jobs", "query_range_jobs", "time_windows",
]
