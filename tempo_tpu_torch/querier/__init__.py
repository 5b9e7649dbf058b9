"""Querier: executes sub-queries against ingesters and backend blocks.

Analog of `modules/querier`: trace-by-id with RF quorum across the
ingester replication set plus backend fan-out (`FindTraceByID`
`querier.go:199`, `forIngesterRings` `querier.go:318`), recent-data search
fan-out, and per-block jobs dispatched by the frontend
(`SearchBlock` `querier.go:780`, query-range `querier_query_range.go`).

Counterpart of `tempo_tpu/querier/`.
"""

from tempo_tpu_torch.querier.querier import Querier, QuerierConfig

__all__ = ["Querier", "QuerierConfig"]
