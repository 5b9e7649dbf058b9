"""tempo_tpu_torch.matview — incremental materialized query grids.

Counterpart of `tempo_tpu/matview/`. Hot recurring TraceQL-metrics
queries become standing device-resident grids (torch tensors on the
materializer's device) that every ingest batch streams into; dashboard
reads turn into a grid slice + the normal combiner/final pass instead of
a block/registry recompute. See `materializer.py` for the design notes.
"""

from tempo_tpu_torch.matview.materializer import (
    Materializer,
    MatViewConfig,
    Subscription,
    configure,
    materializer,
    query_supported,
    reset,
)

__all__ = ["Materializer", "MatViewConfig", "Subscription", "configure",
           "materializer", "query_supported", "reset"]
