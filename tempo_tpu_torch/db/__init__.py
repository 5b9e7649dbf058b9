"""Storage engine facade (SURVEY.md §2.2 'tempodb core'): blocklist,
poller, bounded query pool, TempoDB Reader/Writer with the device read
plane and the cold tier (compaction, retention, sidecar backfill).
Counterpart of `tempo_tpu/db/`."""

from tempo_tpu_torch.db.blocklist import List
from tempo_tpu_torch.db.compactor import (
    CompactorConfig,
    TimeWindowBlockSelector,
    compact,
    do_retention,
    iter_trace_groups,
    merge_blocks,
)
from tempo_tpu_torch.db.pool import Pool
from tempo_tpu_torch.db.poller import Poller, PollerConfig
from tempo_tpu_torch.db.tempodb import TempoDB, TempoDBConfig

__all__ = [
    "CompactorConfig", "List", "Poller", "PollerConfig", "Pool", "TempoDB",
    "TempoDBConfig", "TimeWindowBlockSelector", "compact", "do_retention",
    "iter_trace_groups", "merge_blocks",
]
