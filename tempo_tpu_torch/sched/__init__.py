"""tempo_tpu_torch.sched — shared device-execution scheduler.

Counterpart of `tempo_tpu/sched/`: continuous micro-batching for every
device caller in the process, with bounded per-priority-class queues
(live-ingest > query > compaction), load shedding, a cross-tenant
coalescer over padded power-of-two buckets, and an adaptive batch
window. See `scheduler.py` for the design notes.
"""

from tempo_tpu_torch.sched.scheduler import (
    CLASS_NAMES,
    DeviceScheduler,
    Job,
    PRIO_COMPACTION,
    PRIO_INGEST,
    PRIO_QUERY,
    QueryBackpressure,
    SchedConfig,
    WindowTuner,
    bucket_rows,
    configure,
    flush,
    fraction_for_pressure,
    ingest_keep_fraction,
    reset,
    run,
    scheduler,
    use,
)

__all__ = [
    "CLASS_NAMES", "DeviceScheduler", "Job", "PRIO_COMPACTION",
    "PRIO_INGEST", "PRIO_QUERY", "QueryBackpressure", "SchedConfig",
    "WindowTuner", "bucket_rows", "configure", "flush",
    "fraction_for_pressure",
    "ingest_keep_fraction", "reset", "run", "scheduler", "use",
]
