"""The generator ingest WAL's config block.

Counterpart of the part of `tempo_tpu/generator/wal.py` that the App's
config reads: `IngestWalConfig` (reference `:67-104`), the `wal:` block.
The WAL itself (`GeneratorWal`: append before ack, watermarked
truncation, exactly-once replay into torch state) comes with durability
and fleet (ROADMAP section 1, item 12): constructing it raises naming
that item, and the App raises the same way when `wal.enabled` is set.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class IngestWalConfig:
    """The `wal:` config block (generator targets only)."""

    enabled: bool = False
    # per-tenant segment logs live under <dir>/<quoted tenant>/
    dir: str = "./tempo-data/generator-wal"
    # durability point for the ack: "batch" fsyncs every appended record
    # (acked == on disk), "interval" fsyncs at most every
    # fsync_interval_s (bounded loss window, much cheaper on slow
    # disks), "off" leaves flushing to the OS page cache (process-crash
    # safe, power-loss unsafe)
    fsync: str = "batch"
    fsync_interval_s: float = 0.5
    # segment rotation: a new segment file past either bound (whole
    # segments are the truncation unit — smaller segments truncate
    # sooner after a checkpoint, more files otherwise)
    segment_max_bytes: int = 64 << 20
    segment_max_age_s: float = 300.0

    def check(self) -> list[str]:
        problems = []
        if self.fsync not in ("batch", "interval", "off"):
            problems.append(f"wal.fsync {self.fsync!r} unknown: use "
                            "'batch' (fsync per acked record), 'interval' "
                            "(time-batched), or 'off' (OS page cache)")
        if self.fsync == "interval" and self.fsync_interval_s <= 0:
            problems.append("wal.fsync_interval_s must be > 0 with "
                            "fsync: interval")
        if self.segment_max_bytes < (1 << 20):
            problems.append(f"wal.segment_max_bytes "
                            f"({self.segment_max_bytes}) < 1MB: rotation "
                            "would thrash one file per handful of records")
        if self.segment_max_age_s <= 0:
            problems.append("wal.segment_max_age_s must be > 0")
        if self.enabled and not self.dir:
            problems.append("wal.enabled needs wal.dir")
        return ["wal: " + p for p in problems] if problems else []


WAL_LATER = ("the generator ingest WAL comes with durability and fleet "
             "(ROADMAP section 1, item 12)")


class GeneratorWal:
    """The reference's per-tenant ingest WAL: not ported yet."""

    def __init__(self, *_args, **_kwargs) -> None:
        raise NotImplementedError(WAL_LATER)


__all__ = ["IngestWalConfig", "GeneratorWal", "WAL_LATER"]
