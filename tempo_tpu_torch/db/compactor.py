"""Compaction: time-window block selection.

Counterpart of `tempo_tpu/db/compactor.py:31-76`: `CompactorConfig` (the
subset of `tempodb/config.go` the reference keeps) and the time-window
block selector (`compaction_block_selector.go`), which `TempoDBConfig`
and `TempoDB` take. The merge itself (`compact`, `merge_blocks`,
`iter_trace_groups`, `do_retention`) and the sketch sidecars come with
the cold tier (ROADMAP section 1, item 11) and raise until then.
"""

from __future__ import annotations

import dataclasses

from tempo_tpu_torch.backend import meta as bm


@dataclasses.dataclass
class CompactorConfig:
    """Subset of `tempodb/config.go` CompactorConfig."""

    max_compaction_window_s: float = 3600.0
    min_inputs: int = 2
    max_inputs: int = 4               # MaxCompactionObjects guard analog
    max_block_objects: int = 1_000_000
    max_block_bytes: int = 100 << 30
    compacted_grace_s: float = 3600.0  # retention grace for compacted markers
    retention_s: float = 14 * 86400.0
    # device cold tier (runbook "Compacting on device"): merge/dedup/
    # re-sort input blocks on device (`ops/compact.py`, one columnar
    # decode per input) instead of the host heapq merge; any failure
    # falls back to the host path for that group, warn-once
    device: bool = True
    # emit a sketch sidecar (block/sidecar.py) next to every compaction
    # output — the historical-fold tier's per-block summary
    sidecars: bool = True
    # compactor sweeps also backfill sidecars for pre-existing blocks
    # (low-priority compaction-class work), this many per tenant sweep
    backfill_sidecars: int = 2


class TimeWindowBlockSelector:
    """Group candidate blocks by (level, time window); oldest window first
    (`compaction_block_selector.go:29,119`)."""

    def __init__(self, cfg: CompactorConfig):
        self.cfg = cfg

    def blocks_to_compact(self, metas: list[bm.BlockMeta]) -> list[list[bm.BlockMeta]]:
        win = self.cfg.max_compaction_window_s
        groups: dict[tuple[int, int], list[bm.BlockMeta]] = {}
        for m in metas:
            groups.setdefault((m.compaction_level, int(m.end_time // win)), []).append(m)
        out = []
        for (_lvl, _w), ms in sorted(groups.items(), key=lambda kv: (kv[0][1], kv[0][0])):
            ms.sort(key=lambda m: m.size_bytes)
            while len(ms) >= self.cfg.min_inputs:
                take = ms[: self.cfg.max_inputs]
                ms = ms[self.cfg.max_inputs:]
                if len(take) >= self.cfg.min_inputs:
                    out.append(take)
        return out


def _cold_tier(name: str):
    def fn(*_args, **_kwargs):
        raise NotImplementedError(
            f"db.compactor.{name} is the cold tier's merge, which comes "
            f"with ROADMAP section 1, item 11")
    fn.__name__ = name
    return fn


compact = _cold_tier("compact")
merge_blocks = _cold_tier("merge_blocks")
iter_trace_groups = _cold_tier("iter_trace_groups")
do_retention = _cold_tier("do_retention")
