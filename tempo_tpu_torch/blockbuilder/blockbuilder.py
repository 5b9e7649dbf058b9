"""The blockbuilder service.

Counterpart of `tempo_tpu/blockbuilder/blockbuilder.py`, host code over
the port's in-memory `ingest.Bus`, `ingest.encoding.decode_push`,
`utils.livetraces` and block writer. Each cut's sketch sidecar
(`block/sidecar.py`) is built on the builder's `device` (`cuda` unless
`"cpu"` is asked for). `partitions=None` on a Kafka bus (one with
`group_request`) enters the consumer-group mode of `ingest.kafka`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

from tempo_tpu_torch.backend.raw import RawWriter
from tempo_tpu_torch.block.writer import write_block
from tempo_tpu_torch.device import resolve_device
from tempo_tpu_torch.ingest.bus import Bus
from tempo_tpu_torch.ingest.encoding import decode_push
from tempo_tpu_torch.model.combine import combine_spans, sort_spans
from tempo_tpu_torch.utils.livetraces import LiveTraceStore

CONSUMER_GROUP = "blockbuilder"


@dataclasses.dataclass
class BlockBuilderConfig:
    # owned partitions; None = consumer-group mode on a Kafka bus (the
    # group protocol assigns + re-assigns partitions across replicas)
    partitions: "tuple[int, ...] | None" = (0,)
    consume_cycle_records: int = 1000        # per-cycle fetch budget
    max_block_objects: int = 100_000
    dedicated_columns: tuple = ()
    # emit the sketch sidecar (block/sidecar.py) at cut time, while the
    # spans are still resident — the compactor only backfills blocks that
    # predate this knob
    sidecars: bool = True


class BlockBuilder:
    def __init__(self, bus: Bus, writer: RawWriter,
                 cfg: BlockBuilderConfig | None = None,
                 now: Callable[[], float] = time.time, device=None) -> None:
        self.bus = bus
        self.writer = writer
        self.cfg = cfg or BlockBuilderConfig()
        self.now = now
        self.device = resolve_device(device)
        self.blocks_flushed = 0
        self.records_consumed = 0
        self._cg = None                      # lazy ConsumerGroup

    def _owned(self):
        """(partitions, group) for this cycle: static assignment, or the
        consumer-group's current assignment (rebalances between cycles
        as replicas come and go — reader_client.go's franz-go group)."""
        if self.cfg.partitions is not None:
            return list(self.cfg.partitions), None
        if hasattr(self.bus, "group_request"):
            if self._cg is None:
                from tempo_tpu_torch.ingest.kafka import ConsumerGroup
                self._cg = ConsumerGroup(self.bus, CONSUMER_GROUP,
                                         now=self.now)
            return self._cg.ensure_active(), self._cg
        return list(range(getattr(self.bus, "n_partitions", 1))), None

    def consume_cycle(self) -> int:
        """One cycle: per owned partition, drain from the committed offset,
        build+flush one block per tenant, then commit. Returns records."""
        parts, cg = self._owned()
        return sum(self._consume_partition(p, cg) for p in parts)

    def _consume_partition(self, partition: int, cg=None) -> int:
        start = self.bus.committed(CONSUMER_GROUP, partition)
        recs = self.bus.fetch(partition, start, self.cfg.consume_cycle_records)
        if not recs:
            return 0
        # accumulate per tenant (tenant_store.go live traces)
        stores: dict[str, LiveTraceStore] = {}
        for rec in recs:
            store = stores.setdefault(rec.tenant, LiveTraceStore(now=self.now))
            for tid, spans in decode_push(rec.value):
                store.push(tid, spans)
        # RF1 block(s) per tenant per cycle, flushed BEFORE commit; large
        # cycles split at max_block_objects traces per block
        for tenant, store in stores.items():
            traces = [(lt.trace_id, sort_spans(combine_spans(lt.spans)))
                      for lt in store.cut(immediate=True)]
            traces.sort(key=lambda t: t[0])
            cap = max(self.cfg.max_block_objects, 1)
            for lo in range(0, len(traces), cap):
                chunk = traces[lo: lo + cap]
                meta = write_block(self.writer, tenant, chunk,
                                   dedicated_columns=self.cfg.dedicated_columns,
                                   replication_factor=1)
                if self.cfg.sidecars:
                    from tempo_tpu_torch.backend.meta import write_block_meta
                    from tempo_tpu_torch.block.sidecar import (
                        sidecar_from_traces, write_sidecar)
                    write_sidecar(self.writer, tenant, meta.block_id,
                                  sidecar_from_traces(chunk,
                                                      device=self.device))
                    meta.sidecar = True
                    write_block_meta(self.writer, meta)
                self.blocks_flushed += 1
        next_offset = recs[-1].offset + 1
        if cg is not None:
            cg.commit(partition, next_offset)    # generation-fenced
        else:
            self.bus.commit(CONSUMER_GROUP, partition, next_offset)
        n = len(recs)
        self.records_consumed += n
        return n


# producer helper re-export (it lives with the encoding; kept here for
# discoverability next to the consumer)
from tempo_tpu_torch.ingest.encoding import produce_traces  # noqa: E402,F401
