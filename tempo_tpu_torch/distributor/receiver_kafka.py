"""Kafka receiver: OTLP payloads consumed FROM a topic into the
distributor.

The reference's distributor can host a kafka receiver among its OTel
receivers (`modules/distributor/receiver/shim.go:165-171` "kafka"): an
external pipeline (e.g. an OTel collector exporting to Kafka) produces
OTLP ExportTraceServiceRequest bytes to a topic; the distributor consumes
and ingests them. This is the INVERSE of the ingest-storage bus (where
the distributor is the producer). Works against any `ingest.bus.Bus`
surface — the in-memory bus in tests, `KafkaBus` in deployments.

Record key = tenant (the same convention the write path uses); empty key
falls back to the configured default tenant. Offsets commit after a
successful push, so a crash replays at-least-once — the distributor's
trace-id regroup and the ingester's live-trace merge absorb duplicates
the same way the blockbuilder path does.

Counterpart of `tempo_tpu/distributor/receiver_kafka.py`, host code copied with
its imports moved to the port.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from typing import Sequence

log = logging.getLogger("tempo_tpu_torch.distributor.kafka_receiver")


@dataclasses.dataclass
class KafkaReceiverConfig:
    partitions: Sequence[int] = (0,)
    group: str = "tempo-distributor-receiver"
    default_tenant: str = "single-tenant"
    max_records: int = 100
    poll_interval_s: float = 0.25


class KafkaReceiver:
    """Consume OTLP payload records from bus partitions into a
    distributor. `run_once()` drives one poll (tests); `start()` runs the
    daemon loop."""

    def __init__(self, bus, distributor, cfg: KafkaReceiverConfig | None = None):
        self.bus = bus
        self.dist = distributor
        self.cfg = cfg or KafkaReceiverConfig()
        self.records_consumed = 0
        self.spans_pushed = 0
        self.errors = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def run_once(self) -> int:
        """One fetch+push+commit pass over every owned partition; returns
        records consumed."""
        from tempo_tpu_torch.distributor.distributor import (MalformedPayload,
                                                       RateLimited)

        n = 0
        for partition in self.cfg.partitions:
            offset = self.bus.committed(self.cfg.group, partition)
            recs = self.bus.fetch(partition, offset, self.cfg.max_records)
            if not recs:
                continue
            for rec in recs:
                tenant = rec.tenant or self.cfg.default_tenant
                try:
                    self.dist.push_otlp(tenant, rec.value)
                    self.spans_pushed += 1
                except MalformedPayload:
                    self.errors += 1      # poison record: skip, don't wedge
                except RateLimited:
                    # leave the offset where it is: retry this slice later
                    # instead of dropping over-limit data
                    return n
                n += 1
                self.records_consumed += 1
            # commit AFTER the pushes (at-least-once, like blockbuilder's
            # offset-commit-after-flush)
            self.bus.commit(self.cfg.group, partition, recs[-1].offset + 1)
        return n

    def start(self) -> None:
        def loop():
            while not self._stop.wait(self.cfg.poll_interval_s):
                try:
                    self.run_once()
                except Exception:
                    log.exception("kafka receiver poll failed")

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def shutdown(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
