"""Partitioned ingest bus: the Kafka ingest-storage path, in-process.

Counterpart of `tempo_tpu/ingest/`, the analog of `pkg/ingest` (franz-go
layer) + `pkg/ingest/testkafka`: an append-only partitioned record log
with consumer-group offset commits. The distributor produces trace
records onto partitions chosen by trace token (`sendToKafka`
`distributor.go:612`); the metrics-generator consumes partitions and
commits offsets only after its output is applied.

The in-memory `Bus` is both the test double and the single-process
implementation. The Kafka wire client (`kafka.py`, with its
`ConsumerGroup`) comes with the Kafka ingest item (ROADMAP section 1,
item 14): `KafkaBus` and `ConsumerGroup` raise `NotImplementedError`
until then.
"""

from tempo_tpu_torch.ingest.bus import Bus, Record
from tempo_tpu_torch.ingest.encoding import decode_push, encode_push


def __getattr__(name: str):
    if name in ("KafkaBus", "ConsumerGroup", "kafka"):
        raise NotImplementedError(
            f"tempo_tpu_torch.ingest.{name} comes with the Kafka ingest item "
            f"(ROADMAP section 1, item 14)")
    raise AttributeError(name)


__all__ = ["Bus", "Record", "encode_push", "decode_push"]
