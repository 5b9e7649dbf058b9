"""Partitioned ingest bus: the Kafka ingest-storage path, in-process.

Counterpart of `tempo_tpu/ingest/`, the analog of `pkg/ingest` (franz-go
layer) + `pkg/ingest/testkafka`: an append-only partitioned record log
with consumer-group offset commits. The distributor produces trace
records onto partitions chosen by trace token (`sendToKafka`
`distributor.go:612`); the metrics-generator consumes partitions and
commits offsets only after its output is applied.

The in-memory `Bus` is both the test double and the single-process
implementation; `kafka.KafkaBus` speaks the Kafka wire protocol to a real
broker with the same produce/fetch/commit surface, and
`kafka.ConsumerGroup` balances partitions between its members.
"""

from tempo_tpu_torch.ingest.bus import Bus, Record
from tempo_tpu_torch.ingest.encoding import decode_push, encode_push


__all__ = ["Bus", "Record", "encode_push", "decode_push"]
