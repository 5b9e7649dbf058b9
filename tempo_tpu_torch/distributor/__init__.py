"""Distributor: write-path entry — validate, limit, regroup, replicate.

Counterpart of `tempo_tpu/distributor/`, the analog of
`modules/distributor`: receives OTLP payloads or decoded spans, enforces
per-tenant rate limits (`ingestion_rate_strategy.go`), validates and
truncates, regroups spans by trace id with vectorized token hashing
(`requestsByTraceID` `distributor.go:694-801` + `pkg/util/hash.go:8`),
replicates to ingesters over the ring with RF quorum
(`sendToIngestersViaBytes` `distributor.go:490`), and tees to the
metrics-generators (`sendToGenerators` `distributor.go:563`).

The Kafka and Jaeger-agent receivers are `receiver_kafka.py` and
`receiver_agent.py`.
"""

from tempo_tpu_torch.distributor.distributor import Distributor, DistributorConfig
from tempo_tpu_torch.distributor.limiter import RateLimiter

__all__ = ["Distributor", "DistributorConfig", "RateLimiter"]
